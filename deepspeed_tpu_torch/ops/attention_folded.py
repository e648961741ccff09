"""Head-folded flash attention, K3 (port of
``deepspeed_tpu/ops/attention_folded.py``: ``_fwd_kernel :69``,
``_dq_kernel :146`` and ``_dkdv_kernel :215``, driven by
``flash_fwd_folded :309`` and ``flash_bwd_folded :345``).

The same function as K1/K2 (``ops/attention.py``), in the folded layout:
q/o/dO stay ``[B, S, H, D]`` and the kernels read k/v ``[B, S, KV, D]`` as
the folded ``[B, S, KV*D]`` (the same memory). K3's entry points
(``csrc/flash_attention_folded.cu``) launch K1/K2's kernels on their
per-head grid: the Pallas kernel folds the KV heads into one grid step to
spread a TPU grid step's fixed cost, which the H100 does not have, so K3's
outputs equal K1/K2's bit for bit. Causal,
window and softcap masks as K1/K2. ``lse`` comes out ``[B, S, H]`` fp32 with K1's
``LSE_MASKED`` (+1e30) for a row that sees no key, where the folded Pallas
kernel writes -1e30 (``attention_folded.py:41``): both backwards zero P
for such a row, and the port keeps one marker for both layouts.

``folded_attention_fwd``, ``folded_attention_bwd_dq`` and
``folded_attention_bwd_dkdv`` are the kernels' wrappers, built as K1/K2's
(``attention.kernel_wrappers``): each takes its plain version for a CPU
tensor (``*_reference``, K1/K2's: K3 computes their function) and
launches its kernel for a CUDA tensor or raises; each counts its launches
in ``.launches``. ``flash_fwd_folded`` and ``flash_bwd_folded`` keep the
JAX signatures without ``interpret``; their ``block_q``/``block_k`` are
accepted for that signature only and ignored, since the kernels choose
their own tiles. Unlike the Pallas kernel the sequence need not divide the
blocks: the kernels mask the ragged last tile.
"""

from .attention import (flash_attention_bwd_dkdv_reference,
                        flash_attention_bwd_dq_reference,
                        flash_attention_fwd_reference, kernel_backward,
                        kernel_wrappers)

# K3 computes K1/K2's function: its plain versions are K1/K2's
folded_attention_fwd_reference = flash_attention_fwd_reference
folded_attention_bwd_dq_reference = flash_attention_bwd_dq_reference
folded_attention_bwd_dkdv_reference = flash_attention_bwd_dkdv_reference

folded_attention_fwd, folded_attention_bwd_dq, folded_attention_bwd_dkdv = kernel_wrappers(
    "folded_attention", "dstt_flash_folded", globals(), "K3")


def flash_fwd_folded(q, k, v, scale, causal, block_q, block_k, window=None,
                     softcap=None):
    """``(o [B, S, H, D], lse [B, S, H] fp32)`` through the K3 forward."""
    return folded_attention_fwd(q, k, v, causal, scale, window, softcap)


def flash_bwd_folded(q, k, v, lse, o, g_out, scale, causal, block_q, block_k,
                     window=None, softcap=None):
    """``(dq, dk, dv)`` through the two K3 backward passes; delta =
    rowsum(dO * O) in fp32 first, as the JAX ``flash_bwd_folded`` does."""
    return kernel_backward(folded_attention_bwd_dq, folded_attention_bwd_dkdv, q, k, v, o,
                           lse, g_out, causal, scale, window, softcap)
