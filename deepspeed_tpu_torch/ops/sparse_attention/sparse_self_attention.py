"""Block-sparse self attention (port of
``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py``:
``layout_to_mask`` :22, ``sparse_attention`` :27 and ``SparseSelfAttention``
:74).

Two paths, chosen as the JAX package chooses them (``:46-52``) with
``q.is_cuda`` in place of ``on_tpu()``: on the card, with no
``key_padding_mask`` and ``S % block == 0``, the splash kernel K8
(``splash.py``), whose work scales with the active blocks; otherwise the
dense masked einsum, which is also the numerics oracle. ``use_kernel``
forces either; ``use_kernel=True`` with a padding mask raises. Once the
kernel is chosen on a CUDA tensor, a build or launch failure raises. On a
CPU tensor the kernel path runs K8's plain versions.
"""

from typing import Optional

import numpy as np
import torch

from .sparsity_config import FixedSparsityConfig, SparsityConfig


def layout_to_mask(layout: np.ndarray, block: int) -> np.ndarray:
    """[heads, nb, nb] block layout -> [heads, seq, seq] boolean mask (the
    JAX package's ``np.kron`` with a block of ones, without its int64
    intermediate)."""
    return np.asarray(layout).astype(bool).repeat(block, 1).repeat(block, 2)


def _kernel_path(q, block: int, key_padding_mask, use_kernel: Optional[bool]) -> bool:
    """The JAX package's dispatch (``:46-52``) with ``q.is_cuda`` for
    ``on_tpu()``."""
    if use_kernel and key_padding_mask is not None:
        raise ValueError("the splash kernel does not take key_padding_mask; "
                         "fold padding into the layout or use the dense path")
    if use_kernel is None:
        return key_padding_mask is None and q.shape[2] % block == 0 and q.is_cuda
    return bool(use_kernel)


def sparse_attention(q, k, v, layout: np.ndarray, block: int,
                     key_padding_mask: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None,
                     key_padding_mask_mode: str = "mul",
                     use_kernel: Optional[bool] = None):
    """Masked attention under a block-sparse layout.
    q,k,v: [batch, heads, seq, head_dim]; layout: [heads, nb, nb].
    key_padding_mask [b, s]: mode 'mul' = keep-mask (True/1 = attend);
    mode 'add' = additive float mask (0 = keep, large-negative = drop) —
    the reference's two conventions (sparse_self_attention.py:12).

    On the card (no padding mask, S a multiple of the block) this runs the
    splash kernel (splash.py), whose compute scales with ACTIVE blocks; the
    dense masked einsum is the other path and the oracle. use_kernel forces
    either path."""
    b, h, s, d = q.shape
    scale = scale if scale is not None else (1.0 / float(np.sqrt(d)))
    if _kernel_path(q, block, key_padding_mask, use_kernel):
        from .splash import splash_sparse_attention
        return splash_sparse_attention(q, k, v, layout, block, scale=scale)
    visible = torch.from_numpy(layout_to_mask(layout, block)).to(q.device)[None]
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    neg = torch.finfo(torch.float32).min
    if key_padding_mask is not None:
        kpm = key_padding_mask[:, None, None, :]
        if key_padding_mask_mode == "add" and kpm.dtype != torch.bool:
            # purely additive (reference semantics): moderate biases (e.g.
            # ALiBi-style values <= -1) must bias, not hard-mask — only the
            # sparse layout decides visibility here
            scores = scores + kpm.float()
        else:  # keep-mask (bool is always keep-style, whatever the mode)
            visible = visible & kpm.bool()
    scores = torch.where(visible, scores, torch.full((), neg, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    # rows with no visible key at all would softmax to uniform; zero them
    any_visible = visible.any(-1, keepdim=True)
    probs = torch.where(any_visible, probs, torch.zeros((), device=q.device)).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


class SparseSelfAttention:
    """Reference-parity wrapper: config-held layout, __call__(q, k, v)."""

    def __init__(self, sparsity_config: Optional[SparsityConfig] = None,
                 key_padding_mask_mode: str = "add", attn_mask_mode: str = "mul"):
        self.sparsity_config = sparsity_config or FixedSparsityConfig(num_heads=4)
        self.key_padding_mask_mode = key_padding_mask_mode
        self.attn_mask_mode = attn_mask_mode
        self._layout_cache = {}
        # (seq_len, head_dim, device) -> K8's function with its device tables
        self._splash_cache = {}

    def get_layout(self, seq_len: int) -> np.ndarray:
        if seq_len not in self._layout_cache:
            self._layout_cache[seq_len] = self.sparsity_config.make_layout(seq_len)
        return self._layout_cache[seq_len]

    def __call__(self, query, key, value, key_padding_mask=None):
        _, _, s, d = query.shape
        layout, block = self.get_layout(s), self.sparsity_config.block
        if _kernel_path(query, block, key_padding_mask, None):
            # K8's tables are held beside the layout, so a call builds no
            # cache key from the layout's bytes
            at = (s, d, str(query.device))
            if at not in self._splash_cache:
                from .splash import splash_function
                self._splash_cache[at] = splash_function(layout, block, 1.0 / float(np.sqrt(d)),
                                                         query.device)
            return self._splash_cache[at](query, key, value)
        return sparse_attention(query, key, value, layout, block, key_padding_mask,
                                key_padding_mask_mode=self.key_padding_mask_mode)
