"""Shape-aware attention kernel dispatch (port of
``deepspeed_tpu/ops/kernel_dispatch.py``).

The forward and backward legs of ``ops/attention.flash_attention`` are
chosen independently per (shape, dtype, causal/window/softcap flags,
device kind). Each leg resolves to one of three implementations, named as
in the JAX package because they are cache keys and env values users have
written:

- ``xla``: the plain PyTorch attention with fp32 scores, materialised
  (its backward is autograd through it);
- ``pallas``: the per-head flash kernels K1/K2 (``ops/attention.py``,
  ``csrc/flash_attention.cu``);
- ``folded``: the head-folded flash kernels K3 (``ops/attention_folded.py``).

Precedence per leg, strongest first (``resolve_leg``):

1. explicit ``impl_fwd``/``impl_bwd`` arguments of ``flash_attention``;
2. ``DS_TPU_ATTN_FWD`` / ``DS_TPU_ATTN_BWD`` (``xla|pallas|folded``);
3. legacy ``DS_TPU_FLASH_FOLDED``: nonzero forces ``folded`` on both legs;
   ``0`` pins the per-head variant for a leg that resolves to a kernel;
4. a measured entry of the autotune cache (``autotune_cache.py``, written
   by ``python -m deepspeed_tpu_torch.ops.attn_sweep``) for this device
   kind;
5. the heuristic table (``_heuristic_impl``).

The JAX package has a sixth rung, the deprecated ``.perf/FOLDED_PROVEN``
sentinel (``_sentinel_folded :115``). The port leaves it out: it reads a
file of the checkout, so a decision would depend on what lies beside the
code rather than on the measured table.

Blocks follow the same order: explicit > ``DS_TPU_FLASH_BLOCKS`` >
measured > per-head_dim defaults. ``BLOCK_TABLE`` and ``_heuristic_impl``
are the JAX package's rules, measured on a TPU v5e; they are kept as they
are so that the port decides as the JAX package does for the same inputs
on ``cpu`` and on the JAX package's TPU kinds. The CUDA kernels choose
their own tiles, so a Decision's blocks are recorded (cache entries,
``describe``) and do not change which kernel runs.

On a card's kind (any kind but ``cpu`` and the TPU kinds) the heuristic
and a measured entry resolve only to the kernels (``route_impls``): the
TPU's ``xla`` pick is not carried to a card, and the sweep there times and
commits only ``pallas`` and ``folded``. The plain attention runs on a card
only where the caller pinned it (an ``impl_*`` argument or the env).
"""

import logging
import os
from typing import NamedTuple, Optional

from .autotune_cache import get_cache

logger = logging.getLogger(__name__)

IMPL_XLA = "xla"
IMPL_PALLAS = "pallas"  # per-head kernels K1/K2 (ops/attention.py)
IMPL_FOLDED = "folded"  # head-folded kernels K3 (ops/attention_folded.py)
_IMPLS = (IMPL_XLA, IMPL_PALLAS, IMPL_FOLDED)

# head_dim -> default (block_q, block_k): the JAX package's table, from a
# TPU v5e measurement (hd64 (256, 512) +20% over (256, 256) there)
BLOCK_TABLE = {64: (256, 512), 128: (128, 128)}
DEFAULT_BLOCKS = (128, 128)


class ShapeSig(NamedTuple):
    """The static facts a dispatch decision may depend on."""
    batch: int
    seq_q: int
    seq_k: int
    heads: int
    kv_heads: int
    head_dim: int
    dtype: str
    causal: bool
    windowed: bool
    softcapped: bool


class Decision(NamedTuple):
    """One leg's resolved choice. ``source``: explicit | env | legacy-env |
    measured | heuristic, with ``+pallas-forced`` where ``pallas_only``
    replaced an ``xla`` pick."""
    impl: str
    block_q: int
    block_k: int
    source: str


def dtype_name(dtype) -> str:
    """``bfloat16`` for ``torch.bfloat16`` (and for the string itself): the
    JAX package's spelling, so the two packages write the same keys."""
    return str(dtype).replace("torch.", "")


def make_sig(q_shape, kv_heads: int, seq_k: int, dtype, causal: bool,
             window, softcap) -> ShapeSig:
    b, sq, h, d = q_shape
    return ShapeSig(batch=int(b), seq_q=int(sq), seq_k=int(seq_k),
                    heads=int(h), kv_heads=int(kv_heads), head_dim=int(d),
                    dtype=dtype_name(dtype), causal=bool(causal),
                    windowed=window is not None,
                    softcapped=softcap is not None)


def signature(leg: str, sig: ShapeSig, device_kind: str) -> str:
    """Cache key: leg + device kind + the whole shape signature."""
    return (f"{leg}|{device_kind}|b{sig.batch}|sq{sig.seq_q}|sk{sig.seq_k}"
            f"|h{sig.heads}|kv{sig.kv_heads}|d{sig.head_dim}|{sig.dtype}"
            f"|c{int(sig.causal)}|w{int(sig.windowed)}"
            f"|sc{int(sig.softcapped)}")


def device_kind(device=None) -> str:
    """The cache keys' device kind: ``torch.cuda.get_device_name`` of a CUDA
    device (``NVIDIA H100 80GB HBM3``), else ``cpu``. ``device`` defaults
    to the current CUDA device when there is one."""
    import torch
    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu"))
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"


def route_impls(kind: str) -> tuple:
    """The implementations the heuristic, a measured entry and the sweep may
    pick on device kind ``kind``: all three on ``cpu`` and the JAX package's
    TPU kinds, only the kernels on a card."""
    if kind == "cpu" or kind.upper().startswith("TPU"):
        return _IMPLS
    return (IMPL_PALLAS, IMPL_FOLDED)


def _env_impl(name: str) -> Optional[str]:
    val = os.environ.get(name, "").strip().lower()
    if not val:
        return None
    if val not in _IMPLS:
        logger.warning(f"{name}={val!r} ignored (want one of {_IMPLS})")
        return None
    return val


def _variant_preference() -> Optional[str]:
    """Which kernel variant (per-head or folded) a kernel leg takes when
    nothing shape-specific decided it: the legacy env."""
    env = os.environ.get("DS_TPU_FLASH_FOLDED")
    if env is not None:
        return IMPL_FOLDED if env not in ("", "0") else IMPL_PALLAS
    return None


def _env_blocks() -> Optional[tuple]:
    env = os.environ.get("DS_TPU_FLASH_BLOCKS")
    if not env:
        return None
    try:
        bq, bk = (int(x) for x in env.split(","))
        return bq, bk
    except ValueError:
        logger.warning(f"DS_TPU_FLASH_BLOCKS={env!r} ignored (want 'bq,bk')")
        return None


def default_blocks(head_dim: int) -> tuple:
    return BLOCK_TABLE.get(head_dim, DEFAULT_BLOCKS)


def _heuristic_impl(leg: str, sig: ShapeSig, kind: str) -> str:
    """The JAX package's table, from a TPU v5e measurement: the forward
    goes to ``xla`` for head_dim <= 64 at seq_k >= 1024 without a window
    (XLA's fused attention beat the Pallas forward there); windowed shapes
    and every backward take the per-head kernels. On a card's kind every
    leg takes the per-head kernels."""
    if (leg == "fwd" and IMPL_XLA in route_impls(kind) and sig.head_dim <= 64
            and sig.seq_k >= 1024 and not sig.windowed):
        return IMPL_XLA
    return IMPL_PALLAS


def resolve_leg(leg: str, sig: ShapeSig, kind: Optional[str] = None, *,
                explicit_impl: Optional[str] = None,
                explicit_blocks: Optional[tuple] = None,
                pallas_only: bool = False) -> Decision:
    """Resolve one leg ("fwd" | "bwd") to a Decision. ``pallas_only``
    restricts the choice to the kernels: an ``xla`` pick becomes the
    per-head kernel (or the folded one under the legacy env)."""
    kind = kind if kind is not None else device_kind()
    variant = _variant_preference()

    impl = None
    source = None
    if explicit_impl is not None:
        if explicit_impl not in _IMPLS:
            raise ValueError(f"impl {explicit_impl!r}: want one of {_IMPLS}")
        impl, source = explicit_impl, "explicit"
    if impl is None:
        env = _env_impl("DS_TPU_ATTN_FWD" if leg == "fwd" else "DS_TPU_ATTN_BWD")
        if env is not None:
            impl, source = env, "env"
    if impl is None and os.environ.get("DS_TPU_FLASH_FOLDED") not in (None, "", "0"):
        impl, source = IMPL_FOLDED, "legacy-env"

    measured = None
    if impl is None:
        measured = get_cache().lookup(signature(leg, sig, kind))
        if measured and measured.get("impl") in route_impls(kind):
            impl, source = measured["impl"], "measured"
        else:
            measured = None
    if impl is None:
        impl, source = _heuristic_impl(leg, sig, kind), "heuristic"
        if impl == IMPL_PALLAS and variant == IMPL_FOLDED:
            impl = IMPL_FOLDED

    if pallas_only and impl == IMPL_XLA:
        impl = variant or IMPL_PALLAS
        source += "+pallas-forced"

    blocks = explicit_blocks or _env_blocks()
    if blocks is None and measured is not None:
        try:
            blocks = (int(measured["block_q"]), int(measured["block_k"]))
        except (KeyError, TypeError, ValueError):
            blocks = None
    if blocks is None:
        blocks = default_blocks(sig.head_dim)
    return Decision(impl=impl, block_q=int(blocks[0]), block_k=int(blocks[1]),
                    source=source)


def resolve(sig: ShapeSig, kind: Optional[str] = None, *,
            impl_fwd: Optional[str] = None, impl_bwd: Optional[str] = None,
            blocks: Optional[tuple] = None, pallas_only: bool = False):
    """(fwd Decision, bwd Decision) for one attention call."""
    fwd = resolve_leg("fwd", sig, kind, explicit_impl=impl_fwd,
                      explicit_blocks=blocks, pallas_only=pallas_only)
    bwd = resolve_leg("bwd", sig, kind, explicit_impl=impl_bwd,
                      explicit_blocks=blocks, pallas_only=pallas_only)
    return fwd, bwd


def describe(fwd: Decision, bwd: Decision) -> str:
    """Per-leg note, e.g. ``attn[fwd=xla:heuristic,bwd=pallas@128x128:measured]``."""

    def leg(d: Decision) -> str:
        blocks = ("" if d.impl == IMPL_XLA
                  else f"@{d.block_q}x{d.block_k}")
        return f"{d.impl}{blocks}:{d.source}"

    return f"attn[fwd={leg(fwd)},bwd={leg(bwd)}]"


def table_source() -> str:
    """Where dispatch decisions come from, in one line."""
    return get_cache().source_description()


def resolved_note(batch=8, seq=1024, heads=16, kv_heads=None, head_dim=64,
                  dtype="bfloat16", causal=True,
                  kind: Optional[str] = None) -> str:
    """The per-leg dispatch note at a given shape (default: the JAX
    package's bench shape)."""
    sig = make_sig((batch, seq, heads, head_dim),
                   kv_heads if kv_heads is not None else heads, seq, dtype,
                   causal, None, None)
    return describe(*resolve(sig, kind))
