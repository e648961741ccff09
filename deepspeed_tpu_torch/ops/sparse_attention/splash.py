"""Splash block-sparse attention, forward and backward (port of
``deepspeed_tpu/ops/sparse_attention/splash.py``: ``build_block_table`` :44,
the forward ``_splash_kernel`` :63 driven by ``_splash_fwd`` :117, the
backward ``_splash_dq_kernel`` :165 and ``_splash_dkv_kernel`` :201 driven
by ``_splash_bwd`` :242, ``_cached_splash_fn`` :318,
``splash_sparse_attention`` :346 and ``splash_flops`` :368).

q, k and v are ``[B, H, S, D]`` (head-major); the static layout is
``[H or 1, nb, nb]`` with ``nb = S // block``, and row ``bh = b * H + h``
reads layout head ``bh % layout_heads`` (the JAX kernel's
``jax.lax.rem(bh, nheads_layout)``). ``build_block_table`` compacts the
layout into the indices of each row's active k-blocks and their count; the
dk/dv pass uses the table of the transposed layout (for each k-block, the
q-blocks that see it).

Three kernels (bodies in ``csrc/splash_attention.cuh``; the forward, dq
and dk/dv passes build from ``splash_attention.cu``,
``splash_attention_bwd_dq.cu`` and ``splash_attention_bwd_dkdv.cu`` in
parallel), each with its plain version here and a launch count:

- ``splash_attention_fwd`` (K8 forward): ``o`` in q's dtype and ``lse``
  ``[B, H, S]`` fp32; a row with no active block gets o = 0 and lse =
  ``LSE_EMPTY`` (+1e30), so the backward's ``exp(s - lse)`` is exactly 0;
- ``splash_attention_bwd_dq``: dq over the forward table, P rebuilt from
  lse, dS rounded to k's dtype before ``dS k``;
- ``splash_attention_bwd_dkdv``: dk and dv over the transposed table, P
  rounded to dO's dtype and dS to q's dtype.

Each wrapper runs its plain version for a CPU tensor and launches its
kernel for a CUDA tensor or raises. ``delta = rowsum(dO * O)`` stays
PyTorch, as it is an XLA pass outside the Pallas kernels in the JAX
package. The plain versions compute the same function densely under the
layout's mask, in fp32 (fp64 for fp64 inputs: the exact value), in chunks
of ``(batch, head)`` rows.

``splash_sparse_attention`` is one ``torch.autograd.Function`` over the
three; its block tables live on the device in a cache keyed like
``_cached_splash_fn`` (layout bytes, shape, block, scale, device), so a
call never rebuilds them in a host loop.
"""

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from .. import _build
from ..attention import _wide, attention_delta

NEG_INF = -1e30
LSE_EMPTY = -NEG_INF  # lse of a row with no active block: exp(s - lse) == 0

# block sizes the kernels are built for (the JAX package's tests use all four;
# 16 is the reference's default)
KERNEL_BLOCKS = (16, 32, 64, 128)

# the plain versions score at most this many (row, query, key) triples at a
# time: 1 GiB of fp32 per score-shaped temporary
CHUNK_PAIRS = 1 << 28


def build_block_table(layout: np.ndarray):
    """[H, nb, nb] 0/1 layout -> (table [H, nb, A] int32, counts [H, nb]
    int32).

    A = widest active row; padding entries point at block 0 and are skipped
    via the counts.
    """
    layout = np.asarray(layout).astype(bool)
    H, nb, nb2 = layout.shape
    assert nb == nb2, layout.shape
    counts = layout.sum(-1).astype(np.int32)
    A = max(int(counts.max()), 1)
    table = np.zeros((H, nb, A), dtype=np.int32)
    for h in range(H):
        for qb in range(nb):
            idx = np.nonzero(layout[h, qb])[0]
            table[h, qb, :len(idx)] = idx
    return table, counts


@dataclasses.dataclass(frozen=True)
class SplashTables:
    """One layout on one device: the layout itself (bool ``[Lh, nb, nb]``,
    for the plain versions), the block size, and the kernels' int32 block
    tables of the layout and of its transpose."""
    layout: torch.Tensor
    block: int
    table: torch.Tensor
    counts: torch.Tensor
    table_t: torch.Tensor
    counts_t: torch.Tensor

    @staticmethod
    def build(layout: np.ndarray, block: int, device) -> "SplashTables":
        lay = np.ascontiguousarray(np.asarray(layout).astype(bool))
        table, counts = build_block_table(lay)
        table_t, counts_t = build_block_table(lay.transpose(0, 2, 1))
        dev = torch.device(device)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        return SplashTables(put(lay), int(block), put(table), put(counts),
                            put(table_t), put(counts_t))


def _scale(q, scale):
    return float(scale) if scale is not None else 1.0 / float(np.sqrt(q.shape[-1]))


def _layout_tensor(layout, device):
    """The bool layout on ``device``, from an array or a ``SplashTables``."""
    if isinstance(layout, SplashTables):
        return layout.layout.to(device)
    return torch.from_numpy(np.asarray(layout).astype(bool)).to(device)


def _row_chunks(q):
    """``(batch*head)`` row ranges whose dense scores fit ``CHUNK_PAIRS``."""
    B, H, S, _ = q.shape
    step = max(1, CHUNK_PAIRS // (S * S))
    for r0 in range(0, B * H, step):
        yield r0, min(B * H, r0 + step)


def _visible(layout, block, r0, r1):
    """The dense mask ``[r1 - r0, S, S]`` of rows r0:r1: row bh reads
    layout head ``bh % layout_heads``."""
    heads = torch.arange(r0, r1, device=layout.device) % layout.shape[0]
    m = layout[heads]
    return m.repeat_interleave(block, 1).repeat_interleave(block, 2)


def _flat(x):
    B, H, S, D = x.shape
    return x.reshape(B * H, S, D)


def splash_attention_fwd_reference(q, k, v, layout, block: int,
                                   scale: Optional[float] = None):
    """Plain forward of K8: fp32 scores of the active blocks (the others
    masked), the softmax, P cast to v's dtype for the PV product. Returns
    ``(o [B, H, S, D] in q's dtype, lse [B, H, S] fp32)``; a row with no
    active block gives 0 and ``LSE_EMPTY``."""
    B, H, S, D = q.shape
    lay = _layout_tensor(layout, q.device)
    scale = _scale(q, scale)
    qf, kf, vf = _flat(q), _flat(k), _flat(v)
    o = torch.empty_like(qf)
    lse = torch.empty(B * H, S, dtype=_wide(q[:0]).dtype, device=q.device)
    for r0, r1 in _row_chunks(q):
        vis = _visible(lay, block, r0, r1)
        s = torch.einsum("rqd,rkd->rqk", _wide(qf[r0:r1]), _wide(kf[r0:r1])) * scale
        s = s.masked_fill(~vis, float("-inf"))
        m = s.amax(-1, keepdim=True)
        m_safe = torch.where(torch.isinf(m), torch.zeros_like(m), m)
        p = torch.exp(s - m_safe)
        l = p.sum(-1, keepdim=True)
        safe_l = torch.where(l == 0, torch.ones_like(l), l)
        oc = torch.einsum("rqk,rkd->rqd", _wide((p / safe_l).to(v.dtype)),
                          _wide(vf[r0:r1]))
        o[r0:r1] = oc.to(q.dtype)
        lse[r0:r1] = torch.where(l == 0, torch.full_like(l, LSE_EMPTY),
                                 m_safe + torch.log(safe_l))[..., 0]
    return o.reshape(B, H, S, D), lse.reshape(B, H, S)


def _dscores(qf, kf, vf, dof, lse, delta, lay, block, scale, r0, r1):
    """P = exp(s - lse) (0 outside the active blocks) and dS = P * (dP -
    delta) * scale of rows r0:r1, ``[rows, S, S]`` fp32."""
    vis = _visible(lay, block, r0, r1)
    s = torch.einsum("rqd,rkd->rqk", _wide(qf[r0:r1]), _wide(kf[r0:r1])) * scale
    p = torch.exp(s - _wide(lse[r0:r1])[..., None]).masked_fill(~vis, 0.0)
    dp = torch.einsum("rqd,rkd->rqk", _wide(dof[r0:r1]), _wide(vf[r0:r1]))
    return p, p * (dp - _wide(delta[r0:r1])[..., None]) * scale


def splash_attention_bwd_dq_reference(q, k, v, do, lse, delta, layout,
                                      block: int, scale: Optional[float] = None):
    """Plain dq pass of K8: dS rounded to k's dtype for the dS k product
    (``_splash_dq_kernel``)."""
    B, H, S, D = q.shape
    lay = _layout_tensor(layout, q.device)
    scale = _scale(q, scale)
    qf, kf, vf, dof = _flat(q), _flat(k), _flat(v), _flat(do)
    lse, delta = lse.reshape(B * H, S), delta.reshape(B * H, S)
    dq = torch.empty_like(qf)
    for r0, r1 in _row_chunks(q):
        _, ds = _dscores(qf, kf, vf, dof, lse, delta, lay, block, scale, r0, r1)
        dq[r0:r1] = torch.einsum("rqk,rkd->rqd", _wide(ds.to(k.dtype)),
                                 _wide(kf[r0:r1])).to(q.dtype)
    return dq.reshape(B, H, S, D)


def splash_attention_bwd_dkdv_reference(q, k, v, do, lse, delta, layout,
                                        block: int, scale: Optional[float] = None):
    """Plain dk/dv pass of K8: dv = P^T dO (P rounded to dO's dtype), dk =
    dS^T q (dS rounded to q's dtype) (``_splash_dkv_kernel``)."""
    B, H, S, D = q.shape
    lay = _layout_tensor(layout, q.device)
    scale = _scale(q, scale)
    qf, kf, vf, dof = _flat(q), _flat(k), _flat(v), _flat(do)
    lse, delta = lse.reshape(B * H, S), delta.reshape(B * H, S)
    dk, dv = torch.empty_like(kf), torch.empty_like(vf)
    for r0, r1 in _row_chunks(q):
        p, ds = _dscores(qf, kf, vf, dof, lse, delta, lay, block, scale, r0, r1)
        dv[r0:r1] = torch.einsum("rqk,rqd->rkd", _wide(p.to(do.dtype)),
                                 _wide(dof[r0:r1])).to(v.dtype)
        dk[r0:r1] = torch.einsum("rqk,rqd->rkd", _wide(ds.to(q.dtype)),
                                 _wide(qf[r0:r1])).to(k.dtype)
    return dk.reshape(B, H, S, D), dv.reshape(B, H, S, D)


def _check_cuda(name, q, tables, tensors):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    B, H, S, D = q.shape
    Lh, nb, _ = tables.layout.shape
    if tables.block not in KERNEL_BLOCKS:
        raise ValueError(f"{name}: the kernel takes block in {KERNEL_BLOCKS}, "
                         f"got {tables.block}")
    if nb * tables.block != S or H % Lh:
        raise ValueError(f"{name}: layout {tuple(tables.layout.shape)} at block "
                         f"{tables.block} does not cover q {tuple(q.shape)}")
    if D > 128 or D % 8:
        raise ValueError(f"{name}: the kernel takes head_dim <= 128 and a "
                         f"multiple of 8, got {D}")
    if B * H > 65535:
        raise ValueError(f"{name}: the kernel takes batch * heads <= 65535, "
                         f"got {B * H}")
    if q.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"{name}: the kernel takes float32, bfloat16 or float16, "
                        f"got {q.dtype}")
    for t in tensors:
        if t.device != q.device or tables.table.device != q.device:
            raise ValueError(f"{name}: all inputs and the tables must be on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")
    for t in tensors[:4]:
        if tuple(t.shape) != tuple(q.shape) or t.dtype != q.dtype:
            raise ValueError(f"{name}: q, k, v (and dO) must share one shape "
                             "and dtype")
    for t in tensors[4:]:
        if t.dtype != torch.float32 or tuple(t.shape) != (B, H, S):
            raise ValueError(f"{name}: lse and delta must be float32 {(B, H, S)}, "
                             f"got {t.dtype} {tuple(t.shape)}")


def _launch(name, fn, q, tables, transposed, *ptrs, scale):
    B, H, S, D = q.shape
    table, counts = ((tables.table_t, tables.counts_t) if transposed
                     else (tables.table, tables.counts))
    with torch.cuda.device(q.device):
        err = fn(*ptrs, table.data_ptr(), counts.data_ptr(), B * H, S, D,
                 table.shape[0], table.shape[2], tables.block, float(scale),
                 _build.dtype_code(q.dtype),
                 torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, name)


def splash_attention_fwd(q, k, v, tables: SplashTables,
                         scale: Optional[float] = None):
    """K8 forward (kernel ``dstt_splash_fwd``): ``(o, lse)``."""
    if q.device.type == "cpu":
        return splash_attention_fwd_reference(q, k, v, tables, tables.block, scale)
    _check_cuda("splash_attention_fwd", q, tables, (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch("splash_attention_fwd", _build.lib().dstt_splash_fwd, q, tables, False,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            scale=_scale(q, scale))
    splash_attention_fwd.launches += 1
    return o, lse


def splash_attention_bwd_dq(q, k, v, do, lse, delta, tables: SplashTables,
                            scale: Optional[float] = None):
    """K8 dq pass over the forward table (kernel ``dstt_splash_bwd_dq``)."""
    if q.device.type == "cpu":
        return splash_attention_bwd_dq_reference(q, k, v, do, lse, delta, tables,
                                                 tables.block, scale)
    _check_cuda("splash_attention_bwd_dq", q, tables, (q, k, v, do, lse, delta))
    dq = torch.empty_like(q)
    _launch("splash_attention_bwd_dq", _build.lib().dstt_splash_bwd_dq, q, tables,
            False, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), scale=_scale(q, scale))
    splash_attention_bwd_dq.launches += 1
    return dq


def splash_attention_bwd_dkdv(q, k, v, do, lse, delta, tables: SplashTables,
                              scale: Optional[float] = None):
    """K8 dk/dv pass over the transposed table (kernel
    ``dstt_splash_bwd_dkdv``): ``(dk, dv)``."""
    if q.device.type == "cpu":
        return splash_attention_bwd_dkdv_reference(q, k, v, do, lse, delta, tables,
                                                   tables.block, scale)
    _check_cuda("splash_attention_bwd_dkdv", q, tables, (q, k, v, do, lse, delta))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("splash_attention_bwd_dkdv", _build.lib().dstt_splash_bwd_dkdv, q, tables,
            True, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            scale=_scale(q, scale))
    splash_attention_bwd_dkdv.launches += 1
    return dk, dv


for _fn in (splash_attention_fwd, splash_attention_bwd_dq, splash_attention_bwd_dkdv):
    _fn.launches = 0


class _Splash(torch.autograd.Function):
    """The JAX ``custom_vjp``: K8's forward saves ``(q, k, v, o, lse)``;
    the backward computes delta, then runs the dq and the dk/dv kernel."""

    @staticmethod
    def forward(ctx, q, k, v, tables, scale):
        o, lse = splash_attention_fwd(q, k, v, tables, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.tables, ctx.scale = tables, scale
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        g = g.to(q.dtype).contiguous()
        delta = attention_delta(o, g)  # rowsum(dO * O), [B, H, S]
        dq = splash_attention_bwd_dq(q, k, v, g, lse, delta, ctx.tables, ctx.scale)
        dk, dv = splash_attention_bwd_dkdv(q, k, v, g, lse, delta, ctx.tables, ctx.scale)
        return dq, dk, dv, None, None


@functools.lru_cache(maxsize=64)
def _cached_splash_fn(layout_bytes: bytes, layout_shape, block: int,
                      scale: float, device: str):
    """The block tables (host Python loop, then one copy to ``device``) and
    the differentiable function over them, cached per (layout, block,
    scale, device): eager loops must not rebuild them every call."""
    layout = np.frombuffer(layout_bytes, dtype=np.bool_).reshape(layout_shape)
    tables = SplashTables.build(layout, block, device)

    def f(q, k, v):
        return _Splash.apply(q, k, v, tables, scale)

    f.tables = tables
    return f


def splash_function(layout: np.ndarray, block: int, scale: float, device):
    """The cached differentiable K8 function of ``layout`` on ``device``
    (``_cached_splash_fn``): a caller that holds it skips the cache key,
    a copy and hash of the layout's bytes."""
    lay = np.ascontiguousarray(np.asarray(layout).astype(bool))
    return _cached_splash_fn(lay.tobytes(), lay.shape, int(block), float(scale),
                             str(device))


def splash_sparse_attention(q, k, v, layout: np.ndarray, block: int,
                            scale: Optional[float] = None):
    """Block-sparse attention through K8, differentiable through the
    sparse backward kernels (dq over the forward block table, dk/dv over
    the transposed table).

    q,k,v: [batch, heads, seq, head_dim]; layout: [heads or 1, nb, nb]
    static (a 1-head layout broadcasts over heads, dense-path parity).
    """
    B, H, S, D = q.shape
    layout_heads = np.shape(layout)[0]
    if S % block != 0:
        raise ValueError(f"seq {S} not divisible by block {block}")
    if H % layout_heads != 0:
        raise ValueError(f"q heads {H} not a multiple of layout heads {layout_heads}")
    scale = scale if scale is not None else 1.0 / float(np.sqrt(D))
    return splash_function(layout, block, scale, q.device)(q, k, v)


def splash_flops(layout: np.ndarray, block: int, head_dim: int,
                 batch: int = 1) -> dict:
    """Analytic fwd FLOP accounting: the kernel's work is structurally
    proportional to ACTIVE blocks (grid x per-tile matmuls), vs nb^2 for
    the dense-mask path — the reduction the reference's Triton SDD/DSD
    delivers."""
    layout = np.asarray(layout).astype(bool)
    H, nb, _ = layout.shape
    active = int(layout.sum())
    per_block = 4 * block * block * head_dim  # QK^T + PV
    return {
        "active_blocks": active,
        "total_blocks": H * nb * nb,
        "sparse_flops": batch * active * per_block,
        "dense_flops": batch * H * nb * nb * per_block,
        "reduction": 1.0 - active / (H * nb * nb),
    }
