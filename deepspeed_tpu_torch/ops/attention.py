"""Flash attention for training, forward and backward (port of
``deepspeed_tpu/ops/attention.py``: ``flash_attention :654`` with the
Pallas forward ``_fwd_kernel :88`` and backward ``_dq_kernel :273`` /
``_dkdv_kernel :350``).

Layout as in the JAX package: q ``[B, S, H, D]``, k/v ``[B, S, KV, D]``,
``H = KV * G`` with query head ``kv * G + g`` reading KV head ``kv`` (GQA
native). ``lse`` is ``[B, S, H]`` fp32 (the JAX package's natural layout
without its unit lane dim), ``LSE_MASKED`` for a row that sees no key.

``flash_attention`` is an ``autograd.Function``: its forward launches K1
(``flash_attention_fwd``) and saves ``(q, k, v, o, lse)``; its backward
computes ``delta = rowsum(dO * O)`` in fp32 with plain PyTorch (outside
the kernels, as ``_flash_bwd :450`` does) and launches the two K2 passes
(``flash_attention_bwd_dq``, ``flash_attention_bwd_dkdv``). Each wrapper
takes its plain version for a CPU tensor and launches its kernel in
``csrc/flash_attention.cu`` for a CUDA tensor or raises; each counts its
launches in ``.launches``. The plain versions recompute the softmax from
``lse`` as the kernels do, so the backward the CPU tests check is K2's
function, not autograd through a dense softmax.

This slice takes the Llama options: causal or not, GQA, ``scale``, and
any sequence length (the kernels mask the ragged end of their last tile).
``window`` and ``softcap`` raise ``NotImplementedError``.
"""

from typing import Optional

import torch

from . import _build

LSE_MASKED = 1e30  # rows that saw no key: exp(s - LSE_MASKED) == 0


def _check_options(window, softcap):
    unsupported = [name for name, val in (("window", window),
                                          ("softcap", softcap))
                   if val is not None]
    if unsupported:
        raise NotImplementedError(
            f"flash_attention: option(s) {unsupported} are not ported yet")


def _scale(q, scale):
    return float(scale) if scale is not None else 1.0 / q.shape[-1] ** 0.5


def _grouped(x, kv):
    """[B, S, KV*G, D] -> [B, S, KV, G, D] fp32."""
    B, S, H, D = x.shape
    return x.float().reshape(B, S, kv, H // kv, D)


def _scores(q, k, causal, scale):
    """fp32 scores ``[B, KV, G, Sq, Sk]`` and the visibility mask
    ``[Sq, Sk]`` (None when every pair is visible)."""
    s = torch.einsum("bqkgd,bskd->bkgqs", _grouped(q, k.shape[2]),
                     k.float()) * scale
    if not causal:
        return s, None
    n = q.shape[1]
    mask = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
    return s, mask


def flash_attention_fwd_reference(q, k, v, causal: bool = False,
                                  scale: Optional[float] = None):
    """Plain forward (``_xla_attention_lse :506``): fp32 scores, masked
    softmax, P cast to v's dtype before the PV product. Returns
    ``(o [B, S, H, D] in q's dtype, lse [B, S, H] fp32)``; a row that sees
    no key gives 0 and ``LSE_MASKED``."""
    B, S, H, D = q.shape
    s, mask = _scores(q, k, causal, _scale(q, scale))
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(-1, keepdim=True)
    m_safe = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m_safe)
    l = p.sum(-1, keepdim=True)
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.einsum("bkgqs,bskd->bqkgd", (p / safe_l).to(v.dtype).float(),
                     v.float())
    lse = torch.where(l == 0, torch.full_like(l, LSE_MASKED),
                      m_safe + torch.log(safe_l))
    lse = lse[..., 0].permute(0, 3, 1, 2).reshape(B, S, H)
    return o.reshape(B, S, H, D).to(q.dtype), lse.contiguous()


def _probs(q, k, lse, causal, scale):
    """P = exp(s - lse) rebuilt from the saved lse, 0 where masked, as
    ``[B, KV, G, Sq, Sk]`` fp32."""
    B, S, H, _ = q.shape
    KV = k.shape[2]
    s, mask = _scores(q, k, causal, scale)
    lse_g = lse.float().reshape(B, S, KV, H // KV).permute(0, 2, 3, 1)
    p = torch.exp(s - lse_g[..., None])
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    return p


def _delta_g(delta, kv):
    """[B, S, H] -> [B, KV, G, S, 1] fp32."""
    B, S, H = delta.shape
    return delta.float().reshape(B, S, kv, H // kv).permute(0, 2, 3, 1)[..., None]


def flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, causal, scale):
    """Plain dq pass: dS = P * (dP - delta) * scale, rounded to k's dtype
    for the dS K product (``_dq_kernel``)."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    p = _probs(q, k, lse, causal, scale)
    dp = torch.einsum("bqkgd,bskd->bkgqs", _grouped(do, KV), v.float())
    ds = p * (dp - _delta_g(delta, KV)) * scale
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds.to(k.dtype).float(), k.float())
    return dq.reshape(B, S, H, D).to(q.dtype)


def flash_attention_bwd_dkdv_reference(q, k, v, do, lse, delta, causal, scale):
    """Plain dk/dv pass: dv = P^T dO (P rounded to dO's dtype), dk = dS^T q
    (dS rounded to q's dtype), both summed over the G query heads of each
    KV head (``_dkdv_kernel``)."""
    KV = k.shape[2]
    p = _probs(q, k, lse, causal, scale)
    dp = torch.einsum("bqkgd,bskd->bkgqs", _grouped(do, KV), v.float())
    ds = p * (dp - _delta_g(delta, KV)) * scale
    dv = torch.einsum("bkgqs,bqkgd->bskd", p.to(do.dtype).float(),
                      _grouped(do, KV))
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds.to(q.dtype).float(),
                      _grouped(q, KV))
    return dk.to(k.dtype), dv.to(v.dtype)


def attention_delta(o, do):
    """delta = rowsum(dO * O) in fp32, ``[B, S, H]``."""
    return (do.float() * o.float()).sum(-1)


def flash_attention_bwd_reference(q, k, v, o, lse, do, causal: bool = False,
                                  scale: Optional[float] = None):
    """Plain backward of the flash forward: ``(dq, dk, dv)`` from the
    saved ``o`` and ``lse``, P recomputed from ``lse`` as K2 does."""
    scale = _scale(q, scale)
    delta = attention_delta(o, do)
    dq = flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, causal, scale)
    dk, dv = flash_attention_bwd_dkdv_reference(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


def _check_cuda(name, tensors, q, k):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    B, S, H, D = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[1] != S or k.shape[3] != D \
            or H % k.shape[2]:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)} are not [B, S, H, D] / "
                         "[B, S, KV, D] with KV dividing H")
    if D > 128 or D % 8:
        raise ValueError(f"{name}: the kernel takes head_dim <= 128 and a "
                         f"multiple of 8, got {D}")
    if q.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"{name}: the kernel takes float32, bfloat16 or float16, "
                        f"got {q.dtype}")
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"{name}: all inputs must be on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")
    for t in tensors[:4]:  # q, k, v and dO (or o) share q's dtype
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: q, k, v and dO must share one dtype")


def _launch(name, fn, q, k, *ptrs, causal, scale):
    B, S, H, D = q.shape
    with torch.cuda.device(q.device):
        err = fn(*ptrs, B, S, H, k.shape[2], D, float(scale), int(bool(causal)),
                 _build.dtype_code(q.dtype),
                 torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, name)


def flash_attention_fwd(q, k, v, causal: bool = False,
                        scale: Optional[float] = None):
    """K1: ``(o, lse)`` of the flash forward (kernel ``dstt_flash_fwd``)."""
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, causal, scale)
    _check_cuda("flash_attention_fwd", (q, k, v), q, k)
    if v.shape != k.shape:
        raise ValueError("flash_attention_fwd: k and v shapes differ")
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch("flash_attention_fwd", _build.lib().dstt_flash_fwd, q, k,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), causal=causal, scale=_scale(q, scale))
    flash_attention_fwd.launches += 1
    return o, lse


def _check_residuals(name, q, lse, delta):
    for n, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != tuple(q.shape[:3]):
            raise ValueError(f"{name}: {n} must be float32 {tuple(q.shape[:3])},"
                             f" got {t.dtype} {tuple(t.shape)}")


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal: bool = False,
                           scale: Optional[float] = None):
    """K2, dq pass (kernel ``dstt_flash_bwd_dq``)."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, causal, scale)
    _check_cuda("flash_attention_bwd_dq", (q, k, v, do, lse, delta), q, k)
    _check_residuals("flash_attention_bwd_dq", q, lse, delta)
    dq = torch.empty_like(q)
    _launch("flash_attention_bwd_dq", _build.lib().dstt_flash_bwd_dq, q, k,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            causal=causal, scale=scale)
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkdv(q, k, v, do, lse, delta, causal: bool = False,
                             scale: Optional[float] = None):
    """K2, dk/dv pass (kernel ``dstt_flash_bwd_dkdv``)."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_dkdv_reference(q, k, v, do, lse, delta, causal,
                                         scale)
    _check_cuda("flash_attention_bwd_dkdv", (q, k, v, do, lse, delta), q, k)
    _check_residuals("flash_attention_bwd_dkdv", q, lse, delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("flash_attention_bwd_dkdv", _build.lib().dstt_flash_bwd_dkdv, q, k,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            causal=causal, scale=scale)
    flash_attention_bwd_dkdv.launches += 1
    return dk, dv


flash_attention_fwd.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkdv.launches = 0


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = attention_delta(o, do)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, ctx.causal,
                                    ctx.scale)
        dk, dv = flash_attention_bwd_dkdv(q, k, v, do, lse, delta, ctx.causal,
                                          ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None):
    """Blocked attention, q ``[B, S, H, D]``, k/v ``[B, S, KV, D]`` (GQA
    native), differentiable in q, k and v. ``scale`` defaults to
    ``1/sqrt(D)``. Returns ``[B, S, H, D]`` in q's dtype."""
    _check_options(window, softcap)
    if k.shape != v.shape or q.shape[:2] != k.shape[:2] \
            or q.shape[3] != k.shape[3] or q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: expected "
                         "[B, S, H, D] and [B, S, KV, D] with KV dividing H")
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), bool(causal), scale)
