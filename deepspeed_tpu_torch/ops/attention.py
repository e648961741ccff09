"""Flash attention for training, forward and backward, and the route that
picks its kernels (port of ``deepspeed_tpu/ops/attention.py``:
``flash_attention :654`` with the Pallas forward ``_fwd_kernel :88`` and
backward ``_dq_kernel :273`` / ``_dkdv_kernel :350``, and the dispatch
``_run_fwd :576``, ``_bwd_lse_layout :608`` and ``_dispatched_attention
:614``; ``_fit_blocks :554`` has no counterpart, since the kernels run one
tile and mask a ragged last one).

Layout as in the JAX package: q ``[B, S, H, D]``, k/v ``[B, S, KV, D]``,
``H = KV * G`` with query head ``kv * G + g`` reading KV head ``kv`` (GQA
native). ``lse`` is ``[B, S, H]`` fp32 (the JAX package's natural layout
without its unit lane dim), ``LSE_MASKED`` for a row that sees no key.
Mask options as in the JAX kernels: ``causal``; ``window``, which drops
keys with ``q_pos - k_pos >= window``; ``softcap``, which takes the scaled
scores to ``softcap * tanh(s / softcap)`` before any mask.

K1 (``flash_attention_fwd``) and the two K2 passes
(``flash_attention_bwd_dq``, ``flash_attention_bwd_dkdv``) each take their
plain version for a CPU tensor and launch their kernel in
``csrc/flash_attention.cu`` for a CUDA tensor or raise; each counts its
launches in ``.launches``. ``kernel_wrappers`` builds them, and K3's.
The plain versions recompute the softmax from ``lse`` as the kernels do,
so the backward the CPU tests check is K2's function, not autograd
through a dense softmax. They compute in fp32, or in fp64 for fp64
inputs (the exact value of the same function), in chunks of query rows
against only the keys those rows can see, so a long sequence never holds
its whole ``[S, S]`` score matrix.

``flash_attention`` is the route: ``ops/kernel_dispatch.py`` resolves the
forward and the backward leg separately to ``xla`` (the plain attention,
``attention_reference``, with autograd for its backward), ``pallas``
(K1/K2) or ``folded`` (K3, ``ops/attention_folded.py``), and one
``torch.autograd.Function`` runs the two legs. Every kernel leg keeps and
takes ``lse`` in the natural ``[B, S, H]`` layout, so the JAX package's
per-head/natural conversions between the legs have no counterpart here.
"""

from typing import Optional

import torch

from . import _build
from . import kernel_dispatch as kd

LSE_MASKED = 1e30  # rows that saw no key: exp(s - LSE_MASKED) == 0

# the plain versions score at most this many (batch, head, query, key)
# pairs at a time: 1 GiB of fp32 per score-shaped temporary
CHUNK_PAIRS = 1 << 28


def _check_options(window, softcap):
    """``window`` a positive int and ``softcap`` a positive float, or None."""
    if window is not None and (isinstance(window, bool) or int(window) != window
                               or window < 1):
        raise ValueError(f"flash_attention: window must be a positive int, got {window!r}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention: softcap must be positive, got {softcap!r}")


def _scale(q, scale):
    return float(scale) if scale is not None else 1.0 / q.shape[-1] ** 0.5


def _wide(x):
    """x in fp32, the plain versions' compute type; fp64 stays fp64, so an
    fp64 call gives the exact value of the same function."""
    return x if x.dtype == torch.float64 else x.float()


def _grouped(x, kv):
    """[B, S, KV*G, D] -> [B, S, KV, G, D] in the compute type."""
    B, S, H, D = x.shape
    return _wide(x).reshape(B, S, kv, H // kv, D)


def _chunks(q, causal, window):
    """Query-row ranges ``[r0, r1)`` with the key range ``[c0, c1)`` those
    rows can see: keys after the last row are hidden under causal, keys at
    or before ``r0 - window`` by the window. One range when the whole
    score matrix fits ``CHUNK_PAIRS``."""
    B, S, H, _ = q.shape
    step = max(1, CHUNK_PAIRS // (B * H * S))
    for r0 in range(0, S, step):
        r1 = min(S, r0 + step)
        c0 = max(0, r0 - window + 1) if window is not None else 0
        yield r0, r1, c0, r1 if causal else S


def _scores(q, k, scale, causal, window, softcap, r0, r1, c0, c1):
    """Scores ``[B, KV, G, r1-r0, c1-c0]`` (compute type) of query rows r0:r1 against
    keys c0:c1 after the scale and the softcap, the softcap's tanh (None
    without one) and the visibility mask ``[rows, keys]`` (None when every
    pair is visible)."""
    s = torch.einsum("bqkgd,bskd->bkgqs", _grouped(q[:, r0:r1], k.shape[2]),
                     _wide(k[:, c0:c1])) * scale
    t = None
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s = softcap * t
    if not causal and window is None:
        return s, t, None
    qpos = torch.arange(r0, r1, device=q.device)[:, None]
    kpos = torch.arange(c0, c1, device=q.device)[None, :]
    mask = torch.ones(r1 - r0, c1 - c0, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= qpos - kpos < window
    return s, t, mask


def flash_attention_fwd_reference(q, k, v, causal: bool = False,
                                  scale: Optional[float] = None,
                                  window: Optional[int] = None,
                                  softcap: Optional[float] = None):
    """Plain forward (``_xla_attention_lse :506``): fp32 scores, masked
    softmax, P cast to v's dtype before the PV product. Returns
    ``(o [B, S, H, D] in q's dtype, lse [B, S, H] fp32)``; a row that sees
    no key gives 0 and ``LSE_MASKED``."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    scale = _scale(q, scale)
    o = torch.empty_like(q)
    lse = torch.empty(B, S, H, dtype=_wide(q[:0]).dtype, device=q.device)
    for r0, r1, c0, c1 in _chunks(q, causal, window):
        s, _, mask = _scores(q, k, scale, causal, window, softcap, r0, r1, c0, c1)
        if mask is not None:
            s = s.masked_fill(~mask, float("-inf"))
        m = s.amax(-1, keepdim=True)
        m_safe = torch.where(torch.isinf(m), torch.zeros_like(m), m)
        p = torch.exp(s - m_safe)
        l = p.sum(-1, keepdim=True)
        safe_l = torch.where(l == 0, torch.ones_like(l), l)
        oc = torch.einsum("bkgqs,bskd->bqkgd", _wide((p / safe_l).to(v.dtype)),
                          _wide(v[:, c0:c1]))
        o[:, r0:r1] = oc.reshape(B, r1 - r0, H, D).to(q.dtype)
        lc = torch.where(l == 0, torch.full_like(l, LSE_MASKED),
                         m_safe + torch.log(safe_l))
        lse[:, r0:r1] = lc[..., 0].permute(0, 3, 1, 2).reshape(B, r1 - r0, H)
    return o, lse


def _probs(q, k, lse, scale, causal, window, softcap, r0, r1, c0, c1):
    """P = exp(s - lse) rebuilt from the saved lse, 0 where masked, as
    ``[B, KV, G, rows, keys]`` fp32, and the softcap's tanh."""
    B, _, H, _ = q.shape
    KV = k.shape[2]
    s, t, mask = _scores(q, k, scale, causal, window, softcap, r0, r1, c0, c1)
    lse_g = _wide(lse[:, r0:r1]).reshape(B, r1 - r0, KV, H // KV).permute(0, 2, 3, 1)
    p = torch.exp(s - lse_g[..., None])
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    return p, t


def _delta_g(delta, kv, r0, r1):
    """rows r0:r1 of [B, S, H] -> [B, KV, G, rows, 1] fp32."""
    B, _, H = delta.shape
    d = _wide(delta[:, r0:r1]).reshape(B, r1 - r0, kv, H // kv)
    return d.permute(0, 2, 3, 1)[..., None]


def _dscores(q, k, v, do, lse, delta, scale, causal, window, softcap, r0, r1, c0, c1):
    """P and dS = P * (dP - delta) * scale (times 1 - t^2 under softcap)
    of one chunk, ``[B, KV, G, rows, keys]`` fp32."""
    KV = k.shape[2]
    p, t = _probs(q, k, lse, scale, causal, window, softcap, r0, r1, c0, c1)
    dp = torch.einsum("bqkgd,bskd->bkgqs", _grouped(do[:, r0:r1], KV),
                      _wide(v[:, c0:c1]))
    ds = p * (dp - _delta_g(delta, KV, r0, r1)) * scale
    if t is not None:  # d/ds of cap * tanh(s / cap) is 1 - t^2
        ds = ds * (1.0 - t * t)
    return p, ds


def flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, causal, scale,
                                     window=None, softcap=None):
    """Plain dq pass: dS rounded to k's dtype for the dS K product
    (``_dq_kernel``)."""
    B, S, H, D = q.shape
    dq = torch.empty_like(q)
    for r0, r1, c0, c1 in _chunks(q, causal, window):
        _, ds = _dscores(q, k, v, do, lse, delta, scale, causal, window, softcap,
                         r0, r1, c0, c1)
        dqc = torch.einsum("bkgqs,bskd->bqkgd", _wide(ds.to(k.dtype)),
                           _wide(k[:, c0:c1]))
        dq[:, r0:r1] = dqc.reshape(B, r1 - r0, H, D).to(q.dtype)
    return dq


def flash_attention_bwd_dkdv_reference(q, k, v, do, lse, delta, causal, scale,
                                       window=None, softcap=None):
    """Plain dk/dv pass: dv = P^T dO (P rounded to dO's dtype), dk = dS^T q
    (dS rounded to q's dtype), both summed over the G query heads of each
    KV head (``_dkdv_kernel``) and, in the compute type, over the chunks."""
    KV = k.shape[2]
    dk = torch.zeros(k.shape, dtype=_wide(k[:0]).dtype, device=k.device)
    dv = torch.zeros(v.shape, dtype=_wide(v[:0]).dtype, device=v.device)
    for r0, r1, c0, c1 in _chunks(q, causal, window):
        p, ds = _dscores(q, k, v, do, lse, delta, scale, causal, window, softcap,
                         r0, r1, c0, c1)
        dv[:, c0:c1] += torch.einsum("bkgqs,bqkgd->bskd", _wide(p.to(do.dtype)),
                                     _grouped(do[:, r0:r1], KV))
        dk[:, c0:c1] += torch.einsum("bkgqs,bqkgd->bskd", _wide(ds.to(q.dtype)),
                                     _grouped(q[:, r0:r1], KV))
    return dk.to(k.dtype), dv.to(v.dtype)


def attention_delta(o, do):
    """delta = rowsum(dO * O) in fp32 (fp64 for fp64 inputs), ``[B, S, H]``."""
    return (_wide(do) * _wide(o)).sum(-1)


def flash_attention_bwd_reference(q, k, v, o, lse, do, causal: bool = False,
                                  scale: Optional[float] = None,
                                  window: Optional[int] = None,
                                  softcap: Optional[float] = None):
    """Plain backward of the flash forward: ``(dq, dk, dv)`` from the
    saved ``o`` and ``lse``, P recomputed from ``lse`` as K2 does."""
    scale = _scale(q, scale)
    delta = attention_delta(o, do)
    args = (q, k, v, do, lse, delta, causal, scale, window, softcap)
    dq = flash_attention_bwd_dq_reference(*args)
    dk, dv = flash_attention_bwd_dkdv_reference(*args)
    return dq, dk, dv


def attention_reference(q, k, v, causal: bool = False,
                        scale: Optional[float] = None,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None):
    """The route's ``xla`` leg (``_xla_attention :53``): fp32 scores of the
    whole sequence, materialised, the masked softmax, P in v's dtype for
    the PV product; differentiable by autograd, which is its backward."""
    B, S, H, D = q.shape
    s, _, mask = _scores(q, k, _scale(q, scale), causal, window, softcap, 0, S, 0, S)
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, -1)
    o = torch.einsum("bkgqs,bskd->bqkgd", _wide(p.to(v.dtype)), _wide(v))
    return o.reshape(B, S, H, D).to(q.dtype)


def _check_cuda(name, tensors, q, k):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    B, S, H, D = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[1] != S or k.shape[3] != D \
            or H % k.shape[2]:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)} are not [B, S, H, D] / "
                         "[B, S, KV, D] with KV dividing H")
    if D > 256 or D % 8:
        raise ValueError(f"{name}: the kernel takes head_dim <= 256 and a "
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


def _check_residuals(name, q, lse, delta):
    for n, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != tuple(q.shape[:3]):
            raise ValueError(f"{name}: {n} must be float32 {tuple(q.shape[:3])},"
                             f" got {t.dtype} {tuple(t.shape)}")


def launch(name, fn, q, k, *ptrs, causal, scale, window, softcap):
    """Call kernel entry point ``fn`` (K1/K2 or K3) on q's stream: the
    pointers, then the shape and the mask options (a window no shorter
    than the sequence masks nothing and goes as S)."""
    B, S, H, D = q.shape
    with torch.cuda.device(q.device):
        err = fn(*ptrs, B, S, H, k.shape[2], D, float(scale), int(bool(causal)),
                 min(int(window), S) if window is not None else 0,
                 float(softcap) if softcap is not None else 0.0,
                 _build.dtype_code(q.dtype),
                 torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, name)


def kernel_wrappers(prefix: str, symbol: str, scope: dict, label: str):
    """The three kernel wrappers of one flash layout: ``{prefix}_fwd``,
    ``{prefix}_bwd_dq`` and ``{prefix}_bwd_dkdv``, launching the entry points
    ``{symbol}_fwd``, ``{symbol}_bwd_dq`` and ``{symbol}_bwd_dkdv``. Each
    runs its plain version ``scope[name + "_reference"]`` (read at the call)
    for a CPU tensor and launches its kernel for a CUDA tensor or raises;
    each counts its own launches in ``.launches``."""

    def fwd(q, k, v, causal: bool = False, scale: Optional[float] = None,
            window: Optional[int] = None, softcap: Optional[float] = None):
        name = fwd.__name__
        _check_options(window, softcap)
        if q.device.type == "cpu":
            return scope[name + "_reference"](q, k, v, causal, scale, window, softcap)
        _check_cuda(name, (q, k, v), q, k)
        if v.shape != k.shape:
            raise ValueError(f"{name}: k and v shapes differ")
        o = torch.empty_like(q)
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        launch(name, getattr(_build.lib(), f"{symbol}_fwd"), q, k,
               q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
               lse.data_ptr(), causal=causal, scale=_scale(q, scale),
               window=window, softcap=softcap)
        fwd.launches += 1
        return o, lse

    def bwd(part, grads_of):
        def run(q, k, v, do, lse, delta, causal: bool = False,
                scale: Optional[float] = None, window: Optional[int] = None,
                softcap: Optional[float] = None):
            name = run.__name__
            _check_options(window, softcap)
            scale = _scale(q, scale)
            if q.device.type == "cpu":
                return scope[name + "_reference"](q, k, v, do, lse, delta, causal,
                                                  scale, window, softcap)
            _check_cuda(name, (q, k, v, do, lse, delta), q, k)
            _check_residuals(name, q, lse, delta)
            grads = [torch.empty_like(t) for t in grads_of(q, k, v)]
            launch(name, getattr(_build.lib(), f"{symbol}_bwd_{part}"), q, k,
                   q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                   lse.data_ptr(), delta.data_ptr(), *(g.data_ptr() for g in grads),
                   causal=causal, scale=scale, window=window, softcap=softcap)
            run.launches += 1
            return grads[0] if len(grads) == 1 else tuple(grads)
        return run

    wrappers = (fwd, bwd("dq", lambda q, k, v: (q, )), bwd("dkdv", lambda q, k, v: (k, v)))
    for fn, part, does in zip(wrappers, ("fwd", "bwd_dq", "bwd_dkdv"),
                              ("forward: ``(o, lse)``", "dq pass", "dk/dv pass")):
        fn.__name__ = fn.__qualname__ = f"{prefix}_{part}"
        fn.__doc__ = f"{label} {does} (kernel ``{symbol}_{part}``)."
        fn.launches = 0
    return wrappers


flash_attention_fwd, flash_attention_bwd_dq, flash_attention_bwd_dkdv = kernel_wrappers(
    "flash_attention", "dstt_flash", globals(), "K1/K2")


def kernel_backward(dq_fn, dkdv_fn, q, k, v, o, lse, do, causal, scale, window,
                    softcap):
    """``(dq, dk, dv)`` through one layout's two backward passes, after
    delta = rowsum(dO * O) in fp32."""
    delta = attention_delta(o, do)
    args = (q, k, v, do, lse, delta, causal, scale, window, softcap)
    return (dq_fn(*args), *dkdv_fn(*args))


def _kernels(impl):
    """The wrapper triple (fwd, dq, dkdv) of a kernel leg: K1/K2 for
    ``pallas``, K3 for ``folded``."""
    if impl == kd.IMPL_FOLDED:
        from . import attention_folded as ff
        return ff.folded_attention_fwd, ff.folded_attention_bwd_dq, ff.folded_attention_bwd_dkdv
    return flash_attention_fwd, flash_attention_bwd_dq, flash_attention_bwd_dkdv


def _bwd_lse_layout(bwd_dec):
    """What the backward leg takes of the forward: nothing for ``xla``
    (autograd recomputes), else lse in the natural ``[B, S, H]`` layout,
    which K1 and K3 both write (the JAX package's per-head K1 layout has
    no counterpart)."""
    return None if bwd_dec.impl == kd.IMPL_XLA else "natural"


def _run_fwd(q, k, v, scale, causal, window, softcap, dec, lse_layout):
    """One forward leg per its Decision: ``(o, lse)``, lse None when the
    backward leg does not take it."""
    if dec.impl == kd.IMPL_XLA:
        if lse_layout is None:
            return attention_reference(q, k, v, causal, scale, window, softcap), None
        return flash_attention_fwd_reference(q, k, v, causal, scale, window, softcap)
    o, lse = _kernels(dec.impl)[0](q, k, v, causal, scale, window, softcap)
    return o, (lse if lse_layout is not None else None)


class _DispatchedAttention(torch.autograd.Function):
    """Attention whose forward and backward legs follow two Decisions
    (``_dispatched_attention``'s custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, softcap, fwd_dec, bwd_dec):
        o, lse = _run_fwd(q, k, v, scale, causal, window, softcap, fwd_dec,
                          _bwd_lse_layout(bwd_dec))
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = (scale, causal, window, softcap, bwd_dec)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        scale, causal, window, softcap, dec = ctx.opts
        do = do.contiguous()
        if dec.impl == kd.IMPL_XLA:
            # differentiate the plain attention (the JAX rule's jax.vjp)
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                out = attention_reference(*leaves, causal, scale, window, softcap)
                dq, dk, dv = torch.autograd.grad(out, leaves, do)
        else:
            dq, dk, dv = kernel_backward(*_kernels(dec.impl)[1:], q, k, v, o, lse, do,
                                         causal, scale, window, softcap)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    force_pallas: Optional[bool] = None,
                    impl_fwd: Optional[str] = None,
                    impl_bwd: Optional[str] = None):
    """Blocked attention, q ``[B, S, H, D]``, k/v ``[B, S, KV, D]`` (GQA
    native), differentiable in q, k and v. ``scale`` defaults to
    ``1/sqrt(D)``. Returns ``[B, S, H, D]`` in q's dtype.

    The forward and backward implementations are picked independently by
    ``ops/kernel_dispatch.py`` for this shape and q's device kind:
    ``impl_fwd``/``impl_bwd`` (``xla`` | ``pallas`` | ``folded``) pin a
    leg, ``block_q``/``block_k`` pin the Decision's blocks (recorded: the
    kernels run one tile); then the env, the measured autotune cache and
    the heuristic decide. On a CUDA tensor the cache and the heuristic
    pick only the kernels, so the plain attention runs there only where
    the caller pinned it. ``force_pallas=True`` keeps both legs on the
    kernels (an ``xla`` pick becomes ``pallas``); ``force_pallas=False``
    runs the plain attention with autograd, as the JAX package does off the
    TPU. On a CPU tensor the kernel legs run their plain versions."""
    if k.shape != v.shape or q.shape[:2] != k.shape[:2] \
            or q.shape[3] != k.shape[3] or q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: expected "
                         "[B, S, H, D] and [B, S, KV, D] with KV dividing H")
    _check_options(window, softcap)
    scale = _scale(q, scale)
    if force_pallas is False:
        return attention_reference(q, k, v, causal, scale, window, softcap)
    sig = kd.make_sig(q.shape, k.shape[2], k.shape[1], q.dtype, causal,
                      window, softcap)
    blocks = ((block_q, block_k)
              if block_q is not None and block_k is not None else None)
    fwd_dec, bwd_dec = kd.resolve(
        sig, kd.device_kind(q.device), impl_fwd=impl_fwd, impl_bwd=impl_bwd,
        blocks=blocks, pallas_only=bool(force_pallas) and impl_fwd is None
        and impl_bwd is None)
    return _DispatchedAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                      scale, bool(causal), window, softcap,
                                      fwd_dec, bwd_dec)
