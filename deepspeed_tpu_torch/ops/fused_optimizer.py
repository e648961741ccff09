"""Fused optimizer steps over flat buffers (port of
``deepspeed_tpu/ops/fused_optimizer.py``, K7: ``fused_adam_step :86``,
``fused_lion_step :126``, ``fused_lamb_step :165``).

Each function takes flat ``[N]`` buffers: params in any float dtype,
grads in any float dtype, moments fp32. The per-step scalars are tensors
in device memory, as the Pallas body takes ``lr_ref`` and ``step_ref``
(``:67-83``): ``lr`` a one-element fp32 learning rate, ``step`` a
one-element fp32 update count (1 for the first update) and ``skip`` a
one-element bool flag or None. A set flag means the step overflowed and
writes nothing: the buffers keep their bits (a zero learning rate would
not do: ``0 * inf`` is NaN, and the moments still move). So the engine
enqueues steps with no host read between them (``runtime/engine.py``).
``device_scalar`` makes such a tensor of a number once.

The functional forms keep the JAX signatures and defaults (LAMB's eps is
1e-6 there), take ``lr`` and ``step`` as numbers or tensors as the JAX
functions do, and return new ``(params, m[, v])``. Beside them, the
in-place forms the engine calls, which take the scalars as tensors only:
``adam_step_`` (with ``l2=True`` the weight decay goes into the gradient
before the moments, the engine's ``adam``), ``lion_step_`` and
``lamb_update_`` (LAMB's first pass; ``out`` may be the gradient buffer,
which is dead by then), and ``lamb_apply_trust_``, the per-segment trust
ratio and write that the JAX function computes outside Pallas
(``:199-219``).

The arithmetic is the Pallas body's, in the order it writes it: the bias
corrections are ``1 - exp(step * log b)`` in fp32 (``:75-76``; optax and
the jnp branch take ``1 - b**step``, which differs by ulps of ``b**step``:
at step 1 and b 0.999 that is ~6e-5 of ``bc2``), and every quotient
divides by a tensor (PyTorch's CUDA division by a Python scalar multiplies
by the reciprocal), so on the card a kernel equals its plain version to
the last bit of ``expf``. The in-place wrappers take the plain version
(``*_reference``, which takes the same tensors) for CPU tensors and launch
``csrc/fused_optimizer.cu`` for CUDA tensors or raise; each counts its
kernel launches in ``.launches``, a skipped step's launch included.
"""

import math
from typing import Optional, Sequence, Tuple

import torch

from . import _build

FLOAT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
ADAM_NO_DECAY, ADAM_DECOUPLED, ADAM_L2 = 0, 1, 2  # csrc/fused_optimizer.cu AdamMode


def device_scalar(x, device, dtype=torch.float32) -> torch.Tensor:
    """``x`` (a number or a one-element tensor) as a one-element tensor of
    ``dtype`` on ``device``. A number is written by a fill, not copied from
    the host."""
    if isinstance(x, torch.Tensor):
        return x.reshape(1).to(device=device, dtype=dtype)
    return torch.full((1, ), x, dtype=dtype, device=device)


def bias_correction(b: float, step, device) -> torch.Tensor:
    """``1 - exp(step * log b)`` in fp32 on ``device``, with ``log b``
    taken in double and rounded to fp32, as K7 computes it; ``step`` a
    number or a one-element tensor."""
    log_b = torch.full((1, ), math.log(b), dtype=torch.float32, device=device)
    return 1 - torch.exp(device_scalar(step, device) * log_b)


def _unless(skip, old, new):
    """``new``, or where the flag ``skip`` is set ``old`` (each a tuple of
    tensors, None for an output with no old value)."""
    if skip is None:
        return new
    return tuple(n if o is None else torch.where(skip, o, n) for o, n in zip(old, new))


def adam_update_reference(p, g, m, v, lr, step, b1=0.9, b2=0.999, eps=1e-8,
                          weight_decay=0.0, l2=False, skip=None):
    """Plain Adam/AdamW step (``:99-108``): new ``(p in p's dtype, m, v)``.
    ``l2``: ``g + wd * p`` before the moments and no decoupled decay."""
    pf, gf = p.float(), g.float()
    if weight_decay and l2:
        gf = gf + weight_decay * pf
    m_n = b1 * m + (1 - b1) * gf
    v_n = b2 * v + (1 - b2) * gf * gf
    bc1 = bias_correction(b1, step, m.device)
    bc2 = bias_correction(b2, step, m.device)
    upd = (m_n / bc1) / (torch.sqrt(v_n / bc2) + eps)
    if weight_decay and not l2:
        upd = upd + weight_decay * pf
    return _unless(skip, (p, m, v), ((pf - lr * upd).to(p.dtype), m_n, v_n))


def lion_update_reference(p, g, m, lr, b1=0.9, b2=0.99, weight_decay=0.0, skip=None):
    """Plain Lion step (``:140-145``): new ``(p in p's dtype, m)``."""
    pf, gf = p.float(), g.float()
    u = torch.sign(b1 * m + (1 - b1) * gf)
    if weight_decay:
        u = u + weight_decay * pf
    return _unless(skip, (p, m), ((pf - lr * u).to(p.dtype), b2 * m + (1 - b2) * gf))


def lamb_update_reference(g, m, v, step, b1=0.9, b2=0.999, eps=1e-6, skip=None,
                          out=None):
    """Plain LAMB first pass (``:191-197``): new ``(u, m, v)``, all fp32;
    under a set ``skip`` the old ``m``, ``v`` and ``out`` (where given)."""
    gf = g.float()
    m_n = b1 * m + (1 - b1) * gf
    v_n = b2 * v + (1 - b2) * gf * gf
    bc1 = bias_correction(b1, step, m.device)
    bc2 = bias_correction(b2, step, m.device)
    return _unless(skip, (out, m, v),
                   ((m_n / bc1) / (torch.sqrt(v_n / bc2) + eps), m_n, v_n))


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda(name, tensors, fp32):
    """``tensors``: the flat buffers of one call, ``fp32`` the ones that
    must be fp32 (moments, LAMB's u)."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    n = tensors[0].numel()
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: all buffers must be on one device")
        if t.dim() != 1 or t.numel() != n:
            raise ValueError(f"{name}: buffers must be flat [N] of one length, got "
                             f"{[tuple(x.shape) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: buffers must be contiguous")
        if t.dtype not in FLOAT_DTYPES:
            raise TypeError(f"{name}: the kernel takes float32, bfloat16 or "
                            f"float16, got {t.dtype}")
    for t in fp32:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: moments (and LAMB's u) must be float32, "
                            f"got {t.dtype}")
    return n


def _check_scalars(name, device, skip, **scalars):
    """The per-step scalars of one call: one-element tensors on the
    buffers' device, fp32 ``lr``/``step`` and a bool ``skip`` (or None)."""
    for key, t in dict(scalars, skip=skip).items():
        if t is None and key == "skip":
            continue
        dtype = torch.bool if key == "skip" else torch.float32
        if not isinstance(t, torch.Tensor) or t.dtype != dtype or t.numel() != 1:
            raise TypeError(f"{name}: {key} must be a one-element {dtype} tensor "
                            f"(device_scalar makes one), got {t!r}")
        if t.device != device:
            raise ValueError(f"{name}: {key} must be on the buffers' device {device}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def adam_step_(p, g, m, v, lr, step, b1=0.9, b2=0.999, eps=1e-8,
               weight_decay=0.0, l2=False, skip=None):
    """One Adam/AdamW step in place on flat ``p``, ``m``, ``v`` (kernel
    ``dstt_adam_step``); nothing moves where ``skip`` is set."""
    if p.device.type == "cpu":
        _check_scalars("adam_step_", p.device, skip, lr=lr, step=step)
        for t, new in zip((p, m, v), adam_update_reference(
                p, g, m, v, lr, step, b1, b2, eps, weight_decay, l2, skip)):
            t.copy_(new)
        return p, m, v
    n = _check_cuda("adam_step_", (p, g, m, v), (m, v))
    _check_scalars("adam_step_", p.device, skip, lr=lr, step=step)
    mode = ADAM_NO_DECAY if not weight_decay else ADAM_L2 if l2 else ADAM_DECOUPLED
    if n:
        with torch.cuda.device(p.device):
            err = _build.lib().dstt_adam_step(
                p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), n, lr.data_ptr(),
                step.data_ptr(), _ptr(skip), b1, 1 - b1, math.log(b1), b2, 1 - b2,
                math.log(b2), eps, float(weight_decay), mode, _build.dtype_code(p.dtype),
                _build.dtype_code(g.dtype), _stream(p))
        _build.check(err, "adam_step_")
        adam_step_.launches += 1
    return p, m, v


def lion_step_(p, g, m, lr, b1=0.9, b2=0.99, weight_decay=0.0, skip=None):
    """One Lion step in place on flat ``p``, ``m`` (kernel
    ``dstt_lion_step``); nothing moves where ``skip`` is set."""
    if p.device.type == "cpu":
        _check_scalars("lion_step_", p.device, skip, lr=lr)
        for t, new in zip((p, m), lion_update_reference(p, g, m, lr, b1, b2,
                                                         weight_decay, skip)):
            t.copy_(new)
        return p, m
    n = _check_cuda("lion_step_", (p, g, m), (m, ))
    _check_scalars("lion_step_", p.device, skip, lr=lr)
    mode = ADAM_DECOUPLED if weight_decay else ADAM_NO_DECAY
    if n:
        with torch.cuda.device(p.device):
            err = _build.lib().dstt_lion_step(
                p.data_ptr(), g.data_ptr(), m.data_ptr(), n, lr.data_ptr(), _ptr(skip),
                b1, 1 - b1, b2, 1 - b2, float(weight_decay), mode,
                _build.dtype_code(p.dtype), _build.dtype_code(g.dtype), _stream(p))
        _build.check(err, "lion_step_")
        lion_step_.launches += 1
    return p, m


def lamb_update_(g, m, v, step, b1=0.9, b2=0.999, eps=1e-6, out=None, skip=None):
    """LAMB's first pass in place on flat ``m``, ``v``; writes the update
    into ``out`` (fp32; may be ``g`` itself) or a new buffer, and returns
    it (kernel ``dstt_lamb_update``). Where ``skip`` is set nothing is
    written: ``m``, ``v`` and ``out`` keep their values."""
    if out is None:
        out = torch.empty(g.shape, dtype=torch.float32, device=g.device)
    if g.device.type == "cpu":
        _check_scalars("lamb_update_", g.device, skip, step=step)
        u, m_n, v_n = lamb_update_reference(g, m, v, step, b1, b2, eps, skip, out)
        for t, new in ((m, m_n), (v, v_n), (out, u)):
            t.copy_(new)
        return out
    n = _check_cuda("lamb_update_", (g, m, v, out), (m, v, out))
    _check_scalars("lamb_update_", g.device, skip, step=step)
    if n:
        with torch.cuda.device(g.device):
            err = _build.lib().dstt_lamb_update(
                g.data_ptr(), m.data_ptr(), v.data_ptr(), out.data_ptr(), n,
                step.data_ptr(), _ptr(skip), b1, 1 - b1, math.log(b1), b2, 1 - b2,
                math.log(b2), eps, _build.dtype_code(g.dtype), _stream(g))
        _build.check(err, "lamb_update_")
        lamb_update_.launches += 1
    return out


adam_step_.launches = 0
lion_step_.launches = 0
lamb_update_.launches = 0


def segment_bounds(segments: Optional[Sequence[int]], n: int):
    """JAX ``segments`` (boundary offsets ``(0, n1, ..., N)``; None or two
    entries: the whole buffer) as ``[(start, end), ...]``."""
    if segments is None or len(segments) <= 2:
        return [(0, n)]
    return list(zip(segments[:-1], segments[1:]))


def lamb_apply_trust_(p, u, lr, weight_decay, bounds, skip=None, norms=None):
    """The rest of the LAMB step (``:199-219``) in place, fp32 flat ``p``
    and ``u``: ``u += wd * p``; per segment the trust ratio ``||p|| /
    ||u||`` (1 where either norm is 0); ``p -= (lr * trust) * u``, with
    ``lr`` a one-element fp32 tensor. ``u`` ends scaled. Where ``skip`` is
    set, ``u`` ends zero and ``p`` keeps its bits. No temporary of the
    buffer's size. ``norms`` maps the segments' views to the norms the
    ratio takes (default: each segment's own; under ZeRO a segment is a
    piece of a parameter and ``norms`` gives the whole parameter's)."""
    ps = [p[a:b] for a, b in bounds]
    us = [u[a:b] for a, b in bounds]
    if weight_decay:
        torch._foreach_add_(us, ps, alpha=float(weight_decay))
    if norms is None:
        norms = lambda xs: torch.stack(torch._foreach_norm(xs))  # noqa: E731
    pn = norms(ps)
    un = norms(us)
    trust = torch.where((pn > 0) & (un > 0), pn / un.clamp_min(1e-30),
                        torch.ones_like(pn))
    torch._foreach_mul_(us, list((lr * trust).unbind()))
    if skip is not None:
        u.masked_fill_(skip, 0.0)
    p.sub_(u)
    return p


def fused_adam_step(params, grads, m, v, lr, step, b1: float = 0.9,
                    b2: float = 0.999, eps: float = 1e-8,
                    weight_decay: float = 0.0) -> Tuple[torch.Tensor, ...]:
    """One AdamW step over flat buffers ``[N]``. Returns new
    ``(params, m, v)``; ``step`` is the 1-based step count."""
    p, m_n, v_n = params.clone(), m.clone(), v.clone()
    dev = params.device
    return adam_step_(p, grads, m_n, v_n, device_scalar(lr, dev), device_scalar(step, dev),
                      b1, b2, eps, weight_decay)


def fused_lion_step(params, grads, m, lr, b1: float = 0.9, b2: float = 0.99,
                    weight_decay: float = 0.0) -> Tuple[torch.Tensor, ...]:
    """One Lion step over flat buffers ``[N]`` (optax.lion semantics).
    Returns new ``(params, m)``."""
    p, m_n = params.clone(), m.clone()
    return lion_step_(p, grads, m_n, device_scalar(lr, params.device), b1, b2, weight_decay)


def _lamb_step(pass_fn, params, grads, m, v, lr, step, b1, b2, eps, weight_decay,
               segments):
    dev = params.device
    u, m_n, v_n = pass_fn(grads, m, v, device_scalar(step, dev), b1, b2, eps)
    pf = params.float().clone()
    lamb_apply_trust_(pf, u, device_scalar(lr, dev), weight_decay,
                      segment_bounds(segments, pf.numel()))
    return pf.to(params.dtype), m_n, v_n


def _lamb_pass(g, m, v, step, b1, b2, eps):
    m_n, v_n = m.clone(), v.clone()
    return lamb_update_(g, m_n, v_n, step, b1, b2, eps), m_n, v_n


def fused_lamb_step(params, grads, m, v, lr, step, b1: float = 0.9,
                    b2: float = 0.999, eps: float = 1e-6, weight_decay: float = 0.0,
                    segments: Optional[Tuple[int, ...]] = None) -> Tuple[torch.Tensor, ...]:
    """One LAMB step over flat buffers ``[N]``: the first pass (K7), then
    the trust ratio per segment (``segments``: boundary offsets ``(0, n1,
    ..., N)``; default one segment). Returns new ``(params, m, v)``."""
    return _lamb_step(_lamb_pass, params, grads, m, v, lr, step, b1, b2, eps,
                      weight_decay, segments)


def fused_lamb_step_reference(params, grads, m, v, lr, step, b1=0.9, b2=0.999,
                              eps=1e-6, weight_decay=0.0, segments=None):
    """:func:`fused_lamb_step` with the plain first pass on any device."""
    return _lamb_step(lamb_update_reference, params, grads, m, v, lr, step, b1, b2,
                      eps, weight_decay, segments)
