"""1-bit Adam, 0/1 Adam and 1-bit LAMB over flat fp32 buffers (port of
``deepspeed_tpu/runtime/onebit.py``; reference
``runtime/fp16/onebit/{adam,zoadam,lamb}.py``).

Each is a ``FlatOptimizer`` whose state is flat fp32 buffers (``mu``,
``nu`` and for 1-bit Adam and LAMB ``error``) beside the update count on
the device. The optax chain of the JAX package is kept in order: the core
update, then ``+ wd * p`` (decoupled), then ``p -= lr * u``.

- **1-bit Adam.** Up to ``freeze_step`` updates: exact Adam, one K7 pass
  (AdamW's, ``ops/fused_optimizer.py``). After: the variance is frozen and
  the momentum ``mu = b1 mu + (1 - b1) g`` is sign-compressed with error
  feedback: ``c = mu + error``, ``mu = sign(c) * mean|c|`` (``>= 0`` maps to
  +1), ``error = c - mu``, and the update ``(mu / bc1) / (sqrt(nu / bc2) +
  eps)``. The scale is per parameter over the whole parameter: where a
  rank holds pieces of a parameter (ZeRO stages 1-3) the pieces' sums of
  ``|c|`` are all-reduced over the ZeRO group first (``sums``, as the
  engine sums norms). With ``exchange`` set (the post-warmup wire,
  ``runtime/onebit_wire.py``) the compression is the compressed allreduce
  of each parameter's momentum over the ranks instead.
- **0/1 Adam.** The variance moves at the updates where ``count %
  var_update_scaler == 0`` or ``count <= var_freeze_step`` (K7's Adam
  pass), and stays at the others; the momentum is never compressed.
- **1-bit LAMB.** 1-bit Adam's update, then per parameter the trust ratio
  ``||p|| / ||u||`` (1 where either is 0), clamped to ``[min_coeff,
  max_coeff]``, before the weight decay is added. Its warmup runs K7's
  LAMB first pass.

Which phase a step is in is decided on the host from the update count (a
host read of the device count while an fp16 step is unsettled). The steps
after the freeze are plain PyTorch: the JAX package has no Pallas kernel
for them. The bias corrections are K7's ``1 - exp(step * log b)``, where
optax takes ``1 - b**step`` (ulps apart).
"""

import torch

from ..ops.fused_optimizer import adam_step_, bias_correction, lamb_update_
from ..comm.compressed import spans
from .optimizers import FlatOptimizer, _keep_unless, chunked, decay_and_step_

ONEBIT_DEFAULT_FREEZE_STEP = 100000


class _OneBitBase(FlatOptimizer):
    """The state and the frozen-variance step shared by the three. The
    steps after the freeze go one parameter's piece at a time, the update
    written over the gradient buffer, so no temporary is larger than a
    piece."""

    def __init__(self, params, bounds, lr, lr_fn, betas, eps, weight_decay):
        super().__init__(params, bounds, lr, lr_fn)
        self.betas, self.eps, self.weight_decay = tuple(betas), float(eps), float(weight_decay)
        self.state = {"mu": self._zeros(), "nu": self._zeros()}
        self.exchange = None  # the wire's exchange_signs over the data-parallel group
        self._numel_t = None

    def _next_count(self) -> int:
        """The count of the update about to run (1 for the first)."""
        return self.count + 1

    def _views(self, flat):
        return [flat[a:b] for a, b in self.bounds]

    def _chunks(self, *flats):
        """The bounds' chunks (``optimizers.chunked``) of each of ``flats``."""
        return zip(*[[f[a:b] for a, b in chunked(self.bounds)] for f in flats])

    def _compressed(self, corrected):
        """Per piece of ``corrected`` (the momentum plus the residual), a
        ``SignLeaf``-like ``part(a, b)``: the momentum the update uses and
        this rank's compressed momentum of elements ``[a, b)``. Each
        parameter's scale is its whole mean |x|."""
        if self.exchange is not None:
            return self.exchange(corrected)
        if self._numel_t is None:
            n = ([self.whole_numels[i] for i in self.owners] if self.whole_numels
                 else [b - a for a, b in self.bounds])
            self._numel_t = torch.tensor(n, dtype=torch.float32).to(self.params.device)
        l1 = torch.stack(torch._foreach_norm(corrected, 1))
        scale = (self.sums(l1) if self.sums is not None else l1) / self._numel_t
        return [_LocalSign(c, s) for c, s in zip(corrected, scale.unbind())]

    def _frozen_update(self, grads, step, compress: bool, skip):
        """After the freeze: ``mu`` moves (compressed with ``compress``),
        ``nu`` stays; the core update ``(mu / bc1) / (sqrt(nu / bc2) +
        eps)`` is written over ``grads`` and returned, a chunk at a time.
        ``mu`` and ``error`` keep their values where ``skip`` is set."""
        b1, b2 = self.betas
        mu, nu = self.state["mu"], self.state["nu"]
        bc1 = bias_correction(b1, step, mu.device)
        bc2 = bias_correction(b2, step, mu.device)

        def core(m, v):
            return (m / bc1) / (torch.sqrt(v / bc2) + self.eps)

        if not compress:
            for g, m, v in self._chunks(grads, mu, nu):
                m_new = b1 * m + (1 - b1) * g
                _keep_unless(skip, m, m_new)
                g.copy_(core(m_new, v))
            return grads
        err = self.state["error"]
        for g, m, e in self._chunks(grads, mu, err):  # grads: the corrected momentum
            g.copy_(b1 * m + (1 - b1) * g).add_(e)
        signs = self._compressed([grads[a:b] for a, b in self.bounds])
        for (a, b), sign in zip(self.bounds, signs):
            for s, t in spans(b - a):
                m_used, mine = sign.part(s, t)
                g, m, e, v = (x[a + s:a + t] for x in (grads, mu, err, nu))
                _keep_unless(skip, e, g - mine)
                _keep_unless(skip, m, m_used)
                g.copy_(core(m_used, v))
        return grads

    def _apply(self, u, lr, skip):
        decay_and_step_(self.params, u, self.bounds, lr, self.weight_decay, skip)


class _LocalSign:
    """A piece's local compression: ``sign(c) * scale`` (``>= 0`` maps to
    +1), the same values used and kept."""

    def __init__(self, corrected, scale):
        self.corrected, self.scale = corrected, scale

    def part(self, a: int, b: int):
        x = torch.where(self.corrected[a:b] >= 0, self.scale, -self.scale)
        return x, x


class OneBitAdam(_OneBitBase):

    def __init__(self, params, bounds, lr, lr_fn, betas, eps, weight_decay, freeze_step):
        super().__init__(params, bounds, lr, lr_fn, betas, eps, weight_decay)
        self.freeze_step = int(freeze_step)
        self.state["error"] = self._zeros()

    def _update(self, grads, lr, step, skip):
        if self._next_count() <= self.freeze_step:
            adam_step_(self.params, grads, self.state["mu"], self.state["nu"], lr, step,
                       *self.betas, self.eps, self.weight_decay, l2=False, skip=skip)
            return
        self._apply(self._frozen_update(grads, step, True, skip), lr, skip)


class ZeroOneAdam(_OneBitBase):

    def __init__(self, params, bounds, lr, lr_fn, betas, eps, weight_decay, var_freeze_step,
                 var_update_scaler):
        super().__init__(params, bounds, lr, lr_fn, betas, eps, weight_decay)
        self.var_freeze_step = int(var_freeze_step)
        self.var_update_scaler = int(var_update_scaler)

    def _update(self, grads, lr, step, skip):
        c = self._next_count()
        if c % self.var_update_scaler == 0 or c <= self.var_freeze_step:
            adam_step_(self.params, grads, self.state["mu"], self.state["nu"], lr, step,
                       *self.betas, self.eps, self.weight_decay, l2=False, skip=skip)
            return
        self._apply(self._frozen_update(grads, step, False, skip), lr, skip)


class OneBitLamb(_OneBitBase):

    def __init__(self, params, bounds, lr, lr_fn, betas, eps, weight_decay, freeze_step,
                 max_coeff, min_coeff):
        super().__init__(params, bounds, lr, lr_fn, betas, eps, weight_decay)
        self.freeze_step = int(freeze_step)
        self.max_coeff, self.min_coeff = float(max_coeff), float(min_coeff)
        self.state["error"] = self._zeros()

    def _norms(self, flat):
        views = self._views(flat)
        if self.norms is not None:
            return self.norms(views)
        return torch.stack(torch._foreach_norm(views))

    def _update(self, grads, lr, step, skip):
        if self._next_count() <= self.freeze_step:
            u = lamb_update_(grads, self.state["mu"], self.state["nu"], step, *self.betas,
                             self.eps, out=grads, skip=skip)
        else:
            u = self._frozen_update(grads, step, True, skip)
        pn, un = self._norms(self.params), self._norms(u)
        ratio = torch.where(un > 0, pn / torch.clamp(un, min=1e-12), torch.ones_like(un))
        ratio = torch.where(pn > 0, ratio, torch.ones_like(pn)).clamp(self.min_coeff,
                                                                        self.max_coeff)
        torch._foreach_mul_(self._views(u), list(ratio.unbind()))
        self._apply(u, lr, skip)


def build_onebit_optimizer(name, common, opt_params):
    """``onebitadam``, ``zerooneadam`` or ``onebitlamb`` with the JAX
    package's keys and defaults (``onebit.py:172``); ``common``: the
    ``FlatOptimizer`` arguments ``(params, bounds, lr, lr_fn)``."""
    betas = tuple(opt_params.get("betas", (0.9, 0.999)))
    eps = float(opt_params.get("eps", 1e-8))
    wd = float(opt_params.get("weight_decay", 0.0))
    freeze_step = int(opt_params.get("freeze_step", ONEBIT_DEFAULT_FREEZE_STEP))
    if name == "onebitadam":
        return OneBitAdam(*common, betas, eps, wd, freeze_step)
    if name == "zerooneadam":
        return ZeroOneAdam(*common, betas, eps, wd,
                           int(opt_params.get("var_freeze_step", freeze_step)),
                           int(opt_params.get("var_update_scaler", 16)))
    if name == "onebitlamb":
        return OneBitLamb(*common, betas, eps, wd, freeze_step,
                          float(opt_params.get("max_coeff", 10.0)),
                          float(opt_params.get("min_coeff", 0.01)))
    raise ValueError(name)
