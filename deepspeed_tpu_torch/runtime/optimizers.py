"""Optimizer construction from config (port of
``deepspeed_tpu/runtime/optimizers.py:37 build_optimizer``) over ONE flat
fp32 master buffer, with the optax semantics the JAX engine runs:

- ``adam``: ``optax.adam``; with ``weight_decay``, L2 into the gradient
  before the moments (``add_decayed_weights -> scale_by_adam``, ``:55-61``);
- ``adamw``: ``optax.adamw``, decoupled decay of every parameter:
  ``u = m_hat / (sqrt(v_hat) + eps) + wd * p``;
- ``lamb``: ``optax.lamb``: the AdamW update scaled per parameter by the
  trust ratio ``||p|| / ||u||`` (1 where either is 0); eps from the config
  (default 1e-8, not ``fused_lamb_step``'s 1e-6);
- ``lion``: ``optax.lion``, ``u = sign(b1 m + (1 - b1) g) + wd * p`` and
  ``m = b2 m + (1 - b2) g``; betas default to (0.9, 0.99) (``:48-49``);
- ``sgd``: ``add_decayed_weights -> optax.sgd(momentum, nesterov)``: the
  trace ``t = g + momentum * t`` and ``u = g + momentum * t`` (nesterov)
  or ``t``; plain ``u = g`` without momentum;
- ``adagrad``: ``optax.adagrad(lr, eps)``: ``s = g^2 + s`` from 0.1,
  ``u = g * rsqrt(s + eps)`` (0 where s is 0); no weight decay. This is not
  ``torch.optim.Adagrad``.

Every update is ``p -= lr * u`` at update count ``t`` (1 for the first),
with Adam's bias corrections at ``t`` and the learning rate ``lr_fn(t -
1)`` when a schedule is given (optax reads the count before it
increments), else the constant ``lr``. adam, adamw, lion and lamb run one
K7 pass over the whole flat buffer (``ops/fused_optimizer.py``); LAMB
writes its update into the gradient buffer, which is dead by then, and
applies the trust ratio in PyTorch. sgd and adagrad are a few PyTorch
ops. ``muadam``, ``muadamw`` and ``musgd`` are ``runtime/mup.py``'s,
``onebitadam``, ``zerooneadam`` and ``onebitlamb`` ``runtime/onebit.py``'s;
any other name raises ``NotImplementedError``.

The update count lives on the device, as in the optax state the JAX
program carries, so the engine can enqueue K steps with no host read
between them (``engine.fused_train_steps``). A step may take a skip flag
(a one-element bool tensor, the engine's fp16 overflow): where it is set
nothing moves, the count included (K7 reads the flag; sgd and adagrad
keep their state through ``torch.where``). The learning rate comes from
the device count: ``begin_window(k)`` writes ``lr_fn(c)`` for ``c`` in
``[count, count + k)`` into a small device table, and each step reads
the entry of its own count. That is exact under skips, because the count
moves only on applied steps. The host mirror of the count is brought up
to date by ``settle`` once the host has read the flags (the window's one
fetch); a step without a flag settles itself.
"""

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..comm.compressed import spans
from ..ops.fused_optimizer import (adam_step_, device_scalar, lamb_apply_trust_,
                                   lamb_update_, lion_step_)

ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
LAMB_OPTIMIZER = "lamb"
LION_OPTIMIZER = "lion"
SGD_OPTIMIZER = "sgd"
ADAGRAD_OPTIMIZER = "adagrad"
MU_OPTIMIZERS = ("muadam", "muadamw", "musgd")
ONEBIT_OPTIMIZERS = ("onebitadam", "zerooneadam", "onebitlamb")
_MU_KEYS = {"base_shapes", "momentum", "nesterov"}
_ONEBIT_KEYS = {"freeze_step", "comm_backend_name", "var_freeze_step", "var_update_scaler",
                "max_coeff", "min_coeff"}
ADAM_DEFAULT_BETAS = (0.9, 0.999)
LION_DEFAULT_BETAS = (0.9, 0.99)
ADAGRAD_INITIAL_ACCUMULATOR = 0.1
_COMMON_KEYS = {"lr", "betas", "eps", "weight_decay"}


class FlatOptimizer:
    """An optimizer over the flat fp32 buffer ``params``; ``bounds`` are
    the ``(start, end)`` of each parameter in it (LAMB's trust ratio is
    per parameter). Under ZeRO ``params`` is a rank's shard of the
    masters, ``bounds`` the pieces of parameters it holds, and ``norms``
    maps the pieces' views to the norms of their whole parameters (partial
    sums all-reduced over the ZeRO group), ``sums`` a tensor of the
    bounds' partial sums to their whole parameters' sums. ``owners`` is
    each bound's parameter, ``names``, ``shapes`` and ``whole_numels`` the
    parameters' (muP reads the names and shapes, the 1-bit optimizers
    the numels). Subclasses define ``_update(grads, lr, step, skip)``
    (``lr`` and ``step`` one-element fp32 device tensors, ``skip`` a flag
    or None) and keep their state as flat fp32 buffers in ``self.state``."""

    def __init__(self, params: torch.Tensor, bounds: Sequence[Tuple[int, int]],
                 lr: float, lr_fn: Optional[Callable[[int], float]]):
        if params.dtype != torch.float32 or params.dim() != 1:
            raise ValueError("the optimizer takes one flat fp32 master buffer")
        self.params = params
        self.bounds = list(bounds)
        self.norms = self.sums = None
        self.owners = list(range(len(self.bounds)))
        self.names = self.shapes = self.whole_numels = None
        self.lr = float(lr)
        self.lr_fn = lr_fn
        self.state: Dict[str, torch.Tensor] = {}
        self._count = torch.zeros((), dtype=torch.int64, device=params.device)
        self._count_host = 0  # exact while no step is unsettled
        self._unsettled = 0  # flagged steps whose flags the host has not read
        self._lr_const = device_scalar(self.lr, params.device)
        self._lr_table = None
        self._table_base = 0
        self._table_left = 0  # steps the table still covers

    def _zeros(self):
        return torch.zeros_like(self.params)

    @property
    def count(self) -> int:
        """The number of applied updates (a host read of the device count
        while a flagged step is unsettled)."""
        return int(self._count) if self._unsettled else self._count_host

    def current_lr(self) -> float:
        """The learning rate the next update uses."""
        return float(self.lr_fn(self.count)) if self.lr_fn is not None else self.lr

    def begin_window(self, k: int) -> None:
        """Make the learning rates of the next ``k`` steps readable on the
        device: one small host-to-device copy, from pinned memory on a
        card, with no synchronisation."""
        self._table_left = int(k)
        if self.lr_fn is None:
            return
        base = self.count
        table = torch.tensor([float(self.lr_fn(base + i)) for i in range(k)],
                             dtype=torch.float32)
        if self.params.is_cuda:
            table = table.pin_memory().to(self.params.device, non_blocking=True)
        self._lr_table, self._table_base = table, base

    def settle(self, applied: int) -> None:
        """The host has read the flags of the unsettled steps: ``applied``
        of them updated."""
        self._count_host += int(applied)
        self._unsettled = 0

    @torch.no_grad()
    def step(self, grads: torch.Tensor, skip: Optional[torch.Tensor] = None) -> None:
        """One update of the masters from the flat fp32 ``grads`` (which
        the update may overwrite); nothing moves where ``skip`` is set."""
        if self._table_left == 0:
            self.begin_window(1)
        self._table_left -= 1
        lr = self._lr_const
        if self.lr_fn is not None:
            lr = torch.index_select(self._lr_table, 0, (self._count - self._table_base).view(1))
        step = (self._count + 1).to(torch.float32).view(1)
        if skip is not None:
            skip = skip.reshape(1)
        self._update(grads, lr, step, skip)
        if skip is None:
            self._count += 1
            self._count_host += 1
        else:
            self._count += skip.logical_not().reshape(())
            self._unsettled += 1

    def _update(self, grads, lr, step, skip):
        raise NotImplementedError


class Adam(FlatOptimizer):
    """Adam (``l2``: weight decay into the gradient) or AdamW: one K7 pass."""

    def __init__(self, params, bounds, lr, lr_fn, betas, eps, weight_decay, l2):
        super().__init__(params, bounds, lr, lr_fn)
        self.betas, self.eps, self.weight_decay, self.l2 = tuple(betas), eps, weight_decay, l2
        self.state = {"m": self._zeros(), "v": self._zeros()}

    def _update(self, grads, lr, step, skip):
        adam_step_(self.params, grads, self.state["m"], self.state["v"], lr, step,
                   *self.betas, self.eps, self.weight_decay, l2=self.l2, skip=skip)


class Lion(FlatOptimizer):
    """Lion: one K7 pass."""

    def __init__(self, params, bounds, lr, lr_fn, betas, weight_decay):
        super().__init__(params, bounds, lr, lr_fn)
        self.betas, self.weight_decay = tuple(betas), weight_decay
        self.state = {"m": self._zeros()}

    def _update(self, grads, lr, step, skip):
        lion_step_(self.params, grads, self.state["m"], lr, *self.betas, self.weight_decay,
                   skip=skip)


class Lamb(FlatOptimizer):
    """LAMB: K7's first pass writes the update over ``grads``, then the
    per-parameter trust ratio and the write of the masters."""

    def __init__(self, params, bounds, lr, lr_fn, betas, eps, weight_decay):
        super().__init__(params, bounds, lr, lr_fn)
        self.betas, self.eps, self.weight_decay = tuple(betas), eps, weight_decay
        self.state = {"m": self._zeros(), "v": self._zeros()}

    def _update(self, grads, lr, step, skip):
        u = lamb_update_(grads, self.state["m"], self.state["v"], step, *self.betas,
                         self.eps, out=grads, skip=skip)
        lamb_apply_trust_(self.params, u, lr, self.weight_decay, self.bounds, skip,
                          norms=self.norms)


def _keep_unless(skip, buf, new):
    """``buf = new``, except where the flag ``skip`` is set."""
    buf.copy_(new if skip is None else torch.where(skip, buf, new))


def chunked(bounds):
    """Each ``(start, end)`` of ``bounds`` cut into chunks of at most
    ``CHUNK_ELEMENTS`` (each a multiple of 8 from its start)."""
    return [(a + s, a + e) for a, b in bounds for s, e in spans(b - a)]


def decay_and_step_(params, u, bounds, lr, weight_decay, skip):
    """``p -= lr * (u + wd * p)`` over ``bounds`` a chunk at a time (no
    large temporary), unless ``skip``."""
    for a, b in chunked(bounds):
        p, x = params[a:b], u[a:b]
        if weight_decay:
            x = x + weight_decay * p
        _keep_unless(skip, p, p - lr * x)


class SGD(FlatOptimizer):
    """SGD with optional (nesterov) momentum and L2 weight decay."""

    def __init__(self, params, bounds, lr, lr_fn, momentum, nesterov, weight_decay):
        super().__init__(params, bounds, lr, lr_fn)
        self.momentum, self.nesterov, self.weight_decay = momentum, nesterov, weight_decay
        if momentum:
            self.state = {"trace": self._zeros()}

    def _update(self, grads, lr, step, skip):
        u = grads + self.weight_decay * self.params if self.weight_decay else grads
        if self.momentum:
            trace = self.state["trace"] * self.momentum + u
            u = u + self.momentum * trace if self.nesterov else trace
            _keep_unless(skip, self.state["trace"], trace)
        _keep_unless(skip, self.params, self.params - lr * u)


class Adagrad(FlatOptimizer):
    """optax's adagrad: accumulators from 0.1, ``g * rsqrt(s + eps)``."""

    def __init__(self, params, bounds, lr, lr_fn, eps):
        super().__init__(params, bounds, lr, lr_fn)
        self.eps = eps
        self.state = {"sum_of_squares": torch.full_like(params, ADAGRAD_INITIAL_ACCUMULATOR)}

    def _update(self, grads, lr, step, skip):
        s = self.state["sum_of_squares"] + grads * grads
        inv = torch.where(s > 0, torch.rsqrt(s + self.eps), torch.zeros_like(s))
        _keep_unless(skip, self.state["sum_of_squares"], s)
        _keep_unless(skip, self.params, self.params - lr * (inv * grads))


def build_optimizer(name: Optional[str], params: torch.Tensor,
                    opt_params: Optional[Dict] = None,
                    lr_fn: Optional[Callable[[int], float]] = None,
                    bounds: Optional[Sequence[Tuple[int, int]]] = None,
                    norms=None, sums=None, owners=None, names=None, shapes=None,
                    whole_numels=None) -> FlatOptimizer:
    """The optimizer for config ``optimizer.type`` (default ``adamw``)
    over the flat fp32 master buffer ``params``; ``bounds``: each
    parameter's ``(start, end)`` in it (default: one parameter).
    ``opt_params`` takes ``lr``, ``betas``, ``eps`` and ``weight_decay``,
    for sgd ``momentum`` and ``nesterov``, for muP ``base_shapes`` (and
    musgd's momentum), for the 1-bit optimizers ``freeze_step``,
    ``comm_backend_name`` (the engine's wire), ``var_freeze_step``,
    ``var_update_scaler``, ``max_coeff`` and ``min_coeff``. ``norms``,
    ``sums``, ``owners``, ``names``, ``shapes``, ``whole_numels``: see
    ``FlatOptimizer``."""
    opt_params = dict(opt_params or {})
    name = (name or ADAMW_OPTIMIZER).lower()
    allowed = _COMMON_KEYS | ({"momentum", "nesterov"} if name == SGD_OPTIMIZER else set()) \
        | (_MU_KEYS if name in MU_OPTIMIZERS else set()) \
        | (_ONEBIT_KEYS if name in ONEBIT_OPTIMIZERS else set())
    extra = sorted(set(opt_params) - allowed)
    if extra:
        raise NotImplementedError(f"optimizer {name!r} params {extra} are not ported yet")
    bounds = bounds if bounds is not None else [(0, params.numel())]
    lr = float(opt_params.get("lr", 1e-3))
    user_betas = opt_params.get("betas")
    betas = tuple(user_betas) if user_betas is not None else ADAM_DEFAULT_BETAS
    eps = float(opt_params.get("eps", 1e-8))
    wd = float(opt_params.get("weight_decay", 0.0))
    common = (params, bounds, lr, lr_fn)
    if name in (ADAM_OPTIMIZER, ADAMW_OPTIMIZER):
        opt = Adam(*common, betas, eps, wd, l2=name == ADAM_OPTIMIZER)
    elif name == LAMB_OPTIMIZER:
        opt = Lamb(*common, betas, eps, wd)
    elif name == LION_OPTIMIZER:
        opt = Lion(*common, tuple(user_betas) if user_betas is not None
                   else LION_DEFAULT_BETAS, wd)
    elif name == SGD_OPTIMIZER:
        opt = SGD(*common, float(opt_params.get("momentum", 0.0)),
                  bool(opt_params.get("nesterov", False)), wd)
    elif name == ADAGRAD_OPTIMIZER:
        opt = Adagrad(*common, eps)
    elif name in MU_OPTIMIZERS:
        from .mup import build_mu_optimizer
        opt = build_mu_optimizer(name, common, opt_params)
    elif name in ONEBIT_OPTIMIZERS:
        from .onebit import build_onebit_optimizer
        opt = build_onebit_optimizer(name, common, opt_params)
    else:
        raise NotImplementedError(
            f"optimizer {name!r} is not ported; the port has adam, adamw, lamb, lion, "
            "sgd, adagrad, muadam, muadamw, musgd, onebitadam, zerooneadam and onebitlamb")
    opt.norms, opt.sums = norms, sums
    if owners is not None:
        opt.owners = list(owners)
    opt.names, opt.shapes, opt.whole_numels = names, shapes, whole_numels
    return opt
