"""muP optimizers over flat fp32 buffers (port of
``deepspeed_tpu/runtime/mup.py``; reference ``runtime/config.py:79-81``,
which hands MuAdam/MuAdamW/MuSGD to the ``mup`` package).

The width bookkeeping is the JAX package's: ``make_base_shapes`` records a
base-width model's shapes as a JSON-able ``{path: [dims]}`` dict, the path
the JAX tree's key path joined by ``/`` (``model/layers_0/self_attn/
q_proj/kernel``; the port keeps the flax shapes, ``models/convert.py``), and
the config passes it as ``optimizer.params.base_shapes``. Each parameter's
update is multiplied by its muTransfer factor (Tensor Programs V, Table
3), a dimension counting as infinite where it differs from the base, the
trailing two axes of a kernel read as ``[fan_in, fan_out]``:

==========  ===========================  ==================
leaf kind   infinite dims                LR multiplier
==========  ===========================  ==================
Adam-family hidden/output (fan_in inf)   1 / fan_in_mult
Adam-family input-like, biases           1
SGD         hidden (both inf)            1
SGD         input-like / bias (out inf)  fan_out_mult
SGD         output-like (fan_in inf)     1 / fan_in_mult
==========  ===========================  ==================

``muadam`` and ``muadamw`` run K7's Adam first pass (``lamb_update_``,
which writes ``m_hat / (sqrt(v_hat) + eps)`` over the gradient buffer),
then the multipliers per parameter, then for ``muadamw`` the decoupled
weight decay, which the multiplier does not scale (muTransfer's
independent weight decay; ``muadam`` ignores ``weight_decay`` with a
warning, as in JAX), then ``p -= lr * u``. ``musgd`` is L2 decay into the
gradient, optax's ``trace`` (momentum, nesterov), the multipliers and the
step, in PyTorch.
"""

import logging
from typing import Dict, List

import torch

from ..ops.fused_optimizer import lamb_update_
from .optimizers import ADAM_DEFAULT_BETAS, FlatOptimizer, _keep_unless, decay_and_step_

logger = logging.getLogger(__name__)


def param_path(name: str) -> str:
    """A port parameter name's JAX key path, joined by ``/``."""
    from ..models.convert import jax_key_path
    return "/".join(jax_key_path(name))


def make_base_shapes(named_params) -> Dict[str, List[int]]:
    """``{path: [dims]}`` of a base-width model (a module, or pairs of
    name and tensor)."""
    if hasattr(named_params, "named_parameters"):
        named_params = named_params.named_parameters()
    return {param_path(n): list(p.shape) for n, p in named_params}


def _leaf_mult(shape, base, family: str, path: str) -> float:
    if list(shape) == list(base):
        return 1.0
    if len(shape) != len(base):
        raise ValueError(
            f"muP base shape for {path} has rank {len(base)} but the model leaf has rank "
            f"{len(shape)}; base_shapes from a different model?")
    if len(shape) == 0:
        return 1.0
    if len(shape) == 1:
        return shape[0] / base[0] if family == "sgd" else 1.0
    fan_in_mult, fan_out_mult = shape[-2] / base[-2], shape[-1] / base[-1]
    fan_in_inf, fan_out_inf = shape[-2] != base[-2], shape[-1] != base[-1]
    if family == "adam":
        return 1.0 / fan_in_mult if fan_in_inf else 1.0
    if fan_in_inf and fan_out_inf:
        return 1.0
    if fan_out_inf:
        return fan_out_mult
    if fan_in_inf:
        return 1.0 / fan_in_mult
    return 1.0


def width_multipliers(names, shapes, base_shapes: Dict, family: str) -> List[float]:
    """Each parameter's LR multiplier for ``family`` (``adam`` or
    ``sgd``), in the order of ``names``."""
    mults, missing = [], []
    for name, shape in zip(names, shapes):
        key = param_path(name)
        if key not in base_shapes:
            missing.append(key)
            mults.append(1.0)
        else:
            mults.append(_leaf_mult(tuple(shape), base_shapes[key], family, key))
    if missing:
        raise ValueError(
            f"muP base_shapes missing {len(missing)} param paths (e.g. {missing[:3]}); "
            "regenerate with make_base_shapes() on a BASE-width model with the same structure")
    return mults


class _MuBase(FlatOptimizer):

    family = "adam"

    def _mults(self):
        """Each bound's multiplier (its parameter's), once."""
        if getattr(self, "_mult_list", None) is None:
            if self.names is None:
                raise ValueError("a muP optimizer needs the parameters' names and shapes")
            per_param = width_multipliers(self.names, self.shapes, self.base_shapes,
                                          self.family)
            self._mult_list = [per_param[i] for i in self.owners]
        return self._mult_list

    def _scale(self, u):
        """``u`` times each parameter's multiplier, in place."""
        pairs = [(u[a:b], m) for (a, b), m in zip(self.bounds, self._mults()) if m != 1.0]
        if pairs:
            views, mults = zip(*pairs)
            torch._foreach_mul_(list(views), list(mults))


class MuAdam(_MuBase):
    """``muadam`` (``decoupled`` False) or ``muadamw``."""

    def __init__(self, params, bounds, lr, lr_fn, betas, eps, weight_decay, base_shapes,
                 decoupled):
        super().__init__(params, bounds, lr, lr_fn)
        self.betas, self.eps, self.base_shapes = tuple(betas), float(eps), base_shapes
        self.weight_decay = float(weight_decay) if decoupled else 0.0
        if weight_decay and not decoupled:
            logger.warning("muadam ignores weight_decay (use muadamw)")
        self.state = {"m": self._zeros(), "v": self._zeros()}

    def _update(self, grads, lr, step, skip):
        u = lamb_update_(grads, self.state["m"], self.state["v"], step, *self.betas, self.eps,
                         out=grads, skip=skip)
        self._scale(u)
        decay_and_step_(self.params, u, self.bounds, lr, self.weight_decay, skip)


class MuSGD(_MuBase):

    family = "sgd"

    def __init__(self, params, bounds, lr, lr_fn, momentum, nesterov, weight_decay,
                 base_shapes):
        super().__init__(params, bounds, lr, lr_fn)
        self.momentum, self.nesterov = float(momentum), bool(nesterov)
        self.weight_decay, self.base_shapes = float(weight_decay), base_shapes
        if self.momentum:
            self.state = {"trace": self._zeros()}

    def _update(self, grads, lr, step, skip):
        u = grads + self.weight_decay * self.params if self.weight_decay else grads
        if self.momentum:
            trace = u + self.momentum * self.state["trace"]
            u = u + self.momentum * trace if self.nesterov else trace
            _keep_unless(skip, self.state["trace"], trace)
        self._scale(u)
        _keep_unless(skip, self.params, self.params - lr * u)


def build_mu_optimizer(name: str, common, opt_params: Dict):
    """``muadam``, ``muadamw`` or ``musgd`` (``mup.py:133``); ``common``:
    the ``FlatOptimizer`` arguments ``(params, bounds, lr, lr_fn)``."""
    base_shapes = opt_params.get("base_shapes")
    if not isinstance(base_shapes, dict) or not base_shapes:
        raise ValueError(f"{name} needs optimizer.params.base_shapes (make_base_shapes("
                         "base_width_params), the mup set_base_shapes analog)")
    betas = tuple(opt_params.get("betas", ADAM_DEFAULT_BETAS))
    eps = float(opt_params.get("eps", 1e-8))
    wd = float(opt_params.get("weight_decay", 0.0))
    if name in ("muadam", "muadamw"):
        return MuAdam(*common, betas, eps, wd, base_shapes, decoupled=name == "muadamw")
    if name == "musgd":
        return MuSGD(*common, float(opt_params.get("momentum", 0.0)),
                     bool(opt_params.get("nesterov", False)), wd, base_shapes)
    raise ValueError(f"unknown mu optimizer {name}")
