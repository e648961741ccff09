"""Optimizer construction from config (port of
``deepspeed_tpu/runtime/optimizers.py:37 build_optimizer``) for Adam and
AdamW, with optax's semantics, which the JAX engine runs:

- ``adamw``: ``optax.adamw`` decays every parameter (no mask):
  ``u = m_hat / (sqrt(v_hat) + eps) + wd * p`` and ``p -= lr * u``;
- ``adam``: ``optax.adam``; with ``weight_decay``, torch-Adam's L2 form,
  ``g += wd * p`` before the moments (the JAX chain
  ``add_decayed_weights -> scale_by_adam -> scale_by_learning_rate``).

Moments ``m = b1 m + (1 - b1) g`` and ``v = b2 v + (1 - b2) g^2`` and the
bias corrections ``1 - b^t`` at update count ``t`` (1 for the first
update). The learning rate of update ``t`` is ``lr_fn(t - 1)`` when a
schedule is given (optax reads the count before it increments), else the
constant ``lr``. The update is ``torch.optim.Adam``/``AdamW`` with
``fused=True``: one pass over each master, its gradient and moments, in
place. Its AdamW decays first, ``p *= 1 - lr * wd``, then subtracts
``lr * m_hat / (sqrt(v_hat) + eps)``: optax's update, rounded at other
points. Other optimizer names raise.
"""

from typing import Callable, Dict, Iterable, Optional

import torch

ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
ADAM_DEFAULT_BETAS = (0.9, 0.999)


class ScheduledAdam:
    """Adam/AdamW over a list of fp32 master tensors, the learning rate of
    each update read from ``lr_fn`` at the update count."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float = 1e-3,
                 betas=ADAM_DEFAULT_BETAS, eps: float = 1e-8,
                 weight_decay: float = 0.0, decoupled: bool = True,
                 lr_fn: Optional[Callable[[int], float]] = None):
        self.params = list(params)
        self.lr = float(lr)
        self.lr_fn = lr_fn
        self.count = 0
        cls = torch.optim.AdamW if decoupled else torch.optim.Adam
        self.torch_optimizer = cls(self.params, lr=self.lr, betas=tuple(betas),
                                   eps=float(eps), weight_decay=float(weight_decay),
                                   fused=True)

    def current_lr(self) -> float:
        """The learning rate the next update uses."""
        return float(self.lr_fn(self.count)) if self.lr_fn is not None else self.lr

    @torch.no_grad()
    def step(self, grads):
        """One update of every parameter from ``grads`` (fp32, same order)."""
        self.torch_optimizer.param_groups[0]["lr"] = self.current_lr()
        self.count += 1
        for p, g in zip(self.params, grads):
            p.grad = g
        self.torch_optimizer.step()
        for p in self.params:
            p.grad = None


def build_optimizer(name: Optional[str], params: Iterable[torch.Tensor],
                    opt_params: Optional[Dict] = None,
                    lr_fn: Optional[Callable[[int], float]] = None) -> ScheduledAdam:
    """The optimizer for config ``optimizer.type`` (default ``adamw``)
    over the fp32 masters ``params``; ``opt_params`` takes ``lr``,
    ``betas``, ``eps`` and ``weight_decay``."""
    opt_params = dict(opt_params or {})
    name = (name or ADAMW_OPTIMIZER).lower()
    if name not in (ADAM_OPTIMIZER, ADAMW_OPTIMIZER):
        raise NotImplementedError(
            f"optimizer {name!r} is not ported; the port has adam and adamw")
    extra = sorted(set(opt_params) - {"lr", "betas", "eps", "weight_decay"})
    if extra:
        raise NotImplementedError(f"optimizer params {extra} are not ported yet")
    return ScheduledAdam(params, lr=float(opt_params.get("lr", 1e-3)),
                         betas=opt_params.get("betas", ADAM_DEFAULT_BETAS),
                         eps=float(opt_params.get("eps", 1e-8)),
                         weight_decay=float(opt_params.get("weight_decay", 0.0)),
                         decoupled=name == ADAMW_OPTIMIZER, lr_fn=lr_fn)
