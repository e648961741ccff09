"""The training engine, ZeRO stage 0 on one device (port of
``deepspeed_tpu/runtime/engine.py``).

What it keeps from the JAX engine:
- the precision policy (``:268-296``): compute in bf16 when ``bf16`` is
  enabled, else fp32; the masters are fp32 (``_init_state :511``);
- ``param_cast="engine"`` (``value_and_grads :705``): the model computes
  with the compute-dtype cast of the masters and the gradients are taken
  with respect to that cast, with the loss scaled by ``1/gas``
  (``fwd_bwd :725``), then added into an fp32 accumulation buffer;
- ``apply_step :750``: the global norm of the accumulated gradients, the
  clip factor ``min(1, clip / (gnorm + 1e-6))``, the optimizer (optax
  semantics, ``runtime/optimizers.py``) and the schedule;
- the API: ``forward :1285``, ``backward :1325``, ``step :1383``,
  ``train_batch :1669``, ``eval_batch :1833``, ``get_lr :1959`` and
  ``get_global_grad_norm :2003``.

What differs, by the nature of PyTorch: JAX's ``forward`` computes the
loss and the gradients in one compiled program and ``backward`` only
commits them; here ``forward`` builds the autograd graph and ``backward``
runs it and accumulates. The compute copy lives in the model's
parameters and is refreshed from the masters after each optimizer step
(in fp32 the two are one tensor). The optimizer updates the masters in
place, where the JAX engine returns new arrays.

Not ported yet (``ROADMAP.md``): fp16 loss scaling, offload, ZeRO 1-3 and
the comm layer, the fused K-step programs, checkpointing, resilience and
observability. The engine runs on ``cuda`` unless the caller passes
``device="cpu"``; without CUDA it raises.
"""

from typing import Optional

import torch
from torch.profiler import record_function

from ..config.config import DeepSpeedTorchConfig
from ..utils.device import resolve_device
from .lr_schedules import get_lr_schedule
from .optimizers import build_optimizer


def _extract_loss(out):
    """Contract: the model returns loss, (loss, aux) or a dict with 'loss'."""
    if isinstance(out, tuple):
        return out[0]
    if isinstance(out, dict):
        return out["loss"]
    return out


class DeepSpeedTorchEngine:

    def __init__(self, model, model_parameters=None, config=None,
                 lr_scheduler=None, device=None):
        self._config = DeepSpeedTorchConfig(config if config is not None else {})
        self.device = resolve_device(device)
        self.module = model.to(self.device)
        self.compute_dtype = (torch.bfloat16 if self._config.bf16_enabled
                              else torch.float32)
        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self.losses = None
        self._pending = None
        self._training = True
        self._last_grad_norm = None
        self._init_state(model_parameters)

        base_lr = float(self._config.optimizer_params.get("lr", 1e-3))
        self._base_lr = base_lr
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is None and self._config.scheduler_name is not None:
            self.lr_scheduler = get_lr_schedule(self._config.scheduler_name,
                                                self._config.scheduler_params,
                                                base_lr=base_lr)
        lr_fn = self.lr_scheduler.lr_at if self.lr_scheduler is not None else None
        self.optimizer = build_optimizer(self._config.optimizer_name,
                                         self._masters,
                                         self._config.optimizer_params, lr_fn)

    @torch.no_grad()
    def _init_state(self, model_parameters):
        """fp32 masters on the device, the model's parameters set to their
        compute-dtype cast (the same tensor when that is fp32), and the fp32
        gradient accumulation buffer."""
        names = {id(p): n for n, p in self.module.named_parameters()}
        params = (list(model_parameters) if model_parameters is not None
                  else [p for p in self.module.parameters() if p.requires_grad])
        if not params or any(id(p) not in names for p in params):
            raise ValueError("model_parameters must be parameters of model")
        self._params = params
        self.param_names = [names[id(p)] for p in params]
        self._masters = []
        for p in params:
            master = p.detach().to(torch.float32)
            if self.compute_dtype == torch.float32:
                p.data = master
            elif p.dtype != self.compute_dtype:
                p.data = master.to(self.compute_dtype)
            self._masters.append(master)
            p.requires_grad_(True)
        self._grad_acc = [torch.zeros_like(m) for m in self._masters]

    def master_params(self):
        """``{name: fp32 master}`` (the engine's own tensors)."""
        return dict(zip(self.param_names, self._masters))

    # ---- the training API ----

    def train(self, mode: bool = True):
        """Torch-style mode switch: in eval mode ``forward`` is
        ``eval_batch``."""
        self._training = bool(mode)
        return self

    def eval(self):
        return self.train(False)

    def _to_device(self, x):
        return x.to(self.device) if isinstance(x, torch.Tensor) else x

    def forward(self, *args, **kwargs):
        """The loss of one micro-batch, with its autograd graph; call
        ``backward(loss)`` next. After ``eval()`` this is ``eval_batch``."""
        if not self._training:
            return self.eval_batch(*args, **kwargs)
        if self._pending is not None:
            raise RuntimeError(
                "forward() called twice without backward(); for evaluation "
                "use engine.eval() (then forward() is grad-free) or eval_batch()")
        args = tuple(self._to_device(a) for a in args)
        kwargs = {k: self._to_device(v) for k, v in kwargs.items()}
        loss = _extract_loss(self.module(*args, **kwargs))
        self._pending = loss
        return loss

    def backward(self, loss):
        """Gradients of ``loss / gas`` with respect to the compute copy,
        added into the fp32 accumulation buffer."""
        if self._pending is None:
            raise RuntimeError("backward() called without a preceding forward()")
        (loss.float() / self.gradient_accumulation_steps()).backward()
        with torch.no_grad():
            for p, acc in zip(self._params, self._grad_acc):
                if p.grad is not None:
                    acc.add_(p.grad)
                    p.grad = None
        self._pending = None
        self.losses = loss.detach()
        self.micro_steps += 1
        return loss

    def is_gradient_accumulation_boundary(self):
        return self.micro_steps % self.gradient_accumulation_steps() == 0

    @torch.no_grad()
    def step(self):
        """At a gradient-accumulation boundary: global norm, clip, optimizer
        update of the masters, schedule step, and the compute copy
        refreshed from the masters."""
        if not (self.is_gradient_accumulation_boundary() and self.micro_steps > 0):
            return
        with record_function("optimizer_step"):  # names the step in a profile
            self._apply_step()
        self.global_steps += 1
        self.global_samples += self.train_batch_size()
        if self.lr_scheduler is not None:
            self.lr_scheduler.step()

    def _apply_step(self):
        grads = self._grad_acc
        gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        clip = self._config.gradient_clipping
        if clip > 0:
            torch._foreach_mul_(grads, torch.clamp(clip / (gnorm + 1e-6), max=1.0))
        self.optimizer.step(grads)
        torch._foreach_zero_(grads)
        for p, master in zip(self._params, self._masters):
            if p.data is not master:
                p.data.copy_(master)
        self._last_grad_norm = gnorm

    def train_batch(self, data_iter):
        """``gradient_accumulation_steps`` micro-batches of forward,
        backward and step; each item of ``data_iter`` is a tuple of the
        model's positional arguments (or one tensor). Returns the mean loss
        as a float."""
        self._training = True
        losses = []
        for _ in range(self.gradient_accumulation_steps()):
            batch = next(data_iter)
            if not isinstance(batch, tuple):
                batch = (batch, )
            loss = self.forward(*batch)
            self.backward(loss)
            self.step()
            losses.append(loss.detach())
        return float(torch.stack(losses).float().mean())

    @torch.no_grad()
    def eval_batch(self, *args, **kwargs):
        """The model's output with no gradient."""
        args = tuple(self._to_device(a) for a in args)
        kwargs = {k: self._to_device(v) for k, v in kwargs.items()}
        return self.module(*args, **kwargs)

    # ---- info ----

    def train_batch_size(self):
        return self._config.train_batch_size

    def gradient_accumulation_steps(self):
        return self._config.gradient_accumulation_steps

    def get_lr(self):
        """The learning rate of the latest update (the schedule's value
        before the first)."""
        if self.lr_scheduler is not None:
            return self.lr_scheduler.get_last_lr()
        return [self._base_lr]

    def get_global_grad_norm(self) -> Optional[float]:
        """The global norm of the latest step's gradients, before clipping."""
        return None if self._last_grad_norm is None else float(self._last_grad_norm)
