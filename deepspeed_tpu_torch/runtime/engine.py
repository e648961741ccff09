"""The training engine, ZeRO stage 0 on one device (port of
``deepspeed_tpu/runtime/engine.py``).

What it keeps from the JAX engine:
- the precision policy (``:268-296``): compute in bf16 when ``bf16`` is
  enabled, in fp16 with loss scaling when ``fp16`` is, else fp32; the
  masters are fp32 (``_init_state :511``);
- ``param_cast="engine"`` (``value_and_grads :705``): the model computes
  with the compute-dtype cast of the masters and the gradients are taken
  with respect to that cast, with the loss scaled by ``1/gas`` and then by
  the loss scale (``loss_from_cparams :677``), then added into an fp32
  accumulation buffer;
- ``apply_step :750``, in its order: ``grads = acc / cur_scale``; overflow
  if any value is non-finite; the global norm and the clip factor ``min(1,
  clip / (gnorm + 1e-6))``; the update (``runtime/optimizers.py``); on
  overflow nothing moves (masters, optimizer state and its update count,
  the compute copy); the scale update; the accumulation buffer zeroed. The
  schedule advances only on an applied step and ``skipped_steps`` counts
  the others (``step :1405-1416``);
- the API: ``forward :1285``, ``backward :1325``, ``step :1383``,
  ``train_batch :1669``, ``eval_batch :1833``, ``get_lr :1959``,
  ``get_mom :1980``, ``get_global_grad_norm :2003``, ``cur_scale`` and
  ``loss_scale()`` (``:2007-2011``).

The state is flat: the fp32 masters, the gradient accumulation buffer and
each optimizer moment are ONE fp32 buffer each, and the per-parameter
tensors are views into them, each starting at a multiple of 64 elements
(256 bytes) so every view a product or a kernel reads stays aligned; the
compute copy (bf16 or fp16) is one more flat buffer whose views are the
model's parameters. So each optimizer step is one K7 launch over the whole
buffer and the refresh of the compute copy one ``copy_``. The padding
between views holds zeros in every buffer and stays zero under every
update.

What differs, by the nature of PyTorch: JAX's ``forward`` computes the
loss and the gradients in one compiled program and ``backward`` only
commits them; here ``forward`` builds the autograd graph and ``backward``
runs it and accumulates. The overflow flag is the global norm's: any
non-finite gradient makes the sum of squares non-finite, and a finite
gradient born in fp16 (at most 65504 per micro-batch, unscaled by a scale
>= 1) cannot overflow it. Buffers update in place where the JAX engine
returns new arrays.

Not ported yet (``ROADMAP.md``): offload, ZeRO 1-3 and the comm layer,
the fused K-step programs, ``data_types.grad_accum_dtype``,
checkpointing, resilience and observability. The engine runs on ``cuda``
unless the caller passes ``device="cpu"``; without CUDA it raises.
"""

from typing import Optional

import torch
from torch.profiler import record_function

from ..config.config import DeepSpeedTorchConfig
from ..utils.device import resolve_device
from . import loss_scaler
from .lr_schedules import get_lr_schedule
from .optimizers import ADAM_DEFAULT_BETAS, build_optimizer

FLAT_ALIGN = 64  # elements: each view of a flat fp32 buffer starts 256-byte aligned


def flat_bounds(numels, align: int = FLAT_ALIGN):
    """``(start, end)`` of each of ``numels`` in one flat buffer, every
    start a multiple of ``align``, and the buffer's length."""
    bounds, total = [], 0
    for n in numels:
        bounds.append((total, total + n))
        total += -(-n // align) * align
    return bounds, total


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
                              else torch.float16 if self._config.fp16_enabled
                              else torch.float32)
        self._use_loss_scaling = self._config.fp16_enabled
        self.scale_state = loss_scaler.initial_state(self._config.fp16_config)
        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self.skipped_steps = 0
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
        self.optimizer = build_optimizer(self._config.optimizer_name, self._flat_master,
                                         self._config.optimizer_params, lr_fn,
                                         bounds=self._bounds)

    @torch.no_grad()
    def _init_state(self, model_parameters):
        """The flat fp32 masters on the device, the model's parameters set
        to views of the flat compute-dtype copy (of the masters themselves
        in fp32), and the flat fp32 gradient accumulation buffer."""
        names = {id(p): n for n, p in self.module.named_parameters()}
        params = (list(model_parameters) if model_parameters is not None
                  else [p for p in self.module.parameters() if p.requires_grad])
        if not params or any(id(p) not in names for p in params):
            raise ValueError("model_parameters must be parameters of model")
        self._params = params
        self.param_names = [names[id(p)] for p in params]
        self._bounds, total = flat_bounds([p.numel() for p in params])

        def views(flat):
            return [flat[a:b].view(p.shape) for (a, b), p in zip(self._bounds, params)]

        self._flat_master = torch.zeros(total, dtype=torch.float32, device=self.device)
        self._masters = views(self._flat_master)
        for p, master in zip(params, self._masters):
            master.copy_(p.detach())
        self._flat_compute = None
        if self.compute_dtype == torch.float32:
            compute = self._masters
        else:
            self._flat_compute = self._flat_master.to(self.compute_dtype)
            compute = views(self._flat_compute)
        for p, c in zip(params, compute):
            p.data = c
            p.requires_grad_(True)
        self._flat_grad = torch.zeros(total, dtype=torch.float32, device=self.device)
        self._grad_acc = views(self._flat_grad)

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
        """Gradients of ``loss / gas`` (times the loss scale under fp16)
        with respect to the compute copy, added into the fp32 accumulation
        buffer."""
        if self._pending is None:
            raise RuntimeError("backward() called without a preceding forward()")
        scaled = loss.float() / self.gradient_accumulation_steps()
        if self._use_loss_scaling:
            scaled = scaled * self.scale_state.cur_scale
        scaled.backward()
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
        """At a gradient-accumulation boundary: unscale, overflow check,
        global norm, clip, optimizer update of the masters and refresh of
        the compute copy (skipped on overflow), loss-scale update, and the
        schedule step of an applied update."""
        if not (self.is_gradient_accumulation_boundary() and self.micro_steps > 0):
            return
        with record_function("optimizer_step"):  # names the step in a profile
            overflow = self._apply_step()
        self.global_steps += 1
        self.global_samples += self.train_batch_size()
        if overflow:
            self.skipped_steps += 1
        elif self.lr_scheduler is not None:
            self.lr_scheduler.step()

    def _apply_step(self) -> bool:
        grads = self._flat_grad
        if self._use_loss_scaling:
            grads.div_(torch.full((), self.scale_state.cur_scale, device=grads.device))
        # per parameter, then over the parameters (optax.global_norm's
        # shape): one fp32 sum over the whole buffer loses ~1e-5 on the CPU
        gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(self._grad_acc)))
        # any non-finite gradient makes the norm non-finite (module docstring)
        overflow = self._use_loss_scaling and not bool(torch.isfinite(gnorm))
        if not overflow:
            clip = self._config.gradient_clipping
            if clip > 0:
                grads.mul_(torch.clamp(clip / (gnorm + 1e-6), max=1.0))
            self.optimizer.step(grads)
            if self._flat_compute is not None:
                self._flat_compute.copy_(self._flat_master)
        self.scale_state = loss_scaler.next_state(self._config.fp16_config,
                                                  self.scale_state, overflow)
        grads.zero_()
        self._last_grad_norm = gnorm
        return overflow

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

    def get_mom(self):
        """The configured betas (the JAX engine's report; a OneCycle
        schedule's cycled momentum is its own ``get_mom()``)."""
        return [tuple(self._config.optimizer_params.get("betas", ADAM_DEFAULT_BETAS))]

    def get_global_grad_norm(self) -> Optional[float]:
        """The global norm of the latest step's gradients, before clipping."""
        return None if self._last_grad_norm is None else float(self._last_grad_norm)

    @property
    def cur_scale(self) -> float:
        """The loss scale the next backward multiplies by."""
        return self.scale_state.cur_scale

    def loss_scale(self) -> float:
        return self.cur_scale
