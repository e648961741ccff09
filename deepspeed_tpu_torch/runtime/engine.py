"""The training engine, ZeRO stage 0 on one device (port of
``deepspeed_tpu/runtime/engine.py``).

What it keeps from the JAX engine:
- the precision policy (``:268-296``): compute in bf16 when ``bf16`` is
  enabled, in fp16 with loss scaling when ``fp16`` is, else fp32; the
  masters are fp32 (``_init_state :511``); ``data_types.grad_accum_dtype``
  (fp32, bf16, or fp16 under fp16 training) is the accumulation buffer's
  dtype, with JAX's errors;
- ``param_cast="engine"`` (``value_and_grads :705``): the model computes
  with the compute-dtype cast of the masters and the gradients are taken
  with respect to that cast, with the loss scaled by ``1/gas`` and then by
  the loss scale (``loss_from_cparams :677``), then added into the
  accumulation buffer (``fwd_bwd``: ``a + g.astype(a.dtype)``);
- ``apply_step :750``, in its order: ``grads = acc.astype(fp32) /
  cur_scale``; overflow if any value is non-finite (fp16 only); the global
  norm and the clip factor ``min(1, clip / (gnorm + 1e-6))``; the update
  (``runtime/optimizers.py``); on overflow nothing moves (masters,
  optimizer state and its update count, the compute copy); the scale
  update; the accumulation buffer zeroed. The schedule advances only on an
  applied step and ``skipped_steps`` counts the others (``step
  :1405-1416``);
- the fused programs: ``fused_train_step :1788`` (gas 1), ``fused_train_steps
  :1843`` (K steps of stacked batches, one fetch of the losses and flags)
  and the gas > 1 ``train_batch`` (``_run_fused_train_batch :1702``: gas
  micro-batches and the apply step, one fetch);
- the engine-level ``activation_checkpointing.remat_policy`` (``:298-303``:
  the whole forward under recompute);
- ``training_data`` (``:470``): a ``DeepSpeedDataLoader`` of micro batches;
- the API: ``forward :1285``, ``backward :1325``, ``step :1383``,
  ``train_batch :1669``, ``eval_batch :1833``, ``get_lr :1959``,
  ``get_mom :1980``, ``get_global_grad_norm :2003``, ``cur_scale`` and
  ``loss_scale()`` (``:2007-2011``).

The step reads nothing on the host. The overflow flag, the loss scale
(``loss_scaler.DeviceLossScaleState``), the optimizer's update count and
its learning rate live on the device, and K7 reads them there
(``ops/fused_optimizer.py``). So ``fused_train_steps`` enqueues its K steps
with no synchronisation between them, as the JAX ``lax.scan`` carries
them, and fetches the ``[K]`` losses and flags once at the end; then the
host counters, the schedule (one ``step()`` per applied update) and the
optimizer's host count are brought up to date. ``step()`` keeps JAX's
per-step host read of the flag. The window is not captured in a CUDA
graph.

The state is flat: the fp32 masters, the gradient accumulation buffer and
each optimizer moment are ONE buffer each, and the per-parameter tensors
are views into them, each starting at a multiple of 64 elements (256
bytes) so every view a product or a kernel reads stays aligned; the
compute copy (bf16 or fp16) is one more flat buffer whose views are the
model's parameters. So each optimizer step is one K7 launch over the whole
buffer and the refresh of the compute copy one ``copy_``. The padding
between views holds zeros in every buffer and stays zero under every
update. Under a bf16 or fp16 accumulation buffer the step first makes an
fp32 copy of it, as JAX casts ``acc`` before the unscale, and the norm,
clip and K7 read that copy.

What differs, by the nature of PyTorch: JAX's ``forward`` computes the
loss and the gradients in one compiled program and ``backward`` only
commits them; here ``forward`` builds the autograd graph and ``backward``
runs it and accumulates. The overflow flag is the global norm's: any
non-finite gradient makes the sum of squares non-finite, and a finite
gradient born in fp16 (at most 65504 per micro-batch, unscaled by a scale
>= 1) cannot overflow it. Buffers update in place where the JAX engine
returns new arrays.

Not ported yet (``ROADMAP.md``): offload, ZeRO 1-3 and the comm layer,
the async step window (``_AsyncStepWindow``, ``get_loss``), checkpointing,
resilience and observability. The engine runs on ``cuda`` unless the
caller passes ``device="cpu"``; without CUDA it raises.
"""

from typing import Optional

import torch
from torch.profiler import record_function

from ..config.config import DeepSpeedTorchConfig
from ..utils.device import resolve_device
from ..utils.dtypes import resolve_dtype
from . import loss_scaler
from .activation_checkpointing import checkpointing
from .dataloader import DeepSpeedDataLoader
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


def grad_accum_dtype(config, use_loss_scaling: bool) -> torch.dtype:
    """``data_types.grad_accum_dtype`` with the JAX engine's rules and
    messages (``:277-296``): fp32 by default, bf16, or fp16 only under fp16
    training (its overflow check turns saturation into a skipped step)."""
    try:
        dtype = resolve_dtype(config.data_types_config.get("grad_accum_dtype"),
                              torch.float32)
    except ValueError as e:
        raise ValueError(f"data_types.grad_accum_dtype: {e}") from None
    if dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError("data_types.grad_accum_dtype must be fp32/bf16/fp16")
    if dtype == torch.float16 and not use_loss_scaling:
        raise ValueError("grad_accum_dtype=fp16 requires fp16 training "
                         "(loss scaling + overflow skip); use bf16 or "
                         "fp32 accumulation otherwise")
    return dtype


def _batch(item):
    return item if isinstance(item, tuple) else (item, )


def _extract_loss(out):
    """Contract: the model returns loss, (loss, aux) or a dict with 'loss'."""
    if isinstance(out, tuple):
        return out[0]
    if isinstance(out, dict):
        return out["loss"]
    return out


class DeepSpeedTorchEngine:

    def __init__(self, model, model_parameters=None, config=None,
                 lr_scheduler=None, device=None, training_data=None, collate_fn=None):
        self._config = DeepSpeedTorchConfig(config if config is not None else {})
        self.device = resolve_device(device)
        self.module = model.to(self.device)
        self.compute_dtype = (torch.bfloat16 if self._config.bf16_enabled
                              else torch.float16 if self._config.fp16_enabled
                              else torch.float32)
        self._use_loss_scaling = self._config.fp16_enabled
        self.grad_accum_dtype = grad_accum_dtype(self._config, self._use_loss_scaling)
        self.scale_state = loss_scaler.to_device(
            loss_scaler.initial_state(self._config.fp16_config), self.device)
        self._no_overflow = torch.zeros((), dtype=torch.bool, device=self.device)
        self._remat_policy = self._config.activation_checkpointing_config.remat_policy
        checkpointing.resolve_policy(self._remat_policy)
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
        self.training_dataloader = None
        if training_data is not None:
            self.training_dataloader = DeepSpeedDataLoader(
                training_data, batch_size=self.train_micro_batch_size_per_gpu(),
                collate_fn=collate_fn)

    @torch.no_grad()
    def _init_state(self, model_parameters):
        """The flat fp32 masters on the device, the model's parameters set
        to views of the flat compute-dtype copy (of the masters themselves
        in fp32), and the flat gradient accumulation buffer."""
        names = {id(p): n for n, p in self.module.named_parameters()}
        params = (list(model_parameters) if model_parameters is not None
                  else [p for p in self.module.parameters() if p.requires_grad])
        if not params or any(id(p) not in names for p in params):
            raise ValueError("model_parameters must be parameters of model")
        self._params = params
        self.param_names = [names[id(p)] for p in params]
        self._bounds, total = flat_bounds([p.numel() for p in params])
        self._shapes = [p.shape for p in params]

        self._flat_master = torch.zeros(total, dtype=torch.float32, device=self.device)
        self._masters = self._views(self._flat_master)
        for p, master in zip(params, self._masters):
            master.copy_(p.detach())
        self._flat_compute = None
        if self.compute_dtype == torch.float32:
            compute = self._masters
        else:
            self._flat_compute = self._flat_master.to(self.compute_dtype)
            compute = self._views(self._flat_compute)
        for p, c in zip(params, compute):
            p.data = c
            p.requires_grad_(True)
        self._flat_grad = torch.zeros(total, dtype=self.grad_accum_dtype, device=self.device)
        self._grad_acc = self._views(self._flat_grad)

    def _views(self, flat):
        """Each parameter's shaped view into the flat buffer ``flat``."""
        return [flat[a:b].view(shape) for (a, b), shape in zip(self._bounds, self._shapes)]

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
        out = (checkpointing.checkpoint_with(self._remat_policy, self.module, *args, **kwargs)
               if self._remat_policy else self.module(*args, **kwargs))
        loss = _extract_loss(out)
        self._pending = loss
        return loss

    def backward(self, loss):
        """Gradients of ``loss / gas`` (times the loss scale under fp16)
        with respect to the compute copy, added into the accumulation
        buffer (each gradient cast to the buffer's dtype first)."""
        if self._pending is None:
            raise RuntimeError("backward() called without a preceding forward()")
        scaled = loss.float() / self.gradient_accumulation_steps()
        if self._use_loss_scaling:
            scaled = scaled * self.scale_state.cur_scale
        scaled.backward()
        narrow = self.grad_accum_dtype != torch.float32
        with torch.no_grad():
            for p, acc in zip(self._params, self._grad_acc):
                if p.grad is not None:
                    acc.add_(p.grad.to(acc.dtype) if narrow else p.grad)
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
        schedule step of an applied update. Under fp16 the host reads the
        step's overflow flag, as the JAX engine's ``step`` does."""
        if not (self.is_gradient_accumulation_boundary() and self.micro_steps > 0):
            return
        overflow = self._apply_step()
        self._settle([bool(overflow)] if self._use_loss_scaling else [False])

    @torch.no_grad()
    def _apply_step(self) -> torch.Tensor:
        """The update from the accumulated gradients, with no host read;
        returns the overflow flag (a 0-d bool tensor, False but under
        fp16)."""
        with record_function("optimizer_step"):  # names the step in a profile
            acc = self._flat_grad
            grads = acc if acc.dtype == torch.float32 else acc.float()
            if self._use_loss_scaling:
                grads.div_(self.scale_state.cur_scale)
            # per parameter, then over the parameters (optax.global_norm's
            # shape): one fp32 sum over the whole buffer loses ~1e-5 on the CPU
            gnorm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(self._views(grads))))
            overflow = None
            if self._use_loss_scaling:  # any non-finite gradient: a non-finite norm
                overflow = torch.logical_not(torch.isfinite(gnorm))
            clip = self._config.gradient_clipping
            if clip > 0:
                grads.mul_(torch.clamp(clip / (gnorm + 1e-6), max=1.0))
            self.optimizer.step(grads, skip=overflow)
            if self._flat_compute is not None:  # the masters' cast, moved or not
                self._flat_compute.copy_(self._flat_master)
            overflow = self._no_overflow if overflow is None else overflow
            self.scale_state = loss_scaler.next_device_state(self._config.fp16_config,
                                                             self.scale_state, overflow)
            acc.zero_()
            self._last_grad_norm = gnorm
        return overflow

    def _settle(self, overflows):
        """The host's bookkeeping of applied steps whose overflow flags it
        has read: the step and sample counts, ``skipped_steps``, the
        optimizer's host count and one schedule step per applied update."""
        applied = overflows.count(False)
        self.global_steps += len(overflows)
        self.global_samples += len(overflows) * self.train_batch_size()
        self.skipped_steps += len(overflows) - applied
        if self._use_loss_scaling:
            self.optimizer.settle(applied)
        if self.lr_scheduler is not None:
            for _ in range(applied):
                self.lr_scheduler.step()

    def _fetch(self, t: torch.Tensor) -> torch.Tensor:
        """The host's one read of a window: ``t`` copied to the CPU."""
        return t.cpu()

    def _require_gas_one(self, what: str):
        if self.gradient_accumulation_steps() != 1:
            raise AssertionError(f"{what} requires gradient_accumulation_steps == 1")

    def _train_window(self, batches):
        """Forward, backward and the apply step of each ``(args, kwargs)``
        in ``batches``, enqueued with no host read; returns the ``[K]``
        losses and overflow flags on the device."""
        self._training = True
        self.optimizer.begin_window(len(batches))
        losses, overflows = [], []
        for args, kwargs in batches:
            loss = self.forward(*args, **kwargs)
            self.backward(loss)
            overflows.append(self._apply_step())
            losses.append(loss.detach().float())
        return torch.stack(losses), torch.stack(overflows)

    def fused_train_step(self, *args, **kwargs):
        """``forward``, ``backward`` and ``step`` of one batch (gas 1 only),
        with the host reading only the overflow flag; returns the loss as a
        device scalar."""
        self._require_gas_one("fused_train_step")
        losses, overflows = self._train_window([(args, kwargs)])
        self._settle(self._fetch(overflows).tolist())
        return losses[0]

    def fused_train_steps(self, *args, **kwargs):
        """K optimizer steps of stacked batches with one host read: every
        tensor argument carries a leading ``[K, ...]`` axis and step ``i``
        takes slice ``i``. The same steps as K ``fused_train_step`` calls
        (gas 1 only), enqueued with no synchronisation between them; then
        one fetch of the losses and overflow flags, and the host's
        bookkeeping. Returns the ``[K]`` losses (fp32, on the host)."""
        self._require_gas_one("fused_train_steps")
        args = tuple(self._to_device(a) for a in args)
        kwargs = {k: self._to_device(v) for k, v in kwargs.items()}
        lead = {t.shape[0] for t in (*args, *kwargs.values()) if isinstance(t, torch.Tensor)}
        if len(lead) != 1 or 0 in lead:
            raise ValueError("fused_train_steps: every tensor argument needs one "
                             f"leading step axis [K, ...] of K >= 1, got {sorted(lead)}")
        K = lead.pop()

        def at(x, i):
            return x[i] if isinstance(x, torch.Tensor) else x

        losses, overflows = self._train_window(
            [(tuple(at(a, i) for a in args), {k: at(v, i) for k, v in kwargs.items()})
             for i in range(K)])
        host = self._fetch(torch.cat([losses, overflows.float()]))
        self._settle([bool(f) for f in host[K:]])
        return host[:K]

    def train_batch(self, data_iter=None):
        """One optimizer step over ``gradient_accumulation_steps``
        micro-batches (each item of ``data_iter``: a tuple of the model's
        positional arguments, or one tensor): at gas 1 ``fused_train_step``,
        above it the micro-batches and the apply step with one fetch.
        Returns the mean loss as a float."""
        self._training = True
        gas = self.gradient_accumulation_steps()
        if gas == 1:
            return float(self.fused_train_step(*_batch(next(data_iter))))
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for _ in range(gas):
            loss = self.forward(*_batch(next(data_iter)))
            self.backward(loss)
            total = total + loss.detach().float()  # the JAX scan's fp32 sum
        overflow = self._apply_step()
        host = self._fetch(torch.stack([total / gas, overflow.float()]))
        self._settle([bool(host[1])])
        return float(host[0])

    @torch.no_grad()
    def eval_batch(self, *args, **kwargs):
        """The model's output with no gradient."""
        args = tuple(self._to_device(a) for a in args)
        kwargs = {k: self._to_device(v) for k, v in kwargs.items()}
        return self.module(*args, **kwargs)

    # ---- info ----

    def train_batch_size(self):
        return self._config.train_batch_size

    def train_micro_batch_size_per_gpu(self):
        return self._config.train_micro_batch_size_per_gpu

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
        """The loss scale the next backward multiplies by (a host read)."""
        return float(self.scale_state.cur_scale)

    def loss_scale(self) -> float:
        return self.cur_scale
