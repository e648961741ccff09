"""The training engine, ZeRO stages 0-3 over the named mesh (port of
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

ZeRO and the mesh (the JAX engine's ``:160-265``, ``:328-360``,
``:514-590``). With ``zero_optimization.stage`` above 0, a ``mesh``
section, or ``torch.distributed`` initialized, the engine joins the named
mesh (``comm.init_distributed``; one process needs no process group) and
the batch triangle is resolved over the data-parallel world ``data x
fsdp``. The engine takes the global batch, as the JAX engine does, and
each rank computes on its rows (``zero_sharding.ZeroShardingPlan.
batch_rows``). The loss is the token mean over the global batch: each
rank's loss is weighted by its share of the global count of labels that
count (``module.loss_token_count``, which a module trained across ranks
must give), so that the
gradients summed over the ranks are those of the global mean, however
unevenly ``ignore_index`` labels fall; the loss returned is the global
one. The state is laid out in units (``zero_sharding.FlatLayout``); each
rank keeps its shards of the masters and the optimizer state (stage 1), of
the accumulation buffer (stage 2) and of the compute copy (stage 3,
gathered on use, ``runtime/zero3.py``). Stage 1 accumulates whole
gradients and reduce-scatters them at the boundary; stages 2-3
reduce-scatter each micro-step's gradients into the shard; the replicas of
the ZeRO group then all-reduce the shard. The global norm is per
parameter, then over the parameters: per-parameter partial sums of
squares all-reduced over the ZeRO group, then the square roots, so the
overflow flag, the clip factor and K7's skip flag agree on every rank with
no host read. K7 runs once per step on the rank's shard. Stages 1-2 then
all-gather the updated shard's cast into the whole compute copy. Stage 0
across ranks all-reduces the whole accumulation buffer at the boundary.
The ``pipe``, ``seq``, ``expert`` and ``model`` axes are not ported yet
and raise.

The wires (``:888-970``). With ``gradient_comm`` active and supported,
``train_batch`` runs the bucketed gradient wire (``runtime/grad_comm.py``)
at any ``gradient_accumulation_steps``, the flat state is laid out by its
bucket plan, and ``fused_train_step(s)`` raise. At stage 3 the wire is the
scheduled ZeRO-3 store (``runtime/zero3_schedule.py``, installed before
the optimizer, so the moments are bucket shards): ``train_batch`` runs its
scheduled step, and ``forward``/``eval_batch`` read the parameters
through its schedule too. With ``onebitadam`` or ``onebitlamb`` and
``comm_backend_name`` at gas 1, ``fused_train_step`` (and so
``train_batch``) runs the compressed momentum exchange
(``runtime/onebit_wire.py``) from step ``freeze_step`` on, decided on the
host by the step number, and ``fused_train_steps`` raises. It takes
precedence over ``gradient_comm``. A config either wire cannot run (fp16,
axes beyond data and fsdp, ...) logs a warning and keeps the default
reduce, as the JAX engine does. ``forward``/``backward``/``step`` always
keep the default reduce.

Checkpointing (``:2032-2420``): ``save_checkpoint`` writes each rank's
flat state and its layout, rank 0 the host state, and seals the tag
(``checkpoint/engine.py``); ``load_checkpoint`` falls back through older
tags past a torn or corrupt one, and reads the ranges its own layout needs,
so a checkpoint of any world and stage (2 or 3, the store or not) loads
into any other; ``load_universal_checkpoint``, ``full_params`` and
``save_16bit_model``. Resilience (``:1055-1230``): the ``resilience``
section's preemption handlers (restored by ``destroy``), interval
autosave and retention, ``auto_resume``, and the anomaly sentry's
rollback, which keeps the data sampler's position; sync mode only.

Not ported yet (``ROADMAP.md``): offload, the async step window
(``_AsyncStepWindow``, ``get_loss``) and observability. The engine
runs on ``cuda`` unless the caller passes ``device="cpu"``; without CUDA
it raises.
"""

import contextlib
import logging
import os
import time
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from .. import zero
from ..comm import comm
from ..checkpoint.engine import (COMMIT_MARKER_FILE, MANIFEST_FILE, CheckpointCorruptionError,
                                 ShardedReader,
                                 TorchCheckpointEngine, find_latest_valid_checkpoint,
                                 prune_checkpoints, quarantine_checkpoint, read_host_state,
                                 read_latest_tag, verify_checkpoint, write_latest_tag)
from ..comm.mesh import get_mesh_context, mesh_is_initialized
from ..config.config import DeepSpeedTorchConfig
from ..models.convert import universal_name
from ..utils.device import resolve_device
from ..utils.dtypes import resolve_dtype
from ..utils.fault_injection import get_fault_injector
from . import loss_scaler
from .activation_checkpointing import checkpointing
from .dataloader import DeepSpeedDataLoader
from .grad_comm import GradCommWire, grad_comm_supported, plan_wire
from .lr_schedules import get_lr_schedule
from .optimizers import ADAM_DEFAULT_BETAS, build_optimizer
from .zero3 import GatherUnits, GradReducer
from .zero3_schedule import Zero3Store, init_param_store
from .onebit import ONEBIT_DEFAULT_FREEZE_STEP
from .onebit_wire import wire_step, wire_supported
from .zero_governor import max_live_advisory
from .zero_sharding import (FlatLayout, Unit, ZeroShardingPlan, flat_bounds,  # noqa: F401
                            model_units)

logger = logging.getLogger(__name__)
UNPORTED_AXES = ("pipe", "seq", "expert", "model")


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
                 lr_scheduler=None, device=None, training_data=None, collate_fn=None,
                 mesh_param=None, distributed_port=29500, dist_init_required=None):
        raw = config if config is not None else {}
        self._config = DeepSpeedTorchConfig(raw, world_size=self._dp_world_from(raw))
        self.device = resolve_device(device)
        zc = self._config.zero_config
        self.mesh_ctx = self._join_mesh(mesh_param, distributed_port, dist_init_required)
        self.dp_world_size = self.mesh_ctx.dp_size if self.mesh_ctx is not None else 1
        self._config.reresolve(self.dp_world_size)
        self.zero_plan = ZeroShardingPlan(self.mesh_ctx, zc.stage,
                                          zc.param_persistence_threshold)
        if "comms_logger" in self._config._param_dict:
            comm.configure(self._config)
        self.module = model if zc.stage >= 3 else model.to(self.device)
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
        self._last_overflows = []
        self._pending = None
        self._training = True
        self._last_grad_norm = None
        self._local = None  # this step's local loss, weighted for the global mean
        self._onebit_wire, self._wire_freeze_step = False, 0
        bucketed = self._choose_wire()
        for key in ("zero_quantized_weights", "zero_quantized_gradients"):
            if getattr(zc, key) and not bucketed:
                raise NotImplementedError(
                    f"zero_optimization.{key} (ZeRO++) is ported only as the scheduled ZeRO-3 "
                    "store's int8 tier, which does not run here (it needs a pure data-parallel "
                    "mesh whose ZeRO group is the whole dp world and bf16/fp32)")
        self._init_state(model_parameters, bucketed)
        self._wire = None
        if bucketed:
            self._wire = self._store or GradCommWire(self, self._bucket_layout)
        if zc.stage >= 3:
            advice = max_live_advisory(sum(p.numel() for p in self._params),
                                       zc.max_live_parameters,
                                       bool(getattr(getattr(model, "config", None),
                                                    "scan_layers", False)))
            if advice:
                logger.warning(advice)

        base_lr = float(self._config.optimizer_params.get("lr", 1e-3))
        self._base_lr = base_lr
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is None and self._config.scheduler_name is not None:
            self.lr_scheduler = get_lr_schedule(self._config.scheduler_name,
                                                self._config.scheduler_params,
                                                base_lr=base_lr)
        lr_fn = self.lr_scheduler.lr_at if self.lr_scheduler is not None else None
        self.optimizer = build_optimizer(
            self._config.optimizer_name, self._flat_master, self._config.optimizer_params,
            lr_fn, bounds=self._bounds, norms=self._piece_norms if self._sharded else None,
            sums=self._piece_sums if self._sharded else None,
            owners=[i for i, _, _, _ in self.layout.pieces] if self._sharded else None,
            names=self.param_names, shapes=self._shapes,
            whole_numels=[p.numel() for p in self._params])
        self.training_dataloader = None
        if training_data is not None:
            self.training_dataloader = DeepSpeedDataLoader(
                training_data, batch_size=self.train_micro_batch_size_per_gpu(),
                collate_fn=collate_fn)
        self.checkpoint_engine = self._make_checkpoint_engine()
        self._init_resilience()

    @staticmethod
    def _dp_world_from(raw) -> int:
        """The data-parallel world before the mesh exists (``data x fsdp``
        of the config's mesh over the process group's ranks), so the batch
        triangle validates as the JAX engine's ``_dp_world_from`` does."""
        import json
        import torch.distributed as dist
        from ..comm.mesh import MESH_AXES, resolve_axis_sizes
        if isinstance(raw, str):
            with open(raw) as f:
                raw = json.load(f)
        if mesh_is_initialized():
            return get_mesh_context().dp_size
        n = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
        mesh = dict(raw.get("mesh") or {}) if isinstance(raw, dict) else {}
        mesh.pop("axis_order", None)
        if mesh and all(v != -1 for v in mesh.values()) and "data" not in mesh:
            mesh["data"] = -1
        try:
            sizes = resolve_axis_sizes(n, mesh or {"data": -1}, MESH_AXES)
        except ValueError:
            return n
        return sizes["data"] * sizes["fsdp"]

    def _join_mesh(self, mesh_param, distributed_port, dist_init_required):
        """The mesh context when ZeRO, a ``mesh`` section, the gradient
        wire, ``mesh_param`` or an initialized process group asks for one
        (joining it through ``comm.init_distributed`` when none exists),
        else None."""
        import torch.distributed as dist
        zc, pd = self._config.zero_config, self._config._param_dict
        wanted = (zc.stage > 0 or "mesh" in pd or mesh_param is not None
                  or self._config.gradient_comm_config.active
                  or dist_init_required or (dist.is_available() and dist.is_initialized()))
        if mesh_is_initialized():
            ctx = get_mesh_context()
        elif wanted:
            axes = self._config.mesh_config.axis_sizes()
            if mesh_param is not None:  # reference mesh_param=(dp, sp)
                axes = {"data": mesh_param[0], "seq": mesh_param[1]}
            ctx = comm.init_distributed(distributed_port=distributed_port,
                                        dist_init_required=dist_init_required, mesh_axes=axes)
        else:
            return None
        split = {a: ctx.axis_size(a) for a in UNPORTED_AXES if ctx.axis_size(a) > 1}
        if split:
            raise NotImplementedError(f"mesh axes {split} are not ported yet: the port's "
                                      "engine runs the data and fsdp axes")
        return ctx

    def _choose_wire(self) -> bool:
        """Which wire runs (the JAX engine's ``:888-970``): sets the 1-bit
        wire's flag and freeze step; returns whether the bucketed gradient
        wire runs."""
        cfg = self._config
        op = cfg.optimizer_params
        if ((cfg.optimizer_name or "") in ("onebitadam", "onebitlamb")
                and op.get("comm_backend_name") and cfg.gradient_accumulation_steps == 1):
            if wire_supported(self):
                self._onebit_wire = True
                self._wire_freeze_step = int(op.get("freeze_step", ONEBIT_DEFAULT_FREEZE_STEP))
            else:
                logger.warning("1-bit wire program unavailable (it needs gas=1, ZeRO stage 0, "
                               "bf16/fp32, a pure data-parallel mesh and no gradient "
                               "clipping); gradients exchange uncompressed fp32; consider "
                               "gradient_comm's onebit tier, which composes with ZeRO 1-2")
        if not cfg.gradient_comm_config.active or self._onebit_wire:
            return False
        if grad_comm_supported(self):
            return True
        logger.warning("gradient_comm requested but unsupported here (it needs a pure "
                       "data-parallel mesh, bf16/fp32, for a quantized tier more than one rank, "
                       "and at stage 3 a ZeRO group that is the whole data-parallel world); "
                       "gradients exchange through the default reduce")
        return False

    @torch.no_grad()
    def _init_state(self, model_parameters, bucketed=False):
        """The flat fp32 masters (this rank's shards of them at stage >= 1),
        the model's parameters set to views of the flat compute-dtype copy
        (of the masters themselves in fp32 at stage 0; gathered on use at
        stage 3), and the flat gradient accumulation buffer (this rank's
        shard at stage >= 2). ``bucketed``: laid out by the gradient wire's
        bucket plan."""
        names = {id(p): n for n, p in self.module.named_parameters()}
        params = (list(model_parameters) if model_parameters is not None
                  else [p for p in self.module.parameters() if p.requires_grad])
        if not params or any(id(p) not in names for p in params):
            raise ValueError("model_parameters must be parameters of model")
        self._params = params
        self._index = {id(p): i for i, p in enumerate(params)}
        self.param_names = [names[id(p)] for p in params]
        self._shapes = [p.shape for p in params]
        numels = [p.numel() for p in params]
        plan = self.zero_plan
        self._sharded = plan.stage >= 1
        self._bucket_layout = self._zero3_store = self._store = None
        self._zero3_schedule = None
        if bucketed and plan.shard_params:  # the scheduled ZeRO-3 store
            self._zero3_store, units = init_param_store(self, self.param_names, self._shapes)
            unit_modules = [[] for _ in units]
        elif bucketed:
            self._bucket_layout, units = plan_wire(self.param_names, self._shapes,
                                                   self.dp_world_size, plan.zero_size,
                                                   self._config.gradient_comm_config)
            unit_modules = [[] for _ in units]
        elif self._sharded:
            units, unit_modules = model_units(self.module, params, numels, plan.zero_size,
                                              plan.param_persistence_threshold)
        else:
            units, unit_modules = [Unit("all", range(len(params)), numels, 1)], [[]]
        self.layout = FlatLayout(units, len(params), plan.zero_size, plan.zero_index())
        self._bounds = ([(s, e) for _, s, e, _ in self.layout.pieces] if self._sharded
                        else self.layout.full_bounds)
        self._gather = self._reducer = None
        # each piece's parameter, on the device once (no copy inside a step)
        self._owners = torch.tensor([i for i, _, _, _ in self.layout.pieces], dtype=torch.long,
                                    device=self.device)

        if plan.shard_params:  # only this rank's shards reach the device
            trained = set(self._index)
            for m in self.module.modules():
                for key, p in m.named_parameters(recurse=False):
                    if id(p) not in trained:
                        p.data = p.data.to(self.device)
                for key, b in m.named_buffers(recurse=False):
                    setattr(m, key, b.to(self.device))
        self._flat_master = torch.zeros(self.layout.shard_numel, dtype=torch.float32,
                                        device=self.device)
        for i, s, e, off in self.layout.pieces:
            self._flat_master[s:e].copy_(params[i].detach().reshape(-1)[off:off + e - s])
        self._masters = (self.layout.piece_views(self._flat_master) if self._sharded
                         else self._views(self._flat_master))
        for p in params:
            p.requires_grad_(True)
        self._flat_compute = None
        if self._zero3_store is not None:
            self._store = Zero3Store(self, self._zero3_store)
        elif plan.shard_params:
            self._flat_compute = (self._flat_master if self.compute_dtype == torch.float32
                                  else self._flat_master.to(self.compute_dtype))
            self._gather = GatherUnits(self.layout, params, self._shapes, self._flat_compute,
                                       unit_modules, plan.zero_axes, self.compute_dtype,
                                       self.device)
        elif self._sharded:
            self._flat_compute = torch.empty(self.layout.full_numel, dtype=self.compute_dtype,
                                             device=self.device)
            for p, c in zip(params, self.layout.full_views(self._flat_compute, self._shapes)):
                p.data = c
            self._refresh_compute()
        else:
            if self.compute_dtype == torch.float32:
                compute = self._masters
            else:
                self._flat_compute = self._flat_master.to(self.compute_dtype)
                compute = self._views(self._flat_compute)
            for p, c in zip(params, compute):
                p.data = c
        self._grad_acc = None
        if plan.shard_grads:
            self._flat_grad = torch.zeros(self.layout.shard_numel, dtype=self.grad_accum_dtype,
                                          device=self.device)
            if self._store is None:  # the store's gather reduces in its backward
                self._reducer = GradReducer(
                    self.layout, params, self._flat_grad, plan.zero_axes,
                    on_reduced=self._gather.release if self._gather is not None else None)
        else:
            self._flat_grad = torch.zeros(self.layout.full_numel, dtype=self.grad_accum_dtype,
                                          device=self.device)
            self._grad_acc = self.layout.full_views(self._flat_grad, self._shapes)
        zero.register(self, params)

    def _views(self, flat):
        """Each parameter's shaped view into the flat buffer ``flat``."""
        return [flat[a:b].view(shape) for (a, b), shape in zip(self._bounds, self._shapes)]

    @torch.no_grad()
    def _refresh_compute(self):
        """The compute copy from the masters: a cast (stage 0), the cast
        shard all-gathered into the whole copy per unit (stages 1-2), the
        cast shard and the persistent unit gathered (stage 3)."""
        plan = self.zero_plan
        if self._store is not None:
            self._store.refresh_persistent()
            return
        if not self._sharded or plan.shard_params:
            if self._flat_compute is not None and self._flat_compute is not self._flat_master:
                self._flat_compute.copy_(self._flat_master)
            if self._gather is not None:
                self._gather.refresh_persistent()
            return
        shard = (self._flat_master if self.compute_dtype == torch.float32
                 else self._flat_master.to(self.compute_dtype))
        for u in self.layout.units:
            comm.all_gather_into_tensor(self.layout.unit_full(self._flat_compute, u),
                                        self.layout.unit_shard(shard, u), group=plan.zero_axes)

    def _param_sums(self, partials):
        """Each parameter's sum from ``partials``, one per piece of this
        rank's flat state (``layout.pieces``): added per parameter and
        all-reduced over the ZeRO group."""
        sums = torch.zeros(self.layout.n_params, dtype=torch.float32, device=self.device)
        if partials.numel():
            sums.index_add_(0, self._owners, partials)
        return comm.all_reduce(sums, group=self.zero_plan.zero_axes)

    def _param_norms(self, views):
        """Each parameter's norm from ``views``, the pieces of this rank's
        flat state: the pieces' sums of squares summed per parameter
        (``_param_sums``), then the square roots."""
        squares = (torch.stack(torch._foreach_norm(views)).square() if views
                   else torch.zeros(0, dtype=torch.float32, device=self.device))
        return self._param_sums(squares).sqrt()

    def _piece_norms(self, views):
        """The norm of each piece's whole parameter (LAMB's trust ratio)."""
        return self._param_norms(views)[self._owners]

    def _piece_sums(self, partials):
        """The sum of each piece's whole parameter from the pieces'
        ``partials`` (the 1-bit optimizers' scale)."""
        return self._param_sums(partials)[self._owners]

    def master_params(self):
        """``{name: fp32 master}`` (the engine's own tensors): whole shaped
        views at stage 0, this rank's 1-D pieces of each parameter that
        its shards hold at stage >= 1."""
        if not self._sharded:
            return dict(zip(self.param_names, self._masters))
        return {self.param_names[i]: m for (i, _, _, _), m in zip(self.layout.pieces,
                                                                   self._masters)}

    @torch.no_grad()
    def full_master_params(self):
        """``{name: whole fp32 master}``, all-gathered over the ZeRO group
        (a collective: every rank calls it)."""
        if not self._sharded:
            return dict(zip(self.param_names, self._masters))
        full = torch.empty(self.layout.full_numel, dtype=torch.float32, device=self.device)
        for u in self.layout.units:
            comm.all_gather_into_tensor(self.layout.unit_full(full, u),
                                        self.layout.unit_shard(self._flat_master, u),
                                        group=self.zero_plan.zero_axes)
        return dict(zip(self.param_names, self.layout.full_views(full, self._shapes)))

    def state_bytes(self):
        """The bytes of this rank's flat state: the masters, each optimizer
        moment, the accumulation buffer and the compute copy (at stage 3
        its shards and the persistent unit's whole buffer)."""
        out = {"masters": self._flat_master.nbytes}
        out.update({k: v.nbytes for k, v in self.optimizer.state.items()})
        out["grad_acc"] = self._flat_grad.nbytes
        compute = self._flat_compute
        out["compute"] = 0 if compute is None or compute is self._flat_master else compute.nbytes
        if self._gather is not None:
            out["compute"] += sum(f.nbytes for u, f in zip(self.layout.units, self._gather.full)
                                  if u.persistent and f is not None)
        if self._store is not None and self._store.pers_full is not None:
            out["compute"] += self._store.pers_full.nbytes
        return out

    # ---- zero.GatheredParameters ----

    def _user_gather(self, params):
        """Gather and pin the stage-3 units of ``params``; returns them."""
        if self._store is not None:
            raise NotImplementedError("zero.GatheredParameters under the scheduled ZeRO-3 store: "
                                      "read whole parameters with engine.full_params()")
        if self._gather is None:
            return []
        ks = sorted({self.layout.unit_of[self._index[id(p)]] for p in params})
        for k in ks:
            self._gather.materialize(k)
            self._gather.pins[k] += 1
        return ks

    @torch.no_grad()
    def _user_release(self, params, ks, modifier_rank=None):
        """Unpin the units ``ks``; with ``modifier_rank`` (an index along the
        data-parallel axes) first broadcast that rank's values of
        ``params`` and write them into every rank's masters and compute
        shards."""
        if modifier_rank is not None:
            by_param = {}
            for (i, s, e, off) in self.layout.pieces:
                by_param.setdefault(i, []).append((s, e, off))
            for p in params:
                i = self._index[id(p)]
                comm.broadcast(p.data, src=modifier_rank, group=self.zero_plan.dp_axes)
                flat = p.data.reshape(-1)
                for s, e, off in by_param.get(i, []):
                    self._flat_master[s:e].copy_(flat[off:off + e - s])
                    if self._gather is not None and self._flat_compute is not self._flat_master:
                        self._flat_compute[s:e].copy_(flat[off:off + e - s])
        for k in ks:
            self._gather.pins[k] -= 1
            self._gather.release(k)
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
        args, kwargs = self._local_batch(*self._fault_poison(args, kwargs))
        loss = self._module_loss(args, kwargs)
        self._pending = loss
        if self.dp_world_size > 1:
            self._local, loss = self._global_loss(loss, args, kwargs)
        return loss

    def _module_loss(self, args, kwargs):
        """The model's loss on this rank's ``args``/``kwargs``, with its
        autograd graph (under the remat policy; stage 3 gathers on use)."""
        if self._store is not None:  # the parameters read through its schedule
            return _extract_loss(self._store.call(args, kwargs))
        with self._gather.saved_tensors() if self._gather is not None else contextlib.nullcontext():
            out = (checkpointing.checkpoint_with(self._remat_policy, self.module, *args,
                                                 **kwargs)
                   if self._remat_policy else self.module(*args, **kwargs))
        return _extract_loss(out)

    def _local_loss(self, *args, **kwargs):
        """The loss of this rank's rows of the global batch alone (the
        wires' micro-step loss: no token weighting)."""
        return self._module_loss(*self._local_batch(*self._fault_poison(args, kwargs)))

    def _local_batch(self, args, kwargs):
        """The arguments on the device, each batch tensor cut to this
        rank's rows."""
        rows = self.zero_plan.batch_rows
        return (tuple(rows(self._to_device(a)) for a in args),
                {k: rows(self._to_device(v)) for k, v in kwargs.items()})

    def _global_loss(self, loss, args, kwargs):
        """``(local, global)``: this rank's loss weighted by its share of
        the global count of counted labels, and the token mean over the
        global batch (one all-reduce of the counts and the weighted
        sums)."""
        count = getattr(self.module, "loss_token_count", None)
        n = count(*args, **kwargs) if count is not None else None
        if n is None:
            raise ValueError(
                f"{type(self.module).__name__} gives no loss_token_count for this batch: across "
                f"{self.dp_world_size} data-parallel ranks the engine weights each rank's loss "
                "by its share of the tokens the global mean averages over")
        lf, n = loss.float(), n.float()
        both = comm.all_reduce(torch.stack([n, lf.detach() * n]), group=self.zero_plan.dp_axes)
        denom = both[0].clamp(min=1.0)
        return lf * (n / denom), both[1] / denom

    def backward(self, loss):
        """Gradients of ``loss / gas`` (times the loss scale under fp16)
        with respect to the compute copy, added into the accumulation
        buffer (each gradient cast to the buffer's dtype first)."""
        if self._pending is None:
            raise RuntimeError("backward() called without a preceding forward()")
        if self._local is not None:  # across ranks: the weighted local loss
            loss, self._local = self._local, None
        scaled = loss.float() / self.gradient_accumulation_steps()
        if self._use_loss_scaling:
            scaled = scaled * self.scale_state.cur_scale
        scaled.backward()
        if self._store is not None:  # the shards' gradients, summed over the ranks
            self._store.collect(self._flat_grad)
        elif self._reducer is not None:  # stages 2-3: reduce-scattered into the shard
            self._reducer.flush()
            if self._gather is not None:
                self._gather.release_all()
        else:
            self._accumulate_grads()
        self._pending = None
        self.losses = loss.detach()
        self.micro_steps += 1
        return loss

    @torch.no_grad()
    def _accumulate_grads(self):
        """Each parameter's ``.grad`` added into the whole accumulation
        buffer (cast to its dtype first), and dropped."""
        narrow = self.grad_accum_dtype != torch.float32
        for p, acc in zip(self._params, self._grad_acc):
            if p.grad is not None:
                acc.add_(p.grad.to(acc.dtype) if narrow else p.grad)
                p.grad = None

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
        self._resilience_step_boundary(self.losses)

    @torch.no_grad()
    def _apply_step(self, grads=None) -> torch.Tensor:
        """The update from the accumulated gradients (or from ``grads``,
        the fp32 gradients of this rank's flat state a wire reduced), with
        no host read; returns the overflow flag (a 0-d bool tensor, False
        but under fp16)."""
        with record_function("optimizer_step"):  # names the step in a profile
            acc = self._flat_grad
            grads = self._reduced_grads() if grads is None else grads
            if self._use_loss_scaling:
                grads.div_(self.scale_state.cur_scale)
            # per parameter, then over the parameters (optax.global_norm's
            # shape): one fp32 sum over the whole buffer loses ~1e-5 on the CPU
            if self._sharded:
                gnorm = torch.linalg.vector_norm(
                    self._param_norms(self.layout.piece_views(grads)))
            else:
                gnorm = torch.linalg.vector_norm(
                    torch.stack(torch._foreach_norm(self._views(grads))))
            overflow = None
            if self._use_loss_scaling:  # any non-finite gradient: a non-finite norm
                overflow = torch.logical_not(torch.isfinite(gnorm))
            clip = self._config.gradient_clipping
            if clip > 0:
                grads.mul_(torch.clamp(clip / (gnorm + 1e-6), max=1.0))
            self.optimizer.step(grads, skip=overflow)
            self._refresh_compute()  # the masters' cast, moved or not
            overflow = self._no_overflow if overflow is None else overflow
            self.scale_state = loss_scaler.next_device_state(self._config.fp16_config,
                                                             self.scale_state, overflow)
            acc.zero_()
            self._last_grad_norm = gnorm
        return overflow

    def _reduced_grads(self) -> torch.Tensor:
        """This rank's fp32 gradients of its shard (the whole buffer at
        stage 0), summed over the data-parallel world: stage 0 all-reduces
        the buffer across ranks, stage 1 reduce-scatters it per unit over
        the ZeRO group, stages 2-3 hold the group's sum already; then the
        replicas of the group all-reduce the shard."""
        plan, acc = self.zero_plan, self._flat_grad
        if not self._sharded:
            if self.dp_world_size > 1:
                comm.all_reduce(acc, group=plan.dp_axes)
            return acc if acc.dtype == torch.float32 else acc.float()
        if plan.shard_grads:
            grads = acc
        else:
            grads = torch.empty(self.layout.shard_numel, dtype=acc.dtype, device=acc.device)
            for u in self.layout.units:
                self.layout.unit_shard(grads, u).copy_(
                    comm.reduce_scatter(self.layout.unit_full(acc, u), group=plan.zero_axes))
        if plan.replica_axes:
            comm.all_reduce(grads, group=plan.replica_axes)
        return grads if grads.dtype == torch.float32 else grads.float()

    def _settle(self, overflows):
        """The host's bookkeeping of applied steps whose overflow flags it
        has read: the step and sample counts, ``skipped_steps``, the
        optimizer's host count and one schedule step per applied update."""
        applied = overflows.count(False)
        self._last_overflows = list(overflows)
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
        if self._wire is not None:  # the JAX engine's assert: no fused program under it
            raise AssertionError(f"{what} does not run under the bucketed gradient wire "
                                 "(gradient_comm); use train_batch")
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
        if self._onebit_wire and self.global_steps >= self._wire_freeze_step:
            loss = wire_step(self, args, kwargs)  # past the warmup: the 1-bit wire
        else:
            losses, overflows = self._train_window([(args, kwargs)])
            self._settle(self._fetch(overflows).tolist())
            loss = losses[0]
        self._resilience_step_boundary(loss)
        return loss

    def fused_train_steps(self, *args, **kwargs):
        """K optimizer steps of stacked batches with one host read: every
        tensor argument carries a leading ``[K, ...]`` axis and step ``i``
        takes slice ``i``. The same steps as K ``fused_train_step`` calls
        (gas 1 only), enqueued with no synchronisation between them; then
        one fetch of the losses and overflow flags, and the host's
        bookkeeping. Returns the ``[K]`` losses (fp32, on the host)."""
        self._require_gas_one("fused_train_steps")
        if self._onebit_wire:
            # the wire swaps in per step after freeze_step; a window of K steps
            # would run uncompressed past the switch
            raise RuntimeError("fused_train_steps does not compose with the 1-bit wire "
                               "program (onebit* + comm_backend_name); use fused_train_step")
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
        self._resilience_step_boundary(host[:K])
        return host[:K]

    def train_batch(self, data_iter=None):
        """One optimizer step over ``gradient_accumulation_steps``
        micro-batches (each item of ``data_iter``: a tuple of the model's
        positional arguments, or one tensor): under the bucketed gradient
        wire its program; else at gas 1 ``fused_train_step``, above it the
        micro-batches and the apply step with one fetch.
        Returns the mean loss as a float."""
        self._training = True
        if self._wire is not None:
            loss = self._wire.train_batch(data_iter, _batch)
            self._resilience_step_boundary([loss])
            return loss
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
        self._resilience_step_boundary(host[:1])
        return float(host[0])

    @torch.no_grad()
    def eval_batch(self, *args, **kwargs):
        """The model's output with no gradient; across ranks the global
        batch's: a scalar loss as the token mean over it, a batch of
        outputs gathered in row order."""
        local_args, local_kwargs = self._local_batch(args, kwargs)
        out = (self._store.call(local_args, local_kwargs) if self._store is not None
               else self.module(*local_args, **local_kwargs))
        if self.dp_world_size == 1 or not isinstance(out, torch.Tensor):
            return out
        if out.dim() == 0:
            return self._global_loss(out, local_args, local_kwargs)[1]
        split = any(self.zero_plan.splits(self._to_device(a))
                    for a in (*args, *kwargs.values()))
        return comm.all_gather(out, group=self.zero_plan.dp_axes) if split else out

    # ---- checkpointing (the JAX engine's :2032-2420) ----

    def _dist_world(self) -> int:
        import torch.distributed as dist
        return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1

    def _make_checkpoint_engine(self):
        """This process's checkpoint engine: its global rank among the
        processes that save one checkpoint, their barrier, and rank 0's
        verdict shared with every rank."""
        import torch.distributed as dist
        if self._dist_world() == 1:
            return TorchCheckpointEngine()

        def agree(ok: bool) -> bool:
            flag = torch.tensor([1.0 if ok else 0.0], device=self.device)
            dist.broadcast(flag, src=0)
            return bool(flag.item())

        return TorchCheckpointEngine(rank=dist.get_rank(), barrier=lambda: agree(True),
                                     agree=agree)

    def _ckpt_writes(self) -> bool:
        """Whether this rank writes its state: one rank of each set of
        replicas (the data-parallel index 0 at stage 0, replica index 0
        across the ZeRO groups above it)."""
        plan = self.zero_plan
        if self.mesh_ctx is None:
            return True
        if not self._sharded:
            return plan.dp_index() == 0
        return not plan.replica_axes or self.mesh_ctx.axis_index(plan.replica_axes) == 0

    def _mid_accumulation(self) -> bool:
        """Whether the accumulation buffer holds gradients (it is zero at a
        boundary: the apply step zeroes it)."""
        return self.micro_steps % self.gradient_accumulation_steps() != 0

    def _state_dict(self):
        """This rank's flat state: the masters (``fp32``), the accumulation
        buffer between boundaries (at one it holds zeros, and a load zeroes
        it), each optimizer buffer, the update count and the loss scale."""
        buffers = {"fp32": self._flat_master}
        if self._mid_accumulation():
            buffers["grad_acc"] = self._flat_grad
        buffers.update({f"optimizer.{k}": v for k, v in self.optimizer.state.items()})
        return {"buffers": buffers,
                "scalars": {"optimizer_count": int(self.optimizer.count),
                            "scale_state": list(loss_scaler.to_host(self.scale_state))}}

    def _ckpt_layout(self):
        """Which parameter ranges each of ``_state_dict``'s buffers holds
        (``checkpoint/engine.py ShardedReader``)."""
        names = self.param_names
        flat = [[names[i], s, e, off] for i, s, e, off in self.layout.pieces]
        grad = (flat if self.zero_plan.shard_grads or not self._sharded else
                [[names[i], a, b, 0] for i, (a, b) in enumerate(self.layout.full_bounds)])
        kinds = {"fp32": "flat"}
        if self._mid_accumulation():
            kinds["grad_acc"] = "grad"
        kinds.update({f"optimizer.{k}": "flat" for k in self.optimizer.state})
        return {"params": {n: list(s) for n, s in zip(names, self._shapes)},
                "pieces": {"flat": flat, "grad": grad}, "buffers": kinds,
                "meta": {"stage": self.zero_plan.stage, "world": self.dp_world_size,
                         "zero_size": self.zero_plan.zero_size,
                         "zero3_store": self._zero3_store is not None}}

    def _checkpoint_tag_validation(self, tag) -> None:
        """Every process must save under the same tag (reference
        engine.py:3092): a diverged tag fragments one checkpoint."""
        import zlib
        import torch.distributed as dist
        mode = self._config.checkpoint_config.tag_validation
        if self._dist_world() == 1 or mode == "IGNORE":
            return
        h = float(zlib.crc32(str(tag).encode()))
        both = torch.tensor([h, -h], dtype=torch.float64, device=self.device)
        dist.all_reduce(both, op=dist.ReduceOp.MAX)
        if float(both[0]) != -float(both[1]):
            msg = (f"checkpoint tag '{tag}' is not consistent across processes — a "
                   "mixed-tag save fragments the checkpoint")
            if mode == "FAIL":
                raise ValueError(msg)
            logger.warning(msg)

    def _host_state(self, client_state):
        sd = {"global_steps": self.global_steps, "global_samples": self.global_samples,
              "micro_steps": self.micro_steps, "skipped_steps": self.skipped_steps,
              "ds_config_batch": [self.train_batch_size(), self.train_micro_batch_size_per_gpu(),
                                  self.gradient_accumulation_steps()],
              "client_state": client_state or {}}
        if self.lr_scheduler is not None and hasattr(self.lr_scheduler, "state_dict"):
            sd["lr_scheduler"] = self.lr_scheduler.state_dict()
        sampler = self._sampler()
        if sampler is not None and hasattr(sampler, "state_dict"):
            sd["data_sampler"] = sampler.state_dict()
        if self._zero3_store is not None:
            m = self._zero3_store
            sd["zero3_store"] = {"bucket_size_mb": float(m.bucket_size_mb),
                                 "pad_multiple": int(m.pad_multiple),
                                 "persistent_idx": [int(i) for i in m.p_idx],
                                 "n_leaves": int(m.n_leaves)}
        return sd

    def _sampler(self):
        return getattr(self.training_dataloader, "sampler", None)

    def save_checkpoint(self, save_dir, tag=None, client_state=None, save_latest=True,
                        exclude_frozen_parameters=False):
        """Save every rank's state under ``save_dir/tag`` (default
        ``global_step<N>``) and seal it; ``latest`` moves only to a sealed
        tag. Returns whether the checkpoint committed. A collective."""
        t0 = time.perf_counter()
        tag = str(tag or f"global_step{self.global_steps}")
        self._checkpoint_tag_validation(tag)
        ce = self.checkpoint_engine
        ce.create(tag)
        path = os.path.join(save_dir, tag)
        ce.last_save_bytes = 0
        if self._ckpt_writes():
            ce.save(self._state_dict(), path, host_state=self._host_state(client_state),
                    layout=self._ckpt_layout())
        if self._config.zero_config.gather_16bit_weights_on_model_save:
            self.save_16bit_model(path)
        # commit before `latest` moves: the commit is the durability barrier
        committed = ce.commit(tag) is not False
        self.last_checkpoint = {"tag": tag, "bytes": ce.last_save_bytes,
                                "seconds": time.perf_counter() - t0, "committed": committed}
        if not committed:
            logger.error(f"checkpoint {tag} failed to commit; `latest` still points at the "
                         "previous checkpoint")
            return False
        self._last_good_tag = tag
        if ce.rank == 0:
            if save_latest:
                write_latest_tag(save_dir, tag)
            rc = self._resilience
            if rc.enabled and rc.keep_last_n:
                prune_checkpoints(save_dir, rc.keep_last_n, protect=(tag, ))
        return True

    @torch.no_grad()
    def full_params(self):
        """``{name: whole fp32 master}`` (the JAX engine's ``full_params
        :2047``): the one deliberate whole-model gather under the
        scheduled ZeRO-3 store. A collective."""
        return self.full_master_params()

    def save_16bit_model(self, save_dir, save_filename="pytorch_model.npz",
                         exclude_frozen_parameters=False):
        """The whole weights in the compute dtype (bf16, else fp16) as one
        archive keyed by their JAX tree paths, bf16 as its uint16 bit
        pattern with a ``__dtype__`` key (``:2159``). A collective; rank 0
        writes."""
        full = self.full_params()
        bf16 = self.compute_dtype == torch.bfloat16
        if self.checkpoint_engine.rank != 0:
            return True
        os.makedirs(save_dir, exist_ok=True)
        sd = {}
        for name, v in full.items():
            v = v.detach().to("cpu")
            sd[universal_name(name)] = (v.to(torch.bfloat16).view(torch.int16).numpy()
                                        .view(np.uint16) if bf16
                                        else v.to(torch.float16).numpy())
        sd["__dtype__"] = np.asarray("bfloat16" if bf16 else "float16")
        path = os.path.join(save_dir, save_filename)
        np.savez(path, **sd)
        logger.info(f"saved 16-bit model to {path} ({len(sd)} tensors)")
        return True

    def _resolve_load_tag(self, load_dir):
        """``latest`` while it names a sealed, verified tag; else the
        newest tag that verifies (quarantining the provably bad ones);
        else a legacy ``latest``; else None."""
        lt = read_latest_tag(load_dir)
        rank0 = self.checkpoint_engine.rank == 0
        if lt is not None:
            path = os.path.join(load_dir, lt)
            if verify_checkpoint(path, require_manifest=True)[0]:
                return lt
            if rank0 and any(os.path.exists(os.path.join(path, f))
                             for f in (MANIFEST_FILE, COMMIT_MARKER_FILE)):
                quarantine_checkpoint(load_dir, lt)  # provably bad: the scan skips it
        tag = find_latest_valid_checkpoint(load_dir, quarantine=rank0)
        if tag is None and lt is not None and verify_checkpoint(
                os.path.join(load_dir, lt), require_manifest=False)[0]:
            tag = lt
        return tag

    def load_checkpoint(self, load_dir, tag=None, load_module_strict=True,
                        load_optimizer_states=True, load_lr_scheduler_states=True,
                        load_module_only=False, custom_load_fn=None):
        """Restore from ``load_dir/tag`` (no tag: the newest that verifies;
        an explicit tag that fails verification raises
        ``CheckpointCorruptionError``). The checkpoint may come from any
        world and stage: each buffer's ranges are read through the saved
        layouts. Returns ``(path, client_state)``, or ``(None, {})``."""
        t0 = time.perf_counter()
        verified = tag is None  # the tag the scan picks has verified
        if tag is None:
            tag = self._resolve_load_tag(load_dir)
            if tag is None:
                logger.warning(f"Unable to find a valid checkpoint in {load_dir}, if trying to "
                               "load a specific checkpoint please pass tag")
                return None, {}
        path = os.path.join(load_dir, str(tag))
        ok, reason = (True, "") if verified else verify_checkpoint(path, require_manifest=False)
        if not ok:
            raise CheckpointCorruptionError(f"{path}: {reason}")
        host_state = read_host_state(path)
        saved = (host_state or {}).get("zero3_store")
        if saved is not None and self._zero3_store is not None and \
                int(saved["n_leaves"]) != self._zero3_store.n_leaves:
            raise ValueError(f"checkpoint ZeRO-3 store covers {saved['n_leaves']} param leaves "
                             f"but the live model has {self._zero3_store.n_leaves}")
        reader = ShardedReader(path)
        kinds = ["fp32"]
        if load_optimizer_states and not load_module_only:
            self._flat_grad.zero_()
            kinds += [k for k in ["grad_acc"] + [f"optimizer.{k}" for k in self.optimizer.state]
                      if reader.has(k)]
        self._read_buffers(reader, kinds)
        if load_optimizer_states and not load_module_only:
            sc = reader.scalars()
            self._set_update_count(int(sc.get("optimizer_count", 0)))
            if "scale_state" in sc:
                self.scale_state = loss_scaler.to_device(
                    loss_scaler.LossScaleState(*sc["scale_state"]), self.device)
        self._refresh_compute()
        client_state = {}
        if host_state:
            self.global_steps = host_state.get("global_steps", 0)
            self.global_samples = host_state.get("global_samples", 0)
            self.micro_steps = host_state.get("micro_steps", 0)
            self.skipped_steps = host_state.get("skipped_steps", 0)
            client_state = host_state.get("client_state", {})
            if (load_lr_scheduler_states and self.lr_scheduler is not None
                    and "lr_scheduler" in host_state
                    and hasattr(self.lr_scheduler, "load_state_dict")):
                self.lr_scheduler.load_state_dict(host_state["lr_scheduler"])
            sampler = self._sampler()
            if sampler is not None and "data_sampler" in host_state:
                sampler.load_state_dict(host_state["data_sampler"])
        self._last_good_tag = str(tag)
        self.last_load = {"tag": str(tag), "seconds": time.perf_counter() - t0,
                          "saved_stage": reader.meta.get("stage"),
                          "saved_world": reader.meta.get("world")}
        return path, client_state

    @torch.no_grad()
    def _read_buffers(self, reader, kinds):
        """Each of ``kinds`` into this rank's buffer: the pieces it holds,
        read from whichever saved ranks hold them."""
        names = self.param_names
        full_grad = self._sharded and not self.zero_plan.shard_grads
        for kind in kinds:
            buf = self._flat_buffer(kind)
            places = ([(i, a, b, 0) for i, (a, b) in enumerate(self.layout.full_bounds)]
                      if kind == "grad_acc" and full_grad else self.layout.pieces)
            for i, s, e, off in places:
                buf[s:e].copy_(reader.read(kind, names[i], off, off + e - s))

    def _flat_buffer(self, kind: str) -> torch.Tensor:
        """The flat buffer a checkpoint's ``kind`` names: ``fp32`` (the
        masters), ``grad_acc``, ``optimizer.<state key>``."""
        if kind == "fp32":
            return self._flat_master
        if kind == "grad_acc":
            return self._flat_grad
        return self.optimizer.state[kind[len("optimizer."):]]

    def _set_update_count(self, n: int):
        opt = self.optimizer
        opt._count.fill_(n)
        opt._count_host, opt._unsettled, opt._table_left = n, 0, 0

    def _peek_zero3_store_meta(self, path):
        """The saved store's descriptor from the checkpoint's host state
        (no array data read), or None when it was saved without the store."""
        hs = read_host_state(path)
        return (hs or {}).get("zero3_store")

    def load_universal_checkpoint(self, universal_dir):
        """Resume from a universal checkpoint (``:2184``): the fp32 master
        of each parameter, and with Adam-family state its moments and the
        update count set to the saved step, onto this engine's layout
        whatever wrote it (this package or the JAX one). The step counter
        is the saved step; the schedule is not restored, as in JAX."""
        from ..checkpoint.universal import load_universal, read_universal_meta
        meta = read_universal_meta(universal_dir)
        frags = {"fp32": load_universal(universal_dir, "fp32.npy")}
        if meta.get("has_optim_states") and {"m", "v"} <= set(self.optimizer.state):
            frags["optimizer.m"] = load_universal(universal_dir, "exp_avg.npy")
            frags["optimizer.v"] = load_universal(universal_dir, "exp_avg_sq.npy")
        missing = [universal_name(n) for n in self.param_names
                   if universal_name(n) not in frags["fp32"]]
        if missing:
            raise KeyError(f"universal checkpoint missing parameters: {missing[:5]}")
        with torch.no_grad():
            for kind, arrays in frags.items():
                buf = self._flat_buffer(kind)
                for i, s, e, off in self.layout.pieces:
                    flat = np.asarray(arrays[universal_name(self.param_names[i])],
                                      dtype=np.float32).reshape(-1)
                    buf[s:e].copy_(torch.from_numpy(flat[off:off + e - s]))
        step = int(meta.get("step", 0))
        if len(frags) > 1:
            self._set_update_count(step)
        self._refresh_compute()
        self.global_steps = step
        logger.info(f"loaded universal checkpoint {universal_dir} at step {step}")
        return universal_dir, {}

    # ---- resilience (the JAX engine's :1055-1230) ----

    def _init_resilience(self):
        rc = self._config.resilience_config
        self._resilience = rc
        self._sentry = None
        self._preempted = False
        self.preempt_count = 0
        self._autosave_requested = False
        self._last_good_tag = None
        self._resilience_save_dir = rc.save_dir
        self._signal_prev_handlers = {}
        if not rc.enabled:
            return
        if rc.fault_injection.enabled:
            get_fault_injector().configure(rc.fault_injection)
        from .sentry import AnomalySentry
        self._sentry = AnomalySentry(
            max_consecutive=rc.max_consecutive_anomalies, spike_window=rc.loss_spike_window,
            spike_factor=rc.loss_spike_factor, spike_min_history=rc.loss_spike_min_history)
        if rc.preempt_save:
            self._install_preempt_handlers()
        if rc.auto_resume and rc.save_dir:
            # the newest checkpoint that verifies, not blindly `latest`
            path, _ = self.load_checkpoint(rc.save_dir)
            if path is not None:
                logger.info(f"[resilience] auto-resumed from {path} at step {self.global_steps}")

    def _install_preempt_handlers(self):
        import signal
        for name in self._resilience.preempt_signals:
            sig = getattr(signal, name, None)
            if sig is None:
                continue
            try:
                prev = signal.signal(sig, self._on_preempt_signal)
            except (ValueError, OSError):  # not the main thread
                continue
            self._signal_prev_handlers[sig] = prev

    def _remove_preempt_handlers(self):
        import signal
        for sig, prev in getattr(self, "_signal_prev_handlers", {}).items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._signal_prev_handlers = {}

    def _on_preempt_signal(self, signum, frame):
        # signal context: set flags only; the save runs at the next step
        # boundary, where the engine's state is consistent
        self._preempted = True
        self.preempt_count += 1
        logger.warning(f"[resilience] signal {signum} received; checkpoint will be saved at "
                       "the next step boundary")

    @property
    def preempted(self) -> bool:
        return self.preempt_count > 0

    def _fault_poison(self, args, kwargs):
        """The ``train.nan_grads`` fault site: the micro-batch's float
        tensors set to NaN, so the loss and the gradients are NaN."""
        fi = get_fault_injector()
        if not (fi.enabled and fi.fire("train.nan_grads") is not None):
            return args, kwargs

        def poison(x):
            if isinstance(x, torch.Tensor) and x.is_floating_point():
                return torch.full_like(x, float("nan"))
            return x
        return tuple(poison(a) for a in args), {k: poison(v) for k, v in kwargs.items()}

    def _resilience_step_boundary(self, losses):
        """After each optimizer step of every training path: the sentry
        fed the step's losses (host values the step fetched, or fetched
        here) and overflow flags, the rollback on its verdict, the interval
        autosave and the preemption save."""
        rc = self._resilience
        if not rc.enabled:
            return
        fi = get_fault_injector()
        if fi.enabled and fi.fire("train.sigterm") is not None:
            import signal
            os.kill(os.getpid(), signal.SIGTERM)
        if self._sentry is not None:
            if isinstance(losses, torch.Tensor):
                losses = losses.detach().float().reshape(-1).tolist()
            flags = self._last_overflows or [False] * len(losses)
            base = self.global_steps - len(losses)
            for i, (loss, flag) in enumerate(zip(losses, flags)):
                self._sentry.observe(None if loss is None else float(loss),
                                     bool(flag) and self._use_loss_scaling, base + i + 1)
                if self._sentry.should_rollback:
                    self._rollback_to_last_good()
                    break
        if (rc.autosave_interval_steps and self.global_steps > 0
                and self.global_steps % rc.autosave_interval_steps == 0):
            self._autosave_requested = True
        if self._preempted and rc.preempt_save:
            self._autosave_requested = True
            self._preempted = False  # one save per preemption notice
        if self._autosave_requested and self._resilience_save_dir:
            self._autosave_requested = False
            ok = self.save_checkpoint(self._resilience_save_dir)
            logger.info(f"[resilience] autosave at step {self.global_steps}: "
                        f"{'committed' if ok else 'FAILED'}")

    def _rollback_to_last_good(self) -> bool:
        """Restore the masters, the optimizer state and the counters from
        the last good checkpoint, but KEEP the data sampler's position: the
        offending data window is skipped, not replayed."""
        rc = self._resilience
        self._sentry.reset()
        if not rc.rollback or not self._resilience_save_dir:
            logger.warning("[resilience] anomaly threshold hit but rollback is disabled or no "
                           "save_dir is configured")
            return False
        sampler = self._sampler()
        sampler_sd = (sampler.state_dict()
                      if sampler is not None and hasattr(sampler, "state_dict") else None)
        tag = self._last_good_tag or find_latest_valid_checkpoint(self._resilience_save_dir)
        if tag is None:
            logger.warning("[resilience] no valid checkpoint to roll back to")
            return False
        try:
            path, _ = self.load_checkpoint(self._resilience_save_dir, tag=tag)
        except CheckpointCorruptionError as e:
            logger.error(f"[resilience] rollback target is corrupt: {e}")
            return False
        if path is None:
            return False
        if sampler_sd is not None:  # the load rewound it with the rest
            sampler.load_state_dict(sampler_sd)
        self._sentry.note_rollback(tag, self.global_steps)
        return True

    def destroy(self):
        """Release the engine's state and hooks, and restore the signal
        handlers the preemption autosave replaced (``:1992``)."""
        self._remove_preempt_handlers()
        for hooks in (self._gather, self._reducer):
            if hooks is not None:
                hooks.remove_hooks()
        self._pending = None

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
