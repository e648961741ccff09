"""The bucketed gradient wire's ``train_batch`` (port of
``deepspeed_tpu/runtime/grad_comm.py``; reference ``stage_1_and_2.py``'s
bucketed reduce with ``overlap_comm``).

With ``gradient_comm`` active and supported, ``train_batch`` runs this
program in place of the default reduce, at every ``gradient_accumulation_
steps`` (1 included):

1. each micro-step's LOCAL gradients (the loss of this rank's rows, over
   ``gas``; no token weighting) go into the buckets as fp32
   (``comm/bucketing.py``), the residual of the last micro-step's quantized
   exchange added first (``error_feedback``; it starts at zero each step);
2. with ``overlap_comm`` each bucket is reduce-scattered as soon as that
   micro-step's backward ends, as async work whose handle is waited (on
   the device's stream under NCCL, no host read) before the next
   micro-step's shard is added, so it overlaps the next forward and
   backward; without it the buckets accumulate locally and are exchanged
   once at the boundary;
3. the summed shards are divided by the world ``w`` (times its fp32
   reciprocal, as XLA compiles JAX's ``s / w``); stages 0-1 all-gather
   them back through the tier; at stage 2 the reduce-scatter IS the
   gradient partition: the engine's stage-2 flat state is laid out by the
   bucket plan (each rank's shard of each bucket), so the reduce-scatter
   writes the shard K7 steps on and no gradient gather follows (where the
   ZeRO group is the whole world; see below);
4. the engine's apply step (norm, clip, K7, the compute copy's refresh);
5. the reported loss is the mean over the micro-steps and the ranks
   (JAX's ``pmean(loss_sum / gas)``), fetched once with the overflow flag.

Under the wire the engine's flat state is laid out by the bucket plan at
every stage (``plan_wire``): the buckets end to end, the parameters in the
JAX tree's order and packed as JAX packs them, so every quantization block
holds JAX's elements; at stages 1-2 each bucket is a unit of the ZeRO
layout, sharded in ``w`` equal parts (multiples of the block, so K7's
loads stay aligned). ``forward``/``backward``/``step`` keep the default
reduce over that layout.

``grad_comm_supported`` is JAX's predicate: a pure data-parallel mesh, no
fp16; at stage 3 the scheduled ZeRO-3 store's (``runtime/zero3_schedule.py
zero3_store_supported``), whose step (``Zero3Store.train_batch``) takes the
wire's place. The buckets always run over the whole data-parallel world
(``data x fsdp``), padded to ``world x quantization_block_size``. Where the
ZeRO group is smaller than that world (``data`` and ``fsdp`` both split,
the group ``fsdp``), stage 2 leaves each reduced bucket scattered over the
ZeRO axes as JAX does: the world's reduced quarters (say) are gathered in
fp32, which moves no number, and each rank keeps its ZeRO shard; stage 1
gathers back through the tier, as at any world. One difference: a world of
one rank runs the fp32 tier (its numbers are the default reduce's, which
JAX runs there; a quantized tier there falls back as in JAX).
"""

import time

import torch

from ..comm import comm
from ..comm.bucketing import (all_gather_bucket, bucket_wire_bytes, jax_leaf_order,
                              plan_buckets, record_bucket_traffic, reduce_scatter_bucket)
from ..comm.compressed import reciprocal
from .zero_sharding import Unit

NON_DP_AXES = ("model", "seq", "expert", "pipe")


def _dp_axes(ctx):
    return tuple(a for a in ("data", "fsdp") if ctx.axis_size(a) > 1)


def grad_comm_supported(engine) -> bool:
    """Whether the wire runs for ``engine`` (see the module's docstring)."""
    cfg, ctx = engine._config, engine.mesh_ctx
    if ctx is None:
        return False
    if cfg.zero_config.stage >= 3:
        from .zero3_schedule import zero3_store_supported
        return zero3_store_supported(engine)
    gc = cfg.gradient_comm_config
    quantized = gc.comm_quantization != "fp32" or any(
        t != "fp32" for t in gc.comm_quantization_per_dtype.values())
    return (not cfg.fp16_enabled and all(ctx.axis_size(a) == 1 for a in NON_DP_AXES)
            and (len(_dp_axes(ctx)) >= 1 or not quantized))


def plan_wire(names, shapes, world: int, zero_size: int, gc):
    """The bucket plan of the parameters ``names`` of ``shapes`` (fp32
    masters, in the JAX tree's order, each bucket padded to ``world x
    quantization_block_size``) and its buckets as units of the engine's
    flat layout over a ZeRO group of ``zero_size``."""
    order = jax_leaf_order(names)
    leaves = [torch.empty(shapes[i], dtype=torch.float32, device="meta") for i in order]
    layout = plan_buckets(leaves, gc.bucket_size_mb,
                          pad_multiple=world * gc.quantization_block_size)
    units = [Unit(f"bucket_{k}", [order[s.leaf_index] for s in b.slots], None, zero_size,
                  bounds=[(s.offset, s.offset + s.size) for s in b.slots],
                  length=b.padded_size)
             for k, b in enumerate(layout.buckets)]
    return layout, units


class GradCommWire:
    """The wire of ``engine``, whose flat layout's units are the buckets of
    ``layout`` in order. ``stats``: the steps run and the wire bytes banked
    (``bucket_wire_bytes`` of the global tier a step)."""

    def __init__(self, engine, layout):
        gc = engine._config.gradient_comm_config
        self.engine = engine
        self.layout = layout
        self.tiers = [gc.tier_for_dtype(b.dtype) for b in layout.buckets]
        self.tier = gc.comm_quantization
        self.block = gc.quantization_block_size
        self.overlap = gc.overlap_comm
        self.feedback = gc.error_feedback and any(t != "fp32" for t in self.tiers)
        plan = engine.zero_plan
        self.group = plan.dp_axes
        self.w = engine.dp_world_size
        # stage 2 over a ZeRO group smaller than the world: the world's
        # reduced chunks are gathered back and each rank keeps its shard
        self._regather = plan.shard_grads and plan.zero_size != self.w
        self.stats = {"steps": 0, "wire_bytes": 0}
        self.step_bytes = bucket_wire_bytes(layout, self.w, self.tier, self.block)["wire_bytes"]

    # ---- one step

    def train_batch(self, data_iter, batch):
        """One optimizer step over ``gas`` micro-batches of ``data_iter``
        (each through ``batch``); returns the mean loss as a float."""
        eng = self.engine
        gas = eng.gradient_accumulation_steps()
        t0 = time.perf_counter()
        self._start()
        reducer = eng._reducer
        if reducer is not None:  # the wire reduces; the default hooks stand aside
            reducer.paused = True
        try:
            total = torch.zeros((), dtype=torch.float32, device=eng.device)
            for _ in range(gas):
                loss = eng._local_loss(*batch(next(data_iter)))
                (loss.float() / gas).backward()
                total = total + loss.detach().float()
                self._micro()
            grads = self._boundary()
        finally:
            if reducer is not None:
                reducer.paused = False
        overflow = eng._apply_step(grads)
        mean = comm.all_reduce(total / gas, group=self.group).mul_(
            reciprocal(self.w, eng.device)[0])
        host = eng._fetch(torch.stack([mean, overflow.float()]))
        eng.micro_steps += gas
        eng.losses = mean
        eng._settle([bool(host[1])])
        self.stats["steps"] += 1
        self.stats["wire_bytes"] += self.step_bytes
        record_bucket_traffic(self.layout, self.w, self.tier, self.block,
                              duration=time.perf_counter() - t0, op="reduce_scatter")
        return float(host[0])

    def _full(self):
        return torch.zeros(self.engine.layout.full_numel, dtype=torch.float32,
                           device=self.engine.device)

    def _start(self):
        """The step's buffers: the running shards (at stage 2 the shards of
        the accumulation buffer itself), the local accumulation of the
        boundary mode, the residuals."""
        eng, lay = self.engine, self.engine.layout
        acc = eng._flat_grad
        self._pending, self._err = None, None
        if eng.zero_plan.shard_grads:
            self._dst = acc if acc.dtype == torch.float32 else torch.zeros_like(
                acc, dtype=torch.float32)
            self._shards = ([lay.unit_shard(self._dst, u) for u in lay.units]
                            if not self._regather else
                            [torch.zeros(u.length // self.w, dtype=torch.float32,
                                         device=eng.device) for u in lay.units])
        else:
            self._dst = None
            self._shards = [torch.zeros(u.length // self.w, dtype=torch.float32,
                                        device=eng.device) for u in lay.units]
        self._acc = None
        if not self.overlap:
            local = not eng.zero_plan.shard_grads and acc.dtype == torch.float32
            self._acc = acc if local else self._full()
        elif self.feedback:
            self._err = self._full()

    def _grads_into(self, buf, add: bool, unit=None):
        """This micro-step's gradients (of ``unit``'s parameters only, into
        its bucket ``buf``) into the bucket-laid ``buf``, added or copied,
        each parameter's ``.grad`` dropped."""
        eng = self.engine
        lay = eng.layout
        if unit is None:
            places = [(i, lay.full_bounds[i]) for i in range(len(eng._params))]
        else:
            places = list(zip(unit.params, unit.bounds))
        with torch.no_grad():
            for i, (a, b) in places:
                p = eng._params[i]
                if p.grad is not None:
                    view = buf[a:b].view(eng._shapes[i])
                    view.add_(p.grad) if add else view.copy_(p.grad)
                    p.grad = None

    @torch.no_grad()
    def _micro(self):
        lay = self.engine.layout
        if not self.overlap:
            self._grads_into(self._acc, add=True)
            return
        self._wait()  # the last micro-step's exchange ran beside this one's backward
        handles = []
        for u, tier in zip(lay.units, self.tiers):  # a bucket at a time
            bucket = torch.zeros(u.length, dtype=torch.float32, device=self.engine.device)
            self._grads_into(bucket, add=False, unit=u)
            if self._err is not None:
                bucket.add_(lay.unit_full(self._err, u))
            h, resid = reduce_scatter_bucket(bucket, self.group, tier, self.block,
                                             async_op=True)
            handles.append(h)  # the process group holds the collective's input
            if self._err is not None and resid is not None:  # replaces the last residual
                lay.unit_full(self._err, u).copy_(resid)
        self._pending = handles

    def _wait(self):
        """The last micro-step's reduce-scatters added into the shards."""
        if self._pending is None:
            return
        for shard, h in zip(self._shards, self._pending):
            shard.add_(h.wait())
        self._pending = None

    @torch.no_grad()
    def _boundary(self) -> torch.Tensor:
        """The step's fp32 gradients of this rank's flat state: the shards
        summed over the ranks, over ``w``, and at stages 0-1 gathered back
        (stage 1 then keeps its shard of each bucket)."""
        eng, lay = self.engine, self.engine.layout
        if self.overlap:
            self._wait()
        else:
            for u, tier, shard in zip(lay.units, self.tiers, self._shards):
                shard.copy_(reduce_scatter_bucket(lay.unit_full(self._acc, u), self.group,
                                                  tier, self.block)[0])
        self._acc = self._err = None
        inv = reciprocal(self.w, eng.device)  # XLA's s / w
        if eng.zero_plan.shard_grads:
            if not self._regather:
                return self._dst.mul_(inv)
            zi = lay.zero_index
            for u, shard in zip(lay.units, self._shards):
                full = comm.all_gather_into_tensor(None, shard.mul_(inv), group=self.group)
                lay.unit_shard(self._dst, u).copy_(full[zi * u.shard_len:(zi + 1) * u.shard_len])
            self._shards = None
            return self._dst
        acc = eng._flat_grad
        full = acc if acc.dtype == torch.float32 else self._full()
        for u, tier, shard in zip(lay.units, self.tiers, self._shards):
            all_gather_bucket(shard.mul_(inv), self.group, tier, self.block,
                              out=lay.unit_full(full, u))
        self._shards = None
        if not eng._sharded:
            return full
        grads = torch.empty(lay.shard_numel, dtype=torch.float32, device=eng.device)
        zi = lay.zero_index
        for u in lay.units:
            lay.unit_shard(grads, u).copy_(
                lay.unit_full(full, u)[zi * u.shard_len:(zi + 1) * u.shard_len])
        return grads
