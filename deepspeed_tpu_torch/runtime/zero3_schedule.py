"""The scheduled ZeRO-3 parameter store (port of
``deepspeed_tpu/runtime/zero3_schedule.py``; reference
``runtime/zero/stage3.py`` and ``partitioned_param_coordinator.py``).

Stage 3 with the bucketed gradient wire (``gradient_comm``) runs this store
in place of the gather units of ``runtime/zero3.py``:

1. **The store.** The fp32 masters live as the wire planner's flat buckets
   (``comm/bucketing.py``), planned over the parameters in the JAX tree's
   leaf order and padded to ``world x quantization_block_size``; each rank
   holds 1/dp of every bucket (a unit of the engine's ``FlatLayout``). The
   bucket budget is ``zero_governor.gather_bucket_mb``. Parameters of at
   most ``stage3_param_persistence_threshold`` elements are the
   persistent leaves: their compute copy is whole on every rank, never
   gathered, and their gradients are reduced over the ranks in fp32 at the
   boundary (JAX's ``psum``). The port keeps their fp32 masters and moments
   sharded like every other unit of the flat state (JAX replicates them):
   the update is elementwise, so the numbers do not change. The optimizer
   state is built over the store, so the moments are bucket shards too and
   K7 steps only the rank's own shard.

2. **The schedule pass.** PyTorch has no jaxpr, so the use points come
   from running one micro-batch's loss once, at the first call with a
   batch's shapes, under a ``torch.overrides.TorchFunctionMode``
   (``trace_param_uses``): the mode sees every torch call, Tensor method
   and Python function that takes part in ``__torch_function__`` (the
   chunked CE does, so its read of the unembedding is seen, and a tied
   embedding's second use). A call that reads a bucket leaf is one
   operation of the sequence; each leaf's first and last use are indices
   into it. The trace runs under ``no_grad`` with zeros standing in for the
   leaves, and counts only the calls that read a leaf, so branches on the
   grad mode do not move the indices. ``derive_schedule`` is JAX's, copied:
   a reuse distance in elements splits a bucket's span into epochs, each
   epoch is issued one ahead of its first use, and prefetches are demoted,
   latest first, while the gathered peak is above
   ``stage3_max_live_parameters``. A leaf the loss never reads gets no use:
   its bucket is never gathered and its gradient stays zero.

3. **The scheduled step.** No interpreter: the same mode drives the
   schedule from the use points. At an epoch's issue point the bucket's
   ``param_gather_bucket`` is issued (``async_op``); at its first use it is
   waited on, cast to the compute dtype and split into its leaves, and each
   call that reads a leaf gets that view in place of the parameter (whose
   own storage is a NaN placeholder); after the epoch's last use the views
   are dropped, and rebinding at a later epoch releases the earlier one.
   ``param_gather_bucket``'s backward reduce-scatters each bucket's
   gradient through the backward tier, so the gradients come back as this
   rank's bucket shards; the gas micro-steps add them in forward order
   (the JAX scan's ``acc + g``), the boundary divides by the world (times
   its fp32 reciprocal), and the engine's apply step runs unchanged on the
   owned shards: the stage-2 wire's arithmetic. ``zero_quantized_weights``
   and ``zero_quantized_gradients`` pick the int8 forward and backward
   tiers (JAX ``:468-471``).

Remat (the engine's ``remat_policy``, which checkpoints the whole
forward, and the model's ``remat``, each layer). The store runs under
both, as JAX's does. The checkpointed forward runs inside the scheduled
mode like any other: its gathers are the schedule's, through
``param_gather_bucket``. Its regions drop what they would save, the
gathered weights included, so a bucket lives only for its epoch. The
backward recomputes each region after the mode is gone: the call hands
``checkpointing.recompute_under`` a factory, and each recompute runs under
a mode of its own (``_recompute_mode``) that gathers again, through
``param_gather_bucket`` on the detached shard, every bucket the region
reads, once a region, and drops them when the region ends. PyTorch's
checkpoint (``use_reentrant=False``) takes from a recompute only the
tensors the forward's graph saved; the gradient flows through the
forward's graph. So each bucket's gradient is reduce-scattered once per
gather epoch of the forward (once a micro-step under the default
schedule), by the backward of the forward's gather: a bucket that holds
small leaves of several layers gathers again in each of their regions'
recomputes, but those gathers have no backward, and the region's
gradients with respect to the bucket's views add up in the forward
gather's output before its backward runs. The gathered values are the
forward's to the bit (the same shard through the same tier), so the
recomputed activations are the forward's too.

Two differences from JAX. A world of one rank runs the store too (JAX's
predicate wants a split dp axis), over a group of one, as the port's
gradient wire does. The store's forward, ``eval_batch`` and the
``forward``/``backward``/``step`` API go through the same scheduled mode
(the split API with the default loss weighting, gradients summed, not
divided), where JAX materializes the whole tree under jit.
"""

import logging
import time
from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import _disable_current_modes

from ..comm import comm
from ..comm.bucketing import (BucketLayout, flatten_buckets, jax_leaf_order, param_gather_bucket,
                              plan_buckets)
from ..comm.compressed import reciprocal
from .activation_checkpointing import checkpointing
from .zero_governor import gather_bucket_mb
from .zero_sharding import Unit, zero_axes_for

logger = logging.getLogger(__name__)
NON_DP_AXES = ("model", "seq", "expert", "pipe")

# ---------------------------------------------------------------------------
# the store: fp32 masters as ZeRO-sharded flat buckets
# ---------------------------------------------------------------------------


class Zero3StoreMeta:
    """Static description of a bucketed parameter store, over the leaves
    in the JAX tree's order: ``layout`` plans the NON-persistent leaves
    (``np_idx[k]`` is the leaf index of the layout's k-th leaf), ``p_idx``
    the persistent ones; ``leaf_shapes`` each leaf's shape and ``order``
    each leaf's index among the engine's parameters."""

    def __init__(self, layout: BucketLayout, np_idx: Tuple[int, ...], p_idx: Tuple[int, ...],
                 leaf_shapes, bucket_size_mb: float, pad_multiple: int, order=None):
        self.layout = layout
        self.np_idx = tuple(np_idx)
        self.p_idx = tuple(p_idx)
        self.leaf_shapes = tuple(tuple(s) for s in leaf_shapes)
        self.bucket_size_mb = bucket_size_mb
        self.pad_multiple = pad_multiple
        self.order = tuple(order) if order is not None else tuple(range(len(leaf_shapes)))

    @property
    def n_leaves(self) -> int:
        return len(self.leaf_shapes)

    @property
    def persistent_elements(self) -> int:
        return sum(_numel(self.leaf_shapes[i]) for i in self.p_idx)


def _numel(shape) -> int:
    n = 1
    for d in shape or (1, ):
        n *= int(d)
    return n


def build_store_meta(shapes, persistent_idx, bucket_size_mb: float, pad_multiple: int,
                     order=None) -> Zero3StoreMeta:
    """Plan the bucketed store for leaves of ``shapes`` (in the JAX tree's
    leaf order). Masters are fp32, so the buckets are planned for fp32."""
    shapes = [tuple(s) for s in shapes]
    p_set = set(int(i) for i in persistent_idx)
    np_idx = tuple(i for i in range(len(shapes)) if i not in p_set)
    p_idx = tuple(sorted(p_set))
    layout = plan_buckets([torch.empty(shapes[i], dtype=torch.float32, device="meta")
                           for i in np_idx], bucket_size_mb, pad_multiple=pad_multiple)
    return Zero3StoreMeta(layout, np_idx, p_idx, shapes, bucket_size_mb, pad_multiple, order)


def store_from_tree(leaves, meta: Zero3StoreMeta):
    """Leaves (JAX order) -> ``{"buckets": [flat fp32 buckets],
    "persistent": [leaves]}``."""
    leaves = list(leaves)
    return {"buckets": flatten_buckets([leaves[i] for i in meta.np_idx], meta.layout)
            if meta.np_idx else [],
            "persistent": [leaves[i] for i in meta.p_idx]}


def materialize_params(store, meta: Zero3StoreMeta) -> List[torch.Tensor]:
    """Store -> the leaves in JAX order (views of the buckets)."""
    leaves: List[Optional[torch.Tensor]] = [None] * meta.n_leaves
    for k, i in enumerate(meta.p_idx):
        leaves[i] = store["persistent"][k]
    for arr, b in zip(store["buckets"], meta.layout.buckets):
        for s in b.slots:
            leaves[meta.np_idx[s.leaf_index]] = arr[s.offset:s.offset + s.size].view(s.shape)
    return leaves


def _dp_axes(ctx):
    return tuple(a for a in ("data", "fsdp") if ctx.axis_size(a) > 1)


def zero3_store_supported(engine) -> bool:
    """Whether the store runs for ``engine``: stage 3, the bucketed wire
    asked for, no fp16 loss scaling, and a pure data-parallel mesh whose
    ZeRO axes are the whole dp world (JAX's predicate, ``:164``). A world
    of one rank qualifies; remat does not matter."""
    cfg, ctx = engine._config, engine.mesh_ctx
    if ctx is None:
        return False
    return (cfg.zero_config.stage >= 3 and cfg.gradient_comm_config.active
            and not cfg.fp16_enabled
            and all(ctx.axis_size(a) == 1 for a in NON_DP_AXES)
            and tuple(zero_axes_for(ctx)) == _dp_axes(ctx))


def init_param_store(engine, names, shapes):
    """The store's plan for the engine's parameters ``names`` of
    ``shapes`` (``init_param_store :184``): its meta, and its buckets (then
    the persistent unit) as units of the engine's flat layout."""
    cfg = engine._config
    zc, gc = cfg.zero_config, cfg.gradient_comm_config
    w = engine.dp_world_size
    order = jax_leaf_order(names)
    leaf_shapes = [tuple(shapes[i]) for i in order]
    thresh = int(zc.param_persistence_threshold or 0)
    persistent = [k for k, s in enumerate(leaf_shapes) if _numel(s) <= thresh]
    eff_mb = gather_bucket_mb(gc.bucket_size_mb, zc.max_live_parameters,
                              zc.prefetch_bucket_size)
    meta = build_store_meta(leaf_shapes, persistent, eff_mb, w * gc.quantization_block_size,
                            order)
    zero_size = engine.zero_plan.zero_size
    units = [Unit(f"bucket_{k}", [order[meta.np_idx[s.leaf_index]] for s in b.slots], None,
                  zero_size, bounds=[(s.offset, s.offset + s.size) for s in b.slots],
                  length=b.padded_size)
             for k, b in enumerate(meta.layout.buckets)]
    if meta.p_idx:
        numels = [_numel(s) for s in shapes]
        units.append(Unit("persistent", sorted(order[i] for i in meta.p_idx), numels,
                          zero_size, persistent=True))
    total = sum(_numel(s) for s in leaf_shapes)
    logger.info(f"ZeRO-3 param store: {len(meta.layout.buckets)} buckets "
                f"({sum(b.padded_size for b in meta.layout.buckets)} elements, bucket <= "
                f"{eff_mb:.2f}MB, 1/{w} per rank) + {len(meta.p_idx)} persistent leaves "
                f"({meta.persistent_elements}/{total} elements whole, threshold {thresh})")
    return meta, units


# ---------------------------------------------------------------------------
# schedule pass: trace -> first/last use -> gather epochs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GatherEpoch:
    """One scheduled all-gather of one bucket: issued before operation
    ``issue_at`` (-1 = program start), landed (split into leaves) at
    ``first_use``, releasable after ``last_use``."""
    bucket: int
    issue_at: int
    first_use: int
    last_use: int

    @property
    def prefetched(self) -> bool:
        return self.issue_at < self.first_use


@dataclass(frozen=True)
class Zero3Schedule:
    epochs: Tuple[GatherEpoch, ...]
    n_eqns: int
    peak_live_elements: int
    persistent_elements: int
    prefetch_count: int          # epochs issued ahead of first use
    gather_wire_bytes: int       # per microbatch, per rank, forward tier


def _gather_recv_bytes(elems: int, world: int, tier: str, block: int) -> int:
    """Receive-side wire bytes per rank for one bucket all-gather."""
    recv = elems * (world - 1) // world
    if tier == "int8":
        nb = (elems + block - 1) // block
        return recv + 8 * nb * (world - 1) // world
    if tier == "onebit":
        return recv // 8 + 4 * (world - 1)
    return recv * 4


def _peak_live(epochs, sizes, persistent_elements: int) -> int:
    """Max gathered elements over the program: sweep every issue point; an
    epoch is live on [issue_at, last_use]."""
    peak = 0
    for t in sorted({e.issue_at for e in epochs}):
        live = sum(sizes[e.bucket] for e in epochs
                   if e.issue_at <= t <= e.last_use)
        peak = max(peak, live)
    return peak + persistent_elements


def derive_schedule(layout, np_idx, first, last, n_eqns: int,
                    max_live_parameters: Optional[int],
                    max_reuse_distance: Optional[int],
                    persistent_elements: int, world: int, fwd_tier: str,
                    block: int) -> Zero3Schedule:
    """Per-bucket gather epochs from the traced first/last uses (JAX's
    ``derive_schedule``, unchanged).

    A bucket's use points are the union of its leaves' first/last-use
    operations. The span splits into multiple epochs (release + re-gather)
    wherever the elements of OTHER buckets used strictly between two
    consecutive use points exceed ``max_reuse_distance`` — the reference's
    release rule, measured in the same parameter-element units. Epochs are
    then issued one ahead (epoch j at epoch j-1's first use; the first at
    program start) unless that would push the gathered-element peak past
    ``max_live_parameters`` — the governor budget demotes prefetches
    (latest first) back to gather-at-use."""
    sizes = [b.padded_size for b in layout.buckets]
    bucket_pts = []
    for b in layout.buckets:
        pts = sorted({p for s in b.slots
                      for p in (first[np_idx[s.leaf_index]],
                                last[np_idx[s.leaf_index]]) if p is not None})
        bucket_pts.append(pts)
    reuse = (int(max_reuse_distance)
             if max_reuse_distance and max_reuse_distance > 0 else None)

    def elems_between(bi, lo, hi):
        tot = 0
        for bj, pts in enumerate(bucket_pts):
            if bj != bi and any(lo < p < hi for p in pts):
                tot += sizes[bj]
        return tot

    spans = []  # (bucket, seg_first_use, seg_last_use)
    for bi, pts in enumerate(bucket_pts):
        if not pts:
            continue  # dead bucket: never gathered, grads stay zero
        start = prev = pts[0]
        for p in pts[1:]:
            if reuse is not None and elems_between(bi, prev, p) > reuse:
                spans.append((bi, start, prev))
                start = p
            prev = p
        spans.append((bi, start, prev))
    spans.sort(key=lambda s: (s[1], s[0]))

    epochs = []
    for j, (bi, fu, lu) in enumerate(spans):
        issue = -1 if j == 0 else min(spans[j - 1][1], fu)
        epochs.append(GatherEpoch(bucket=bi, issue_at=issue, first_use=fu,
                                  last_use=lu))
    budget = (int(max_live_parameters)
              if max_live_parameters and max_live_parameters > 0 else None)
    if budget is not None:
        # demote prefetches, latest-issued first, until the peak fits
        for j in range(len(epochs) - 1, -1, -1):
            if _peak_live(epochs, sizes, persistent_elements) <= budget:
                break
            e = epochs[j]
            if e.prefetched:
                epochs[j] = replace(e, issue_at=e.first_use)
        peak = _peak_live(epochs, sizes, persistent_elements)
        if peak > budget:
            logger.warning(
                f"ZeRO-3 schedule: gathered-element peak {peak} exceeds "
                f"stage3_max_live_parameters={budget} even with every "
                f"prefetch demoted — bucket spans overlap structurally; "
                f"lower gradient_comm.bucket_size_mb")
    wire = sum(_gather_recv_bytes(sizes[e.bucket], world, fwd_tier, block)
               for e in epochs)
    return Zero3Schedule(
        epochs=tuple(epochs), n_eqns=n_eqns,
        peak_live_elements=_peak_live(epochs, sizes, persistent_elements),
        persistent_elements=persistent_elements,
        prefetch_count=sum(1 for e in epochs if e.prefetched),
        gather_wire_bytes=wire)


def _swap(obj, fn):
    """``obj`` (a call's args and kwargs) with ``fn`` applied to every
    tensor inside tuples, lists and dicts."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, (tuple, list)):
        return type(obj)(_swap(x, fn) for x in obj)
    if isinstance(obj, dict):
        return {k: _swap(v, fn) for k, v in obj.items()}
    return obj


def _reads(obj, leaf_of, out):
    """The leaf indices of the parameters in ``obj`` (into ``out``)."""
    if isinstance(obj, torch.Tensor):
        k = leaf_of.get(id(obj))
        if k is not None:
            out.append(k)
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            _reads(x, leaf_of, out)
    elif isinstance(obj, dict):
        for x in obj.values():
            _reads(x, leaf_of, out)
    return out


class _LeafMode(TorchFunctionMode):
    """Every call that reads a leaf (a parameter in ``leaf_of``) is one
    operation, numbered from 0; ``at(t, leaves)`` runs before it and
    returns each leaf's stand-in, ``after(t)`` after it. Attribute reads
    (``.shape``, ``.dtype``) are not operations: the placeholders answer
    them."""

    def __init__(self, leaf_of, at, after=None):
        super().__init__()
        self.leaf_of, self.at, self.after = leaf_of, at, after
        self.t = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(func, "__name__", None) == "__get__":
            return func(*args, **kwargs)
        read = _reads((args, kwargs), self.leaf_of, [])
        if not read:
            return func(*args, **kwargs)
        t, self.t = self.t, self.t + 1
        stand_in = self.at(t, read)
        args, kwargs = _swap((args, kwargs),
                             lambda x: stand_in.get(self.leaf_of.get(id(x)), x))
        out = func(*args, **kwargs)
        if self.after is not None:
            self.after(t)
        return out


def trace_param_uses(run, params, dtype=None):
    """``(first, last, n_ops)``: the first and last operation of ``run()``
    that reads each tensor of ``params`` (None for one never read), over
    the sequence of the calls that read any of them. ``run`` is called
    under ``no_grad`` with zeros (of ``dtype``, default each parameter's)
    standing in for the parameters."""
    leaf_of = {id(p): k for k, p in enumerate(params)}
    first: List[Optional[int]] = [None] * len(params)
    last: List[Optional[int]] = [None] * len(params)

    def at(t, read):
        out = {}
        for k in read:
            if first[k] is None:
                first[k] = t
            last[k] = t
            p = params[k]
            out[k] = torch.zeros(p.shape, dtype=dtype or p.dtype, device=p.device)
        return out

    mode = _LeafMode(leaf_of, at)
    with torch.no_grad(), mode:
        run()
    return first, last, mode.t


def _shape_key(args, kwargs):
    def one(x):
        if isinstance(x, torch.Tensor):
            return ("T", tuple(x.shape), str(x.dtype))
        if isinstance(x, (tuple, list)):
            return tuple(one(v) for v in x)
        if isinstance(x, dict):
            return tuple(sorted((k, one(v)) for k, v in x.items()))
        return repr(x)
    return one((args, kwargs))


# ---------------------------------------------------------------------------
# the scheduled step
# ---------------------------------------------------------------------------


class Zero3Store:
    """The store of ``engine`` (whose flat layout's units are ``meta``'s
    buckets, then the persistent unit): the placeholders and the
    persistent compute copy, the schedules per batch shape, the scheduled
    forward, and the wire's ``train_batch``. ``stats``: the steps run, the
    gathers issued (``recompute_gathers``: those of remat's recomputes),
    the forward gathers' wire bytes banked (the schedule's
    ``gather_wire_bytes`` a micro-batch) and the last step's seconds."""

    def __init__(self, engine, meta: Zero3StoreMeta):
        cfg = engine._config
        zc, gc = cfg.zero_config, cfg.gradient_comm_config
        self.engine = engine
        self.meta = meta
        self.layout = engine.layout
        self.n_buckets = len(meta.layout.buckets)
        self.group = engine.zero_plan.dp_axes
        self.w = engine.dp_world_size
        self.block = int(gc.quantization_block_size)
        self.fwd_tier = "int8" if zc.zero_quantized_weights else "fp32"
        self.bwd_tier = "int8" if zc.zero_quantized_gradients else "fp32"
        self.max_live, self.max_reuse = zc.max_live_parameters, zc.max_reuse_distance
        self.dtype = engine.compute_dtype
        params = engine._params
        self.leaves = [params[i] for i in meta.order]  # JAX leaf order
        np_set = set(meta.np_idx)
        self.leaf_of = {id(p): k for k, p in enumerate(self.leaves) if k in np_set}
        self._bucket_of = {meta.np_idx[s.leaf_index]: b
                           for b, bucket in enumerate(meta.layout.buckets) for s in bucket.slots}
        self.schedules = {}
        self.stats = {"steps": 0, "gathers": 0, "recompute_gathers": 0, "wire_bytes": 0}
        self._shards = None
        device = engine.device
        self._nan = torch.full((), float("nan"), dtype=self.dtype, device=device)
        for k in meta.np_idx:
            self.leaves[k].data = self._nan.expand(meta.leaf_shapes[k])
        self.persistent = self.layout.units[-1] if meta.p_idx else None
        self.pers_full = None
        if self.persistent is not None:
            u = self.persistent
            self.pers_full = torch.empty(u.length, dtype=self.dtype, device=device)
            for i, (a, b) in zip(u.params, u.bounds):
                params[i].data = self.pers_full[a:b].view(engine._shapes[i])
        self.refresh_persistent()

    # ---- the compute copy

    @torch.no_grad()
    def refresh_persistent(self):
        """The persistent leaves' whole compute copy from the masters."""
        if self.persistent is None:
            return
        u, lay = self.persistent, self.layout
        shard = lay.unit_shard(self.engine._flat_master, u).to(self.dtype)
        comm.all_gather_into_tensor(self.pers_full, shard, group=self.group)

    # ---- the schedule

    def schedule_for(self, args, kwargs) -> Zero3Schedule:
        """The schedule of a forward on ``args``/``kwargs``'s shapes, traced
        at its first call."""
        key = _shape_key(args, kwargs)
        sched = self.schedules.get(key)
        if sched is None:
            np_idx = self.meta.np_idx  # the persistent leaves are never gathered
            f, g, n_ops = trace_param_uses(lambda: self.engine.module(*args, **kwargs),
                                           [self.leaves[k] for k in np_idx], self.dtype)
            first, last = [None] * self.meta.n_leaves, [None] * self.meta.n_leaves
            for k, a, b in zip(np_idx, f, g):
                first[k], last[k] = a, b
            sched = self.schedules[key] = derive_schedule(
                self.meta.layout, self.meta.np_idx, first, last, n_ops, self.max_live,
                self.max_reuse, self.meta.persistent_elements, self.w, self.fwd_tier,
                self.block)
            self.engine._zero3_schedule = sched
            logger.info(f"ZeRO-3 scheduled step: {len(sched.epochs)} gather epochs over "
                        f"{self.n_buckets} buckets ({sched.prefetch_count} prefetched), tiers "
                        f"fwd={self.fwd_tier}/bwd={self.bwd_tier}, peak live "
                        f"{sched.peak_live_elements} elements (budget {self.max_live:.3g}), "
                        f"{sched.gather_wire_bytes} gather B/microbatch/rank")
        return sched

    def call(self, args, kwargs):
        """The module's output on ``args``/``kwargs`` with every bucket
        leaf read through the schedule. Under grad mode the gradients come
        back as this rank's bucket shards (``collect``)."""
        sched = self.schedule_for(args, kwargs)
        self.engine._zero3_schedule = sched
        lay, master = self.layout, self.engine._flat_master
        grad = torch.is_grad_enabled()
        shards = [lay.unit_shard(master, u).detach().requires_grad_(grad)
                  for u in lay.units[:self.n_buckets]]
        self._shards = shards if grad else None
        buckets = self.meta.layout.buckets
        issue_at, land_at, drop_at = {}, {}, {}
        for j, e in enumerate(sched.epochs):
            issue_at.setdefault(e.issue_at, []).append((j, e))
            land_at.setdefault(e.first_use, []).append((j, e))
            drop_at.setdefault(e.last_use, []).append((j, e))
        inflight, env = {}, {}

        def issue(j, e):
            with _disable_current_modes():
                inflight[j] = param_gather_bucket(shards[e.bucket], self.group, self.fwd_tier,
                                                  self.bwd_tier, self.block, async_op=True)
            self.stats["gathers"] += 1

        def at(t, read):
            for j, e in issue_at.get(t, ()):
                issue(j, e)
            for j, e in land_at.get(t, ()):
                with _disable_current_modes():
                    full = inflight.pop(j).wait().to(self.dtype)
                    views = self._split(e.bucket, full)
                for k, view in views.items():
                    env[k] = (j, view)
            try:
                return {k: env[k][1] for k in read}
            except KeyError as e:
                raise RuntimeError(
                    f"scheduled ZeRO-3: {self.engine.param_names[self.meta.order[e.args[0]]]} "
                    f"read at operation {t} outside its gather epoch; the forward's "
                    "operations differ from its trace") from None

        def after(t):
            for j, e in drop_at.get(t, ()):
                for s in buckets[e.bucket].slots:
                    k = self.meta.np_idx[s.leaf_index]
                    if env.get(k, (None, ))[0] == j:
                        del env[k]

        for j, e in issue_at.get(-1, ()):
            issue(j, e)
        policy = self.engine._remat_policy
        try:
            with _LeafMode(self.leaf_of, at, after), \
                    checkpointing.recompute_under(self._recompute_mode):
                if policy:
                    return checkpointing.checkpoint_with(policy, self.engine.module, *args,
                                                         **kwargs)
                return self.engine.module(*args, **kwargs)
        finally:
            for h in inflight.values():  # an epoch whose use never came
                h.handle.wait()

    def _split(self, b, full):
        """Bucket ``b``'s gathered ``full`` (in the compute dtype) as
        ``{leaf: view}``."""
        bucket = self.meta.layout.buckets[b]
        sizes = [s.size for s in bucket.slots]
        pad = bucket.padded_size - bucket.size
        parts = full.split_with_sizes(sizes + [pad] if pad else sizes)
        return {self.meta.np_idx[s.leaf_index]: part.view(s.shape)
                for s, part in zip(bucket.slots, parts)}

    def _recompute_mode(self):
        """The mode a checkpointed region's recompute runs under: each
        bucket the region reads is gathered again at its first read and
        dropped with the mode. The gather starts from a detached copy of
        the shard that requires grad, so the recompute saves what the
        forward saved (a product of weights that need no gradient saves
        nothing); the forward's gather carries the gradient. The gathers
        here and in the forward run outside the dispatch modes, so a
        selective policy's op counts see the model's operations alone."""
        lay, master = self.layout, self.engine._flat_master
        env = {}

        def at(t, read):
            for k in read:
                if k not in env:
                    b = self._bucket_of[k]
                    with _disable_current_modes():
                        shard = lay.unit_shard(master, lay.units[b]).detach().requires_grad_()
                        full = param_gather_bucket(shard, self.group, self.fwd_tier,
                                                   self.bwd_tier, self.block)
                        env.update(self._split(b, full.to(self.dtype)))
                    self.stats["recompute_gathers"] += 1
            return {k: env[k] for k in read}

        return _LeafMode(self.leaf_of, at)

    @torch.no_grad()
    def collect(self, acc: torch.Tensor, persistent_acc: Optional[torch.Tensor] = None):
        """After a backward: the bucket shards' gradients added into
        ``acc`` (this rank's flat state), the persistent leaves' gradients
        into ``persistent_acc`` (the persistent unit's whole buffer; None:
        summed over the ranks into ``acc`` now, in fp32), each ``.grad``
        dropped."""
        eng, lay = self.engine, self.layout
        for u, s in zip(lay.units, self._shards or ()):
            if s.grad is not None:
                lay.unit_shard(acc, u).add_(s.grad)
        self._shards = None
        for k in self.meta.np_idx:
            if self.leaves[k].grad is not None:
                raise RuntimeError(
                    f"scheduled ZeRO-3: {eng.param_names[self.meta.order[k]]} took its gradient "
                    "outside the store's gather (a call that does not take part in "
                    "__torch_function__ read the parameter)")
        u = self.persistent
        if u is None:
            return
        local = persistent_acc if persistent_acc is not None else torch.zeros(
            u.length, dtype=torch.float32, device=acc.device)
        for i, (a, b) in zip(u.params, u.bounds):
            p = eng._params[i]
            if p.grad is not None:
                local[a:b].add_(p.grad.reshape(-1))
                p.grad = None
        if persistent_acc is None:
            self.reduce_persistent(acc, local)

    def reduce_persistent(self, acc, local):
        """The persistent unit's local gradients summed over the ranks
        (fp32, as JAX's ``psum``) and added into its shard of ``acc``."""
        u = self.persistent
        self.layout.unit_shard(acc, u).add_(comm.reduce_scatter(local, group=self.group))

    # ---- the wire's step

    def train_batch(self, data_iter, batch):
        """One optimizer step over ``gas`` micro-batches of ``data_iter``
        (each through ``batch``); returns the mean loss as a float."""
        eng = self.engine
        gas = eng.gradient_accumulation_steps()
        t0 = time.perf_counter()
        acc = eng._flat_grad
        acc32 = acc if acc.dtype == torch.float32 else torch.zeros_like(acc, dtype=torch.float32)
        pers = (torch.zeros(self.persistent.length, dtype=torch.float32, device=eng.device)
                if self.persistent is not None else None)
        total = torch.zeros((), dtype=torch.float32, device=eng.device)
        for _ in range(gas):
            loss = eng._local_loss(*batch(next(data_iter)))
            (loss.float() / gas).backward()
            total = total + loss.detach().float()
            self.collect(acc32, pers)
        with torch.no_grad():
            if pers is not None:
                self.reduce_persistent(acc32, pers)
            acc32.mul_(reciprocal(self.w, eng.device))  # XLA's s / w
        overflow = eng._apply_step(acc32)
        if acc32 is not acc:
            acc32.zero_()
        mean = comm.all_reduce(total / gas, group=self.group).mul_(
            reciprocal(self.w, eng.device)[0])
        host = eng._fetch(torch.stack([mean, overflow.float()]))
        eng.micro_steps += gas
        eng.losses = mean
        eng._settle([bool(host[1])])
        sched = eng._zero3_schedule
        self.stats["steps"] += 1
        if sched is not None:
            self.stats["wire_bytes"] += gas * sched.gather_wire_bytes
        self.stats["seconds"] = time.perf_counter() - t0
        return float(host[0])
