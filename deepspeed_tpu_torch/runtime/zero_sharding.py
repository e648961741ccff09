"""ZeRO's partitioning of the engine's flat state (port of
``deepspeed_tpu/runtime/zero_sharding.py``).

Which state is sharded at each stage is the JAX plan's (``:157``):

- stage 1: the fp32 masters and the optimizer state;
- stage 2: and the gradient accumulation buffer;
- stage 3: and the compute copy (the parameters the model computes with),
  gathered on use (``runtime/zero3.py``); parameters of at most
  ``param_persistence_threshold`` elements stay whole on every rank, as
  ``tree_shardings(..., min_size=...)`` keeps them replicated.

The ZeRO group is JAX's (``zero_axes_for``): the ``fsdp`` axis when it is
split, else the whole data-parallel world. Gradients are summed over the
whole data-parallel world all the same: reduce-scattered inside the ZeRO
group, then all-reduced across the replicas of the group (the ``data``
axis when ``fsdp`` is split).

Where the JAX plan shards each leaf along its largest divisible dimension
(``choose_partition_dim``), the port shards flat buffers, the layout
PyTorch DeepSpeed itself uses; the update is elementwise and the norms are
summed per parameter, so the math is the same. The parameters are grouped
into units (``FlatLayout``): the gather units of stage 3 (a decoder layer,
or a chunk of ``scan_chunk_size`` layers), the rest of the model, and the
persistent parameters. Each unit is one flat segment, every parameter in
it starting at a multiple of ``FLAT_ALIGN`` elements, padded to a multiple
of ``zero world x FLAT_ALIGN`` and cut into equal shards: rank ``i`` of
the ZeRO group holds shard ``i`` of every unit, so every shard starts
256-byte aligned for K7's vector loads, and a unit is gathered or reduced
by one collective. A rank's flat state is its shards end to end.

``batch_rows`` is the port's ``batch_sharding`` (``:292``): the engine
takes the global batch and each rank its contiguous rows, in the order of
its index along the data-parallel axes, when dim 0 divides by the
data-parallel world (dim 1 with ``stacked``); otherwise every rank takes
the whole batch.
"""

from typing import List, Optional, Sequence, Tuple

import torch

FLAT_ALIGN = 64  # elements: each view of a flat fp32 buffer starts 256-byte aligned


def flat_bounds(numels, align: int = FLAT_ALIGN):
    """``(start, end)`` of each of ``numels`` in one flat buffer, every
    start a multiple of ``align``, and the buffer's length."""
    bounds, total = [], 0
    for n in numels:
        bounds.append((total, total + n))
        total += -(-n // align) * align
    return bounds, total


def zero_axes_for(ctx) -> Tuple[str, ...]:
    """The mesh axes ZeRO partitions over: the fsdp axis when it is split
    (MiCS/hybrid-shard layout), else the full data-parallel world."""
    if ctx.axis_size("fsdp") > 1:
        return ("fsdp", )
    return tuple(a for a in ("data", "fsdp") if ctx.axis_size(a) > 1)


class Unit:
    """One flat segment of the layout: the parameters ``params`` (indices
    into the engine's parameter list) at ``bounds`` within the segment of
    ``length`` elements, at ``full_offset`` in the whole flat buffer; each
    rank's shard is ``shard_len`` elements, at ``shard_offset`` in its flat
    state. ``persistent``: whole on every rank at stage 3. ``bounds`` and
    ``length`` given: the parameters at those places in a segment of that
    length (a bucket of the gradient wire, ``runtime/grad_comm.py``), the
    length a multiple of ``zero_size``."""

    def __init__(self, name: str, params: List[int], numels: Sequence[int], zero_size: int,
                 persistent: bool = False, bounds=None, length: Optional[int] = None):
        self.name = name
        self.params = list(params)
        self.persistent = persistent
        if bounds is not None:
            self.bounds, self.length = list(bounds), int(length)
        else:
            self.bounds, total = flat_bounds([numels[i] for i in self.params])
            step = zero_size * FLAT_ALIGN
            self.length = -(-total // step) * step if total else 0
        self.shard_len = self.length // zero_size
        self.full_offset = 0
        self.shard_offset = 0


class FlatLayout:
    """The units of a model's parameters over a ZeRO group of ``zero_size``
    ranks, seen from rank ``zero_index`` of it."""

    def __init__(self, units: List[Unit], n_params: int, zero_size: int, zero_index: int):
        self.units = list(units)
        self.n_params = n_params
        self.zero_size = zero_size
        self.zero_index = zero_index
        full = shard = 0
        for u in self.units:
            u.full_offset, u.shard_offset = full, shard
            full += u.length
            shard += u.shard_len
        self.full_numel, self.shard_numel = full, shard
        self.unit_of = {}
        self.full_bounds = [None] * n_params
        for k, u in enumerate(self.units):
            for i, (a, b) in zip(u.params, u.bounds):
                self.unit_of[i] = k
                self.full_bounds[i] = (u.full_offset + a, u.full_offset + b)
        # the pieces of each parameter in this rank's shards:
        # (parameter, start in the flat state, end, start in the parameter)
        self.pieces = []
        for u in self.units:
            lo = zero_index * u.shard_len
            hi = lo + u.shard_len
            for i, (a, b) in zip(u.params, u.bounds):
                s, e = max(a, lo), min(b, hi)
                if s < e:
                    self.pieces.append((i, u.shard_offset + s - lo, u.shard_offset + e - lo,
                                        s - a))

    def piece_views(self, flat: torch.Tensor):
        """Each piece's view into this rank's flat state ``flat``."""
        return [flat[s:e] for _, s, e, _ in self.pieces]

    def full_views(self, flat: torch.Tensor, shapes):
        """Each parameter's shaped view into a whole flat buffer."""
        return [flat[a:b].view(shape) for (a, b), shape in zip(self.full_bounds, shapes)]

    def unit_full(self, flat: torch.Tensor, u: Unit) -> torch.Tensor:
        return flat[u.full_offset:u.full_offset + u.length]

    def unit_shard(self, flat: torch.Tensor, u: Unit) -> torch.Tensor:
        return flat[u.shard_offset:u.shard_offset + u.shard_len]


def model_units(module, params, numels, zero_size: int, persistence_threshold: Optional[int]):
    """The units of ``params`` (the engine's trained parameters of
    ``module``): one per gather unit the model names
    (``module.gather_units()``, lists of submodules; none: the whole model
    is one unit), one for the rest, and with a ``persistence_threshold``
    one of the parameters of at most that many elements; a unit left with
    no parameter is dropped. Returns the units and, for each, the modules
    whose forward gathers it (stage 3)."""
    pid = {id(p): i for i, p in enumerate(params)}
    groups = list(module.gather_units()) if hasattr(module, "gather_units") else []
    small = set() if persistence_threshold is None else {
        i for i, n in enumerate(numels) if n <= persistence_threshold}
    taken, units, modules = set(small), [], []
    for k, mods in enumerate(groups):
        idx = [pid[id(p)] for m in mods for p in m.parameters()
               if id(p) in pid and pid[id(p)] not in taken]
        taken.update(idx)
        units.append(Unit(f"unit_{k}", idx, numels, zero_size))
        modules.append(list(mods))
    rest = [i for i in range(len(params)) if i not in taken]
    units = ([Unit("rest", rest, numels, zero_size)] + units
             + [Unit("persistent", sorted(small), numels, zero_size, persistent=True)])
    kept = [(u, m) for u, m in zip(units, [[module]] + modules + [[]]) if u.params]
    return [u for u, _ in kept], [m for _, m in kept]


class ZeroShardingPlan:
    """The stage's plan over the mesh ``ctx`` (None: one process): the ZeRO
    axes and the replica axes, and which of the engine's flat buffers are
    sharded (``shard_optimizer``, ``shard_grads``, ``shard_params``)."""

    def __init__(self, ctx, stage: int, param_persistence_threshold: int = 0):
        self.ctx = ctx
        self.stage = stage
        dp = tuple(a for a in ("data", "fsdp") if ctx is not None and ctx.axis_size(a) > 1)
        self.dp_axes = dp or ("data", )
        self.dp_size = ctx.dp_size if ctx is not None else 1
        self.zero_axes = zero_axes_for(ctx) if (stage > 0 and ctx is not None) else ()
        self.zero_size = ctx.axis_size(self.zero_axes) if self.zero_axes else 1
        self.replica_axes = tuple(a for a in dp if a not in self.zero_axes)
        self.param_persistence_threshold = param_persistence_threshold
        self.shard_optimizer = stage >= 1
        self.shard_grads = stage >= 2
        self.shard_params = stage >= 3

    def dp_index(self) -> int:
        return self.ctx.axis_index(self.dp_axes) if self.ctx is not None else 0

    def zero_index(self) -> int:
        return self.ctx.axis_index(self.zero_axes) if self.zero_axes else 0

    def batch_rows(self, x, stacked: bool = False):
        """This rank's rows of the global batch tensor ``x`` (dim 1 with
        ``stacked``), or all of it when the dim does not divide by the
        data-parallel world; anything but a tensor as it is."""
        dim = 1 if stacked else 0
        n = self.dp_size
        if n == 1 or not isinstance(x, torch.Tensor) or x.dim() <= dim or x.shape[dim] % n:
            return x
        rows = x.shape[dim] // n
        return x.narrow(dim, self.dp_index() * rows, rows)

    def splits(self, x, stacked: bool = False) -> bool:
        dim = 1 if stacked else 0
        return (self.dp_size > 1 and isinstance(x, torch.Tensor) and x.dim() > dim
                and x.shape[dim] % self.dp_size == 0)
