"""The named device mesh (port of ``deepspeed_tpu/comm/mesh.py``).

One global mesh of processes (one rank per device) with the JAX package's
named axes, in its order,

    (pipe, data, fsdp, seq, expert, model)

each reference "group" an axis or a tuple of axes (``("data", "fsdp")`` is
the data-parallel world, ``"fsdp"`` the ZeRO partition group when it is
split). ``MeshContext`` holds a ``torch.distributed.device_mesh.DeviceMesh``
over the ranks (rank ``r`` at the row-major position ``r`` of the axis
sizes, as ``init_device_mesh`` lays them out) and hands out the process
group of an axis, or of a tuple of axes flattened as JAX flattens them:
the first axis major, so a rank's index along ``("data", "fsdp")`` is
``data * fsdp_size + fsdp`` (``AxisGroup``).

Without ``torch.distributed`` initialized the context is one process with
no groups, and every collective over it is a copy.

JAX's ``sharding``/``replicated`` (``NamedSharding`` over the mesh) have no
meaning here, where each process holds its own tensors: they are left out.
"""

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

MESH_AXES = ("pipe", "data", "fsdp", "seq", "expert", "model")

_GLOBAL_MESH_CTX: Optional["MeshContext"] = None


def resolve_axis_sizes(n_devices: int, sizes: Dict[str, int],
                       order: Sequence[str] = MESH_AXES) -> Dict[str, int]:
    """Resolve -1 entries: the first -1 axis absorbs all remaining devices."""
    fixed = {k: v for k, v in sizes.items() if v != -1}
    prod = int(np.prod([max(v, 1) for v in fixed.values()])) if fixed else 1
    free = [k for k in order if sizes.get(k, 1) == -1]
    out = {k: max(sizes.get(k, 1), 1) for k in order}
    if free:
        if n_devices % prod != 0:
            raise ValueError(f"Device count {n_devices} not divisible by fixed mesh axes {fixed}")
        rem = n_devices // prod
        out[free[0]] = rem
        for k in free[1:]:
            out[k] = 1
    total = int(np.prod(list(out.values())))
    if total != n_devices:
        raise ValueError(f"Mesh axes {out} (={total}) do not cover {n_devices} devices")
    return out


class AxisGroup:
    """The ranks that differ only along ``axes``, seen from one rank:
    ``ranks`` are their global ranks in JAX's order of the flattened axes
    (``ranks[i]`` is the rank at axis index ``i``), ``index`` this rank's
    axis index, ``pg`` their process group (None for a group of one with no
    ``torch.distributed``). A process group numbers its ranks in ascending
    global rank; ``order[i]`` is the group rank of axis index ``i`` (None
    where the two orders agree, as they do for axes in mesh order)."""

    def __init__(self, axes: Tuple[str, ...], ranks: List[int], index: int, pg,
                 backend: Optional[str]):
        self.axes = axes
        self.ranks = list(ranks)
        self.index = index
        self.size = len(ranks)
        self.pg = pg
        self.backend = backend
        by_rank = sorted(ranks)
        order = [by_rank.index(r) for r in ranks]
        self.order = None if order == list(range(self.size)) else order

    def global_rank(self, index: int) -> int:
        return self.ranks[index]

    def __repr__(self):
        return f"AxisGroup(axes={self.axes}, ranks={self.ranks}, index={self.index})"


class MeshContext:
    """The global mesh and the axis-name algebra every layer uses."""

    def __init__(self, sizes: Dict[str, int], axis_order: Sequence[str], rank: int = 0,
                 device_mesh=None, backend: Optional[str] = None):
        self.sizes = dict(sizes)
        self._order = tuple(axis_order)
        self.rank = rank
        self.device_mesh = device_mesh
        self.backend = backend
        self._groups = {}
        shape = tuple(self.sizes[a] for a in self._order)
        self.coords = dict(zip(self._order, np.unravel_index(rank, shape))) if shape else {}
        self.coords = {a: int(c) for a, c in self.coords.items()}

    # -------- construction --------

    @classmethod
    def create(cls, axis_sizes: Optional[Dict[str, int]] = None,
               axis_order: Sequence[str] = MESH_AXES, device_type: Optional[str] = None
               ) -> "MeshContext":
        """The mesh over every rank of ``torch.distributed`` (one process
        when it is not initialized); -1 fills an axis as in JAX, and
        ``data`` absorbs what a fully given spec leaves."""
        import torch.distributed as dist
        initialized = dist.is_available() and dist.is_initialized()
        n = dist.get_world_size() if initialized else 1
        axis_sizes = dict(axis_sizes) if axis_sizes else {"data": -1}
        if all(v != -1 for v in axis_sizes.values()):
            axis_sizes.setdefault("data", -1)
        sizes = resolve_axis_sizes(n, axis_sizes, order=axis_order)
        if not initialized:
            return cls(sizes, axis_order)
        from torch.distributed.device_mesh import init_device_mesh
        backend = dist.get_backend()
        device_type = device_type or ("cuda" if backend == "nccl" else "cpu")
        mesh = init_device_mesh(device_type, tuple(sizes[a] for a in axis_order),
                                mesh_dim_names=tuple(axis_order))
        return cls(sizes, axis_order, dist.get_rank(), mesh, backend)

    # -------- axis algebra --------

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return self._order

    def axis_size(self, axis) -> int:
        if axis is None:
            return self.world_size
        if isinstance(axis, (tuple, list)):
            return int(np.prod([self.axis_size(a) for a in axis]))
        return self.sizes.get(axis, 1)

    @property
    def world_size(self) -> int:
        return int(np.prod(list(self.sizes.values())))

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        """Axes over which pure data parallelism happens (incl. ZeRO axis)."""
        return tuple(a for a in ("data", "fsdp") if self.axis_size(a) > 1) or ("data", )

    @property
    def dp_size(self) -> int:
        return self.axis_size("data") * self.axis_size("fsdp")

    @property
    def fsdp_size(self) -> int:
        return self.axis_size("fsdp")

    @property
    def mp_size(self) -> int:
        return self.axis_size("model")

    @property
    def sp_size(self) -> int:
        return self.axis_size("seq")

    @property
    def ep_size(self) -> int:
        return self.axis_size("expert")

    @property
    def pp_size(self) -> int:
        return self.axis_size("pipe")

    # -------- process groups --------

    def axis_index(self, axes: Sequence[str]) -> int:
        """This rank's index along ``axes`` flattened (the first axis
        major), as ``lax.axis_index`` over the tuple."""
        idx = 0
        for a in axes:
            idx = idx * self.axis_size(a) + self.coords.get(a, 0)
        return idx

    def _ranks_along(self, axes: Sequence[str], coords: Dict[str, int]) -> List[int]:
        """The global ranks at ``coords`` off ``axes``, in axis-index order."""
        shape = tuple(self.sizes[a] for a in self._order)
        out = []
        for i in range(self.axis_size(tuple(axes))):
            c = dict(coords)
            for a in reversed(tuple(axes)):
                c[a] = i % self.axis_size(a)
                i //= self.axis_size(a)
            out.append(int(np.ravel_multi_index(tuple(c.get(a, 0) for a in self._order),
                                                shape)))
        return out

    def group(self, axes=None) -> AxisGroup:
        """The group of ``axes`` (an axis name, a tuple of them, or None for
        every axis). A tuple whose ranks no existing group holds makes a new
        process group: a collective call, so every rank asks for it in the
        same order (as SPMD code does)."""
        if axes is None:
            axes = self._order
        axes = (axes, ) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in self._order]
        if unknown:
            raise ValueError(f"axes {unknown} are not axes of the mesh {self._order}")
        if axes in self._groups:
            return self._groups[axes]
        ranks = self._ranks_along(axes, self.coords)
        index = ranks.index(self.rank)
        if self.device_mesh is None:
            grp = AxisGroup(axes, ranks, index, None, None)
        else:
            grp = AxisGroup(axes, ranks, index, self._process_group(axes, ranks), self.backend)
        self._groups[axes] = grp
        return grp

    def _process_group(self, axes, ranks):
        import torch.distributed as dist
        live = [a for a in axes if self.axis_size(a) > 1]
        if sorted(ranks) == list(range(self.world_size)):
            return dist.group.WORLD
        if len(live) <= 1:  # the mesh's own group of that axis (any axis for one rank)
            return self.device_mesh.get_group(live[0] if live else axes[0])
        # every rank makes every group of this partition, in one order
        others = [a for a in self._order if a not in axes]
        parts = []
        for i in range(math.prod(self.axis_size(a) for a in others)):
            c = {}
            for a in reversed(others):
                c[a] = i % self.axis_size(a)
                i //= self.axis_size(a)
            parts.append(sorted(self._ranks_along(axes, c)))
        mine, _ = dist.new_subgroups_by_enumeration(parts)
        return mine


# ---------------- global accessors ----------------


def set_mesh_context(ctx: MeshContext):
    global _GLOBAL_MESH_CTX
    _GLOBAL_MESH_CTX = ctx


def get_mesh_context() -> MeshContext:
    global _GLOBAL_MESH_CTX
    if _GLOBAL_MESH_CTX is None:
        _GLOBAL_MESH_CTX = MeshContext.create()
    return _GLOBAL_MESH_CTX


def mesh_is_initialized() -> bool:
    return _GLOBAL_MESH_CTX is not None


def reset_mesh_context():
    global _GLOBAL_MESH_CTX
    _GLOBAL_MESH_CTX = None
