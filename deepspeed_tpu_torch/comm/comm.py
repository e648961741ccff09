"""Functional communication API (port of ``deepspeed_tpu/comm/comm.py``).

The module-level collectives (``all_reduce``, ``all_gather``,
``reduce_scatter``, ``all_to_all_single``, ``broadcast``, ``ppermute``,
...) over ``torch.distributed`` process groups, with groups named by mesh
axes as in JAX (``comm/mesh.py``): ``group=None`` is every axis,
``"fsdp"`` one axis, ``("data", "fsdp")`` a tuple flattened with its
first axis major.

The contract of each collective is the JAX eager one, rank by rank: rank
``r`` holds the local block that JAX device ``r`` holds of the input, and
gets back device ``r``'s block of the JAX eager result. So ``all_gather``
concatenates (``tiled``) or stacks the group's blocks along ``axis`` in
axis-index order; ``reduce_scatter`` reduces the blocks and hands index
``i`` the ``i``-th chunk along ``axis``; ``all_to_all_single`` splits the
block along ``split_axis``, sends chunk ``j`` to index ``j`` and
concatenates what it receives along ``concat_axis``; ``broadcast`` and
``ppermute`` name ranks by their index in the group. ``AVG`` is the sum
divided by the group's size, as ``pmean``. Like JAX, ``reduce`` and
``gather`` leave their result on every rank. Unlike JAX, ``send``,
``recv`` and ``scatter`` run (JAX has no eager form of them): a rank is
named by its index in the group.

``all_reduce``, ``broadcast``, ``recv`` and ``scatter`` write into their
tensor, as ``torch.distributed`` does, and return it; the others return
new tensors (``*_into_tensor`` and ``reduce_scatter_tensor`` fill the
output they are given). ``async_op=True`` returns a ``CommHandle``
whose ``wait()`` returns the result. On CUDA tensors over NCCL a
collective is enqueued on the current stream and the host does not wait.

``init_distributed`` discovers rank, world and master from torchrun's
``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``MASTER_ADDR``/``MASTER_PORT``, or
from the schedulers' variables (``mpi_discovery``), initializes the
default process group (``nccl`` with CUDA, else ``gloo``) and builds the
mesh. A single process needs no process group: the mesh is then one rank
and every collective a copy. The retrying rendezvous and
``exchange_host_state`` of the JAX module are not ported yet.
"""

import datetime
import functools
import os
import time
import warnings
from typing import Optional, Sequence, Union

import torch

from .comms_logging import get_comms_logger
from .mesh import (MESH_AXES, AxisGroup, MeshContext, get_mesh_context, mesh_is_initialized,
                   set_mesh_context)
from .reduce_op import ReduceOp, to_torch

AxisNames = Union[str, Sequence[str], None]

_INITIALIZED = False
_LOCAL_RANK = 0

# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _dist():
    import torch.distributed as dist
    return dist


def _group(group: AxisNames) -> AxisGroup:
    return get_mesh_context().group(group)


class CommHandle:
    """Handle of an ``async_op`` collective: ``wait()`` waits for it (on the
    device's stream, for NCCL) and returns its result."""

    def __init__(self, value=None, work=None, finish=None):
        self.value = value
        self._work = work
        self._finish = finish

    def wait(self):
        if self._work is not None:
            self._work.wait()
            self._work = None
        if self._finish is not None:
            self.value = self._finish()
            self._finish = None
        return self.value


def _finish(result, work, finish, async_op):
    """The result of a collective that ``finish`` completes once ``work``
    (None when done) is done."""
    if async_op:
        return CommHandle(result, work, finish)
    if work is not None:
        work.wait()
    return finish() if finish is not None else result


def timed_op(func):
    """Time and log an op while the comms logger is on (the device is
    synchronised around it then), as ``comm.py:101 timed_op``."""

    @functools.wraps(func)
    def wrapper(tensor, *args, **kwargs):
        cl = get_comms_logger()
        if not (cl.records(func.__name__) and isinstance(tensor, torch.Tensor)):
            return func(tensor, *args, **kwargs)
        sync = torch.cuda.synchronize if tensor.is_cuda else (lambda: None)
        sync()
        t0 = time.time()
        result = func(tensor, *args, **kwargs)
        if isinstance(result, CommHandle):
            result.wait()
        sync()
        group = kwargs.get("group")
        n = get_world_size(group)
        cl.append(func.__name__, kwargs.get("log_name", func.__name__), time.time() - t0,
                  tensor.numel() * tensor.element_size(), n)
        return result

    return wrapper


def _reorder(x: torch.Tensor, index) -> torch.Tensor:
    """``x``'s leading chunks taken in the order ``index`` (None: as is)."""
    if index is None:
        return x
    return x[torch.tensor(index, device=x.device)]


def _inverse(order):
    if order is None:
        return None
    inv = [0] * len(order)
    for i, g in enumerate(order):
        inv[g] = i
    return inv


def _stack_gather(x: torch.Tensor, grp: AxisGroup, async_op=False):
    """``[n, *x.shape]``: the group's blocks in axis-index order; returns
    (result, work, finish)."""
    x = x.contiguous()
    flat = x.reshape(-1) if x.dim() == 0 else x
    cat = torch.empty((grp.size * flat.shape[0], ) + tuple(flat.shape[1:]), dtype=x.dtype,
                      device=x.device)  # the blocks end to end along dim 0
    out = cat.view((grp.size, ) + tuple(x.shape))
    if grp.pg is None:
        out[0].copy_(x)
        return out, None, None

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        work = _dist().all_gather_into_tensor(cat, flat, group=grp.pg, async_op=async_op)
    return out, work, (lambda: _reorder(out, grp.order))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def parse_slurm_nodelist(nodelist: str) -> list:
    """Expand Slurm's compact nodelist syntax ("n[001-003,007],login-0",
    bracket groups may carry suffixes or repeat: "rack[1-2]-n[1-4]") into
    hostnames, without shelling out to ``scontrol show hostnames``."""

    def _split_top(s):
        parts, depth, cur = [], 0, []
        for ch in s:
            if ch == "[":
                depth += 1
            elif ch == "]":
                depth -= 1
            if ch == "," and depth == 0:
                parts.append("".join(cur))
                cur = []
            else:
                cur.append(ch)
        if cur:
            parts.append("".join(cur))
        return parts

    def _expand(tok):
        i = tok.find("[")
        if i < 0:
            return [tok]
        j = tok.index("]", i)
        prefix, body, rest = tok[:i], tok[i + 1:j], tok[j + 1:]
        vals = []
        for part in body.split(","):
            if "-" in part:
                lo, hi = part.split("-")
                width = len(lo)
                vals.extend(f"{v:0{width}d}" for v in range(int(lo), int(hi) + 1))
            else:
                vals.append(part)
        return [prefix + v + tail for v in vals for tail in _expand(rest)]

    return [h for tok in _split_top(nodelist) if tok for h in _expand(tok)]


def _env(*names, default=None):
    for n in names:
        if os.environ.get(n) not in (None, ""):
            return os.environ[n]
    return default


def mpi_discovery(distributed_port: int = 29500, auto: bool = True):
    """``(coordinator_address, num_processes, process_id)`` from the
    scheduler's environment, as the JAX function reads it: explicit
    ``JAX_COORDINATOR_ADDRESS``/``COORDINATOR_ADDRESS`` with
    ``JAX_NUM_PROCESSES``/``JAX_PROCESS_ID`` (``bin/deepspeed``'s ssh
    fan-out) and OpenMPI's ``OMPI_COMM_WORLD_SIZE``/``RANK`` always; with
    ``auto`` the coordinator from ``OMPI_MCA_orte_hnp_uri``, Slurm's step
    (``SLURM_STEP_NUM_TASKS``, ``SLURM_PROCID``, the first host of
    ``SLURM_STEP_NODELIST``/``SLURM_JOB_NODELIST``), MPICH/MVAPICH's PMI
    variables and ``DS_HOSTLIST``. Each field is resolved on its own: the
    explicit variables win. ``(None, 1, 0)`` when nothing is found."""
    coord = _env("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS")
    nproc = _env("JAX_NUM_PROCESSES", "NUM_PROCESSES", "OMPI_COMM_WORLD_SIZE")
    pid = _env("JAX_PROCESS_ID", "PROCESS_ID", "OMPI_COMM_WORLD_RANK")

    if auto and _env("OMPI_COMM_WORLD_SIZE"):
        if coord is None:
            uri = _env("OMPI_MCA_orte_hnp_uri", "PMIX_SERVER_URI2", default="")
            if "tcp://" in uri:
                head = uri.split("tcp://", 1)[1].split(",")[0].split(":")[0]
                coord = f"{head}:{distributed_port}"
    elif auto and _env("SLURM_STEP_NUM_TASKS"):
        # step-scoped variables only: a bare sbatch/salloc shell has the
        # allocation's SLURM_NTASKS and no step, so no peers to wait for
        nproc = nproc if nproc is not None else _env("SLURM_STEP_NUM_TASKS")
        pid = pid if pid is not None else _env("SLURM_PROCID", default="0")
        if coord is None:
            nodelist = _env("SLURM_STEP_NODELIST", "SLURM_JOB_NODELIST")
            if nodelist:
                coord = f"{parse_slurm_nodelist(nodelist)[0]}:{distributed_port}"
    elif auto and (_env("MV2_COMM_WORLD_SIZE") or _env("PMI_SIZE")):
        # PMI v1 carries no coordinator: the launcher pins it
        nproc = nproc if nproc is not None else _env("MV2_COMM_WORLD_SIZE", "PMI_SIZE")
        pid = pid if pid is not None else _env("MV2_COMM_WORLD_RANK", "PMI_RANK",
                                               default="0")
    elif auto and _env("DS_HOSTLIST"):
        import socket
        hosts = [h for h in _env("DS_HOSTLIST").split(",") if h]
        nproc = nproc if nproc is not None else str(len(hosts))
        if pid is None:
            me = socket.gethostname()
            cands = [i for i, h in enumerate(hosts)
                     if h == me or h.split(".")[0] == me.split(".")[0]]
            if not cands:
                raise RuntimeError(
                    f"DS_HOSTLIST={_env('DS_HOSTLIST')} does not contain this "
                    f"host ({me}); every node would claim process_id=0 and "
                    "the rendezvous would hang. Use hostnames matching "
                    "`hostname` output in the hostfile, or export "
                    "JAX_PROCESS_ID explicitly.")
            pid = str(cands[0])
        if coord is None:
            coord = f"{hosts[0]}:{distributed_port}"

    return coord, int(nproc or "1"), int(pid or "0")


def discover_rendezvous(distributed_port: int = 29500, auto: bool = True):
    """``(init_method, world_size, rank, local_rank)`` from the
    environment: torchrun's variables first (``env://``), else
    ``mpi_discovery``'s coordinator as ``tcp://host:port``; the local rank
    from ``LOCAL_RANK``, ``OMPI_COMM_WORLD_LOCAL_RANK`` or
    ``SLURM_LOCALID`` (else 0)."""
    local = int(_env("LOCAL_RANK", "OMPI_COMM_WORLD_LOCAL_RANK", "SLURM_LOCALID",
                     default="0"))
    if _env("RANK") is not None and _env("WORLD_SIZE") is not None:
        method = "env://" if _env("MASTER_ADDR") is not None else None
        return method, int(_env("WORLD_SIZE")), int(_env("RANK")), local
    coord, nproc, pid = mpi_discovery(distributed_port, auto=auto)
    if coord is None and _env("MASTER_ADDR") is not None:
        coord = f"{_env('MASTER_ADDR')}:{_env('MASTER_PORT', default=str(distributed_port))}"
    return (f"tcp://{coord}" if coord else None), nproc, pid, local


def init_distributed(dist_backend: Optional[str] = None,
                     auto_mpi_discovery: bool = True,
                     distributed_port: int = 29500,
                     verbose: bool = True,
                     timeout=None,
                     init_method=None,
                     dist_init_required=None,
                     config=None,
                     rank: int = -1,
                     world_size: int = -1,
                     mesh_axes: Optional[dict] = None):
    """Initialize the default process group (when there is more than one
    process, or ``init_method``/``dist_init_required`` ask for one) and the
    global mesh; returns the ``MeshContext``. The backend is ``nccl`` with
    CUDA, else ``gloo``; with CUDA the device is ``local_rank % device
    count``. ``rank``/``world_size`` override what the environment says."""
    global _INITIALIZED, _LOCAL_RANK
    dist = _dist()
    if not dist.is_initialized():
        method, nproc, pid, local = discover_rendezvous(distributed_port, auto_mpi_discovery)
        if rank >= 0:
            pid = rank
        if world_size > 0:
            nproc = world_size
        method = init_method or method
        if nproc > 1 or init_method is not None or dist_init_required:
            backend = dist_backend or ("nccl" if torch.cuda.is_available() else "gloo")
            if method is None:
                raise RuntimeError(
                    f"init_distributed: {nproc} processes but no rendezvous: set "
                    "MASTER_ADDR/MASTER_PORT (torchrun) or pass init_method")
            if torch.cuda.is_available():
                torch.cuda.set_device(local % torch.cuda.device_count())
            if timeout is not None and not hasattr(timeout, "total_seconds"):
                timeout = datetime.timedelta(seconds=float(timeout))
            kwargs = {} if timeout is None else {"timeout": timeout}
            dist.init_process_group(backend, init_method=method, rank=pid,
                                    world_size=nproc, **kwargs)
        _LOCAL_RANK = local
    if not mesh_is_initialized():
        set_mesh_context(MeshContext.create(axis_sizes=mesh_axes))
    _INITIALIZED = True
    return get_mesh_context()


def is_initialized():
    return _INITIALIZED or mesh_is_initialized()


def initialize_mesh_device(mesh_shape, mesh_axis_names):
    """Reference ``comm.py:603``; returns the global MeshContext."""
    sizes = dict(zip(mesh_axis_names, mesh_shape))
    ctx = MeshContext.create(axis_sizes=sizes, axis_order=tuple(mesh_axis_names))
    set_mesh_context(ctx)
    return ctx


# ---------------------------------------------------------------------------
# topology queries
# ---------------------------------------------------------------------------


def get_world_size(group: AxisNames = None) -> int:
    return get_mesh_context().axis_size(group)


def get_rank(group: AxisNames = None) -> int:
    """The global rank, or with ``group`` this rank's index along its axes
    (JAX's host-level ``get_rank`` is the process index either way; its
    in-trace index is ``get_axis_index``)."""
    if group is None:
        return get_mesh_context().rank
    return _group(group).index


def get_local_rank() -> int:
    return _LOCAL_RANK


def get_axis_index(axis: AxisNames) -> int:
    """This rank's index along ``axis`` (flattened over multiple axes)."""
    return _group(axis).index


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _reduce_(tensor, op, grp, async_op):
    """``tensor`` reduced over the group in place; (work, finish)."""
    if op == ReduceOp.AVG:
        torch_op, finish = to_torch(ReduceOp.SUM), (lambda: tensor.div_(grp.size))
    else:
        torch_op, finish = to_torch(op), None
    if grp.pg is None:
        return None, finish
    work = _dist().all_reduce(tensor, op=torch_op, group=grp.pg, async_op=async_op)
    return work, finish


@timed_op
def all_reduce(tensor, op: ReduceOp = ReduceOp.SUM, group: AxisNames = None, async_op=False,
               **kw):
    """``tensor`` reduced over the group, in place; returns it."""
    grp = _group(group)
    work, finish = _reduce_(tensor, op, grp, async_op)
    return _finish(tensor, work, (lambda: finish() if finish else tensor), async_op)


def inference_all_reduce(tensor, op: ReduceOp = ReduceOp.SUM, group: AxisNames = None, **kw):
    """Reference comm.py:500 fast path: the same all-reduce."""
    return all_reduce(tensor, op=op, group=group)


@timed_op
def all_gather(tensor, group: AxisNames = None, axis: int = 0, tiled: bool = True,
               async_op=False, **kw):
    """The group's blocks concatenated along ``axis`` (``tiled``) or stacked
    on a new ``axis``, in axis-index order."""
    grp = _group(group)
    out, work, reorder = _stack_gather(tensor, grp, async_op)
    axis = axis % (tensor.dim() + (0 if tiled else 1)) if tensor.dim() else 0

    def finish():
        g = reorder() if reorder is not None else out
        moved = g.movedim(0, axis)
        if not tiled:
            return moved
        shape = list(tensor.shape)
        shape[axis] *= grp.size
        return moved.reshape(shape)

    return _finish(out, work, finish, async_op)


def all_gather_into_tensor(output_tensor, tensor, group=None, async_op=False):
    """The blocks concatenated along dim 0 into ``output_tensor`` (a new
    tensor when None); returns it."""
    grp = _group(group)
    direct = (output_tensor is not None and output_tensor.is_contiguous() and grp.order is None
              and tensor.is_contiguous() and output_tensor.numel() == grp.size * tensor.numel())
    if direct and grp.pg is not None:  # straight into the caller's buffer
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            work = _dist().all_gather_into_tensor(output_tensor, tensor, group=grp.pg,
                                                  async_op=async_op)
        return _finish(output_tensor, work, None, async_op)
    out, work, reorder = _stack_gather(tensor, grp, async_op)

    def finish():
        g = reorder() if reorder is not None else out
        g = g.reshape((grp.size * tensor.shape[0], ) + tuple(tensor.shape[1:])
                      if tensor.dim() else (grp.size, ))
        if output_tensor is None:
            return g
        output_tensor.copy_(g.reshape(output_tensor.shape))
        return output_tensor

    return _finish(out, work, finish, async_op)


def has_all_gather_into_tensor():
    return True


def has_reduce_scatter_tensor():
    return True


@timed_op
def reduce_scatter(tensor, group: AxisNames = None, axis: int = 0,
                   op: ReduceOp = ReduceOp.SUM, async_op=False, **kw):
    """The blocks reduced, split along ``axis`` into the group's size of
    chunks: index ``i`` gets chunk ``i``."""
    grp = _group(group)
    axis = axis % tensor.dim()
    n = grp.size
    if tensor.shape[axis] % n:
        raise ValueError(f"reduce_scatter: dim {axis} of {tuple(tensor.shape)} does not "
                         f"divide by the group's {n} ranks")
    moved = tensor.movedim(axis, 0)
    chunks = moved.reshape((n, moved.shape[0] // n) + tuple(moved.shape[1:]))
    inp = _reorder(chunks, _inverse(grp.order)).reshape(moved.shape).contiguous()
    out = torch.empty(chunks.shape[1:], dtype=tensor.dtype, device=tensor.device)
    torch_op = to_torch(ReduceOp.SUM if op == ReduceOp.AVG else op)
    if grp.pg is None:
        out.copy_(inp)
        work = None
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            work = _dist().reduce_scatter_tensor(out, inp, op=torch_op, group=grp.pg,
                                                 async_op=async_op)

    def finish():
        res = out.div_(n) if op == ReduceOp.AVG else out
        return res.movedim(0, axis)

    return _finish(out, work, finish, async_op)


def reduce_scatter_tensor(output_tensor, tensor, op=ReduceOp.SUM, group=None, async_op=False):
    """``reduce_scatter`` along dim 0 into ``output_tensor`` (a new tensor
    when None); returns it."""
    res = reduce_scatter(tensor, group=group, op=op, async_op=async_op)

    def put(r):
        if output_tensor is None:
            return r
        output_tensor.copy_(r.reshape(output_tensor.shape))
        return output_tensor

    if async_op:
        return CommHandle(None, res, lambda: put(res.value))
    return put(res)


@timed_op
def all_to_all_single(tensor, group: AxisNames = None, split_axis: int = 0,
                      concat_axis: int = 0, async_op=False, **kw):
    """The block split along ``split_axis`` into the group's size of
    chunks, chunk ``j`` sent to index ``j``; the chunks received
    concatenated along ``concat_axis`` in index order."""
    grp = _group(group)
    n = grp.size
    split_axis, concat_axis = split_axis % tensor.dim(), concat_axis % tensor.dim()
    if tensor.shape[split_axis] % n:
        raise ValueError(f"all_to_all_single: dim {split_axis} of {tuple(tensor.shape)} "
                         f"does not divide by the group's {n} ranks")
    moved = tensor.movedim(split_axis, 0)
    chunks = moved.reshape((n, moved.shape[0] // n) + tuple(moved.shape[1:]))
    inp = _reorder(chunks, _inverse(grp.order)).reshape(moved.shape).contiguous()
    out = torch.empty_like(inp)
    if grp.pg is None:
        out.copy_(inp)
        work = None
    else:
        work = _dist().all_to_all_single(out, inp, group=grp.pg, async_op=async_op)

    def finish():
        got = _reorder(out.view(chunks.shape), grp.order)
        return torch.cat([c.movedim(0, split_axis) for c in got.unbind(0)], dim=concat_axis)

    return _finish(out, work, finish, async_op)


def all_to_all(output_tensor_list, input_tensor_list, group=None, async_op=False):
    """List form: stack, ``all_to_all_single`` on dim 0, unstack (chunks of
    one squeezed). Fills ``output_tensor_list`` when given."""
    x = torch.stack(list(input_tensor_list), dim=0)
    out = all_to_all_single(x, group=group, split_axis=0, concat_axis=0)
    n = get_world_size(group)
    chunks = [c.squeeze(0) if c.shape[0] == 1 else c for c in torch.chunk(out, n, dim=0)]
    if output_tensor_list is not None:
        for dst, c in zip(output_tensor_list, chunks):
            dst.copy_(c)
    return chunks


@timed_op
def broadcast(tensor, src: int = 0, group: AxisNames = None, async_op=False, **kw):
    """Every rank ends with index ``src``'s block, in place; returns it."""
    grp = _group(group)
    if grp.pg is None:
        return _finish(tensor, None, None, async_op)
    work = _dist().broadcast(tensor, src=grp.global_rank(src), group=grp.pg,
                             async_op=async_op)
    return _finish(tensor, work, None, async_op)


def ppermute(tensor, perm, group: AxisNames = None):
    """``lax.ppermute``: for each ``(src, dst)`` pair of axis indices the
    block of ``src`` goes to ``dst``; a rank that is no destination gets
    zeros. Point-to-point sends and receives in one batch."""
    grp = _group(group)
    me = grp.index
    out = torch.zeros_like(tensor)
    x = tensor.contiguous()
    sends = [d for s, d in perm if s == me and d != me]
    recvs = [s for s, d in perm if d == me and s != me]
    if any(s == me and d == me for s, d in perm):
        out.copy_(x)
    if sends or recvs:
        dist = _dist()
        ops = ([dist.P2POp(dist.isend, x, grp.global_rank(d), grp.pg) for d in sends]
               + [dist.P2POp(dist.irecv, out, grp.global_rank(s), grp.pg) for s in recvs])
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return out


def send(tensor, dst, group=None, tag=0):
    """Send ``tensor`` to axis index ``dst`` of the group."""
    grp = _group(group)
    _dist().send(tensor.contiguous(), grp.global_rank(dst), group=grp.pg, tag=tag)


def recv(tensor, src, group=None, tag=0):
    """Receive into ``tensor`` from axis index ``src``; returns it."""
    grp = _group(group)
    _dist().recv(tensor, grp.global_rank(src), group=grp.pg, tag=tag)
    return tensor


def barrier(group: AxisNames = None):
    grp = _group(group)
    if grp.pg is not None:
        _dist().barrier(group=grp.pg)


def monitored_barrier(group=None, timeout=None, wait_all_ranks=False):
    """gloo's monitored barrier (it names a rank that did not arrive);
    NCCL has none, so there a plain barrier."""
    grp = _group(group)
    if grp.pg is None:
        return
    if grp.backend == "gloo":
        kwargs = {} if timeout is None else {"timeout": timeout}
        _dist().monitored_barrier(group=grp.pg, wait_all_ranks=wait_all_ranks, **kwargs)
    else:
        barrier(group)


# coalesced forms: one collective per tensor, in order (reference
# comm.py all_reduce_coalesced / all_gather_coalesced)
def all_reduce_coalesced(tensors, op=ReduceOp.SUM, group=None, async_op=False):
    return [all_reduce(t, op=op, group=group) for t in tensors]


def all_gather_coalesced(tensors, group=None, async_op=False):
    return [all_gather(t, group=group) for t in tensors]


def reduce_scatter_coalesced(tensors, group=None, async_op=False):
    """Reference ``runtime/comm/coalesced_collectives.py:81``."""
    return [reduce_scatter(t, group=group) for t in tensors]


def reduce(tensor, dst, op=ReduceOp.SUM, group=None, async_op=False):
    """Every rank gets the reduction, as in JAX (a superset of a rooted
    reduce)."""
    return all_reduce(tensor, op=op, group=group, async_op=async_op)


def gather(tensor, gather_list=None, dst=0, group=None, async_op=False):
    """The blocks concatenated on dim 0 on every rank, as in JAX; also
    copied into ``gather_list`` (one block each) when given."""
    out = all_gather(tensor, group=group)
    if gather_list is not None:
        for dst_t, c in zip(gather_list, torch.chunk(out, get_world_size(group), dim=0)):
            dst_t.copy_(c.reshape(dst_t.shape))
    return out


def scatter(tensor, scatter_list=None, src=0, group=None, async_op=False):
    """Index ``src`` hands index ``i`` its ``scatter_list[i]``, written into
    ``tensor``; returns it."""
    grp = _group(group)
    if grp.pg is None:
        tensor.copy_(scatter_list[0])
        return tensor
    mine = grp.index == src
    parts = []
    if mine:
        parts = [scatter_list[i].contiguous()
                 for i in (_inverse(grp.order) or range(grp.size))]

    _dist().scatter(tensor, parts if mine else None, src=grp.global_rank(src), group=grp.pg)
    return tensor


# ---------------------------------------------------------------------------
# logging controls (reference comm.py:404-434)
# ---------------------------------------------------------------------------


def configure(deepspeed_config=None, enabled=None, prof_all=None, prof_ops=None, verbose=None,
              debug=None):
    cl = get_comms_logger()
    if deepspeed_config is not None:
        cl.configure(deepspeed_config)
    if enabled is not None:
        cl.enabled = enabled
    if prof_all is not None:
        cl.prof_all = prof_all
    if prof_ops is not None:
        cl.prof_ops = prof_ops
    if verbose is not None:
        cl.verbose = verbose
    if debug is not None:
        cl.debug = debug


def log_summary(show_straggler=False):
    return get_comms_logger().log_all(show_straggler=show_straggler)


__all__ = [
    "AxisNames", "CommHandle", "MESH_AXES", "ReduceOp", "all_gather", "all_gather_coalesced",
    "all_gather_into_tensor", "all_reduce", "all_reduce_coalesced", "all_to_all",
    "all_to_all_single", "barrier", "broadcast", "configure", "discover_rendezvous", "gather",
    "get_axis_index", "get_comms_logger", "get_local_rank", "get_rank", "get_world_size",
    "has_all_gather_into_tensor", "has_reduce_scatter_tensor", "inference_all_reduce",
    "init_distributed", "initialize_mesh_device", "is_initialized", "log_summary",
    "monitored_barrier", "mpi_discovery", "parse_slurm_nodelist", "ppermute", "recv", "reduce",
    "reduce_scatter", "reduce_scatter_coalesced", "reduce_scatter_tensor", "scatter", "send",
    "timed_op",
]
