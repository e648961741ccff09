"""deepspeed_tpu_torch.comm over gloo ranks on the CPU, against the JAX
package's eager collectives over the same mesh axes.

Rank ``r`` of the port holds the block that JAX device ``r`` holds of the
input and must get back device ``r``'s block of the JAX result. The ranks
are spawned once per world (2: ``{data: 2}``; 4: ``{data: 2, fsdp: 2}``),
joined through a ``file://`` store under the test's ``tmp_path``, and never in
the pytest process; they import neither ``jax`` nor ``deepspeed_tpu``. The
JAX side runs once for the module in a subprocess with
``JAX_PLATFORMS=cpu`` and four forced host devices (the first two for
world 2). Inputs are small integers in fp32, so every sum is exact in any
order and the results must agree bit for bit.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.comm import mesh as tmesh

HERE = os.path.dirname(os.path.abspath(__file__))
MESHES = {2: {"data": 2}, 4: {"data": 2, "fsdp": 2}}
DF = ("data", "fsdp")

# name -> (world, function, kwargs, global shape, input spec per dim)
CASES = {
    "w4_all_reduce_sum_world": (4, "all_reduce", {}, (8, 8), (DF, None)),
    "w4_all_reduce_sum_data": (4, "all_reduce", {"group": "data"}, (8, 8), (DF, None)),
    "w4_all_reduce_sum_fsdp": (4, "all_reduce", {"group": "fsdp"}, (8, 8), (DF, None)),
    "w4_all_reduce_sum_tuple": (4, "all_reduce", {"group": DF}, (8, 8), (DF, None)),
    "w4_all_reduce_max_fsdp": (4, "all_reduce", {"group": "fsdp", "op": "MAX"}, (8, 8),
                               (DF, None)),
    "w4_all_reduce_min_tuple": (4, "all_reduce", {"group": DF, "op": "MIN"}, (8, 8),
                                (DF, None)),
    "w4_all_reduce_avg_data": (4, "all_reduce", {"group": "data", "op": "AVG"}, (8, 8),
                               (DF, None)),
    "w4_all_reduce_product_fsdp": (4, "all_reduce", {"group": "fsdp", "op": "PRODUCT"},
                                   (8, 8), (DF, None)),
    "w4_inference_all_reduce": (4, "inference_all_reduce", {"group": "data"}, (8, 8),
                                (DF, None)),
    "w4_all_gather_fsdp": (4, "all_gather", {"group": "fsdp"}, (8, 8), (DF, None)),
    "w4_all_gather_axis1_tuple": (4, "all_gather", {"group": DF, "axis": 1}, (8, 8),
                                  (DF, None)),
    "w4_all_gather_stacked_data": (4, "all_gather", {"group": "data", "tiled": False},
                                   (8, 8), (DF, None)),
    "w4_all_gather_stacked_axis1_world": (4, "all_gather", {"axis": 1, "tiled": False},
                                          (8, 8), (DF, None)),
    "w4_all_gather_into_tensor_fsdp": (4, "all_gather_into_tensor", {"group": "fsdp"},
                                       (8, 8), (DF, None)),
    "w4_reduce_scatter_fsdp": (4, "reduce_scatter", {"group": "fsdp"}, (8, 8), (DF, None)),
    "w4_reduce_scatter_axis1_tuple": (4, "reduce_scatter", {"group": DF, "axis": 1}, (8, 8),
                                      (DF, None)),
    "w4_reduce_scatter_avg_data": (4, "reduce_scatter", {"group": "data", "axis": 1,
                                                         "op": "AVG"}, (8, 8), (DF, None)),
    "w4_reduce_scatter_tensor_tuple": (4, "reduce_scatter_tensor", {"group": DF}, (16, 8),
                                       (DF, None)),
    "w4_all_to_all_fsdp": (4, "all_to_all_single", {"group": "fsdp", "split_axis": 0,
                                                    "concat_axis": 1}, (8, 8), ("fsdp", None)),
    "w4_all_to_all_tuple": (4, "all_to_all_single", {"group": DF, "split_axis": 1,
                                                     "concat_axis": 0}, (8, 16), (None, DF)),
    "w4_broadcast_fsdp": (4, "broadcast", {"group": "fsdp", "src": 1}, (8, 8), (DF, None)),
    "w4_broadcast_world": (4, "broadcast", {"src": 3}, (8, 8), (DF, None)),
    "w4_ppermute_ring_tuple": (4, "ppermute", {"group": DF,
                                               "perm": [(0, 1), (1, 2), (2, 3), (3, 0)]},
                               (8, 8), (DF, None)),
    "w4_ppermute_partial_fsdp": (4, "ppermute", {"group": "fsdp", "perm": [(0, 1)]}, (8, 8),
                                 (DF, None)),
    "w4_reduce_world": (4, "reduce", {"dst": 0}, (8, 8), (DF, None)),
    "w4_gather_data": (4, "gather", {"group": "data"}, (8, 8), (DF, None)),
    "w2_all_reduce_sum": (2, "all_reduce", {}, (4, 6), ("data", None)),
    "w2_all_reduce_avg": (2, "all_reduce", {"op": "AVG"}, (4, 6), ("data", None)),
    "w2_all_gather_axis1": (2, "all_gather", {"axis": 1}, (4, 6), ("data", None)),
    "w2_reduce_scatter": (2, "reduce_scatter", {"group": "data"}, (4, 6), ("data", None)),
    "w2_all_to_all": (2, "all_to_all_single", {"split_axis": 0, "concat_axis": 1}, (4, 6),
                      ("data", None)),
    "w2_broadcast": (2, "broadcast", {"src": 1}, (4, 6), ("data", None)),
    "w2_ppermute_swap": (2, "ppermute", {"perm": [(0, 1), (1, 0)]}, (4, 6), ("data", None)),
}


def _global(name):
    shape = CASES[name][3]
    rng = np.random.default_rng(sum(map(ord, name)))
    return rng.integers(-3, 4, size=shape).astype(np.float32)


def _local_block(x, spec, rank, world):
    """Rank ``rank``'s block of ``x`` laid out by ``spec`` over the mesh of
    ``world`` (row-major ranks, as JAX's mesh of ``jax.devices()`` and the
    port's ``init_device_mesh``)."""
    ctx = tmesh.MeshContext(tmesh.resolve_axis_sizes(world, MESHES[world]), tmesh.MESH_AXES,
                            rank)
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes, ) if isinstance(axes, str) else axes
        n, i = ctx.axis_size(axes), ctx.axis_index(axes)
        x = np.split(x, n, axis=dim)[i]
    return x


# ---------------------------------------------------------------- the JAX side


def _jax_oracle(out_path):
    """Each case's per-device output blocks from the JAX eager collective
    (``ppermute``, which has no eager form, through ``shard_map``)."""
    import jax
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    import deepspeed_tpu.comm as jdist
    from deepspeed_tpu.comm.mesh import MeshContext, reset_mesh_context, set_mesh_context

    out = {}
    for world in (2, 4):
        reset_mesh_context()
        ctx = MeshContext.create(axis_sizes=MESHES[world], devices=jax.devices()[:world])
        set_mesh_context(ctx)
        rank_of = {d.id: r for r, d in enumerate(ctx.mesh.devices.reshape(-1))}
        for name, (w, fn, kwargs, shape, spec) in CASES.items():
            if w != world:
                continue
            x = jax.device_put(_global(name), ctx.sharding(*spec))
            kw = dict(kwargs)
            if "op" in kw:
                kw["op"] = jdist.ReduceOp[kw["op"]]
            if fn == "ppermute":
                axes = kw["group"] if "group" in kw else tuple(ctx.axis_names)
                res = jax.jit(shard_map(lambda v: jax.lax.ppermute(v, axes, kw["perm"]),
                                        mesh=ctx.mesh, in_specs=(P(*spec), ),
                                        out_specs=P(*spec), check_rep=False))(x)
            elif fn in ("all_gather_into_tensor", "reduce_scatter_tensor"):
                res = getattr(jdist, fn)(None, x, group=kw.get("group"))
            elif fn == "gather":
                res = jdist.gather(x, group=kw.get("group"))
            elif fn == "reduce":
                res = jdist.reduce(x, kw["dst"])
            else:
                res = getattr(jdist, fn)(x, **kw)
            blocks = [None] * world
            for s in res.addressable_shards:
                blocks[rank_of[s.device.id]] = np.asarray(s.data)
            out[name] = blocks
    reset_mesh_context()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


# ---------------------------------------------------------------- the port's ranks


def _port_case(name, rank, world):
    from deepspeed_tpu_torch import comm
    _, fn, kwargs, shape, spec = CASES[name]
    x = torch.from_numpy(_local_block(_global(name), spec, rank, world).copy())
    kw = dict(kwargs)
    if "op" in kw:
        kw["op"] = comm.ReduceOp[kw["op"]]
    if fn == "all_gather_into_tensor":
        out = torch.empty((comm.get_world_size(kw["group"]) * x.shape[0], ) + x.shape[1:])
        res = comm.all_gather_into_tensor(out, x, group=kw["group"])
        assert res is out
    elif fn == "reduce_scatter_tensor":
        res = comm.reduce_scatter_tensor(None, x, group=kw["group"])
    else:
        res = getattr(comm, fn)(x, **kw)
    return res.numpy()


def _checks(rank, world):
    """What has no JAX eager counterpart: the topology queries, send and
    recv, scatter, the list all-to-all, the coalesced forms, async handles
    and the barriers."""
    from deepspeed_tpu_torch import comm
    out = {"world_size": comm.get_world_size(), "rank": comm.get_rank(),
           "fsdp_size": comm.get_world_size("fsdp"), "data_index": comm.get_rank("data"),
           "tuple_index": comm.get_axis_index(DF)}
    peer = (rank + 1) % world
    if rank % 2 == 0:
        comm.send(torch.full((3, ), float(rank)), dst=rank + 1)
    else:
        out["recv"] = comm.recv(torch.empty(3), src=rank - 1).tolist()
    parts = [torch.full((2, ), 10.0 * i) for i in range(world)]
    out["scatter"] = comm.scatter(torch.empty(2), parts if rank == 1 else None, src=1).tolist()
    got = comm.all_to_all(None, [torch.full((2, ), 100.0 * rank + j) for j in range(world)])
    out["all_to_all_list"] = [g.tolist() for g in got]
    out["coalesced"] = [t.tolist() for t in comm.all_reduce_coalesced(
        [torch.ones(2) * rank, torch.ones(1)])]
    handle = comm.all_gather(torch.tensor([float(rank)]), async_op=True)
    out["async_gather"] = handle.wait().tolist()
    comm.barrier()
    comm.monitored_barrier()
    out["peer"] = peer
    return out


def _rank_main(rank, world, store):
    from deepspeed_tpu_torch import comm
    torch.set_num_threads(1)
    comm.init_distributed(dist_backend="gloo", init_method=f"file://{store}", rank=rank,
                          world_size=world, mesh_axes=MESHES[world])
    out = {name: _port_case(name, rank, world) for name, case in CASES.items()
           if case[0] == world}
    out["checks"] = _checks(rank, world)
    with open(f"{store}.rank{rank}", "wb") as f:
        pickle.dump(out, f)
    import torch.distributed as dist
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import torch.multiprocessing as mp
    tmp = str(tmp_path_factory.mktemp("torch_comm"))
    oracle_path = os.path.join(tmp, "oracle.pkl")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([HERE, os.path.dirname(HERE),
                                           os.environ.get("PYTHONPATH", "")]))
    oracle = subprocess.Popen(
        [sys.executable, "-c", f"import test_torch_comm as t; t._jax_oracle({oracle_path!r})"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    port = {}
    try:
        for world in (2, 4):
            store = os.path.join(tmp, f"store{world}")
            mp.start_processes(_rank_main, args=(world, store), nprocs=world,
                               start_method="spawn")
            port[world] = []
            for r in range(world):
                with open(f"{store}.rank{r}", "rb") as f:
                    port[world].append(pickle.load(f))
    finally:
        log, _ = oracle.communicate(timeout=600)
    assert oracle.returncode == 0, log[-4000:]
    with open(oracle_path, "rb") as f:
        return {"port": port, "jax": pickle.load(f)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_collective_matches_jax_eager(runs, name):
    world = CASES[name][0]
    for rank in range(world):
        got, ref = runs["port"][world][rank][name], runs["jax"][name][rank]
        assert got.shape == ref.shape, (rank, got.shape, ref.shape)
        np.testing.assert_array_equal(got, ref, err_msg=f"rank {rank}")


@pytest.mark.parametrize("world", [2, 4])
def test_point_to_point_scatter_lists_and_queries(runs, world):
    for rank in range(world):
        c = runs["port"][world][rank]["checks"]
        sizes = tmesh.resolve_axis_sizes(world, MESHES[world])
        assert c["world_size"] == world and c["rank"] == rank
        assert c["fsdp_size"] == sizes["fsdp"]
        coords = np.unravel_index(rank, [sizes[a] for a in tmesh.MESH_AXES])
        data, fsdp = coords[1], coords[2]
        assert c["data_index"] == data and c["tuple_index"] == data * sizes["fsdp"] + fsdp
        if rank % 2:
            assert c["recv"] == [float(rank - 1)] * 3
        assert c["scatter"] == [10.0 * rank] * 2
        assert c["all_to_all_list"] == [[100.0 * j + rank] * 2 for j in range(world)]
        assert c["coalesced"] == [[float(sum(range(world)))] * 2, [float(world)]]
        assert c["async_gather"] == [float(r) for r in range(world)]


# ---------------------------------------------------------------- the mesh and init


@pytest.mark.parametrize("n,sizes", [
    (8, {"data": -1}), (8, {"data": 2, "fsdp": -1}), (8, {"fsdp": 2, "model": -1, "seq": -1}),
    (4, {"data": 2, "fsdp": 2}), (6, {"pipe": 3, "data": -1}), (1, {}),
])
def test_resolve_axis_sizes_matches_jax(n, sizes):
    from deepspeed_tpu.comm.mesh import resolve_axis_sizes as jax_resolve
    assert tmesh.resolve_axis_sizes(n, sizes) == jax_resolve(n, sizes)


@pytest.mark.parametrize("n,sizes,match", [
    (6, {"data": 4, "fsdp": -1}, "not divisible"),
    (8, {"data": 2, "fsdp": 2}, "do not cover"),
])
def test_resolve_axis_sizes_errors_match_jax(n, sizes, match):
    from deepspeed_tpu.comm.mesh import resolve_axis_sizes as jax_resolve
    with pytest.raises(ValueError, match=match):
        tmesh.resolve_axis_sizes(n, sizes)
    with pytest.raises(ValueError, match=match):
        jax_resolve(n, sizes)


def test_one_process_mesh_is_one_rank_of_copies():
    from deepspeed_tpu_torch import comm
    tmesh.reset_mesh_context()
    try:
        ctx = comm.init_distributed(mesh_axes={"fsdp": -1})
        assert ctx.world_size == 1 and ctx.dp_axes == ("data", ) and ctx.device_mesh is None
        x = torch.arange(6.0).reshape(2, 3)
        assert torch.equal(comm.all_gather(x, group="fsdp", axis=1), x)
        assert torch.equal(comm.reduce_scatter(x.clone(), group=DF), x)
        assert torch.equal(comm.all_reduce(x.clone(), op=comm.ReduceOp.AVG), x)
    finally:
        tmesh.reset_mesh_context()


# names of the JAX package's comm that wait for a later port: the bucketed
# gradient wire (comm/bucketing.py) and the retrying rendezvous's state
UNPORTED_EXPORTS = {
    "Bucket", "BucketLayout", "BucketSlot", "WIRE_TIERS", "all_gather_bucket", "allreduce_bucket",
    "bucket_wire_bytes", "bucketed_allreduce_tree", "dequantize_block_int8", "flatten_buckets",
    "init_error_buckets", "plan_buckets", "quantize_block_int8", "record_bucket_traffic",
    "reduce_scatter_bucket", "unflatten_buckets", "exchange_host_state", "DIST_INIT_RETRIES",
    "DIST_INIT_TIMEOUT_SECS", "DIST_INIT_BACKOFF_SECS"}


def test_exports_match_jax():
    """Every function and class the JAX package's ``comm`` exports, apart
    from the names waiting for a later port, is exported by the port's;
    the capability queries answer as JAX's do."""
    import inspect
    import deepspeed_tpu.comm as jcomm
    from deepspeed_tpu_torch import comm
    names = {n for n, v in vars(jcomm).items()
             if not n.startswith("_") and (inspect.isfunction(v) or inspect.isclass(v))
             and getattr(v, "__module__", "").startswith("deepspeed_tpu.comm")}
    missing = sorted(names - UNPORTED_EXPORTS - set(dir(comm)))
    assert not missing, missing
    for name in ("has_all_gather_into_tensor", "has_reduce_scatter_tensor"):
        assert getattr(comm, name)() == getattr(jcomm, name)()


@pytest.mark.parametrize("nodelist", [
    "n[001-003,007],login-0", "rack[1-2]-n[1-4]", "host", "a[9-11]", "x[1,3]-y",
])
def test_parse_slurm_nodelist_matches_jax(nodelist):
    from deepspeed_tpu.comm import parse_slurm_nodelist as jax_parse
    from deepspeed_tpu_torch.comm import parse_slurm_nodelist
    assert parse_slurm_nodelist(nodelist) == jax_parse(nodelist)


DISCOVERY_ENVS = {
    "none": {},
    "explicit": {"JAX_COORDINATOR_ADDRESS": "10.0.0.1:1234", "JAX_NUM_PROCESSES": "4",
                 "JAX_PROCESS_ID": "2"},
    "openmpi": {"OMPI_COMM_WORLD_SIZE": "8", "OMPI_COMM_WORLD_RANK": "5",
                "OMPI_MCA_orte_hnp_uri": "123.0;tcp://10.1.2.3,10.9.9.9:4444"},
    "slurm": {"SLURM_STEP_NUM_TASKS": "6", "SLURM_PROCID": "3",
              "SLURM_STEP_NODELIST": "gpu[07-09]"},
    "slurm_allocation_only": {"SLURM_NTASKS": "6", "SLURM_JOB_NODELIST": "gpu[07-09]"},
    "pmi": {"PMI_SIZE": "3", "PMI_RANK": "1"},
    "mpirun_with_explicit_size": {"OMPI_COMM_WORLD_SIZE": "8", "OMPI_COMM_WORLD_RANK": "1",
                                  "JAX_NUM_PROCESSES": "4"},
}
_SCHEDULER_VARS = sorted({k for env in DISCOVERY_ENVS.values() for k in env} | {
    "COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "PMIX_SERVER_URI2",
    "SLURM_JOB_NODELIST", "MV2_COMM_WORLD_SIZE", "MV2_COMM_WORLD_RANK", "DS_HOSTLIST",
    "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"})


@pytest.mark.parametrize("case", sorted(DISCOVERY_ENVS))
@pytest.mark.parametrize("auto", [True, False])
def test_mpi_discovery_matches_jax(monkeypatch, case, auto):
    from deepspeed_tpu.comm import mpi_discovery as jax_discovery
    from deepspeed_tpu_torch.comm import mpi_discovery
    for k in _SCHEDULER_VARS:
        monkeypatch.delenv(k, raising=False)
    for k, v in DISCOVERY_ENVS[case].items():
        monkeypatch.setenv(k, v)
    assert mpi_discovery(4321, auto=auto) == jax_discovery(4321, auto=auto)


def test_torchrun_variables_come_first(monkeypatch):
    from deepspeed_tpu_torch.comm.comm import discover_rendezvous
    for k in _SCHEDULER_VARS:
        monkeypatch.delenv(k, raising=False)
    for k, v in {"RANK": "3", "WORLD_SIZE": "4", "LOCAL_RANK": "1", "MASTER_ADDR": "h",
                 "MASTER_PORT": "29501", "OMPI_COMM_WORLD_SIZE": "8"}.items():
        monkeypatch.setenv(k, v)
    assert discover_rendezvous() == ("env://", 4, 3, 1)
    monkeypatch.delenv("RANK")
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.setenv("OMPI_COMM_WORLD_RANK", "6")
    monkeypatch.setenv("OMPI_MCA_orte_hnp_uri", "1;tcp://10.0.0.9:5")
    assert discover_rendezvous(2222) == ("tcp://10.0.0.9:2222", 8, 6, 1)


def test_comms_logger_records_when_enabled():
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.comm.comms_logging import calc_bw_log, get_comms_logger
    from deepspeed_tpu.comm.comms_logging import calc_bw_log as jax_bw
    for op in ("all_reduce", "all_gather", "all_to_all_single", "broadcast"):
        assert calc_bw_log(op, 1 << 20, 1e-3, 4) == jax_bw(op, 1 << 20, 1e-3, 4)
    tmesh.reset_mesh_context()
    try:
        comm.configure(enabled=True, prof_all=True)
        comm.all_reduce(torch.ones(256))
        rec = get_comms_logger().comms_dict["all_reduce"][1024]
        assert rec[0] == 1 and len(rec[1]) == 1
    finally:
        comm.configure(enabled=False)
        get_comms_logger().comms_dict.clear()
        tmesh.reset_mesh_context()
