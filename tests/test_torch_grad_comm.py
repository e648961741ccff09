"""deepspeed_tpu_torch's bucketed gradient wire (``comm/bucketing.py``,
``comm/compressed.py``, ``runtime/grad_comm.py``) against the JAX
package's.

The bucket plan, the int8 quantizer and the sign pack are held to JAX's
bits on the same input in this process, the JAX functions compiled
(``jax.jit``) as the JAX engine runs them. The engine runs on two gloo ranks
spawned once for the module (a ``file://`` store under the test's
temporary directory), each case a fresh engine over ``{data: 2}`` taking 3
``train_batch`` steps; the JAX oracle runs once, in a subprocess with two
forced host devices and a ``{data: 2}`` mesh, from the same weights and
batches (its engine at stage 0 stands for stages 0 and 1, and at the
boundary for stage 2's: the stage moves no number there). The ranks also run the bucket
collectives on seeded inputs that the oracle runs under ``shard_map``.
The rank workers import neither ``jax`` nor ``deepspeed_tpu``.

Tolerances. fp32 tier: losses rtol 1e-5, masters as test_torch_zero.py's
fp32 limits (within 1e-5 but a few elements, none beyond twice the
learning rate's path). int8 and onebit tiers: losses rtol 1e-4 (the JAX
tests hold a tier to fp32 at 0.05), masters within the bf16 limits of
test_torch_zero.py (RMS of the differences within 2^-4 of the path, none
beyond twice it): the gradients agree to fp32 rounding before the
quantizer, so a code (or a sign) differs only where an element sits on a
rounding boundary, and Adam's first steps move such an element by up to
the learning rate.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.comm import bucketing as tb, compressed as tc
from deepspeed_tpu_torch.config.config import DeepSpeedConfigError, DeepSpeedTorchConfig
from deepspeed_tpu_torch.models.convert import jax_key_path, lookup, params_from_jax
from deepspeed_tpu_torch.models.llama import LlamaConfig, init_llama_for_causal_lm

HERE = os.path.dirname(os.path.abspath(__file__))
SEQ, ROWS, STEPS, LR = 16, 4, 3, 1e-3
BUCKET_MB = 0.05  # ~13k fp32 elements: the tiny model spreads over 11 buckets
LOSS_RTOL, MASTER_TOL, MAX_FLIPPED = 1e-5, 1e-5, 4
Q_LOSS_RTOL, Q_RMS, Q_MAX = 1e-4, 2.0 ** -4, 2.0
TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
            rope_theta=10000.0)


def _gc(tier="fp32", overlap=True):
    return {"enabled": True, "overlap_comm": overlap, "comm_quantization": tier,
            "bucket_size_mb": BUCKET_MB}


# name -> ZeRO stage, gradient_comm section, gas
CASES = {
    "fp32_s0_overlap": (0, _gc(), 2),
    "fp32_s0_boundary": (0, _gc(overlap=False), 2),
    "fp32_s1_overlap": (1, _gc(), 2),
    "fp32_s1_boundary": (1, _gc(overlap=False), 2),
    "fp32_s2_overlap": (2, _gc(), 2),
    "fp32_s2_boundary": (2, _gc(overlap=False), 2),
    "int8_s1_overlap": (1, _gc("int8"), 2),
    "onebit_s0_overlap": (0, _gc("onebit"), 2),
    "ignore_index": (0, _gc(), 2),
}
COLLECTIVE_N = 2 * 256 * 3
# the JAX engine's numbers do not depend on the ZeRO stage: the port's
# stage-1 runs, and its stage-2 boundary run, are held to these JAX runs
JAX_CASE = {"fp32_s1_overlap": "fp32_s0_overlap", "fp32_s1_boundary": "fp32_s0_boundary",
            "fp32_s2_boundary": "fp32_s0_boundary"}
JAX_CASES = [c for c in CASES if c not in JAX_CASE] + ["collectives"]


def _engine_config(case, wire=True):
    stage, gc, gas = CASES[case]
    cfg = {"train_batch_size": ROWS * gas, "train_micro_batch_size_per_gpu": ROWS // 2,
           "gradient_accumulation_steps": gas, "zero_optimization": {"stage": stage},
           "mesh": {"data": 2},
           "optimizer": {"type": "AdamW", "params": {"lr": LR, "weight_decay": 0.01}}}
    if wire:
        cfg["gradient_comm"] = dict(gc)
    return cfg


def _batches(case):
    """``[STEPS x gas, ROWS, SEQ]`` ids and labels; ``ignore_index`` puts
    -100 on most of rank 1's labels."""
    gas = CASES[case][2]
    rng = np.random.default_rng(len(case))
    ids = rng.integers(0, 256, size=(STEPS * gas, ROWS, SEQ)).astype(np.int64)
    labels = ids.copy()
    if case == "ignore_index":
        labels[:, ROWS // 2:, 3:] = -100
    return ids, labels


def _tree(seed=1, fields=TINY):
    """The JAX param tree (numpy leaves) of a port model from ``seed``."""
    tmodel = init_llama_for_causal_lm(LlamaConfig(**fields, dtype=torch.float32), seed=seed,
                                      device="cpu")
    tree = {}
    for name, p in tmodel.named_parameters():
        node = tree
        path = jax_key_path(name)
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = p.detach().numpy().copy()
    return tree


def _collective_inputs(rank):
    rng = np.random.default_rng(100 + rank)
    x = rng.normal(size=COLLECTIVE_N).astype(np.float32)
    x[:40] = 0.0  # a zero run: >= 0 packs as +1
    ints = rng.integers(-8, 9, size=(3, COLLECTIVE_N)).astype(np.float32)
    return x, ints


# ---------------------------------------------------------------- the JAX oracle


def _jax_oracle(in_path, out_path, cases):
    """The JAX engine with gradient_comm over ``{data: 2}`` on two host
    devices for each of ``cases``, and (with ``collectives``) the bucket
    collectives under ``shard_map``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    import deepspeed_tpu
    from deepspeed_tpu.comm.mesh import MeshContext, reset_mesh_context, set_mesh_context
    from deepspeed_tpu.models.llama import LlamaConfig as JaxConfig, LlamaForCausalLM as JaxLM

    with open(in_path, "rb") as f:
        tree = pickle.load(f)
    out = {}
    for case in cases:
        if case == "collectives":
            from deepspeed_tpu.comm import bucketing as jb
            from deepspeed_tpu.runtime.onebit_wire import _smap
            reset_mesh_context()
            ctx = MeshContext.create(axis_sizes={"data": 2})
            set_mesh_context(ctx)
            xs = jnp.asarray(np.stack([_collective_inputs(r)[0] for r in range(2)]))
            res = {}
            for tier in tb.WIRE_TIERS:
                def region(x, tier=tier):
                    shard, resid = jb.reduce_scatter_bucket(x[0], "data", tier)
                    avg, aresid = jb.allreduce_bucket(x[0], "data", tier)
                    return (shard[None], resid[None], jb.all_gather_bucket(shard, "data", tier)[None],
                            avg[None], aresid[None])
                fn = jax.jit(_smap(region, ctx.mesh, (P("data"), ), (P("data"), ) * 5, ("data", )))
                res[tier] = [np.asarray(a) for a in fn(xs)]
            out["collectives"] = res
            continue
        stage, gc, gas = CASES[case]
        reset_mesh_context()
        eng, *_ = deepspeed_tpu.initialize(
            model=JaxLM(JaxConfig(**TINY, dtype=jnp.float32, attn_impl="xla")),
            model_parameters=jax.tree_util.tree_map(jnp.array, tree),
            config=_engine_config(case))
        assert eng._grad_comm_layout is not None, case
        ids, labels = _batches(case)
        losses, norms = [], []
        for step in range(STEPS):
            k = step * gas
            losses.append(float(eng.train_batch(iter(
                [(jnp.asarray(ids[k + i]), jnp.asarray(labels[k + i])) for i in range(gas)]))))
            norms.append(float(eng.get_global_grad_norm()))
        out[case] = {"losses": losses, "norms": norms,
                     "params": jax.tree_util.tree_map(np.asarray, eng.params)}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


# ---------------------------------------------------------------- the port's ranks


def _run_case(case, tree, wire=True):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm import reset_mesh_context

    stage, gc, gas = CASES[case]
    reset_mesh_context()
    model = params_from_jax(tree, LlamaConfig(**TINY, dtype=torch.float32),
                            dtype=torch.float32, device="cpu", training=True)
    eng, *_ = deepspeed_tpu_torch.initialize(model=model, config=_engine_config(case, wire),
                                             device="cpu")
    ids, labels = (torch.from_numpy(x) for x in _batches(case))
    losses, norms = [], []
    for step in range(STEPS):
        k = step * gas
        losses.append(eng.train_batch(iter(zip(ids[k:k + gas], labels[k:k + gas]))))
        norms.append(eng.get_global_grad_norm())
    rec = {"losses": losses, "norms": norms, "wired": eng._wire is not None,
           "masters": {k: v.detach().clone().numpy()
                       for k, v in eng.full_master_params().items()},
           "state_bytes": eng.state_bytes(), "shard_numel": eng.layout.shard_numel,
           "full_numel": eng.layout.full_numel}
    if eng._wire is not None:
        rec["stats"] = dict(eng._wire.stats)
        rec["expect_bytes"] = STEPS * tb.bucket_wire_bytes(
            eng._bucket_layout, 2, gc["comm_quantization"])["wire_bytes"]
        rec["unit_lengths"] = [u.length for u in eng.layout.units]
        rec["bucket_sizes"] = [b.padded_size for b in eng._bucket_layout.buckets]
    return rec


def _collectives(rank):
    """Each tier's bucket collectives on this rank's seeded input, and the
    overlapped and the boundary reduce-scatter of integer-valued
    micro-step gradients."""
    x, ints = (torch.from_numpy(a) for a in _collective_inputs(rank))
    out = {}
    for tier in tb.WIRE_TIERS:
        shard, resid = tb.reduce_scatter_bucket(x, "data", tier)
        avg, aresid = tb.allreduce_bucket(x, "data", tier)
        out[tier] = [shard.numpy(), (resid if resid is not None else torch.zeros_like(x)).numpy(),
                     tb.all_gather_bucket(shard, "data", tier).numpy(), avg.numpy(),
                     aresid.numpy()]
    running = torch.zeros(COLLECTIVE_N // 2)
    handles = [tb.reduce_scatter_bucket(g.clone(), "data", async_op=True)[0] for g in ints]
    for h in handles:
        running.add_(h.wait())
    boundary = tb.reduce_scatter_bucket(ints.sum(0), "data")[0]
    out["overlap"], out["boundary"] = running.numpy(), boundary.numpy()
    return out


def _rank_main(rank, store):
    from deepspeed_tpu_torch import comm
    torch.set_num_threads(1)
    comm.init_distributed(dist_backend="gloo", init_method=f"file://{store}", rank=rank,
                          world_size=2)
    with open(os.path.join(os.path.dirname(store), "tree.pkl"), "rb") as f:
        tree = pickle.load(f)
    out = {case: _run_case(case, tree) for case in CASES}
    out["ignore_index_default"] = _run_case("ignore_index", tree, wire=False)
    out["collectives"] = _collectives(rank)
    with open(f"{store}.rank{rank}", "wb") as f:
        pickle.dump(out, f)
    import torch.distributed as dist
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import torch.multiprocessing as mp
    tmp = str(tmp_path_factory.mktemp("torch_grad_comm"))
    tree = _tree()
    with open(os.path.join(tmp, "tree.pkl"), "wb") as f:
        pickle.dump(tree, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=os.pathsep.join([HERE, os.path.dirname(HERE),
                                           os.environ.get("PYTHONPATH", "")]))
    out, in_path = os.path.join(tmp, "oracle.pkl"), os.path.join(tmp, "tree.pkl")
    call = f"import test_torch_grad_comm as t; t._jax_oracle({in_path!r}, {out!r}, {JAX_CASES!r})"
    oracle = subprocess.Popen(
        [sys.executable, "-c", call],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    store = os.path.join(tmp, "store")
    try:
        mp.start_processes(_rank_main, args=(store, ), nprocs=2, start_method="spawn")
    finally:
        log = oracle.communicate(timeout=600)[0]
    ranks = []
    for r in range(2):
        with open(f"{store}.rank{r}", "rb") as f:
            ranks.append(pickle.load(f))
    assert oracle.returncode == 0, log[-4000:]
    with open(out, "rb") as f:
        jax_out = pickle.load(f)
    return {"ranks": ranks, "jax": jax_out}


def _assert_masters_close(masters, ref_tree, path, exact_tier):
    if exact_tier:
        n_off = 0
        for name, got in masters.items():
            ref = np.asarray(lookup(ref_tree, name))
            diff = np.abs(got - ref)
            n_off += int((diff > MASTER_TOL + MASTER_TOL * np.abs(ref)).sum())
            assert diff.max() <= 2 * path, name
        assert n_off <= MAX_FLIPPED, f"{n_off} elements off"
    else:
        diffs = np.concatenate([(got - np.asarray(lookup(ref_tree, n))).ravel()
                                for n, got in masters.items()])
        assert np.sqrt(np.mean(diffs ** 2)) <= Q_RMS * path
        assert np.abs(diffs).max() <= Q_MAX * path


# ---------------------------------------------------------------- against JAX, bit for bit


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k, )))
        else:
            out[prefix + (k, )] = v
    return out


@pytest.mark.parametrize("mb,pad", [(BUCKET_MB, 512), (0.01, 256), (25.0, 1024)])
def test_plan_buckets_matches_jax(mb, pad):
    """The port's parameters in JAX's leaf order give JAX's buckets: the
    same leaves at the same offsets, sizes and paddings."""
    import jax
    from deepspeed_tpu.comm import bucketing as jb
    tree = _tree()
    jleaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    jpaths = ["/".join(str(p.key) for p in path) for path, _ in jleaves]
    jlay = jb.plan_buckets(tree, mb, pad_multiple=pad)
    model = params_from_jax(tree, LlamaConfig(**TINY, dtype=torch.float32),
                            dtype=torch.float32, device="cpu", training=True)
    names, params = zip(*model.named_parameters())
    order = tb.jax_leaf_order(names)
    assert ["/".join(jax_key_path(names[i])) for i in order] == jpaths
    tlay = tb.plan_buckets([params[i] for i in order], mb, pad_multiple=pad)
    assert len(tlay.buckets) == len(jlay.buckets) > (1 if mb < 1 else 0)
    for t, j in zip(tlay.buckets, jlay.buckets):
        assert (t.size, t.padded_size) == (j.size, j.padded_size)
        assert [(s.leaf_index, s.offset, s.size, s.shape) for s in t.slots] == \
            [(s.leaf_index, s.offset, s.size, s.shape) for s in j.slots]
    flat = tb.flatten_buckets([params[i] for i in order], tlay)
    jflat = jb.flatten_buckets(tree, jlay)
    for a, b in zip(flat, jflat):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    back = tb.unflatten_buckets(flat, tlay)
    assert all(torch.equal(back[k], params[i]) for k, i in enumerate(order))


@pytest.mark.parametrize("n", [1, 255, 256, 1000, 4096 + 7])
def test_int8_quantizer_and_sign_pack_bit_equal_jax(n):
    """The affine int8 codes, scales and zero points, the dequantized
    values, the packed signs and their unpacking: the compiled JAX
    functions' bits; the sign scale within an ulp or two (summed in
    another order)."""
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.comm import bucketing as jb, compressed as jc
    rng = np.random.default_rng(n)
    x = (rng.normal(size=n) * 10.0 ** rng.uniform(-4, 3)).astype(np.float32)
    x[: n // 3] = 0.0
    jq = jax.jit(jb.quantize_block_int8)(jnp.asarray(x))
    tq = tb.quantize_block_int8(torch.from_numpy(x), 256)
    for a, b in zip(tq, jq):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        tb.dequantize_block_int8(*tq, n).numpy(),
        np.asarray(jax.jit(lambda *q: jb.dequantize_block_int8(*q, n))(*jq)))
    jp, js = jax.jit(jc.pack_signs)(jnp.asarray(x))
    tp, ts = tc.pack_signs(torch.from_numpy(x))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(float(ts), float(js), rtol=2e-7)
    np.testing.assert_array_equal(tc.unpack_signs(tp, n).numpy(),
                                  np.asarray(jc.unpack_signs(jp, n)))


@pytest.mark.parametrize("n,world,block", [(1000, 2, 256), (4096, 4, 128), (7, 1, 256)])
def test_wire_bytes_match_jax(n, world, block):
    from deepspeed_tpu.comm import compressed as jc
    assert tc.wire_bytes(n, world, block) == jc.wire_bytes(n, world, block)
    int8 = tc.wire_bytes(2 ** 20, 2, 256)
    assert 0.25 < int8["int8_bytes"] / int8["fp32_bytes"] < 0.27
    assert abs(int8["reduction"] - 32) < 0.01


def test_bucket_wire_bytes_match_jax():
    from deepspeed_tpu.comm import bucketing as jb
    tree = _tree()
    jlay = jb.plan_buckets(tree, BUCKET_MB, pad_multiple=512)
    order_names = sorted(_flat(tree))
    tlay = tb.plan_buckets([torch.from_numpy(_flat(tree)[k]) for k in order_names], BUCKET_MB,
                           pad_multiple=512)
    for tier in tb.WIRE_TIERS:
        got, ref = tb.bucket_wire_bytes(tlay, 2, tier), jb.bucket_wire_bytes(jlay, 2, tier)
        assert got == ref, tier


def test_bucket_errors():
    with pytest.raises(ValueError, match="unknown wire tier"):
        tb.reduce_scatter_bucket(torch.zeros(8), None, "fp16")
    lay = tb.plan_buckets([torch.zeros(3), torch.zeros(5)], 1.0)
    with pytest.raises(ValueError, match="plan again"):
        tb.flatten_buckets([torch.zeros(3)], lay)
    with pytest.raises(ValueError, match="positive"):
        tb.plan_buckets([torch.zeros(3)], 0.0)
    errs = tb.init_error_buckets(tb.plan_buckets([torch.zeros(300)], 1.0, pad_multiple=256))
    assert [e.shape[0] for e in errs] == [512]


def test_compressed_tree_checks_shapes():
    with pytest.raises(ValueError, match="error buffers"):
        tc.compressed_allreduce_tree([torch.zeros(4)], [torch.zeros(5)])
    with pytest.raises(ValueError, match="error-feedback"):
        tc.compressed_allreduce_tree([torch.zeros(4)], [])


# ---------------------------------------------------------------- the config


def test_gradient_comm_config_defaults_match_jax():
    from deepspeed_tpu.config.feature_configs import GradientCommConfig as JaxGC
    cfg = DeepSpeedTorchConfig({"train_batch_size": 2}).gradient_comm_config
    ref = JaxGC()
    for key in ("enabled", "bucket_size_mb", "quantization_block_size", "error_feedback",
                "overlap_comm", "comm_quantization_per_dtype"):
        assert getattr(cfg, key) == getattr(ref, key), key
    assert cfg.comm_quantization == getattr(ref.comm_quantization, "value", ref.comm_quantization)
    assert cfg.active is ref.active is False


@pytest.mark.parametrize("section", [
    {"enabled": True}, {"overlap_comm": True}, {"comm_quantization": "int8"},
    {"comm_quantization_per_dtype": {"bfloat16": "onebit"}}, {"enabled": False}])
def test_gradient_comm_active_and_tiers_match_jax(section):
    from deepspeed_tpu.config.feature_configs import GradientCommConfig as JaxGC
    import jax.numpy as jnp
    cfg = DeepSpeedTorchConfig({"train_batch_size": 2, "gradient_comm": section})
    ref = JaxGC(**section)
    gc = cfg.gradient_comm_config
    assert gc.active == ref.active
    for t, j in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        assert gc.tier_for_dtype(t) == ref.tier_for_dtype(j)


@pytest.mark.parametrize("section", [{"bucket_size_mb": 0}, {"quantization_block_size": -1},
                                     {"comm_quantization": "fp8"},
                                     {"comm_quantization_per_dtype": {"float32": "int4"}}])
def test_gradient_comm_config_rejects_bad_values(section):
    with pytest.raises(DeepSpeedConfigError):
        DeepSpeedTorchConfig({"train_batch_size": 2, "gradient_comm": section})


def test_gradient_comm_config_refuses_unknown_keys():
    with pytest.raises(NotImplementedError, match="gradient_comm"):
        DeepSpeedTorchConfig({"train_batch_size": 2, "gradient_comm": {"hierarchical": True}})


# ---------------------------------------------------------------- one process


_WORLD1_DEFAULT = {}


def _world1_default(gas):
    """The default reduce's run at stage 0 (once for the module a gas)."""
    if gas not in _WORLD1_DEFAULT:
        _WORLD1_DEFAULT[gas] = _world1({}, 0, gas)[1:]
    return _WORLD1_DEFAULT[gas]


def _world1(extra, stage, gas=2, steps=3):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm import reset_mesh_context
    reset_mesh_context()
    model = init_llama_for_causal_lm(LlamaConfig(**TINY, dtype=torch.float32), seed=1,
                                     device="cpu")
    cfg = {"train_batch_size": 2 * gas, "gradient_accumulation_steps": gas,
           "zero_optimization": {"stage": stage}, "mesh": {"data": 1},
           "optimizer": {"type": "AdamW", "params": {"lr": LR, "weight_decay": 0.01}}}
    cfg.update(extra)
    eng, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (steps * gas, 2, SEQ)))
    losses = [eng.train_batch(iter([(ids[k + i], ids[k + i]) for i in range(gas)]))
              for k in range(0, steps * gas, gas)]
    return eng, losses, {k: v.detach().clone() for k, v in eng.full_master_params().items()}


@pytest.mark.parametrize("stage,overlap,gas", [
    (0, True, 2), (0, False, 2), (1, True, 2), (1, False, 2), (2, True, 2), (2, False, 2),
    (2, True, 1)])
def test_world1_fp32_wire_bit_equals_default_reduce(stage, overlap, gas):
    """At one rank the fp32 tier adds the same values in the same order
    as the default reduce: the same losses and masters, bit for bit, on
    the bucket-laid state (gas 1 too: the wire owns train_batch there)."""
    base, base_m = _world1_default(gas)
    eng, losses, masters = _world1({"gradient_comm": _gc(overlap=overlap)}, stage, gas)
    assert eng._wire is not None and len(eng._bucket_layout.buckets) > 1
    assert losses == base
    assert all(torch.equal(masters[k], base_m[k]) for k in base_m)
    assert eng._wire.stats["steps"] == 3


def test_world1_wire_refuses_fused_steps_and_stage3():
    eng, *_ = _world1({"gradient_comm": _gc()}, 0, gas=1, steps=1)
    ids = torch.zeros(2, SEQ, dtype=torch.long)
    with pytest.raises(AssertionError, match="gradient wire"):
        eng.fused_train_step(ids, labels=ids)
    with pytest.raises(AssertionError, match="gradient wire"):
        eng.fused_train_steps(ids[None], labels=ids[None])
    # stage 3 under the wire runs the scheduled ZeRO-3 store's step (it
    # raised before runtime/zero3_schedule.py was ported), which refuses
    # the fused steps as the wire does
    eng3, losses, _ = _world1({"gradient_comm": _gc()}, 3, steps=1)
    assert eng3._store is not None and eng3._wire is eng3._store
    assert np.isfinite(losses).all()
    with pytest.raises(AssertionError, match="gradient wire"):
        eng3.fused_train_step(ids, labels=ids)


@pytest.mark.parametrize("extra", [
    {"gradient_comm": _gc("int8")},  # a quantized tier at one rank: JAX's fallback
    {"gradient_comm": _gc(), "fp16": {"enabled": True}},
])
def test_unsupported_wire_warns_and_keeps_default_reduce(extra, caplog):
    with caplog.at_level("WARNING"):
        eng, losses, _ = _world1(extra, 0, steps=1)
    assert eng._wire is None and "gradient_comm requested but unsupported" in caplog.text
    assert np.isfinite(losses).all()


# ---------------------------------------------------------------- two ranks


def test_bucket_collectives_match_jax(runs):
    """Each tier's reduce-scatter, all-gather and allreduce on the same
    per-rank inputs: fp32 and int8 bit for bit, onebit within the ulps of
    its scale."""
    ref = runs["jax"]["collectives"]
    for rank, out in enumerate(runs["ranks"]):
        got = out["collectives"]
        for tier in tb.WIRE_TIERS:
            for a, b in zip(got[tier], ref[tier]):
                if tier == "onebit":
                    # the scales (~0.8) an ulp or two apart: a residual x - s
                    # near 0 keeps that absolute difference
                    np.testing.assert_allclose(a, b[rank], rtol=1e-6, atol=1e-6)
                else:
                    np.testing.assert_array_equal(a, b[rank])


def test_overlapped_and_boundary_reduce_scatter_exact_on_integers(runs):
    """Integer-valued micro-step gradients: the shard summed from
    per-micro-step async reduce-scatters and the one boundary
    reduce-scatter both equal the exact sum, bit for bit."""
    ints = np.stack([_collective_inputs(r)[1] for r in range(2)])  # [rank, micro, n]
    exact = ints.sum(axis=(0, 1))
    for rank, out in enumerate(runs["ranks"]):
        want = exact[rank * COLLECTIVE_N // 2:(rank + 1) * COLLECTIVE_N // 2]
        np.testing.assert_array_equal(out["collectives"]["overlap"], want)
        np.testing.assert_array_equal(out["collectives"]["boundary"], want)


@pytest.mark.parametrize("case", [c for c in CASES if c.startswith("fp32")])
def test_fp32_wire_matches_jax(runs, case):
    """The fp32 tier at stages 0-2, overlapped and at the boundary,
    against JAX's wire engine."""
    got, ref = runs["ranks"][0][case], runs["jax"][JAX_CASE.get(case, case)]
    assert got["wired"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["norms"], ref["norms"], rtol=1e-5)
    _assert_masters_close(got["masters"], ref["params"], STEPS * LR, True)
    assert runs["ranks"][1][case]["losses"] == got["losses"]


@pytest.mark.parametrize("case", ["int8_s1_overlap", "onebit_s0_overlap"])
def test_quantized_tiers_match_jax(runs, case):
    got, ref = runs["ranks"][0][case], runs["jax"][case]
    assert got["wired"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=Q_LOSS_RTOL)
    _assert_masters_close(got["masters"], ref["params"], STEPS * LR, False)
    fp32 = runs["ranks"][0]["fp32_s0_overlap"]["masters"]
    assert any(not np.array_equal(fp32[k], m) for k, m in got["masters"].items())


def test_ignore_index_uneven_follows_the_wire(runs):
    """Labels ignored mostly on rank 1's rows: the wire averages the
    ranks' means, as JAX's wire program does, where the default reduce
    takes the global token mean."""
    labels = _batches("ignore_index")[1]
    counts = [(labels[0, r * 2:(r + 1) * 2, 1:] != -100).sum() for r in range(2)]
    assert counts[0] > 4 * counts[1]
    got, ref = runs["ranks"][0]["ignore_index"], runs["jax"]["ignore_index"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_RTOL)
    _assert_masters_close(got["masters"], ref["params"], STEPS * LR, True)
    default = runs["ranks"][0]["ignore_index_default"]
    assert not default["wired"]
    assert abs(default["losses"][0] - got["losses"][0]) > 1e-3 * abs(got["losses"][0])


@pytest.mark.parametrize("case", list(CASES))
def test_wire_bytes_banked_per_step(runs, case):
    for out in runs["ranks"]:
        rec = out[case]
        assert rec["stats"] == {"steps": STEPS, "wire_bytes": rec["expect_bytes"]}


def test_stage2_state_is_laid_out_by_the_buckets(runs):
    """At stage 2 each bucket is a unit of the flat state: each rank holds
    half of each bucket (a multiple of the block), the masters, moments
    and accumulation buffer all that shard."""
    for out in runs["ranks"]:
        rec = out["fp32_s2_overlap"]
        assert rec["unit_lengths"] == rec["bucket_sizes"]
        assert all(n % (2 * 256) == 0 for n in rec["bucket_sizes"])
        b = rec["state_bytes"]
        assert rec["full_numel"] == sum(rec["bucket_sizes"]) == 2 * rec["shard_numel"]
        assert b["masters"] == b["m"] == b["v"] == b["grad_acc"] == 4 * rec["shard_numel"]
