"""deepspeed_tpu_torch's scheduled ZeRO-3 store (``runtime/zero3_schedule.py``,
``comm/bucketing.py param_gather_bucket``) against the JAX package's, and
the gradient wire at stages 1-2 over ``{data: 2, fsdp: 2}``.

The schedule pass (``derive_schedule``, ``_peak_live``) is held to JAX's on
the same first and last uses, the cases of JAX's ``TestSchedulePass`` and
uses drawn by ``hypothesis``; the store's meta and bucket contents to JAX's
``store_from_tree`` and ``materialize_params`` on the same params. At one
rank, in this process, the store's step is held to the port's stage-2 wire
bit for bit. On gloo ranks spawned once for the module (two, then four;
each rank one torch thread, a ``file://`` store): ``param_gather_bucket``'s
forward and backward, the store against the stage-2 wire over five steps
(bit for bit) and its per-rank bytes, the int8 tiers, a stage-3 checkpoint
written at two ranks, and the wire's int8 tier at stages 1-2 over
``{data: 2, fsdp: 2}``. The JAX oracle runs once, in two subprocesses with
four forced host devices: its scheduled stage 3 over ``{data: 2}`` (losses,
masters and its traced schedule) and its int8 wire over ``{data: 2, fsdp:
2}``. The rank workers import neither ``jax`` nor ``deepspeed_tpu``.

Tolerances. Against JAX, fp32: losses rtol 1e-5, masters as
test_torch_grad_comm.py's fp32 limits. The int8 wire over four ranks:
losses rtol 1e-3 and the masters within test_torch_grad_comm.py's quantized
limits (RMS of the differences within 2^-4 of the learning rate's path,
none beyond twice it). Over four ranks the fp32 sums already differ from
XLA's in the last place (the fp32 tier's step-2 loss differs by an ulp),
and the int8 quantizer turns such an ulp at a rounding boundary into a
code, which Adam's next steps move by up to the learning rate: at stage 2,
where no quantized gather snaps the sums back onto one grid, the third
step's loss moved by 3.2e-4 relative in the run that set this limit. The port's int8 tiers
against its fp32 store: losses rtol 0.05 and masters within 0.1, JAX's own
limits (``test_quantized_gather_within_tolerance``).
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from deepspeed_tpu_torch.comm import bucketing as tb
from deepspeed_tpu_torch.models.convert import jax_key_path, lookup, params_from_jax
from deepspeed_tpu_torch.models.llama import LlamaConfig, init_llama_for_causal_lm
from deepspeed_tpu_torch.runtime import zero3_schedule as tz

HERE = os.path.dirname(os.path.abspath(__file__))
SEQ, ROWS, LR, STEPS, Q_STEPS = 16, 4, 1e-3, 5, 3
BUCKET_MB = 0.05
LOSS_RTOL, MASTER_TOL, MAX_FLIPPED = 1e-5, 1e-5, 4
DF_Q_LOSS_RTOL, Q_RMS, Q_MAX = 1e-3, 2.0 ** -4, 2.0
TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
            rope_theta=10000.0)
GC = {"enabled": True, "overlap_comm": True, "bucket_size_mb": BUCKET_MB}


def _z3(extra=None):
    zero = {"stage": 3, "stage3_param_persistence_threshold": 0}
    zero.update(extra or {})
    return {"zero_optimization": zero, "gradient_comm": dict(GC)}


# name -> (world, mesh, engine config overrides, steps)
CASES = {
    "s3_fp32": (2, {"data": 2}, _z3(), STEPS),
    "s2_fp32": (2, {"data": 2}, {"zero_optimization": {"stage": 2}, "gradient_comm": dict(GC)},
                STEPS),
    "s3_int8": (2, {"data": 2}, _z3({"zero_quantized_weights": True,
                                     "zero_quantized_gradients": True}), Q_STEPS),
    "s1_int8_df": (4, {"data": 2, "fsdp": 2},
                   {"zero_optimization": {"stage": 1},
                    "gradient_comm": dict(GC, comm_quantization="int8")}, Q_STEPS),
    "s2_int8_df": (4, {"data": 2, "fsdp": 2},
                   {"zero_optimization": {"stage": 2},
                    "gradient_comm": dict(GC, comm_quantization="int8")}, Q_STEPS),
    "s2_fp32_df": (4, {"data": 2, "fsdp": 2},
                   {"zero_optimization": {"stage": 2}, "gradient_comm": dict(GC)}, Q_STEPS),
}
# remat: the engine's policies, and the model's own per-layer remat ("_model"
# holds LlamaConfig fields)
REMAT = {"nothing": {"activation_checkpointing": {"remat_policy": "nothing_saveable"}},
         "everything": {"activation_checkpointing": {"remat_policy": "everything_saveable"}},
         "dots": {"activation_checkpointing": {"remat_policy": "dots_saveable"}},
         "dots_nb": {"activation_checkpointing":
                     {"remat_policy": "dots_with_no_batch_dims_saveable"}},
         "model": {"_model": {"remat": True}},
         "model_dots": {"_model": {"remat": True, "remat_policy": "dots_saveable"}}}
for _name, _remat in REMAT.items():
    CASES[f"s3_fp32_remat_{_name}"] = (2, {"data": 2}, dict(_z3(), **_remat), Q_STEPS)
    CASES[f"s2_fp32_remat_{_name}"] = (2, {"data": 2}, dict(CASES["s2_fp32"][2], **_remat),
                                       Q_STEPS)
CASES["s3_int8_remat"] = (2, {"data": 2}, dict(CASES["s3_int8"][2], **REMAT["nothing"]), Q_STEPS)
JAX_CASES = ["s3_fp32", "s1_int8_df", "s2_int8_df", "s2_fp32_df"]
GAS = 2
EXTRA_STEPS = 2  # the two-rank store trains on past its checkpoint


def _engine_config(case):
    world, mesh, extra, _ = CASES[case]
    cfg = {"train_batch_size": ROWS * GAS, "train_micro_batch_size_per_gpu": ROWS // world,
           "gradient_accumulation_steps": GAS, "mesh": dict(mesh),
           "optimizer": {"type": "AdamW", "params": {"lr": LR, "weight_decay": 0.01}}}
    cfg.update({k: v for k, v in extra.items() if k != "_model"})
    return cfg


def _batches(steps):
    ids = np.random.default_rng(5).integers(0, 256, size=(steps * GAS, ROWS, SEQ))
    return ids.astype(np.int64)


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


# ---------------------------------------------------------------- the schedule pass


def _layouts(sizes, mb, pad=1):
    """The same leaves planned by both packages."""
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.comm import bucketing as jb
    jlay = jb.plan_buckets([jax.ShapeDtypeStruct((n, ), jnp.float32) for n in sizes], mb,
                           pad_multiple=pad)
    tlay = tb.plan_buckets([torch.empty(n, device="meta") for n in sizes], mb,
                           pad_multiple=pad)
    return jlay, tlay


def _both(sizes, mb, first, last, n_eqns, budget, reuse, pers=0, world=8, tier="fp32",
          block=256, np_idx=None):
    from deepspeed_tpu.runtime import zero3_schedule as jz
    jlay, tlay = _layouts(sizes, mb)
    np_idx = tuple(range(len(sizes))) if np_idx is None else np_idx
    j = jz.derive_schedule(jlay, np_idx, first, last, n_eqns, budget, reuse, pers, world,
                           tier, block)
    t = tz.derive_schedule(tlay, np_idx, first, last, n_eqns, budget, reuse, pers, world,
                           tier, block)
    return j, t


def _same(j, t):
    assert [(e.bucket, e.issue_at, e.first_use, e.last_use) for e in t.epochs] == \
        [(e.bucket, e.issue_at, e.first_use, e.last_use) for e in j.epochs]
    for key in ("n_eqns", "peak_live_elements", "persistent_elements", "prefetch_count",
                "gather_wire_bytes"):
        assert getattr(t, key) == getattr(j, key), key


ONE_LEAF_MB = 256 * 4 / 2 ** 20  # one 16x16 fp32 leaf a bucket


@pytest.mark.parametrize("case", ["one_ahead", "budget", "reuse_split", "reuse_keep",
                                  "unused_leaf", "int8_wire"])
def test_derive_schedule_matches_jax(case):
    """JAX's TestSchedulePass cases, on the first and last uses of its
    traces: the chain of three products (one ahead, and under a budget of
    one bucket), a leaf used at both ends (split by a reuse distance below
    the elements between, kept above it), an unused leaf, and the int8
    forward tier's wire bytes."""
    chain = ([0, 1, 2], [0, 1, 2], 4)
    args = {"one_ahead": ([256] * 3, chain, None, None, "fp32"),
            "budget": ([256] * 3, chain, 256, None, "fp32"),
            "reuse_split": ([256] * 2, ([0, 1], [2, 1], 4), None, 128, "fp32"),
            "reuse_keep": ([256] * 2, ([0, 1], [2, 1], 4), None, 512, "fp32"),
            "unused_leaf": ([256] * 2, ([0, None], [0, None], 2), None, None, "fp32"),
            "int8_wire": ([256] * 3, chain, None, None, "int8")}[case]
    sizes, (first, last, n), budget, reuse, tier = args
    j, t = _both(sizes, ONE_LEAF_MB, first, last, n, budget, reuse, tier=tier)
    _same(j, t)
    if case == "one_ahead":
        assert t.epochs[0].issue_at == -1 and t.prefetch_count == 3
    if case == "budget":
        assert t.peak_live_elements <= 256 and t.prefetch_count < 3
    if case == "reuse_split":
        assert sum(e.bucket == 0 for e in t.epochs) == 2
    if case == "unused_leaf":
        assert [e.bucket for e in t.epochs] == [0]


@settings(max_examples=60, deadline=None)
@given(st.data())
def test_derive_schedule_matches_jax_on_random_uses(data):
    """Random leaf sizes, bucket budgets, use points (some leaves unused),
    live budgets, reuse distances, persistent elements and tiers."""
    from deepspeed_tpu.runtime import zero3_schedule as jz
    n = data.draw(st.integers(1, 9))
    sizes = data.draw(st.lists(st.integers(1, 600), min_size=n, max_size=n))
    n_eqns = data.draw(st.integers(1, 40))
    first, last = [], []
    for _ in range(n):
        if data.draw(st.booleans()) and data.draw(st.booleans()):
            first.append(None)
            last.append(None)
            continue
        a = data.draw(st.integers(0, n_eqns))
        first.append(a)
        last.append(data.draw(st.integers(a, n_eqns)))
    mb = data.draw(st.sampled_from([ONE_LEAF_MB, 600 * 4 / 2 ** 20, 0.01]))
    budget = data.draw(st.one_of(st.none(), st.integers(0, 3000)))
    reuse = data.draw(st.one_of(st.none(), st.integers(0, 2000)))
    pers = data.draw(st.integers(0, 50))
    world = data.draw(st.sampled_from([1, 2, 8]))
    tier = data.draw(st.sampled_from(["fp32", "int8", "onebit"]))
    j, t = _both(sizes, mb, first, last, n_eqns, budget, reuse, pers, world, tier, 64)
    _same(j, t)
    jlay, tlay = _layouts(sizes, mb)
    sz = [b.padded_size for b in tlay.buckets]
    assert tz._peak_live(t.epochs, sz, pers) == jz._peak_live(j.epochs, sz, pers)


def test_trace_param_uses_orders_reads_and_skips_unused():
    """The port's trace: a chain of products reads its leaves in order;
    a leaf the function never reads gets no use; attribute reads are no
    operations."""
    a, b, c, unused = (torch.nn.Parameter(torch.randn(8, 8)) for _ in range(4))
    x = torch.randn(2, 8)

    def loss():
        assert a.shape == (8, 8)
        return (((x @ a) @ b) @ c.t()).sum()

    first, last, n_ops = tz.trace_param_uses(loss, [a, b, c, unused])
    assert first[:3] == [0, 1, 2] and last[:3] == [0, 1, 2] and n_ops == 3
    assert first[3] is None and last[3] is None


@pytest.mark.parametrize("threshold", [0, 64, 10 ** 5])
def test_store_meta_and_buckets_match_jax(threshold):
    """The store of the tiny Llama's params: the same persistent and
    bucketed leaves, the same slots, bucket contents bit for bit, and the
    leaves materialized back."""
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.runtime import zero3_schedule as jz
    tree = _tree()
    jleaves = jax.tree_util.tree_leaves(tree)
    pidx = [i for i, leaf in enumerate(jleaves) if leaf.size <= threshold]
    jmeta = jz.build_store_meta(tree, pidx, BUCKET_MB, 512)
    jstore = jz.store_from_tree(jax.tree_util.tree_map(jnp.asarray, tree), jmeta)
    model = params_from_jax(tree, LlamaConfig(**TINY, dtype=torch.float32),
                            dtype=torch.float32, device="cpu", training=True)
    names, params = zip(*model.named_parameters())
    order = tb.jax_leaf_order(names)
    leaves = [params[i].detach() for i in order]
    tmeta = tz.build_store_meta([tuple(p.shape) for p in leaves], pidx, BUCKET_MB, 512, order)
    assert (tmeta.np_idx, tmeta.p_idx, tmeta.n_leaves) == (jmeta.np_idx, jmeta.p_idx,
                                                           jmeta.n_leaves)
    assert tmeta.persistent_elements == jmeta.persistent_elements
    for t, j in zip(tmeta.layout.buckets, jmeta.layout.buckets):
        assert (t.size, t.padded_size) == (j.size, j.padded_size)
        assert [(s.leaf_index, s.offset, s.size) for s in t.slots] == \
            [(s.leaf_index, s.offset, s.size) for s in j.slots]
    tstore = tz.store_from_tree(leaves, tmeta)
    assert len(tstore["buckets"]) == len(jstore["buckets"])
    for a, b in zip(tstore["buckets"], jstore["buckets"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back = tz.materialize_params(tstore, tmeta)
    for got, ref in zip(back, jax.tree_util.tree_leaves(jz.materialize_params(jstore, jmeta))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------- one rank, this process


def _world1(extra, stage=3, steps=STEPS, fields=None, seed=1, gas=GAS, batches=None):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm import reset_mesh_context
    reset_mesh_context()
    fields = dict(fields or TINY, **extra.get("_model", {}))
    model = init_llama_for_causal_lm(LlamaConfig(**fields, dtype=torch.float32),
                                     seed=seed, device="cpu")
    cfg = {"train_batch_size": 2 * gas, "gradient_accumulation_steps": gas,
           "zero_optimization": {"stage": stage, "stage3_param_persistence_threshold": 0},
           "gradient_comm": dict(GC),
           "optimizer": {"type": "AdamW", "params": {"lr": LR, "weight_decay": 0.01}}}
    for k, v in extra.items():
        if k == "_model":
            continue
        if isinstance(v, dict) and isinstance(cfg.get(k), dict):
            cfg[k] = dict(cfg[k], **v)
        else:
            cfg[k] = v
    eng, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu")
    ids = batches if batches is not None else torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (steps * gas, 2, SEQ)))
    losses = [eng.train_batch(iter([(ids[k + i], ids[k + i]) for i in range(gas)]))
              for k in range(0, steps * gas, gas)]
    return eng, losses, {k: v.detach().clone() for k, v in eng.full_master_params().items()}


_WORLD1_STAGE2 = {}


def _world1_stage2(chunk):
    if chunk not in _WORLD1_STAGE2:
        fields = dict(TINY, ce_chunk_size=chunk) if chunk else None
        _WORLD1_STAGE2[chunk] = _world1({}, stage=2, fields=fields)[1:]
    return _WORLD1_STAGE2[chunk]


@pytest.mark.parametrize("chunk", [None, 48])
def test_world1_store_bit_equals_stage2_wire(chunk):
    """Five steps at gas 2: the store's losses and masters are the
    stage-2 wire's, bit for bit, with the plain CE and with the chunked CE
    (whose read of the unembedding the trace must see)."""
    base, base_m = _world1_stage2(chunk)
    fields = dict(TINY, ce_chunk_size=chunk) if chunk else None
    eng, losses, masters = _world1({}, fields=fields)
    assert eng._store is not None and eng._wire is eng._store
    assert losses == base
    assert all(torch.equal(masters[k], base_m[k]) for k in base_m)
    sched = eng._zero3_schedule
    nb = len(eng._zero3_store.layout.buckets)
    assert sorted({e.bucket for e in sched.epochs}) == list(range(nb))
    assert sched.epochs[0].issue_at == -1 and sched.prefetch_count == len(sched.epochs)
    assert eng._store.stats["gathers"] == STEPS * GAS * len(sched.epochs)


def test_world1_tied_embedding_and_persistent_leaves():
    """A tied embedding (read at both ends of the forward, one epoch) and
    persistent norm scales (whole, reduced at the boundary) train as the
    stage-2 wire does, bit for bit."""
    fields = dict(TINY, tie_word_embeddings=True)
    extra = {"zero_optimization": {"stage3_param_persistence_threshold": 64}}
    _, base, base_m = _world1(extra, stage=2, fields=fields, steps=3)
    eng, losses, masters = _world1(extra, fields=fields, steps=3)
    persistent = [eng.param_names[i] for i in eng.layout.units[-1].params]
    assert eng.layout.units[-1].persistent and all("norm" in n for n in persistent)
    assert losses == base
    assert all(torch.equal(masters[k], base_m[k]) for k in base_m)
    emb = [e for e in eng._zero3_schedule.epochs
           if "embed_tokens" in " ".join(eng.param_names[i]
                                         for i in eng.layout.units[e.bucket].params)]
    assert len(emb) == 1 and emb[0].last_use > emb[0].first_use


def test_world1_int8_tiers_within_jax_tolerance():
    """``zero_quantized_weights`` and ``zero_quantized_gradients``: the
    int8 gather and reduce-scatter keep the fp32 store's trajectory within
    JAX's own limits (rtol 0.05 on the loss, 0.1 on the masters)."""
    _, base, base_m = _world1({}, steps=3)
    eng, losses, masters = _world1({"zero_optimization": {"zero_quantized_weights": True,
                                                          "zero_quantized_gradients": True}},
                                   steps=3)
    assert (eng._store.fwd_tier, eng._store.bwd_tier) == ("int8", "int8")
    np.testing.assert_allclose(losses, base, rtol=0.05)
    assert max(float((masters[k] - base_m[k]).abs().max()) for k in base_m) < 0.1
    assert losses != base  # the tier really ran


def test_world1_budget_demotes_prefetches():
    """Under ``stage3_max_live_parameters`` the gathered peak stays in the
    budget (the bucket budget follows it, ``gather_bucket_mb``) and fewer
    epochs are prefetched than without it."""
    free = _world1({}, steps=1)[0]._zero3_schedule
    budget = 40000
    eng, losses, _ = _world1({"zero_optimization": {"stage3_max_live_parameters": budget}},
                             steps=1)
    tight = eng._zero3_schedule
    assert tight.peak_live_elements <= budget < free.peak_live_elements
    assert tight.prefetch_count < free.prefetch_count
    assert np.isfinite(losses).all()


def test_world1_forward_backward_step_and_eval_under_store():
    """The split API and ``eval_batch`` read the parameters through the
    schedule: the stage-2 wire's engine (default reduce on this API) gives
    the same numbers."""
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 2, SEQ)))
    engines = [_world1({}, stage=s, steps=0)[0] for s in (2, 3)]
    out = []
    for eng in engines:
        losses = []
        for x in ids:
            loss = eng.forward(x, labels=x)
            eng.backward(loss)
            eng.step()
            losses.append(loss.item())
        out.append((losses, eng.eval_batch(ids[0], labels=ids[0]).item(),
                    eng.eval_batch(ids[0]).detach()))
    assert out[0][0] == out[1][0] and out[0][1] == out[1][1]
    assert torch.equal(out[0][2], out[1][2])


def test_world1_full_params_and_save_16bit_model(tmp_path):
    eng, _, masters = _world1({}, steps=1)
    full = eng.full_params()
    assert all(torch.equal(full[k], masters[k]) for k in masters)
    assert eng.save_16bit_model(str(tmp_path), "model.npz")
    archive = np.load(tmp_path / "model.npz")
    assert str(archive["__dtype__"]) == "float16"
    names = sorted(k for k in archive.files if k != "__dtype__")
    assert names == sorted(".".join(jax_key_path(n)) for n in eng.param_names)


def test_world1_remat_keeps_gather_units(caplog):
    """Remat no longer keeps stage 3's gather units: under the engine's
    policy the store runs, with no warning, gathers each bucket again in
    the recompute, and trains as the stage-2 wire does under the same
    policy, bit for bit."""
    extra = REMAT["nothing"]
    _, base, base_m = _world1(extra, stage=2, steps=1)
    with caplog.at_level("WARNING"):
        eng, losses, masters = _world1(extra, steps=1)
    assert eng._store is not None and eng._gather is None
    assert "gradient_comm requested but unsupported" not in caplog.text
    assert eng._store.stats["recompute_gathers"] == eng._store.stats["gathers"]
    assert losses == base
    assert all(torch.equal(masters[k], base_m[k]) for k in base_m)


_WORLD1_REMAT_STAGE2 = {}


@pytest.mark.parametrize("remat", sorted(REMAT) + ["engine_and_model"])
def test_world1_store_under_remat_bit_equals_stage2_wire(remat):
    """Each remat policy of the engine, the model's per-layer remat (plain
    and under a policy) and both at once: the store runs, its losses and
    masters over two steps are the stage-2 wire's under the same remat,
    bit for bit; a policy that keeps everything recomputes nothing, and
    every other gathers again in the backward."""
    extra = (dict(REMAT["nothing"], **REMAT["model"]) if remat == "engine_and_model"
             else REMAT[remat])
    _, base, base_m = _world1(extra, stage=2, steps=2)
    eng, losses, masters = _world1(extra, steps=2)
    assert eng._store is not None
    assert losses == base
    assert all(torch.equal(masters[k], base_m[k]) for k in base_m)
    regathers = eng._store.stats["recompute_gathers"]
    assert regathers == 0 if remat == "everything" else regathers > 0


def test_world1_quantized_keys_raise_where_the_store_does_not_run():
    """The int8 tiers raise where the store does not run (stage 2, fp16
    loss scaling), and train under remat, where the store now runs, within
    JAX's limits of the fp32 store (rtol 0.05 on the loss, 0.1 on the
    masters)."""
    from deepspeed_tpu_torch.config.config import DeepSpeedTorchConfig
    with pytest.raises(NotImplementedError, match="zero_quantized_weights"):
        DeepSpeedTorchConfig({"train_batch_size": 2, "zero_optimization": {
            "stage": 2, "zero_quantized_weights": True}, "gradient_comm": {"enabled": True}})
    with pytest.raises(NotImplementedError, match="zero_quantized_gradients"):
        _world1({"zero_optimization": {"zero_quantized_gradients": True},
                 "fp16": {"enabled": True}}, steps=1)
    _, base, base_m = _world1({}, steps=3)
    for remat in ("nothing", "model"):
        eng, losses, masters = _world1(
            dict(REMAT[remat], zero_optimization={"zero_quantized_weights": True,
                                                  "zero_quantized_gradients": True}), steps=3)
        assert (eng._store.fwd_tier, eng._store.bwd_tier) == ("int8", "int8")
        assert eng._store.stats["recompute_gathers"] > 0
        np.testing.assert_allclose(losses, base, rtol=0.05)
        assert max(float((masters[k] - base_m[k]).abs().max()) for k in base_m) < 0.1


# ---------------------------------------------------------------- the JAX oracle


def _jax_oracle(in_path, out_path, cases):
    """The JAX engine on four host devices: each case over its mesh, from
    the same weights and batches."""
    import jax
    import jax.numpy as jnp
    import deepspeed_tpu
    from deepspeed_tpu.comm.mesh import MeshContext, reset_mesh_context, set_mesh_context
    from deepspeed_tpu.models.llama import LlamaConfig as JaxConfig, LlamaForCausalLM as JaxLM

    with open(in_path, "rb") as f:
        tree = pickle.load(f)
    out = {}
    for case in cases:
        world, mesh, _, steps = CASES[case]
        reset_mesh_context()
        set_mesh_context(MeshContext.create(axis_sizes=dict(mesh),
                                            devices=jax.devices()[:world]))
        eng, *_ = deepspeed_tpu.initialize(
            model=JaxLM(JaxConfig(**TINY, dtype=jnp.float32, attn_impl="xla")),
            model_parameters=jax.tree_util.tree_map(jnp.array, tree),
            config=_engine_config(case))
        assert eng._grad_comm_layout is not None, case
        ids = _batches(steps)
        losses = [float(eng.train_batch(iter(
            [(jnp.asarray(ids[k + i]), jnp.asarray(ids[k + i])) for i in range(GAS)])))
            for k in range(0, steps * GAS, GAS)]
        rec = {"losses": losses,
               "params": jax.tree_util.tree_map(np.asarray, eng.full_params()
                                                if eng._zero3_store is not None else eng.params)}
        sched = getattr(eng, "_zero3_schedule", None)
        if sched is not None:
            rec["schedule"] = {"buckets": [e.bucket for e in sched.epochs],
                               "prefetch_count": sched.prefetch_count,
                               "gather_wire_bytes": sched.gather_wire_bytes}
        out[case] = rec
    reset_mesh_context()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


# ---------------------------------------------------------------- the port's ranks


def _run_case(case, tree, ckpt_dir):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm import reset_mesh_context
    world, mesh, extra, steps = CASES[case]
    reset_mesh_context()
    model = params_from_jax(tree, LlamaConfig(**dict(TINY, **extra.get("_model", {})),
                                              dtype=torch.float32),
                            dtype=torch.float32, device="cpu", training=True)
    eng, *_ = deepspeed_tpu_torch.initialize(model=model, config=_engine_config(case),
                                             device="cpu")
    ids = torch.from_numpy(_batches(steps + EXTRA_STEPS))

    def step(k):
        return eng.train_batch(iter([(ids[k * GAS + i], ids[k * GAS + i]) for i in range(GAS)]))

    losses = [step(k) for k in range(steps)]
    rec = {"losses": losses, "wired": eng._wire is not None, "store": eng._store is not None,
           "masters": {k: v.detach().clone().numpy()
                       for k, v in eng.full_master_params().items()},
           "state_bytes": eng.state_bytes()}
    if eng._store is not None:
        sched = eng._zero3_schedule
        rec["padded"] = sum(b.padded_size for b in eng._zero3_store.layout.buckets)
        rec["schedule"] = {"buckets": [e.bucket for e in sched.epochs],
                           "prefetch_count": sched.prefetch_count,
                           "gather_wire_bytes": sched.gather_wire_bytes}
        rec["stats"] = dict(eng._store.stats)
    if case == "s3_fp32":  # a checkpoint at two ranks, then two more steps
        rec["saved"] = eng.save_checkpoint(ckpt_dir, tag="w2")
        rec["after"] = [step(k) for k in range(steps, steps + EXTRA_STEPS)]
    return rec


def _gather_checks(rank):
    """``param_gather_bucket`` on integer-valued inputs: its forward is the
    gather, its backward the SUM of the ranks' cotangents' chunks, in the
    sync and the async forms; the int8 tiers are the bucket collectives'."""
    from deepspeed_tpu_torch.comm import comm
    n = 512
    out = {}
    for tier in ("fp32", "int8"):
        for async_op in (False, True):
            shard = torch.arange(n, dtype=torch.float32).add_(1000.0 * rank).requires_grad_()
            coeff = torch.arange(2 * n, dtype=torch.float32).mul_(rank + 1.0)
            got = tb.param_gather_bucket(shard, "data", tier, tier, 256, async_op=async_op)
            full = got.wait() if async_op else got
            (full * coeff).sum().backward()
            out[(tier, async_op)] = (full.detach().numpy(), shard.grad.numpy(),
                                     tb.all_gather_bucket(shard.detach(), "data", tier,
                                                          256).numpy(),
                                     tb.reduce_scatter_bucket(coeff.clone(), "data", tier,
                                                              256)[0].numpy())
    comm.barrier()
    return out


def _rank_main(rank, world, store, cases):
    from deepspeed_tpu_torch import comm
    torch.set_num_threads(1)
    comm.init_distributed(dist_backend="gloo", init_method=f"file://{store}", rank=rank,
                          world_size=world)
    tmp = os.path.dirname(store)
    with open(os.path.join(tmp, "tree.pkl"), "rb") as f:
        tree = pickle.load(f)
    out = {case: _run_case(case, tree, os.path.join(tmp, "ckpt")) for case in cases}
    if world == 2:
        out["gather"] = _gather_checks(rank)
    with open(f"{store}.rank{rank}", "wb") as f:
        pickle.dump(out, f)
    import torch.distributed as dist
    dist.destroy_process_group()


def _spawn(world, tmp):
    import torch.multiprocessing as mp
    store = os.path.join(tmp, f"store{world}")
    cases = [c for c in CASES if CASES[c][0] == world]
    mp.start_processes(_rank_main, args=(world, store, cases), nprocs=world,
                       start_method="spawn")
    out = []
    for r in range(world):
        with open(f"{store}.rank{r}", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("torch_zero3_schedule"))
    tree = _tree()
    in_path, out = os.path.join(tmp, "tree.pkl"), os.path.join(tmp, "oracle.pkl")
    with open(in_path, "wb") as f:
        pickle.dump(tree, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([HERE, os.path.dirname(HERE),
                                           os.environ.get("PYTHONPATH", "")]))
    # the oracle's cases in two processes, each under the spawned ranks' time
    halves = [JAX_CASES[:2], JAX_CASES[2:]]
    outs = [f"{out}.{i}" for i in range(2)]
    oracles = [subprocess.Popen(
        [sys.executable, "-c", f"import test_torch_zero3_schedule as t; "
         f"t._jax_oracle({in_path!r}, {o!r}, {cases!r})"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cases, o in zip(halves, outs)]
    try:
        world2 = _spawn(2, tmp)
        world4 = _spawn(4, tmp)
    finally:
        logs = [o.communicate(timeout=600)[0] for o in oracles]
    jax_out = {}
    for o, log, path in zip(oracles, logs, outs):
        assert o.returncode == 0, log[-4000:]
        with open(path, "rb") as f:
            jax_out.update(pickle.load(f))
    return {"world2": world2, "world4": world4, "jax": jax_out, "tree": tree,
            "ckpt": os.path.join(tmp, "ckpt")}


def _rank0(runs, case):
    return runs["world4" if CASES[case][0] == 4 else "world2"][0][case]


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


# ---------------------------------------------------------------- two and four ranks


@pytest.mark.parametrize("tier", ["fp32", "int8"])
def test_param_gather_bucket_forward_and_backward(runs, tier):
    """On two ranks: the forward is the bucket gather and the backward the
    bucket reduce-scatter of the cotangent (for fp32, the exact gather and
    the SUM of the ranks' chunks), sync and async alike."""
    n = 512
    for rank, out in enumerate(r["gather"] for r in runs["world2"]):
        for async_op in (False, True):
            full, grad, gathered, scattered = out[(tier, async_op)]
            np.testing.assert_array_equal(full, gathered)
            np.testing.assert_array_equal(grad, scattered)
            if tier == "fp32":
                ref = np.concatenate([np.arange(n) + 1000.0 * r for r in range(2)])
                np.testing.assert_array_equal(full, ref)
                chunk = np.arange(2 * n)[rank * n:(rank + 1) * n]
                np.testing.assert_array_equal(grad, chunk * (1.0 + 2.0))


def test_store_bit_equals_stage2_wire_at_two_ranks(runs):
    """Five steps at gas 2 on two ranks: the store's losses and masters
    are the stage-2 wire's, bit for bit, on both ranks."""
    for r in runs["world2"]:
        s3, s2 = r["s3_fp32"], r["s2_fp32"]
        assert s3["losses"] == s2["losses"]
        assert all(np.array_equal(s3["masters"][k], s2["masters"][k]) for k in s2["masters"])


def test_store_matches_jax_scheduled_stage3(runs):
    """Against the JAX engine's scheduled stage 3 over {data: 2}."""
    got, ref = _rank0(runs, "s3_fp32"), runs["jax"]["s3_fp32"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_RTOL)
    _assert_masters_close(got["masters"], ref["params"], LR * STEPS, True)


def test_traced_schedule_matches_jax(runs):
    """The tiny model's traced schedule at two ranks: JAX's bucket order,
    epochs per bucket, prefetch count and gather wire bytes."""
    got, ref = _rank0(runs, "s3_fp32")["schedule"], runs["jax"]["s3_fp32"]["schedule"]
    assert got == ref


def test_store_holds_a_world_share_per_rank(runs):
    """Each rank holds 4 x padded / w bytes of masters, and its Adam
    moments are bucket shards of the same size."""
    for r in runs["world2"]:
        rec = r["s3_fp32"]
        share = 4 * rec["padded"] // 2
        assert rec["state_bytes"]["masters"] == share
        assert rec["state_bytes"]["m"] == rec["state_bytes"]["v"] == share
        # stage 2 keeps the whole compute copy on every rank; the store none
        assert rec["state_bytes"]["compute"] == 0
        assert share < 0.75 * r["s2_fp32"]["state_bytes"]["compute"]
        assert rec["stats"]["wire_bytes"] == STEPS * GAS * rec["schedule"]["gather_wire_bytes"]


def test_int8_tiers_at_two_ranks_within_jax_tolerance(runs):
    for r in runs["world2"]:
        q, base = r["s3_int8"], r["s3_fp32"]
        np.testing.assert_allclose(q["losses"], base["losses"][:Q_STEPS], rtol=0.05)
        assert q["losses"] != base["losses"][:Q_STEPS]


@pytest.mark.parametrize("remat", sorted(REMAT))
def test_store_under_remat_bit_equals_stage2_wire_at_two_ranks(runs, remat):
    """Three steps at gas 2 on two ranks under each remat: the store runs
    and its losses and masters are the stage-2 wire's under the same
    remat, bit for bit, on both ranks."""
    for r in runs["world2"]:
        s3, s2 = r[f"s3_fp32_remat_{remat}"], r[f"s2_fp32_remat_{remat}"]
        assert s3["store"] and s3["stats"]["gathers"] > 0
        assert (s3["stats"]["recompute_gathers"] == 0) == (remat == "everything")
        assert s3["losses"] == s2["losses"]
        assert all(np.array_equal(s3["masters"][k], s2["masters"][k]) for k in s2["masters"])


def test_int8_tiers_under_remat_at_two_ranks_within_jax_tolerance(runs):
    """The int8 tiers under remat on two ranks: within JAX's limits of the
    fp32 store (rtol 0.05 on the loss, 0.1 on the masters)."""
    for r in runs["world2"]:
        q, base = r["s3_int8_remat"], r["s3_fp32"]
        assert q["store"] and q["stats"]["recompute_gathers"] > 0
        np.testing.assert_allclose(q["losses"], base["losses"][:Q_STEPS], rtol=0.05)
        q_m = q["masters"]
        assert max(float(np.abs(q_m[k] - r["s3_int8"]["masters"][k]).max()) for k in q_m) < 0.1


@pytest.mark.parametrize("case", ["s1_int8_df", "s2_int8_df", "s2_fp32_df"])
def test_wire_runs_over_data_and_fsdp_and_matches_jax_int8(runs, case):
    """Stages 1-2 over {data: 2, fsdp: 2}: the wire runs over the whole dp
    world (the default reduce took its place before) and matches the JAX
    engine's int8 tier (and at stage 2 its fp32 tier, which holds the
    regather of the reduced quarters to fp32 limits); the data replicas
    hold the same masters."""
    ranks = [r[case] for r in runs["world4"]]
    assert all(r["wired"] for r in ranks)
    ref = runs["jax"][case]
    exact = "fp32" in case
    for r in ranks:
        np.testing.assert_allclose(r["losses"], ref["losses"],
                                   rtol=LOSS_RTOL if exact else DF_Q_LOSS_RTOL)
        _assert_masters_close(r["masters"], ref["params"], LR * Q_STEPS, exact)
    for k in ranks[0]["masters"]:
        assert all(np.array_equal(ranks[0]["masters"][k], r["masters"][k]) for r in ranks)


@pytest.mark.parametrize("stage", [2, 3])
def test_two_rank_checkpoint_loads_at_one_rank(runs, stage):
    """The store's checkpoint written at two ranks loads at one rank, into
    stage 2 or 3 (the reshard between worlds and stages), and the next two
    steps' losses are the two-rank run's."""
    rec = _rank0(runs, "s3_fp32")
    assert rec["saved"]
    ids = torch.from_numpy(_batches(STEPS + EXTRA_STEPS))
    eng, _, _ = _world1({}, stage=stage, steps=0)
    path, _ = eng.load_checkpoint(runs["ckpt"], tag="w2")
    assert path is not None and eng.global_steps == STEPS
    assert eng.last_load["saved_world"] == 2 and eng.last_load["saved_stage"] == 3
    got = [eng.train_batch(iter([(ids[k * GAS + i], ids[k * GAS + i]) for i in range(GAS)]))
           for k in range(STEPS, STEPS + EXTRA_STEPS)]
    np.testing.assert_allclose(got, rec["after"], rtol=LOSS_RTOL)
