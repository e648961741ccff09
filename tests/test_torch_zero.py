"""deepspeed_tpu_torch ZeRO stages 1-3 over gloo ranks on the CPU, against
the JAX engine at stage 0 on one device over the global batch.

The port's ranks are processes spawned once for the module (world 2 for
most cases, world 4 for ``dryrun_multichip``'s first config), joined
through a ``file://`` store under the test's temporary directory; each
runs its cases and writes its results there. The JAX oracle runs once for
the module, its cases split over two subprocesses with
``JAX_PLATFORMS=cpu`` and four forced host devices, its engine on a
one-device mesh, from the same weights (drawn by the port and handed over
as the JAX tree) and the same batches. Nothing
here initializes a process group in the pytest process; the rank workers
import neither ``jax`` nor ``deepspeed_tpu``.

Tolerances: fp32 runs as ``test_torch_training.py`` holds the stage-0
engine to JAX (losses rtol 1e-5; masters within 1e-5 but a few elements
whose gradient cancels to fp32 noise, none beyond twice the learning
rate's path); bf16 and fp16 runs, where a rank's half batch rounds its
gradients at other points than the whole batch, as its bf16 test does (the
RMS of the master differences within 2^-4 of the path, none beyond twice
the path).
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.config.config import DeepSpeedConfigError, DeepSpeedTorchConfig
from deepspeed_tpu_torch.models.convert import jax_key_path, lookup, params_from_jax
from deepspeed_tpu_torch.models.llama import LlamaConfig, init_llama_for_causal_lm
from deepspeed_tpu_torch.runtime.zero_sharding import FLAT_ALIGN, FlatLayout, model_units

HERE = os.path.dirname(os.path.abspath(__file__))
SEQ = 16
LR = 1e-3
STEPS = 5  # 3 forward/backward/step, then a fused_train_steps window of 2
LOSS_RTOL = 1e-5
MASTER_TOL = 1e-5
MAX_FLIPPED = 4
BF16_RMS, BF16_MAX = 2.0 ** -4, 2.0  # times the learning rate's path
TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
            rope_theta=10000.0)
GEMMA_TINY = dict(TINY, head_dim=16, tie_word_embeddings=True, norm_plus_one=True,
                  embed_scale=8.0, sandwich_norm=True, attn_logit_softcapping=50.0,
                  final_logit_softcapping=30.0, mlp_type="geglu_tanh", rms_norm_eps=1e-6)

# name -> model fields, engine config (beyond the batch), stage, mesh, world,
# global rows, gas, bf16/fp16/fp32
CASES = {
    "stage1": (dict(TINY, ce_chunk_size=100, remat=True, remat_policy="dots_saveable"),
               {}, 1, {"data": 2}, 2, 4, 1, "fp32"),
    "stage2": (dict(TINY, ce_chunk_size=100, remat=True, remat_policy="dots_saveable"),
               {}, 2, {"data": 2}, 2, 4, 1, "fp32"),
    "stage3": (dict(TINY, ce_chunk_size=100, remat=True, remat_policy="dots_saveable"),
               {}, 3, {"fsdp": 2}, 2, 4, 1, "fp32"),
    "ignore_index": (dict(TINY), {}, 3, {"fsdp": 2}, 2, 4, 1, "fp32"),
    "lamb_clip": (dict(TINY), {"optimizer": {"type": "Lamb", "params": {
        "lr": LR, "weight_decay": 0.01}}, "gradient_clipping": 0.05}, 2, {"data": 2}, 2, 4, 1,
        "fp32"),
    "gas2": (dict(TINY), {}, 2, {"data": 2}, 2, 4, 2, "fp32"),
    "scan": (dict(TINY, num_hidden_layers=4, scan_layers=True, scan_chunk_size=2), {}, 3,
             {"fsdp": 2}, 2, 4, 1, "fp32"),
    "gemma2_tied": (dict(GEMMA_TINY), {}, 3, {"fsdp": 2}, 2, 4, 1, "fp32"),
    "fp16_skip": (dict(TINY), {"fp16": {"enabled": True, "initial_scale_power": 16}}, 3,
                  {"fsdp": 2}, 2, 4, 1, "fp16"),
    # __graft_entry__.py dryrun_multichip's first config, at four ranks
    "dryrun": (dict(TINY, ce_chunk_size=96, remat=True, remat_policy="dots_saveable"),
               {"bf16": {"enabled": True}}, 3, {"data": 2, "fsdp": 2}, 4, 8, 1, "bf16"),
}
JAX_CASES = ("stage1", "ignore_index", "lamb_clip", "gas2", "scan", "gemma2_tied", "fp16_skip",
             "dryrun")


def _model_cfg(fields, precision):
    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16, "fp16": torch.float16}[precision]
    return LlamaConfig(**fields, dtype=dtype)


def _engine_config(case):
    fields, extra, stage, mesh, world, rows, gas, precision = CASES[case]
    cfg = {"train_batch_size": rows * gas, "train_micro_batch_size_per_gpu": rows // world,
           "gradient_accumulation_steps": gas,
           "optimizer": {"type": "AdamW", "params": {"lr": LR, "weight_decay": 0.01}}}
    cfg.update(extra)
    return cfg


def _jax_tree(tmodel, fields):
    """The JAX param tree (numpy leaves) holding ``tmodel``'s values; a
    scanned model's layers stacked as the JAX scan holds them."""
    tree = {}
    for name, p in tmodel.named_parameters():
        node = tree
        path = jax_key_path(name)
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = p.detach().float().numpy().copy()
    if fields.get("scan_layers"):
        model, c = tree["model"], fields["scan_chunk_size"]
        n = fields["num_hidden_layers"]
        layers = [model.pop(f"layers_{j}") for j in range(n)]

        def stack(*xs):
            return np.stack(xs) if isinstance(xs[0], np.ndarray) else {
                k: stack(*[x[k] for x in xs]) for k in xs[0]}

        model["layers"] = {f"layer_{i}": stack(*layers[i::c]) for i in range(c)}
    return tree


def _batches(case):
    """``[steps x gas, rows, SEQ]`` ids and labels; ``ignore_index`` puts
    -100 on most of the second half's labels (one rank's rows)."""
    _, _, _, _, _, rows, gas, _ = CASES[case]
    rng = np.random.default_rng(len(case))
    ids = rng.integers(0, 256, size=(STEPS * gas, rows, SEQ)).astype(np.int64)
    labels = ids.copy()
    if case == "ignore_index":
        labels[:, rows // 2:, 3:] = -100
        labels[:, 0, :5] = -100
    return ids, labels


def _initial_tree(case):
    fields, *_ = CASES[case]
    base = dict(fields)
    base.pop("scan_layers", None)
    base.pop("scan_chunk_size", None)
    tmodel = init_llama_for_causal_lm(_model_cfg(base, "fp32"), seed=len(case), device="cpu")
    return _jax_tree(tmodel, fields)


# ---------------------------------------------------------------- the JAX oracle


def _jax_oracle(in_path, out_path, cases):
    """The JAX engine at stage 0 on one device over the global batch, for
    each of ``cases``: losses, grad norms, skipped steps, loss scales and
    the final masters; with ``dryrun`` among them also the JAX engine's own
    ZeRO-3 over its mesh."""
    import jax
    import jax.numpy as jnp
    import deepspeed_tpu
    from deepspeed_tpu.comm.mesh import MeshContext, reset_mesh_context, set_mesh_context
    from deepspeed_tpu.models.llama import LlamaConfig as JaxConfig, LlamaForCausalLM as JaxLM

    with open(in_path, "rb") as f:
        trees = pickle.load(f)
    out = {}
    for case in cases:
        fields, extra, stage, mesh, world, rows, gas, precision = CASES[case]
        dtype = {"fp32": jnp.float32, "bf16": jnp.bfloat16, "fp16": jnp.float16}[precision]
        # XLA's CPU dot refuses fp16 inputs with an fp32 result: fp16 takes
        # the flash route, as test_torch_loss_scaler.py's JAX engine does
        jcfg = JaxConfig(**fields, dtype=dtype,
                         attn_impl="flash" if precision == "fp16" else "xla")
        reset_mesh_context()
        set_mesh_context(MeshContext.create(axis_sizes={"data": 1}, devices=jax.devices()[:1]))
        cfg = _engine_config(case)
        cfg["train_micro_batch_size_per_gpu"] = rows
        params = jax.tree_util.tree_map(jnp.asarray, trees[case])
        eng, *_ = deepspeed_tpu.initialize(model=JaxLM(jcfg), model_parameters=params,
                                           config=cfg)
        ids, labels = _batches(case)
        losses, norms, scales = [], [], []
        for step in range(STEPS):
            total = 0.0
            for micro in range(gas):
                k = step * gas + micro
                loss = eng.forward(jnp.asarray(ids[k]), labels=jnp.asarray(labels[k]))
                eng.backward(loss)
                eng.step()
                total += float(loss)
            losses.append(total / gas)
            norms.append(float(eng.get_global_grad_norm()))
            scales.append(eng.cur_scale)
        out[case] = {"losses": losses, "norms": norms, "skipped_steps": eng.skipped_steps,
                     "scales": scales, "params": jax.tree_util.tree_map(np.asarray, eng.params)}
    if "dryrun" not in cases:
        with open(out_path, "wb") as f:
            pickle.dump(out, f)
        return
    # the second oracle: the JAX engine's own ZeRO-3 over {data: 2, fsdp: 2}
    fields, extra, stage, mesh, world, rows, gas, precision = CASES["dryrun"]
    reset_mesh_context()
    cfg = dict(_engine_config("dryrun"), zero_optimization={"stage": 3}, mesh=mesh)
    eng, *_ = deepspeed_tpu.initialize(
        model=JaxLM(JaxConfig(**fields, dtype=jnp.bfloat16, attn_impl="xla")),
        model_parameters=jax.tree_util.tree_map(jnp.asarray, trees["dryrun"]), config=cfg)
    ids, labels = _batches("dryrun")
    losses = []
    for step in range(STEPS):
        loss = eng.forward(jnp.asarray(ids[step]), labels=jnp.asarray(labels[step]))
        eng.backward(loss)
        eng.step()
        losses.append(float(loss))
    out["dryrun_jax_zero3"] = {"losses": losses,
                               "params": jax.tree_util.tree_map(np.asarray, eng.params)}
    reset_mesh_context()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


# ---------------------------------------------------------------- the port's ranks


def _run_case(case, rank, trees):
    """One case on this rank: 3 forward/backward/step (gas micro-batches
    each) and a fused_train_steps window of 2 (a train_batch loop at gas >
    1); returns what the tests read."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm import reset_mesh_context

    fields, extra, stage, mesh, world, rows, gas, precision = CASES[case]
    reset_mesh_context()
    cfg = _model_cfg(fields, precision)
    model = params_from_jax(trees[case], cfg, dtype=torch.float32, device="cpu", training=True)
    config = dict(_engine_config(case), zero_optimization={
        "stage": stage, "stage3_param_persistence_threshold": 64}, mesh=mesh)
    eng, *_ = deepspeed_tpu_torch.initialize(model=model, config=config, device="cpu")
    ids, labels = (torch.from_numpy(x) for x in _batches(case))
    losses, norms, scales = [], [], []
    for step in range(STEPS):
        if gas > 1:
            k = step * gas
            losses.append(eng.train_batch(iter(zip(ids[k:k + gas], labels[k:k + gas]))))
            norms.append(eng.get_global_grad_norm())
        elif step < 3:
            loss = eng.forward(ids[step], labels=labels[step])
            eng.backward(loss)
            eng.step()
            losses.append(loss.item())
            norms.append(eng.get_global_grad_norm())
            scales.append(eng.cur_scale)
        elif step == 3:
            losses += eng.fused_train_steps(ids[3:], labels=labels[3:]).tolist()
    full = {k: v.detach().clone().numpy() for k, v in eng.full_master_params().items()}
    layout = eng.layout
    straddles = [eng.param_names[i] for u in layout.units for i, (a, b) in zip(u.params, u.bounds)
                 if layout.zero_size > 1 and a // u.shard_len != (b - 1) // u.shard_len]
    rec = {"losses": losses, "norms": norms, "masters": full, "state_bytes": eng.state_bytes(),
           "full_numel": layout.full_numel, "shard_numel": layout.shard_numel,
           "zero_size": layout.zero_size, "straddles": straddles,
           "n_units": len(layout.units), "n_tensors": len(eng.param_names),
           "skipped_steps": eng.skipped_steps, "scales": scales,
           "persistent": [eng.param_names[i] for u in layout.units if u.persistent
                          for i in u.params]}
    if case == "stage3":
        rec["gathered"] = _gathered_parameters_check(eng, rank)
        rec["released_nan"] = _released_unit_check(eng)
    return rec


@torch.no_grad()
def _released_unit_check(eng):
    """Weights of released stage-3 units reached outside the modules that
    gather them: a layer's q_proj called on its own, and the embedding of
    the rest unit. Both give NaN, not a result from zeros."""
    layer = eng.module.model.layers[1]
    q = layer.self_attn.q_proj(torch.ones(1, 2, TINY["hidden_size"]))
    e = eng.module.model.embed_tokens(torch.zeros(1, 2, dtype=torch.long))
    return {"q_proj": bool(q.isnan().all()), "embedding": bool(e.isnan().all())}


class _NoTokenCount(torch.nn.Module):
    """A causal LM whose loss gives the engine no count of its tokens."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, input_ids, labels=None):
        return self.inner(input_ids, labels=labels)


def _no_token_count_check():
    """At dp 2 the engine refuses a loss it cannot weight by its tokens;
    returns the error's message (None if nothing was raised)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm import reset_mesh_context
    reset_mesh_context()
    model = _NoTokenCount(init_llama_for_causal_lm(_model_cfg(TINY, "fp32"), seed=0,
                                                   device="cpu"))
    config = dict(_engine_config("stage1"), zero_optimization={"stage": 1}, mesh={"data": 2})
    eng, *_ = deepspeed_tpu_torch.initialize(model=model, config=config, device="cpu")
    ids = torch.zeros(4, SEQ, dtype=torch.long)
    try:
        eng.forward(ids, labels=ids)
    except ValueError as e:
        return str(e)
    return None


def _gathered_parameters_check(eng, rank):
    """``GatheredParameters`` with ``modifier_rank=1``: rank 1 adds 1 to a
    layer's q_proj inside the block; after it every rank's masters hold
    the edit, and a second block reads the edited whole tensor."""
    from deepspeed_tpu_torch import zero
    name = "model.layers.1.self_attn.q_proj.kernel"
    p = dict(eng.module.named_parameters())[name]
    before = eng.full_master_params()[name].clone()
    with zero.GatheredParameters([p], modifier_rank=1):
        whole = p.shape == before.shape and torch.equal(p.detach(), before)
        if rank == 1:
            p.data.add_(1.0)
    after = eng.full_master_params()[name]
    with zero.GatheredParameters(p):
        reread = torch.equal(p.detach(), before + 1.0)
    released = p.untyped_storage().nbytes() <= p.element_size()
    return {"whole_inside": bool(whole), "masters_edited": bool(torch.equal(after, before + 1.0)),
            "reread": bool(reread), "released_after": bool(released)}


def _rank_main(rank, world, store, cases):
    from deepspeed_tpu_torch import comm
    torch.set_num_threads(1)  # tiny shapes: threads only contend with the other ranks
    comm.init_distributed(dist_backend="gloo", init_method=f"file://{store}", rank=rank,
                          world_size=world)
    with open(os.path.join(os.path.dirname(store), "trees.pkl"), "rb") as f:
        trees = pickle.load(f)
    out = {case: _run_case(case, rank, trees) for case in cases}
    if world == 2:
        out["no_token_count"] = _no_token_count_check()
    with open(f"{store}.rank{rank}", "wb") as f:
        pickle.dump(out, f)
    import torch.distributed as dist
    dist.destroy_process_group()


def _spawn(world, cases, tmp):
    import torch.multiprocessing as mp
    store = os.path.join(tmp, f"store{world}")
    mp.start_processes(_rank_main, args=(world, store, cases), nprocs=world,
                       start_method="spawn")
    out = []
    for r in range(world):
        with open(f"{store}.rank{r}", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("torch_zero"))
    trees = {case: _initial_tree(case) for case in CASES}
    with open(os.path.join(tmp, "trees.pkl"), "wb") as f:
        pickle.dump(trees, f)
    in_path = os.path.join(tmp, "oracle_in.pkl")
    with open(in_path, "wb") as f:
        pickle.dump({c: trees[c] for c in JAX_CASES}, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([HERE, os.path.dirname(HERE),
                                           os.environ.get("PYTHONPATH", "")]))
    # the oracle's cases in two processes, each under the spawned ranks' time
    halves = [JAX_CASES[:len(JAX_CASES) // 2], JAX_CASES[len(JAX_CASES) // 2:]]
    outs = [os.path.join(tmp, f"oracle{i}.pkl") for i in range(2)]
    oracles = [subprocess.Popen(
        [sys.executable, "-c",
         f"import test_torch_zero as t; t._jax_oracle({in_path!r}, {out!r}, {cases!r})"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cases, out in zip(halves, outs)]
    try:
        world2 = _spawn(2, [c for c in CASES if CASES[c][4] == 2], tmp)
        world4 = _spawn(4, [c for c in CASES if CASES[c][4] == 4], tmp)
    finally:
        logs = [o.communicate(timeout=600)[0] for o in oracles]
    jax_out = {}
    for o, log, out in zip(oracles, logs, outs):
        assert o.returncode == 0, log[-4000:]
        with open(out, "rb") as f:
            jax_out.update(pickle.load(f))
    return {"world2": world2, "world4": world4, "jax": jax_out, "trees": trees}


def _rank0(runs, case):
    return runs["world4" if CASES[case][4] == 4 else "world2"][0][case]


def _assert_masters_close(masters, ref_tree, path, precision):
    if precision == "fp32":
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
        assert np.sqrt(np.mean(diffs ** 2)) <= BF16_RMS * path
        assert np.abs(diffs).max() <= BF16_MAX * path


# ---------------------------------------------------------------- config


@pytest.mark.parametrize("section,attr,value", [
    ({"stage": 3, "stage3_param_persistence_threshold": 7}, "param_persistence_threshold", 7),
    ({"stage": 3, "param_persistence_threshold": 9}, "param_persistence_threshold", 9),
    ({"stage": 3, "stage3_max_live_parameters": 1000}, "max_live_parameters", 1000),
    ({"stage": 2, "stage3_prefetch_bucket_size": 5}, "prefetch_bucket_size", 5),
    ({"stage": 1, "overlap_comm": True, "reduce_bucket_size": 10}, "overlap_comm", True),
    ({"stage": 2}, "allgather_bucket_size", int(5e8)),
    ({"stage": 3, "stage3_gather_16bit_weights_on_model_save": True},
     "gather_16bit_weights_on_model_save", True),
    ({"stage": 0, "offload_param": {"device": "none"}}, "stage", 0),
])
def test_zero_config_keys_and_aliases(section, attr, value):
    cfg = DeepSpeedTorchConfig({"train_batch_size": 2, "zero_optimization": section})
    assert getattr(cfg.zero_config, attr) == value


@pytest.mark.parametrize("section,match", [
    ({"stage": 3, "offload_param": {"device": "cpu"}}, "offload_param"),
    ({"stage": 2, "offload_optimizer": {"device": "nvme"}}, "offload_optimizer"),
    ({"stage": 3, "zero_quantized_weights": True}, "zero_quantized_weights"),
    ({"stage": 2, "zero_quantized_gradients": True}, "zero_quantized_gradients"),
    ({"stage": 3, "zero_hpz_partition_size": 2}, "zero_hpz_partition_size"),
    ({"stage": 3, "mics_shard_size": 2}, "mics_shard_size"),
    ({"stage": 3, "zero_quantized_nontrainable_weights": True},
     "zero_quantized_nontrainable_weights"),
])
def test_zero_config_refuses_unported_keys(section, match):
    with pytest.raises(NotImplementedError, match=match):
        DeepSpeedTorchConfig({"train_batch_size": 2, "zero_optimization": section})


@pytest.mark.parametrize("section", [{"stage": 4}, {"stage": 1, "reduce_bucket_size": -1}])
def test_zero_config_rejects_bad_values(section):
    with pytest.raises(DeepSpeedConfigError):
        DeepSpeedTorchConfig({"train_batch_size": 2, "zero_optimization": section})


@pytest.mark.parametrize("batch,dp,expect", [
    ({"train_batch_size": 16}, 4, (16, 4, 1)),
    ({"train_batch_size": 16, "gradient_accumulation_steps": 2}, 4, (16, 2, 2)),
    ({"train_batch_size": 16, "train_micro_batch_size_per_gpu": 2}, 4, (16, 2, 2)),
    ({"train_micro_batch_size_per_gpu": 3, "gradient_accumulation_steps": 2}, 2, (12, 3, 2)),
    ({"train_micro_batch_size_per_gpu": 3}, 2, (6, 3, 1)),
])
def test_batch_triangle_over_the_dp_world(batch, dp, expect):
    """The JAX package's resolution at the same dp world, and again after
    ``reresolve`` to one rank."""
    cfg = DeepSpeedTorchConfig(batch, world_size=dp)
    assert (cfg.train_batch_size, cfg.train_micro_batch_size_per_gpu,
            cfg.gradient_accumulation_steps) == expect
    from deepspeed_tpu.config import DeepSpeedTpuConfig
    ref = DeepSpeedTpuConfig(dict(batch), world_size=dp)
    assert (ref.train_batch_size, ref.train_micro_batch_size_per_gpu,
            ref.gradient_accumulation_steps) == expect
    cfg.reresolve(1)
    assert cfg.train_batch_size == cfg.train_micro_batch_size_per_gpu * \
        cfg.gradient_accumulation_steps


def test_batch_triangle_rejects_a_mismatch_over_dp():
    with pytest.raises(DeepSpeedConfigError, match="world_size"):
        DeepSpeedTorchConfig({"train_batch_size": 8, "train_micro_batch_size_per_gpu": 2,
                              "gradient_accumulation_steps": 2}, world_size=4)


def test_mesh_config_keys():
    cfg = DeepSpeedTorchConfig({"train_batch_size": 2, "mesh": {"fsdp": 2, "data": 2}})
    assert cfg.mesh_config.axis_sizes() == {"pipe": 1, "data": 2, "fsdp": 2, "seq": 1,
                                            "expert": 1, "model": 1}
    with pytest.raises(DeepSpeedConfigError):
        DeepSpeedTorchConfig({"train_batch_size": 2, "mesh": {"fsdp": 0}})


# ---------------------------------------------------------------- the layout


@pytest.mark.parametrize("zero_size", [2, 3, 4])
def test_shard_layout_equal_aligned_and_persistent(zero_size):
    """Every unit cut in equal shards of whole FLAT_ALIGN blocks, the
    pieces of all ranks covering each parameter once, the norm weights
    (at most the threshold's elements) in the persistent unit and each
    layer its own unit."""
    model = init_llama_for_causal_lm(LlamaConfig.tiny(dtype=torch.float32), device="cpu")
    params = list(model.parameters())
    numels = [p.numel() for p in params]
    units, mods = model_units(model, params, numels, zero_size, 64)
    covered = [0] * len(params)
    for r in range(zero_size):
        layout = FlatLayout(units, len(params), zero_size, r)
        assert layout.shard_numel * zero_size == layout.full_numel
        for u in layout.units:
            assert u.length == u.shard_len * zero_size
            assert u.shard_len % FLAT_ALIGN == 0 and u.shard_offset % FLAT_ALIGN == 0
        for i, s, e, off in layout.pieces:
            covered[i] += e - s
    assert covered == numels
    names = [n for n, _ in model.named_parameters()]
    persistent = [names[i] for u in units if u.persistent for i in u.params]
    assert persistent and all(n.endswith("layernorm.weight") or n == "model.norm.weight"
                              for n in persistent)
    assert [len(m) for m in mods[1:-1]] == [1, 1]  # one layer per gather unit


def test_units_keep_their_modules_when_a_unit_empties():
    """With a threshold that makes the embedding and the head persistent,
    the rest of the model leaves no unit, and each remaining unit still
    carries the modules whose forward gathers it."""
    model = init_llama_for_causal_lm(LlamaConfig.tiny(dtype=torch.float32), device="cpu")
    params = list(model.parameters())
    units, mods = model_units(model, params, [p.numel() for p in params], 2, 256 * 64)
    assert len(units) == len(mods) and units[-1].persistent and mods[-1] == []
    assert not any(u.name == "rest" for u in units)
    for u, m in zip(units[:-1], mods[:-1]):
        owned = {id(p) for mod in m for p in mod.parameters()}
        assert all(id(params[i]) in owned for i in u.params)


# ---------------------------------------------------------------- stages 1-3


@pytest.mark.parametrize("case", ["stage1", "stage2", "stage3"])
def test_stages_match_jax_stage0(runs, case):
    """3 steps and a 2-step window of each stage at world 2 against the JAX
    engine at stage 0 on one device over the global batch."""
    got, ref = _rank0(runs, case), runs["jax"]["stage1"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["norms"][:3], ref["norms"][:3], rtol=1e-5)
    _assert_masters_close(got["masters"], ref["params"], STEPS * LR, "fp32")


def test_stages_bit_equal_at_world_2(runs):
    """A sum of two values does not depend on its order, so stages 1, 2
    and 3 leave the same bits."""
    a = _rank0(runs, "stage1")
    for case in ("stage2", "stage3"):
        b = _rank0(runs, case)
        assert a["losses"] == b["losses"] and a["norms"] == b["norms"], case
        for name, m in a["masters"].items():
            assert np.array_equal(m, b["masters"][name]), (case, name)


@pytest.mark.parametrize("case", ["stage1", "stage2", "stage3"])
def test_state_sizes_per_rank(runs, case):
    """Each rank holds 1/zero-world (plus padding) of the masters and the
    optimizer state; at stage 2 also of the accumulation buffer; at stage
    3 also of the compute copy (plus the persistent unit)."""
    stage = CASES[case][2]
    for rank_out in runs["world2"]:
        rec = rank_out[case]
        z, b = rec["zero_size"], rec["state_bytes"]
        n_params = sum(m.size for m in rec["masters"].values())
        shard = rec["shard_numel"] * 4
        assert z == 2 and rec["full_numel"] == 2 * rec["shard_numel"]
        # padding: each tensor to a FLAT_ALIGN block, each unit to z of them
        padding = rec["full_numel"] - n_params
        assert 0 <= padding < FLAT_ALIGN * (rec["n_tensors"] + z * rec["n_units"])
        assert b["masters"] == b["m"] == b["v"] == shard
        assert b["grad_acc"] == (shard if stage >= 2 else 2 * shard)
        persistent = sum(rec["masters"][n].size for n in rec["persistent"])
        if stage == 3:  # fp32 compute: the masters' shards, and the persistent unit
            assert b["compute"] < shard / 4 and b["compute"] >= persistent * 4
        else:
            assert b["compute"] == 2 * shard


def test_dryrun_first_config_at_world_4(runs):
    """dryrun_multichip's first config (tiny Llama, chunked CE 96,
    dots_saveable remat, AdamW, bf16, ZeRO-3 over {data: 2, fsdp: 2}) at
    four ranks, 1 + 2 steps more than the dryrun, against the JAX stage 0
    in bf16."""
    got, ref = _rank0(runs, "dryrun"), runs["jax"]["dryrun"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=2.0 ** -7)
    _assert_masters_close(got["masters"], ref["params"], STEPS * LR, "bf16")
    ranks = runs["world4"]
    assert all(r["dryrun"]["zero_size"] == 2 for r in ranks)
    # the fsdp replicas across data hold the same shards
    assert ranks[0]["dryrun"]["losses"] == ranks[2]["dryrun"]["losses"]


def test_dryrun_first_config_matches_jax_zero3(runs):
    """The same run against the JAX engine's own ZeRO-3 over {data: 2,
    fsdp: 2} on four host devices (the second oracle)."""
    got, ref = _rank0(runs, "dryrun"), runs["jax"]["dryrun_jax_zero3"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=2.0 ** -7)
    _assert_masters_close(got["masters"], ref["params"], STEPS * LR, "bf16")


def test_ignore_index_uneven_over_ranks(runs):
    """Labels ignored mostly on one rank's rows: each rank's loss weighted
    by its share of the global count gives the JAX global token mean."""
    labels = _batches("ignore_index")[1]
    counts = [(labels[0, r * 2:(r + 1) * 2, 1:] != -100).sum() for r in range(2)]
    assert counts[0] > 4 * counts[1]
    got, ref = _rank0(runs, "ignore_index"), runs["jax"]["ignore_index"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_RTOL)
    _assert_masters_close(got["masters"], ref["params"], STEPS * LR, "fp32")


def test_lamb_and_clip_with_a_straddling_parameter(runs):
    """LAMB's trust ratio and the clip factor from norms of whole
    parameters, under stage 2, where parameters straddle the shard
    boundary."""
    got, ref = _rank0(runs, "lamb_clip"), runs["jax"]["lamb_clip"]
    assert got["straddles"], "no parameter straddles a shard boundary"
    assert ref["norms"][0] > 0.05  # the clip bites
    np.testing.assert_allclose(got["norms"], ref["norms"][:3], rtol=1e-5)
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_RTOL)
    _assert_masters_close(got["masters"], ref["params"], STEPS * LR, "fp32")


def test_fp16_skipped_step_under_stage3(runs):
    """fp16 from a scale of 2^16: the first steps overflow and are
    skipped on both ranks as in the JAX engine's stage 0, the scale halves
    as there, and the applied steps agree at the fp16 tolerance."""
    got, ref = _rank0(runs, "fp16_skip"), runs["jax"]["fp16_skip"]
    assert 0 < got["skipped_steps"] == ref["skipped_steps"] < STEPS
    assert got["scales"] == ref["scales"][:3]
    assert runs["world2"][1]["fp16_skip"]["skipped_steps"] == got["skipped_steps"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=2.0 ** -7)
    path = (STEPS - got["skipped_steps"]) * LR
    _assert_masters_close(got["masters"], ref["params"], path, "fp16")


def test_gas2_under_stage2(runs):
    got, ref = _rank0(runs, "gas2"), runs["jax"]["gas2"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_RTOL)
    _assert_masters_close(got["masters"], ref["params"], STEPS * LR, "fp32")


def test_scan_layers_chunk2_under_stage3(runs):
    """scan_layers with scan_chunk_size 2 (two layers a gather unit) from
    the JAX scanned tree through params_from_jax, against JAX's scanned
    model."""
    got, ref = _rank0(runs, "scan"), runs["jax"]["scan"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_RTOL)
    _assert_masters_close(got["masters"], ref["params"], STEPS * LR, "fp32")


def test_gemma2_tied_embedding_under_stage3(runs):
    """Gemma-2's tied embedding, gathered at the embedding and at the head,
    its gradient summed over both uses before the reduce-scatter."""
    got, ref = _rank0(runs, "gemma2_tied"), runs["jax"]["gemma2_tied"]
    assert "model.lm_head.kernel" not in got["masters"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_RTOL)
    _assert_masters_close(got["masters"], ref["params"], STEPS * LR, "fp32")


def test_gathered_parameters_with_modifier_rank(runs):
    for rank_out in runs["world2"]:
        assert rank_out["stage3"]["gathered"] == {"whole_inside": True, "masters_edited": True,
                                                  "reread": True, "released_after": True}


def test_released_stage3_weights_read_as_nan(runs):
    for rank_out in runs["world2"]:
        assert rank_out["stage3"]["released_nan"] == {"q_proj": True, "embedding": True}


def test_engine_refuses_a_loss_without_a_token_count_across_ranks(runs):
    for rank_out in runs["world2"]:
        assert "loss_token_count" in (rank_out["no_token_count"] or "")


@pytest.mark.parametrize("chunk", [None, 24])
def test_loss_token_count_is_the_ce_denominator(chunk):
    """``loss_token_count`` times the loss is the sum of the per-token CE
    over the labels that count (PyTorch's ``cross_entropy`` with
    ``ignore_index``), for the plain and the chunked CE."""
    import torch.nn.functional as F
    model = init_llama_for_causal_lm(_model_cfg(dict(TINY, ce_chunk_size=chunk), "fp32"),
                                     seed=3, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, SEQ)))
    labels = ids.clone()
    labels[0, 4:] = -100
    labels[1, :2] = -100
    with torch.no_grad():
        loss = model(ids, labels=labels)
        logits = model.model(ids)
    n = model.loss_token_count(ids, labels=labels)
    assert int(n) == (labels[:, 1:] != -100).sum()
    ref = F.cross_entropy(logits[:, :-1].reshape(-1, 256), labels[:, 1:].reshape(-1),
                          ignore_index=-100, reduction="sum")
    torch.testing.assert_close(loss * n, ref, rtol=1e-5, atol=0)


# ---------------------------------------------------------------- the model


def test_scan_layers_errors_match_jax():
    with pytest.raises(ValueError, match="sliding_window_layers"):
        init_llama_for_causal_lm(LlamaConfig.tiny(
            scan_layers=True, sliding_window=8, sliding_window_layers=(0, ),
            dtype=torch.float32), device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        init_llama_for_causal_lm(LlamaConfig.tiny(scan_layers=True, scan_chunk_size=3,
                                                  dtype=torch.float32), device="cpu")


def test_params_from_jax_reads_a_scanned_tree():
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.models import LlamaConfig as JaxConfig, init_llama
    _, params = init_llama(JaxConfig.tiny(num_hidden_layers=4, scan_layers=True,
                                          scan_chunk_size=2, dtype=jnp.float32), seed=1)
    tree = jax.tree_util.tree_map(np.asarray, params)
    cfg = LlamaConfig.tiny(num_hidden_layers=4, scan_layers=True, scan_chunk_size=2,
                           dtype=torch.float32)
    model = params_from_jax(tree, cfg, dtype=torch.float32, device="cpu", training=True)
    q = tree["model"]["layers"]["layer_1"]["self_attn"]["q_proj"]["kernel"]
    got = dict(model.named_parameters())["model.layers.3.self_attn.q_proj.kernel"]
    np.testing.assert_array_equal(got.detach().numpy(), q[1])
    assert [len(u) for u in model.gather_units()] == [2, 2]
