"""deepspeed_tpu_torch's 1-bit optimizers (``runtime/onebit.py``) and
their compressed wire (``runtime/onebit_wire.py``, ``comm/compressed.py``)
against the JAX package's.

The optimizers alone: the same seeded parameters and gradients through
``build_onebit_optimizer``'s optax chain and through the port's flat
optimizer (parameters at 64-aligned places in one buffer), across
``freeze_step``, in this process. The engine: two gloo ranks spawned once
for the module (a ``file://`` store under the test's temporary directory)
over ``{data: 2}``, each case a fresh engine taking 5 ``train_batch``
steps at gas 1; the JAX oracle runs once in a subprocess with two forced
host devices, from the same weights and batches. The rank workers
import neither ``jax`` nor ``deepspeed_tpu``.

Tolerances. The warmup steps are Adam (or LAMB) and agree as the port's
Adam does (fp32 rounding). After the freeze the momentum is the sign
times a scale, the mean |x| of a parameter, which the port sums in
another order than XLA: the scales agree to ulps and a sign differs only
where the corrected momentum is within such an ulp of 0, and every step
with a frozen variance divides by its square root plus ``eps``, which
amplifies the rounding where a variance is small. So the optimizer runs
hold rtol 1e-5 with atol 1e-6 (the learning rate is 1e-2). The engines
take ``eps`` 1e-3, which bounds that amplification (``|u| <= scale /
eps``), a vocabulary of 64 and a first batch that holds every token once,
so no embedding row keeps a zero variance (1-bit Adam moves such a row by
its scale over ``eps`` in JAX as in the port). They hold losses rtol 1e-5
and the masters within 1e-5 but 8 elements (a sign taken at a corrected
momentum within an ulp of 0, or an Adam element whose gradient cancels to
fp32 noise), none beyond twice the learning rate's path.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.models.convert import jax_key_path, lookup, params_from_jax
from deepspeed_tpu_torch.models.llama import LlamaConfig, init_llama_for_causal_lm
from deepspeed_tpu_torch.runtime.optimizers import build_optimizer
from deepspeed_tpu_torch.runtime.zero_sharding import flat_bounds

HERE = os.path.dirname(os.path.abspath(__file__))
SEQ, ROWS, STEPS, LR, FREEZE, EPS = 16, 4, 5, 1e-3, 2, 1e-3
MASTER_TOL, MAX_FLIPPED = 1e-5, 8
TINY = dict(vocab_size=64, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
            rope_theta=10000.0)
SHAPES = {"a": (8, 12), "b": (37, ), "c": (3, 5, 7)}

# name -> optimizer type, its params, ZeRO stage
CASES = {
    "onebitadam_wire": ("OneBitAdam", {"comm_backend_name": "nccl"}, 0),
    "onebitlamb_wire": ("OneBitLamb", {"comm_backend_name": "nccl"}, 0),
    "onebitadam_stage2": ("OneBitAdam", {}, 2),
    "onebitlamb_stage1": ("OneBitLamb", {}, 1),
    "zerooneadam_stage2": ("ZeroOneAdam", {"var_freeze_step": 1, "var_update_scaler": 2}, 2),
}


# ---------------------------------------------------------------- the optimizers alone


def _opt_params(name):
    extra = {"zerooneadam": {"var_freeze_step": 2, "var_update_scaler": 3},
             "onebitlamb": {"max_coeff": 3.0, "min_coeff": 0.5}}.get(name, {})
    return dict({"lr": 1e-2, "weight_decay": 0.01, "freeze_step": 3}, **extra)


@pytest.mark.parametrize("name", ["onebitadam", "zerooneadam", "onebitlamb"])
def test_optimizer_matches_jax_across_freeze_step(name):
    """7 updates (3 of warmup) with the same gradients: every parameter
    after every update, and 1-bit Adam's momentum two-valued per parameter
    after the freeze, its variance frozen."""
    import jax
    import jax.numpy as jnp
    import optax
    from deepspeed_tpu.runtime.onebit import build_onebit_optimizer
    rng = np.random.default_rng(7)
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(7)]
    params = _opt_params(name)
    tx = build_onebit_optimizer(name, params, params["lr"])
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jp)
    keys = sorted(SHAPES)
    bounds, total = flat_bounds([int(np.prod(SHAPES[k])) for k in keys])
    flat = torch.zeros(total)
    for k, (a, b) in zip(keys, bounds):
        flat[a:b] = torch.from_numpy(init[k].ravel())
    opt = build_optimizer(name, flat, params, bounds=bounds, names=keys,
                          shapes=[SHAPES[k] for k in keys],
                          whole_numels=[b - a for a, b in bounds])
    for i, g in enumerate(grads):
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        gflat = torch.zeros(total)
        for k, (a, b) in zip(keys, bounds):
            gflat[a:b] = torch.from_numpy(g[k].ravel())
        opt.step(gflat)
        for k, (a, b) in zip(keys, bounds):
            np.testing.assert_allclose(flat[a:b].numpy(), np.asarray(jp[k]).ravel(),
                                       rtol=1e-5, atol=1e-6, err_msg=f"{name} {k} step {i}")
    assert float(flat[bounds[0][1]:bounds[1][0]].abs().sum()) == 0  # the padding stays 0
    if name == "onebitadam":
        mu = opt.state["mu"]
        for a, b in bounds:
            assert len(np.unique(np.abs(mu[a:b].numpy()))) == 1
        nu = opt.state["nu"].clone()
        opt.step(gflat)
        assert torch.equal(opt.state["nu"], nu)


def test_optimizer_keys_and_refusals():
    flat = torch.zeros(8)
    with pytest.raises(NotImplementedError, match="onebitadam"):
        build_optimizer("onebitadam", flat, {"cuda_aware": True})
    opt = build_optimizer("zerooneadam", flat, {"freeze_step": 5})
    assert (opt.var_freeze_step, opt.var_update_scaler) == (5, 16)
    opt = build_optimizer("onebitlamb", flat, {})
    assert (opt.freeze_step, opt.max_coeff, opt.min_coeff) == (100000, 10.0, 0.01)


# ---------------------------------------------------------------- the engines


def _engine_config(case):
    opt, extra, stage = CASES[case]
    params = dict({"lr": LR, "eps": EPS, "weight_decay": 0.01, "freeze_step": FREEZE}, **extra)
    return {"train_batch_size": ROWS, "train_micro_batch_size_per_gpu": ROWS // 2,
            "zero_optimization": {"stage": stage}, "mesh": {"data": 2},
            "optimizer": {"type": opt, "params": params}}


def _batches(case):
    """``[STEPS, ROWS, SEQ]`` ids (and labels): the first batch every token
    of the vocabulary once."""
    rng = np.random.default_rng(len(case))
    ids = rng.integers(0, 64, size=(STEPS, ROWS, SEQ)).astype(np.int64)
    ids[0] = rng.permutation(ROWS * SEQ).reshape(ROWS, SEQ)
    return ids, ids.copy()


def _tree():
    tmodel = init_llama_for_causal_lm(LlamaConfig(**TINY, dtype=torch.float32), seed=2,
                                      device="cpu")
    tree = {}
    for name, p in tmodel.named_parameters():
        node = tree
        path = jax_key_path(name)
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = p.detach().numpy().copy()
    return tree


def _jax_oracle(in_path, out_path, cases):
    import jax
    import jax.numpy as jnp
    import deepspeed_tpu
    from deepspeed_tpu.comm.mesh import reset_mesh_context
    from deepspeed_tpu.models.llama import LlamaConfig as JaxConfig, LlamaForCausalLM as JaxLM

    with open(in_path, "rb") as f:
        tree = pickle.load(f)
    out = {}
    for case in cases:
        reset_mesh_context()
        eng, *_ = deepspeed_tpu.initialize(
            model=JaxLM(JaxConfig(**TINY, dtype=jnp.float32, attn_impl="xla")),
            model_parameters=jax.tree_util.tree_map(jnp.array, tree),
            config=_engine_config(case))
        assert (eng._wire_step is not None) == case.endswith("_wire"), case
        ids, labels = _batches(case)
        losses = [float(eng.train_batch(iter([(jnp.asarray(ids[k]), jnp.asarray(labels[k]))])))
                  for k in range(STEPS)]
        out[case] = {"losses": losses, "params": jax.tree_util.tree_map(np.asarray, eng.params)}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def _run_case(case, tree):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm import reset_mesh_context
    reset_mesh_context()
    model = params_from_jax(tree, LlamaConfig(**TINY, dtype=torch.float32),
                            dtype=torch.float32, device="cpu", training=True)
    eng, *_ = deepspeed_tpu_torch.initialize(model=model, config=_engine_config(case),
                                             device="cpu")
    ids, labels = (torch.from_numpy(x) for x in _batches(case))
    losses = [eng.train_batch(iter([(ids[k], labels[k])])) for k in range(STEPS)]
    rec = {"losses": losses, "wire": eng._onebit_wire,
           "masters": {k: v.detach().clone().numpy()
                       for k, v in eng.full_master_params().items()}}
    if eng._onebit_wire:
        try:
            eng.fused_train_steps(ids[:2], labels=labels[:2])
        except RuntimeError as e:
            rec["fused_steps_error"] = str(e)
    return rec


def _unsupported_wire():
    """1-bit Adam with comm_backend_name under gradient clipping: no wire,
    the default reduce."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm import reset_mesh_context
    reset_mesh_context()
    model = init_llama_for_causal_lm(LlamaConfig(**TINY, dtype=torch.float32), device="cpu")
    cfg = dict(_engine_config("onebitadam_wire"), gradient_clipping=1.0)
    eng, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu")
    return eng._onebit_wire


def _rank_main(rank, store):
    from deepspeed_tpu_torch import comm
    torch.set_num_threads(1)
    comm.init_distributed(dist_backend="gloo", init_method=f"file://{store}", rank=rank,
                          world_size=2)
    with open(os.path.join(os.path.dirname(store), "tree.pkl"), "rb") as f:
        tree = pickle.load(f)
    out = {case: _run_case(case, tree) for case in CASES}
    out["unsupported_wire"] = _unsupported_wire()
    with open(f"{store}.rank{rank}", "wb") as f:
        pickle.dump(out, f)
    import torch.distributed as dist
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import torch.multiprocessing as mp
    tmp = str(tmp_path_factory.mktemp("torch_onebit"))
    in_path = os.path.join(tmp, "tree.pkl")
    with open(in_path, "wb") as f:
        pickle.dump(_tree(), f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=os.pathsep.join([HERE, os.path.dirname(HERE),
                                           os.environ.get("PYTHONPATH", "")]))
    out = os.path.join(tmp, "oracle.pkl")
    call = f"import test_torch_onebit as t; t._jax_oracle({in_path!r}, {out!r}, {list(CASES)!r})"
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


@pytest.mark.parametrize("case", list(CASES))
def test_engine_matches_jax_across_freeze_step(runs, case):
    """2 warmup steps, then 3 compressed ones: over the wire (each rank's
    local momentum exchanged as packed signs) or locally under ZeRO (each
    parameter's scale summed over the pieces the ranks hold)."""
    got, ref = runs["ranks"][0][case], runs["jax"][case]
    assert got["wire"] == case.endswith("_wire")
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    n_off = 0
    for name, m in got["masters"].items():
        want = np.asarray(lookup(ref["params"], name))
        diff = np.abs(m - want)
        n_off += int((diff > MASTER_TOL + MASTER_TOL * np.abs(want)).sum())
        assert diff.max() <= 2 * STEPS * LR, name
    assert n_off <= MAX_FLIPPED, f"{n_off} elements off"
    other = runs["ranks"][1][case]
    assert other["losses"] == got["losses"]
    for name, m in got["masters"].items():  # the replicas stay bit-equal
        assert np.array_equal(other["masters"][name], m), name


def test_wire_refuses_fused_train_steps(runs):
    for out in runs["ranks"]:
        for case in ("onebitadam_wire", "onebitlamb_wire"):
            assert "1-bit wire" in out[case]["fused_steps_error"]


def test_wire_falls_back_when_unsupported(runs):
    assert runs["ranks"][0]["unsupported_wire"] is False
