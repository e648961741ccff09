"""deepspeed_tpu_torch's muP optimizers (``runtime/mup.py``) against the
JAX package's (``deepspeed_tpu/runtime/mup.py``).

The base shapes and the multiplier table of a tiny Llama against a base
model of half its width; ``muadam``, ``muadamw`` and ``musgd`` alone, the
same seeded gradients through the JAX optax chain and the port's flat
optimizer (rtol 1e-5, atol 1e-6 at a learning rate of 1e-2: K7's bias
corrections are ``1 - exp(step * log b)``, optax's ``1 - b**step``, ulps
apart); and the engines, 3 forward/backward/step of the same weights and
batches, with the Adam tolerances of test_torch_optimizer_step.py (rtol
1e-5; at most a few elements, whose gradients cancel to fp32 noise, off
by more, none beyond twice the learning rate's path).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.runtime import mup as jmup
from deepspeed_tpu_torch.models.convert import jax_key_path, lookup
from deepspeed_tpu_torch.models.llama import LlamaConfig, init_llama_for_causal_lm
from deepspeed_tpu_torch.runtime import mup as tmup
from deepspeed_tpu_torch.runtime.optimizers import build_optimizer
from deepspeed_tpu_torch.runtime.zero_sharding import flat_bounds

WIDE = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
            rope_theta=10000.0)
BASE = dict(WIDE, hidden_size=32, intermediate_size=64, num_attention_heads=2,
            num_key_value_heads=1)
LR = 1e-3
MAX_FLIPPED = 4


def _model(fields, seed=0):
    return init_llama_for_causal_lm(LlamaConfig(**fields, dtype=torch.float32), seed=seed,
                                    device="cpu")


def _tree(model):
    return _tree_of({n: p.detach().numpy().copy() for n, p in model.named_parameters()})


def _leaves(tree):
    """The JAX tree's leaves by their ``/`` paths."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(k.key) for k in path): leaf for path, leaf in flat}


def test_base_shapes_match_jax():
    base = _model(BASE)
    assert tmup.make_base_shapes(base) == jmup.make_base_shapes(_tree(base))


@pytest.mark.parametrize("family", ["adam", "sgd"])
def test_multiplier_table_matches_jax(family):
    """Each parameter's multiplier at twice the base width: 1/2 for the
    Adam family's hidden and output kernels, the SGD table's fan-out and
    fan-in rules, 1 for the embedding's fixed vocabulary axis."""
    wide = _model(WIDE)
    shapes = tmup.make_base_shapes(_model(BASE))
    names, params = zip(*wide.named_parameters())
    got = dict(zip(names, tmup.width_multipliers(names, [p.shape for p in params], shapes,
                                                 family)))
    ref = _leaves(jmup.width_multipliers(_tree(wide), shapes, family))
    assert {tmup.param_path(n): m for n, m in got.items()} == ref
    assert set(got.values()) > {1.0}
    if family == "adam":
        assert got["model.layers.0.mlp.down_proj.kernel"] == 0.5
        assert got["model.layers.0.input_layernorm.weight"] == 1.0
    else:
        assert got["model.layers.0.input_layernorm.weight"] == 2.0


def test_missing_and_mismatched_base_shapes_raise():
    wide = _model(WIDE)
    names, params = zip(*wide.named_parameters())
    shapes = [p.shape for p in params]
    bad = tmup.make_base_shapes(_model(BASE))
    bad.pop(tmup.param_path(names[0]))
    with pytest.raises(ValueError, match="missing"):
        tmup.width_multipliers(names, shapes, bad, "adam")
    ranked = dict(tmup.make_base_shapes(_model(BASE)), **{tmup.param_path(names[1]): [4, 4]})
    with pytest.raises(ValueError, match="rank"):
        tmup.width_multipliers(names, shapes, ranked, "adam")
    with pytest.raises(ValueError, match="base_shapes"):
        build_optimizer("muadam", torch.zeros(4), {})


def _flat_optimizer(name, params, model):
    names, tensors = zip(*model.named_parameters())
    bounds, total = flat_bounds([t.numel() for t in tensors])
    flat = torch.zeros(total)
    for t, (a, b) in zip(tensors, bounds):
        flat[a:b] = t.detach().reshape(-1)
    opt = build_optimizer(name, flat, params, bounds=bounds, names=list(names),
                          shapes=[t.shape for t in tensors])
    return opt, flat, names, bounds


@pytest.mark.parametrize("name,extra", [
    ("muadamw", {"weight_decay": 0.1}),
    ("muadam", {}),
    ("musgd", {"momentum": 0.9, "weight_decay": 0.01}),
    ("musgd", {"momentum": 0.9, "nesterov": True}),
    ("musgd", {}),
])
def test_optimizer_steps_match_jax(name, extra):
    """3 updates of the wide model from the same gradients; muadamw's
    decay is not scaled by the multipliers."""
    wide = _model(WIDE)
    params = dict({"lr": 1e-2, "base_shapes": tmup.make_base_shapes(_model(BASE))}, **extra)
    tx = jmup.build_mu_optimizer(name, params, params["lr"])
    tree = jax.tree_util.tree_map(jnp.asarray, _tree(wide))
    state = tx.init(tree)
    opt, flat, names, bounds = _flat_optimizer(name, params, wide)
    rng = np.random.default_rng(3)
    for step in range(3):
        grads = {n: rng.normal(size=tuple(p.shape)).astype(np.float32)
                 for n, p in wide.named_parameters()}
        jgrads = jax.tree_util.tree_map(jnp.asarray, _tree_of(grads))
        upd, state = tx.update(jgrads, state, tree)
        tree = optax.apply_updates(tree, upd)
        g = torch.zeros_like(flat)
        for n, (a, b) in zip(names, bounds):
            g[a:b] = torch.from_numpy(grads[n].ravel())
        opt.step(g)
        for n, (a, b) in zip(names, bounds):
            np.testing.assert_allclose(flat[a:b].numpy(),
                                       np.asarray(lookup(tree, n)).ravel(), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{name} {n} step {step}")


def _tree_of(by_name):
    """The JAX tree of ``{port name: array}``."""
    tree = {}
    for name, arr in by_name.items():
        node = tree
        path = jax_key_path(name)
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arr
    return tree


def test_base_width_muadamw_bit_equals_adamw():
    """At the base width every multiplier is 1: muadamw's updates are
    AdamW's bits."""
    base = _model(BASE)
    params = {"lr": 1e-2, "weight_decay": 0.01, "base_shapes": tmup.make_base_shapes(base)}
    mu, flat_mu, names, bounds = _flat_optimizer("muadamw", params, base)
    plain, flat_plain, _, _ = _flat_optimizer("adamw", {"lr": 1e-2, "weight_decay": 0.01},
                                              base)
    rng = np.random.default_rng(4)
    for _ in range(3):
        g = torch.from_numpy(rng.normal(size=flat_mu.shape[0]).astype(np.float32))
        for a, b in zip([e for _, e in bounds][:-1], [s for s, _ in bounds][1:]):
            g[a:b] = 0  # the padding between parameters holds zeros
        mu.step(g.clone())
        plain.step(g.clone())
    assert torch.equal(flat_mu, flat_plain)


def test_muadam_ignores_weight_decay(caplog):
    base = _model(BASE)
    with caplog.at_level("WARNING"):
        opt, *_ = _flat_optimizer("muadam", {"weight_decay": 0.1,
                                             "base_shapes": tmup.make_base_shapes(base)}, base)
    assert opt.weight_decay == 0.0 and "muadamw" in caplog.text


@pytest.mark.parametrize("optimizer", [
    {"type": "MuAdamW", "params": {"lr": LR, "weight_decay": 0.01}},
    {"type": "MuSGD", "params": {"lr": LR, "momentum": 0.9, "weight_decay": 0.01}},
])
def test_engine_matches_jax_engine(optimizer):
    """The wide model with the base's shapes through both engines."""
    wide = _model(WIDE, seed=5)
    tree = _tree(wide)
    shapes = tmup.make_base_shapes(_model(BASE))
    opt = {"type": optimizer["type"], "params": dict(optimizer["params"], base_shapes=shapes)}
    n_dev = jax.device_count()
    config = {"train_batch_size": n_dev, "optimizer": opt}
    from deepspeed_tpu.models.llama import LlamaConfig as JaxConfig, LlamaForCausalLM as JaxLM
    jeng, *_ = deepspeed_tpu.initialize(
        model=JaxLM(JaxConfig(**WIDE, dtype=jnp.float32, attn_impl="xla")),
        model_parameters=jax.tree_util.tree_map(jnp.asarray, tree), config=config)
    teng, *_ = deepspeed_tpu_torch.initialize(model=wide, config=config, device="cpu")
    for step in range(3):
        ids = np.random.default_rng(step).integers(0, 256, (n_dev, 16)).astype(np.int32)
        jl = jeng.forward(jnp.asarray(ids), labels=jnp.asarray(ids))
        jeng.backward(jl)
        jeng.step()
        t = torch.from_numpy(ids).long()
        tl = teng.forward(t, labels=t)
        teng.backward(tl)
        teng.step()
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    jparams = jax.tree_util.tree_map(np.asarray, jeng.params)
    n_off = 0
    for name, master in teng.master_params().items():
        got, ref = master.numpy(), np.asarray(lookup(jparams, name))
        diff = np.abs(got - ref)
        n_off += int((diff > 1e-5 + 1e-5 * np.abs(ref)).sum())
        assert diff.max() <= 2 * 3 * LR, name
    assert n_off <= MAX_FLIPPED, f"{n_off} elements off"
