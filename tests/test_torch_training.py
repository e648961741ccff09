"""deepspeed_tpu_torch training path against the JAX package, on the same
seeded inputs and weights, in fp32 on the CPU: the Llama loss and every
parameter's gradient (flash attention, dense and chunked CE), the LR
schedules, the optimizer update, and whole engine steps through
``initialize``; then the gates that refuse what the port does not run."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models import init_llama as jax_init_llama
from deepspeed_tpu.runtime import lr_schedules as jax_sched
from deepspeed_tpu.runtime.optimizers import build_optimizer as jax_build_optimizer
from deepspeed_tpu_torch.models.convert import lookup, params_from_jax
from deepspeed_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                              init_llama_for_causal_lm)
from deepspeed_tpu_torch.runtime import lr_schedules
from deepspeed_tpu_torch.runtime.optimizers import build_optimizer

TINY = dict(num_key_value_heads=2)  # 4 query heads over 2 KV heads (G 2)


def _models(ce_chunk_size=None, seed=0, bf16=False):
    """The JAX model and its fp32 params, and the port's model holding the
    same values in fp32 (the engine makes its masters from them)."""
    jcfg = JaxLlamaConfig.tiny(dtype=jnp.bfloat16 if bf16 else jnp.float32,
                               attn_impl="flash", ce_chunk_size=ce_chunk_size, **TINY)
    jmodel, params = jax_init_llama(jcfg, seed=seed)
    tcfg = LlamaConfig.tiny(dtype=torch.bfloat16 if bf16 else torch.float32,
                            ce_chunk_size=ce_chunk_size, **TINY)
    tmodel = params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg,
                             dtype=torch.float32, device="cpu", training=True)
    return jmodel, params, tmodel


def _ids(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


# fp32 on both sides; two layers of sums in another order (the port's
# plain attention against the Pallas kernels in interpret mode)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=2e-6)


@pytest.mark.parametrize("ce_chunk_size", [None, 100], ids=["dense_ce", "chunked_ce"])
def test_causal_lm_loss_and_grads_match_jax(ce_chunk_size):
    jmodel, params, tmodel = _models(ce_chunk_size)
    ids = _ids(1, (2, 40))  # S = 40: not a multiple of the kernels' tiles
    loss_ref, grads_ref = jax.jit(jax.value_and_grad(
        lambda p: jmodel.apply({"params": p}, jnp.asarray(ids),
                               labels=jnp.asarray(ids))))(params)
    t_ids = torch.from_numpy(ids).long()
    loss = tmodel(t_ids, labels=t_ids)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_ref), **LOSS_TOL)
    names = [n for n, _ in tmodel.named_parameters()]
    assert len(names) == len(jax.tree_util.tree_leaves(grads_ref))
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(lookup(grads_ref, name)),
                                   err_msg=name, **GRAD_TOL)


SCHEDULES = {
    "warmup_log": ("WarmupLR", dict(warmup_min_lr=1e-4, warmup_max_lr=1e-2,
                                    warmup_num_steps=6)),
    "warmup_linear": ("WarmupLR", dict(warmup_min_lr=0.0, warmup_max_lr=3e-3,
                                       warmup_num_steps=5, warmup_type="linear")),
    "warmup_decay": ("WarmupDecayLR", dict(total_num_steps=12, warmup_max_lr=1e-2,
                                           warmup_num_steps=4)),
    "warmup_cosine": ("WarmupCosineLR", dict(total_num_steps=12, warmup_num_steps=3,
                                             warmup_min_ratio=0.1)),
    "range_test": ("LRRangeTest", dict(lr_range_test_min_lr=1e-3, lr_range_test_step_size=4,
                                       lr_range_test_step_rate=0.5)),
    "range_test_staircase": ("LRRangeTest", dict(lr_range_test_min_lr=1e-3,
                                                 lr_range_test_step_size=4,
                                                 lr_range_test_step_rate=0.5,
                                                 lr_range_test_staircase=True)),
    # up over 4 steps, down over 3, then decay every step / every 2 steps
    "one_cycle": ("OneCycle", dict(cycle_min_lr=1e-4, cycle_max_lr=1e-3,
                                   cycle_first_step_size=4, cycle_second_step_size=3,
                                   decay_lr_rate=0.1)),
    "one_cycle_staircase": ("OneCycle", dict(cycle_min_lr=1e-4, cycle_max_lr=1e-3,
                                             cycle_first_step_size=5, decay_lr_rate=0.2,
                                             decay_step_size=2, cycle_first_stair_count=2)),
}


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_lr_schedules_match_jax(case):
    name, params = SCHEDULES[case]
    ref = jax_sched.get_lr_schedule(name, params, base_lr=2e-3)
    got = lr_schedules.get_lr_schedule(name, params, base_lr=2e-3)
    for step in range(15):
        # the JAX schedule evaluates in fp32
        np.testing.assert_allclose(got.lr_at(step), float(ref.lr_at(step)),
                                   rtol=1e-6, atol=1e-12, err_msg=f"step {step}")
    assert got.lr_at(0) == params.get("warmup_min_lr", got.lr_at(0))
    if name == "OneCycle":  # the cycled momentum, reported after each step
        for step in range(15):
            ref.step()
            got.step()
            np.testing.assert_allclose(got.get_mom(), ref.get_mom(), rtol=1e-12)


# optimizer, params beyond the common lr 1e-2, betas (0.8, 0.95), eps 1e-6
OPTIMIZER_CASES = {
    "adamw-0.1": ("adamw", {"weight_decay": 0.1}),
    "adam-0.0": ("adam", {"weight_decay": 0.0}),
    "adam-0.05": ("adam", {"weight_decay": 0.05}),
    "lamb-0.01": ("lamb", {"weight_decay": 0.01}),
    "lamb-0.0": ("lamb", {}),
    "lion-0.05": ("lion", {"weight_decay": 0.05}),
    "lion-default_betas": ("lion", {"betas": None}),
    "sgd-momentum": ("sgd", {"weight_decay": 0.01, "momentum": 0.9}),
    "sgd-nesterov": ("sgd", {"momentum": 0.9, "nesterov": True}),
    "sgd-plain": ("sgd", {"weight_decay": 0.01}),
    "adagrad": ("adagrad", {}),
}


@pytest.mark.parametrize("case", sorted(OPTIMIZER_CASES))
def test_optimizer_updates_match_optax(case):
    """The port's optimizer over one flat buffer (two parameters) against
    the JAX package's optax transform on a dict of the same two leaves,
    three updates under a WarmupLR schedule."""
    name, extra = OPTIMIZER_CASES[case]
    rng = np.random.default_rng(3)
    shapes = {"a": (4, 5), "b": (7, )}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    sched = jax_sched.get_lr_schedule("WarmupLR", dict(warmup_min_lr=1e-3,
                                                       warmup_max_lr=1e-2,
                                                       warmup_num_steps=3))
    opt_params = {"lr": 1e-2, "betas": (0.8, 0.95), "eps": 1e-6, **extra}
    opt_params = {k: v for k, v in opt_params.items() if v is not None}
    tx, _ = jax_build_optimizer(name, opt_params, lr_fn=sched.lr_at)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    flat = torch.from_numpy(np.concatenate([params[k].ravel() for k in shapes]))
    bounds = [(0, 20), (20, 27)]
    opt = build_optimizer(name, flat, opt_params,
                          lr_fn=lr_schedules.get_lr_schedule(
                              "WarmupLR", dict(warmup_min_lr=1e-3, warmup_max_lr=1e-2,
                                               warmup_num_steps=3)).lr_at,
                          bounds=bounds)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step(torch.from_numpy(np.concatenate([g[k].ravel() for k in shapes])))
    assert opt.count == 3
    for k, (a, b) in zip(shapes, bounds):
        # fp32: the same elementwise formula, rounded at other points (K7's
        # bias corrections 1 - exp(t log b) against optax's 1 - b**t)
        np.testing.assert_allclose(flat[a:b].numpy(), np.asarray(jp[k]).ravel(),
                                   rtol=1e-6, atol=1e-7)


# The updates use lr_at(0..2) of the engine config's linear WarmupLR
LR_PATH = 1e-4 + 4e-4 + 7e-4
# Adam's update m/(sqrt(v)+eps) is a ratio. Where a gradient cancels to
# fp32 noise, the two engines take different shares of a step at the
# default eps 1e-8 (test_adam_outlier_is_a_cancelling_gradient shows one
# such element). So at most MAX_FLIPPED elements may leave the tolerance,
# and none by more than the whole path of the updates on both sides.
MAX_FLIPPED = 4


def test_adam_outlier_is_a_cancelling_gradient():
    """The element the gas-1 engine test lets through with 8 JAX devices:
    layer 0's q_proj.kernel[56, 17] on the first batch. Its eight
    per-sample gradients cancel to fp32 noise (below 1e-5 of the largest
    term) on both sides, so Adam's first update g/(|g| + eps) takes a
    different share of lr in the port (whole batch) and in the JAX engine
    (mean of per-sample gradients). ``-s`` prints the values."""
    jmodel, params, tmodel = _models()
    ids = _ids(0, (8, 16))
    name, idx = "model.layers.0.self_attn.q_proj.kernel", (56, 17)
    per_sample = jax.jit(jax.vmap(
        jax.grad(lambda p, x: jmodel.apply({"params": p}, x[None], labels=x[None])),
        in_axes=(None, 0)))
    terms = np.asarray(lookup(per_sample(params, jnp.asarray(ids)), name))[(slice(None), *idx)]
    terms = terms.tolist()
    t_ids = torch.from_numpy(ids).long()
    tmodel(t_ids, labels=t_ids).backward()
    g_port = dict(tmodel.named_parameters())[name].grad[idx].item()
    g_jax = float(np.mean(terms))
    shares = [g / (abs(g) + 1e-8) for g in (g_port, g_jax)]
    print(f"per-sample {terms}; port {g_port:.3g}, JAX mean {g_jax:.3g}; "
          f"first update / lr: {shares[0]:.3f} vs {shares[1]:.3f}")
    scale = max(abs(t) for t in terms)
    assert abs(g_port) < 1e-5 * scale and abs(g_jax) < 1e-5 * scale
    assert abs(shares[0] - shares[1]) > 0.05


def _assert_masters_match(masters, ref_params, atol, rtol):
    n_off = 0
    for name, master in masters.items():
        got, ref = master.float().numpy(), np.asarray(lookup(ref_params, name))
        diff = np.abs(got - ref)
        n_off += int((diff > atol + rtol * np.abs(ref)).sum())
        assert diff.max() <= 2 * LR_PATH, name
    assert n_off <= MAX_FLIPPED, f"{n_off} elements off"


def _engine_config(gas, micro, bf16=False):
    cfg = {"train_batch_size": micro * gas,
           "train_micro_batch_size_per_gpu": micro,
           "gradient_accumulation_steps": gas,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
           "scheduler": {"type": "WarmupLR",
                         "params": {"warmup_min_lr": 1e-4, "warmup_max_lr": 1e-3,
                                    "warmup_num_steps": 3, "warmup_type": "linear"}},
           "gradient_clipping": 1.0}
    if bf16:
        cfg["bf16"] = {"enabled": True}
    return cfg


def _engines(gas, bf16=False):
    """The JAX engine and the port's on the same weights. The JAX engine
    takes micro x gas x devices samples a step; the port runs on one
    device, so its micro-batch is the JAX global micro-batch."""
    jmodel, params, tmodel = _models(bf16=bf16)
    n_dev = jax.device_count()
    jcfg = _engine_config(gas, 1, bf16)
    jcfg["train_batch_size"] = gas * n_dev
    jeng, *_ = deepspeed_tpu.initialize(model=jmodel, model_parameters=params,
                                        config=jcfg)
    teng, topt, none, tsched = deepspeed_tpu_torch.initialize(
        model=tmodel, config=_engine_config(gas, n_dev, bf16), device="cpu")
    assert none is None and tsched is teng.lr_scheduler and topt is teng.optimizer
    return jeng, teng, n_dev


@pytest.mark.parametrize("gas", [1, 2])
def test_engine_steps_match_jax_engine(gas):
    jeng, teng, n_dev = _engines(gas)
    for step in range(3):
        for micro in range(gas):
            ids = _ids(10 * step + micro, (n_dev, 16))
            jl = jeng.forward(jnp.asarray(ids), labels=jnp.asarray(ids))
            jeng.backward(jl)
            jeng.step()
            t_ids = torch.from_numpy(ids).long()
            tl = teng.forward(t_ids, labels=t_ids)
            teng.backward(tl)
            teng.step()
            np.testing.assert_allclose(tl.item(), float(jl), **LOSS_TOL)
        assert teng.global_steps == jeng.global_steps == step + 1
        np.testing.assert_allclose(teng.get_lr()[0], float(jeng.get_lr()[0]), rtol=1e-6)
        np.testing.assert_allclose(teng.get_global_grad_norm(),
                                   jeng.get_global_grad_norm(), rtol=1e-5)
    # fp32 gradients that agree to ~1e-9: 1e-5 is 1% of one step's lr
    _assert_masters_match(teng.master_params(),
                          jax.tree_util.tree_map(np.asarray, jeng.params),
                          atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("gas", [1, 2])
def test_bf16_engine_steps_match_jax_engine(gas):
    """bf16 compute on fp32 masters. Two bf16 implementations round at
    other points: a gradient element differs between the port and the JAX
    engine by about as much as either differs from fp32 compute. So the
    cast point is held inside the port, exactly: each
    loss is that of a plain bf16 copy of the masters, and the step's
    gradient norm is that of its bf16 gradients added in fp32 (fp32
    compute moves it by ~1%). The JAX engine then bounds the whole at the
    bf16 scale."""
    jeng, teng, n_dev = _engines(gas, bf16=True)
    for step in range(3):
        plain = copy.deepcopy(teng.module)  # the bf16 cast of the masters
        acc = [torch.zeros_like(m) for m in teng.master_params().values()]
        for micro in range(gas):
            ids = _ids(10 * step + micro, (n_dev, 16))
            jl = jeng.forward(jnp.asarray(ids), labels=jnp.asarray(ids))
            jeng.backward(jl)
            jeng.step()
            t_ids = torch.from_numpy(ids).long()
            tl = teng.forward(t_ids, labels=t_ids)
            teng.backward(tl)
            teng.step()
            pl = plain(t_ids, labels=t_ids)
            (pl.float() / gas).backward()
            for a, p in zip(acc, plain.parameters()):
                assert p.grad.dtype == torch.bfloat16
                a.add_(p.grad.float())
                p.grad = None
            assert tl.item() == pl.item()
            # the token-mean CE of bf16 logits: a few bf16 roundings of
            # ~2^-9 each, averaged over the tokens
            np.testing.assert_allclose(tl.item(), float(jl), rtol=2.0 ** -9)
        gnorm = torch.linalg.vector_norm(torch.stack([a.norm() for a in acc])).item()
        np.testing.assert_allclose(teng.get_global_grad_norm(), gnorm, rtol=1e-6)
        np.testing.assert_allclose(teng.get_global_grad_norm(),
                                   jeng.get_global_grad_norm(), rtol=2.0 ** -6)
    masters = teng.master_params()
    assert all(m.dtype == torch.float32 for m in masters.values())
    jparams = jax.tree_util.tree_map(np.asarray, jeng.params)
    # a gradient's relative difference at the bf16 scale moves its Adam
    # update by about as much: the RMS of the master differences within
    # 2^-4 of the path, and no element beyond the whole path on both sides
    diffs = np.concatenate([(m.numpy() - np.asarray(lookup(jparams, n))).ravel()
                            for n, m in masters.items()])
    assert np.sqrt(np.mean(diffs ** 2)) <= 2.0 ** -4 * LR_PATH
    assert np.abs(diffs).max() <= 2 * LR_PATH


def test_train_batch_and_eval_batch():
    _, _, tmodel = _models()
    eng, *_ = deepspeed_tpu_torch.initialize(model=tmodel, config=_engine_config(2, 2),
                                             device="cpu")
    batches = iter([tuple(torch.from_numpy(_ids(s, (2, 16))).long() for _ in range(2))
                    for s in range(4)])
    first = eng.train_batch(batches)
    assert eng.global_steps == 1 and eng.micro_steps == 2
    ids = torch.from_numpy(_ids(9, (2, 16))).long()
    logits = eng.eval_batch(ids)
    assert logits.shape == (2, 16, 256) and not logits.requires_grad
    eng.eval()
    assert eng.forward(ids, labels=ids).requires_grad is False
    second = eng.train_batch(batches)
    assert np.isfinite([first, second]).all()


def test_bf16_engine_keeps_fp32_masters_and_bf16_compute():
    tmodel = init_llama_for_causal_lm(LlamaConfig.tiny(dtype=torch.float32), seed=0,
                                      device="cpu")
    cfg = dict(_engine_config(1, 2), bf16={"enabled": True})
    eng, *_ = deepspeed_tpu_torch.initialize(model=tmodel, config=cfg, device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in tmodel.parameters())
    assert all(m.dtype == torch.float32 for m in eng.master_params().values())
    ids = torch.from_numpy(_ids(0, (2, 16))).long()
    for _ in range(2):
        loss = eng.forward(ids, labels=ids)
        eng.backward(loss)
        eng.step()
    # the compute copy is the masters' bf16 cast after each step
    for (name, p), m in zip(tmodel.named_parameters(), eng.master_params().values()):
        assert torch.equal(p.detach(), m.to(torch.bfloat16)), name


# sliding_window and attn_logit_softcapping train now (test_torch_mistral.py),
# and so do Gemma-2's final_logit_softcapping and sandwich_norm
# (test_torch_gemma2.py), remat (test_torch_remat.py) and scan_layers
# (test_torch_zero.py); their places hold knobs that still raise
@pytest.mark.parametrize("option", [dict(clip_qkv=8.0), dict(parallel_residual=True),
                                    dict(qk_norm=True),
                                    dict(post_norm=True),
                                    dict(num_local_experts=4),
                                    dict(pos_embedding="alibi"),
                                    dict(norm_type="layernorm")])
def test_training_model_refuses_unported_options(option):
    with pytest.raises(NotImplementedError, match=next(iter(option))):
        LlamaForCausalLM(LlamaConfig.tiny(**option), device="cpu")


# ZeRO stages 1-3, the mesh, the bucketed gradient wire, the scheduled
# ZeRO-3 store, muP and the 1-bit optimizers run now (test_torch_zero.py,
# test_torch_grad_comm.py, test_torch_zero3_schedule.py, test_torch_mup.py,
# test_torch_onebit.py); their places hold what still raises: ZeRO
# offload, ZeRO++'s quantized weights where the store does not run (stage 2
# under the wire) and the reference optimizers' keys the port lacks
@pytest.mark.parametrize("config,match", [
    ({"train_batch_size": 2, "zero_optimization": {"stage": 3,
                                                   "offload_param": {"device": "cpu"}}},
     "offload_param"),
    # fp16_master_weights_and_grads is accepted now (read by nothing, as in JAX)
    ({"train_batch_size": 2, "activation_checkpointing": {"partition_activations": True}},
     "partition_activations"),
    ({"train_batch_size": 2, "gradient_comm": {"enabled": True},
      "zero_optimization": {"stage": 2, "zero_quantized_weights": True}}, "gradient_comm"),
    ({"train_batch_size": 2, "optimizer": {"type": "OneBitLamb",
                                           "params": {"coeff_beta": 0.9}}}, "lamb"),
    ({"train_batch_size": 2, "optimizer": {"type": "MuAdamW",
                                           "params": {"base_shapes": {"a": [1]},
                                                      "amsgrad": True}}}, "muadamw"),
])
def test_engine_refuses_unported_config(config, match):
    model = init_llama_for_causal_lm(LlamaConfig.tiny(dtype=torch.float32),
                                     device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        deepspeed_tpu_torch.initialize(model=model, config=config, device="cpu")


def test_engine_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid")
    model = init_llama_for_causal_lm(LlamaConfig.tiny(dtype=torch.float32),
                                     device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deepspeed_tpu_torch.initialize(model=model, config={"train_batch_size": 2})
