"""fp16 training: the port's loss scaler (``runtime/loss_scaler.py``)
against the JAX package's ``update_scale`` on the overflow sequences of
``tests/unit/runtime/test_loss_scaler.py``, the ``fp16`` config section,
and the fp16 engine against the JAX engine through an injected overflow,
on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models import init_llama as jax_init_llama
from deepspeed_tpu.runtime import loss_scaler as jax_ls
from deepspeed_tpu_torch.config.config import DeepSpeedConfigError, DeepSpeedTorchConfig
from deepspeed_tpu_torch.models.convert import lookup, params_from_jax
from deepspeed_tpu_torch.models.llama import LlamaConfig, init_llama_for_causal_lm
from deepspeed_tpu_torch.runtime import loss_scaler as ls

# (initial state args, overflow flags, update_scale kwargs): the JAX
# package's scaler tests, each sequence run through both rules
SEQUENCES = {
    "growth_every_window": ((4, 1), [False] * 10, dict(scale_window=4)),
    "overflow_resets_growth_clock": ((4, 1), [False, True] + [False] * 6,
                                     dict(scale_window=4)),
    "hysteresis_burns_first": ((4, 2), [True, True, True], dict(scale_window=1000)),
    "consecutive_hysteresis_refills": ((4, 2), [True, False] * 4,
                                       dict(scale_window=1000, consecutive_hysteresis=True,
                                            delayed_shift=2)),
    "min_scale_floor": ((2, 1), [True] * 6, dict(min_scale=1.0)),
    "max_scale_ceiling": ((4, 1), [False] * 3, dict(scale_window=1, max_scale=32.0)),
    "mixed_window_3": ((16, 2), [False, False, True, False, True, True, False, False,
                                 False, False, True] + [False] * 5, dict(scale_window=3)),
}


@pytest.mark.parametrize("case", sorted(SEQUENCES))
def test_update_scale_matches_jax(case):
    init, flags, kw = SEQUENCES[case]
    ref, got = jax_ls.make_dynamic_state(*init), ls.make_dynamic_state(*init)
    for i, ov in enumerate(flags):
        ref = jax_ls.update_scale(ref, jnp.bool_(ov), **kw)
        got = ls.update_scale(got, ov, **kw)
        assert got == ls.LossScaleState(float(ref.cur_scale), int(ref.cur_hysteresis),
                                        int(ref.last_overflow_iter), int(ref.iter)), i


def test_static_scale_and_config_match_jax():
    """``initial_state``/``next_state`` from the ``fp16`` section against
    the JAX ``LossScalerConfig.from_fp16_config``: loss_scale 0 is dynamic
    from 2**initial_scale_power, a nonzero one static and never moves."""
    from deepspeed_tpu.config.feature_configs import FP16Config
    for section in ({"enabled": True, "initial_scale_power": 5, "hysteresis": 3,
                     "loss_scale_window": 7},
                    {"enabled": True, "loss_scale": 128.0}):
        fp16 = DeepSpeedTorchConfig({"train_batch_size": 1, "fp16": section}).fp16_config
        ref_cfg = jax_ls.LossScalerConfig.from_fp16_config(FP16Config(**section))
        ref, got = ref_cfg.initial_state(), ls.initial_state(fp16)
        for ov in (False, True, True, False, True):
            ref, got = ref_cfg.update(ref, jnp.bool_(ov)), ls.next_state(fp16, got, ov)
            assert got == ls.LossScaleState(float(ref.cur_scale), int(ref.cur_hysteresis),
                                            int(ref.last_overflow_iter), int(ref.iter))


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -float("inf")])
def test_engine_overflow_detects_nan_and_inf(bad):
    """The engine's overflow flag is its global norm's finiteness: a NaN or
    an inf of either sign in one gradient element skips the step and halves
    the scale (hysteresis 1); a clean step moves the masters."""
    model = init_llama_for_causal_lm(LlamaConfig.tiny(dtype=torch.float32), seed=0,
                                     dtype=torch.float32, device="cpu")
    config = {"train_batch_size": 1, "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
              "fp16": {"enabled": True, "initial_scale_power": 8, "hysteresis": 1}}
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=config, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (1, 8))).long()
    for injected in (True, False):
        engine.backward(engine.forward(ids, labels=ids))
        if injected:
            engine._grad_acc[-1].view(-1)[-1] = bad
        before = engine.optimizer.params.clone()
        engine.step()
        assert engine.skipped_steps == 1
        assert torch.equal(engine.optimizer.params, before) == injected
    assert engine.cur_scale == 128.0 and engine.optimizer.count == 1


@pytest.mark.parametrize("section,error", [
    ({"fp16": {"enabled": True}, "bf16": {"enabled": True}}, DeepSpeedConfigError),
    # fp16.auto_cast is accepted now (read by nothing, as in JAX)
    ({"async_pipeline": {"enabled": True}}, NotImplementedError),
    ({"fp16": {"enabled": True, "min_loss_scale": -1}}, DeepSpeedConfigError),
    ({"fp16": {"enabled": True, "loss_scale_windw": 10}}, NotImplementedError),
])
def test_fp16_config_refusals(section, error):
    with pytest.raises(error):
        DeepSpeedTorchConfig(dict({"train_batch_size": 1}, **section))


FP16_CONFIG = {
    "train_batch_size": 1,
    "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
    "scheduler": {"type": "WarmupLR", "params": {
        "warmup_min_lr": 1e-4, "warmup_max_lr": 1e-3, "warmup_num_steps": 3,
        "warmup_type": "linear"}},
    "fp16": {"enabled": True, "initial_scale_power": 8, "hysteresis": 1},
    "gradient_clipping": 1.0}


def test_fp16_engine_skips_an_injected_overflow_as_jax_does():
    """Both engines in fp16 (fp32 masters) on the same weights; step 2's
    accumulated gradients get an inf in one element. Both skip it: the
    masters, the moments, the update count, the compute copy and the LR
    keep their values, the scale halves (hysteresis 1) and the skip count
    and scale agree with the JAX engine's at every step."""
    jcfg = JaxLlamaConfig.tiny(dtype=jnp.float16, attn_impl="flash", num_key_value_heads=2)
    jmodel, params = jax_init_llama(jcfg, seed=0)
    params = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), params)
    tmodel = params_from_jax(params, LlamaConfig.tiny(dtype=torch.float32,
                                                      num_key_value_heads=2),
                             dtype=torch.float32, device="cpu", training=True)
    n_dev = jax.device_count()
    config = dict(FP16_CONFIG, train_batch_size=n_dev)
    jeng, *_ = deepspeed_tpu.initialize(model=jmodel, model_parameters=params, config=config)
    teng, *_ = deepspeed_tpu_torch.initialize(model=tmodel, config=config, device="cpu")
    assert all(p.dtype == torch.float16 for p in tmodel.parameters())
    for step in range(3):
        ids = np.random.default_rng(step).integers(0, 256, (n_dev, 16)).astype(np.int32)
        jl = jeng.forward(jnp.asarray(ids), labels=jnp.asarray(ids))
        t_ids = torch.from_numpy(ids).long()
        tl = teng.forward(t_ids, labels=t_ids)
        teng.backward(tl)
        # the fp16 forward rounds at other points than the JAX model's
        np.testing.assert_allclose(tl.item(), float(jl), rtol=2.0 ** -10)
        if step == 1:
            leaves, tree = jax.tree_util.tree_flatten(jeng.grad_acc)
            leaves[0] = leaves[0].at[(0, ) * leaves[0].ndim].set(jnp.inf)
            jeng.grad_acc = jax.tree_util.tree_unflatten(tree, leaves)
            teng._grad_acc[0].view(-1)[0] = float("inf")
            before = {"masters": teng.optimizer.params.clone(),
                      "moments": {k: v.clone() for k, v in teng.optimizer.state.items()},
                      "compute": [p.detach().clone() for p in tmodel.parameters()],
                      "count": teng.optimizer.count, "lr": teng.get_lr(),
                      "jax": jax.tree_util.tree_map(np.asarray, jeng.params)}
        jeng.backward(jl)
        jeng.step()
        teng.step()
        assert teng.skipped_steps == jeng.skipped_steps == (step >= 1)
        assert teng.cur_scale == teng.loss_scale() == jeng.cur_scale == (256.0 if step == 0
                                                                          else 128.0)
        np.testing.assert_allclose(teng.get_lr()[0], float(jeng.get_lr()[0]), rtol=1e-6)
        if step == 1:
            assert not np.isfinite(teng.get_global_grad_norm())
            assert torch.equal(teng.optimizer.params, before["masters"])
            assert all(torch.equal(v, before["moments"][k])
                       for k, v in teng.optimizer.state.items())
            assert all(torch.equal(p.detach(), c)
                       for p, c in zip(tmodel.parameters(), before["compute"]))
            assert teng.optimizer.count == before["count"] and teng.get_lr() == before["lr"]
            assert not teng._flat_grad.any()  # the accumulation buffer is zeroed
            assert all(np.array_equal(a, b) for a, b in zip(
                jax.tree_util.tree_leaves(jeng.params),
                jax.tree_util.tree_leaves(before["jax"])))
        else:
            # fp16 gradients rounded at other points: ~2^-11 relative
            np.testing.assert_allclose(teng.get_global_grad_norm(),
                                       jeng.get_global_grad_norm(), rtol=2.0 ** -8)
    assert teng.optimizer.count == 2 and teng.global_steps == jeng.global_steps == 3
    # two applied updates (lr 1e-4 and 4e-4) from fp16 gradients: the RMS
    # of the master differences within 2^-4 of that path, no element
    # beyond twice it (an element whose gradient cancels takes another
    # share of Adam's step on each side)
    path = 1e-4 + 4e-4
    jparams = jax.tree_util.tree_map(np.asarray, jeng.params)
    diffs = np.concatenate([(m.numpy() - np.asarray(lookup(jparams, n))).ravel()
                            for n, m in teng.master_params().items()])
    assert np.sqrt(np.mean(diffs ** 2)) <= 2.0 ** -4 * path
    assert np.abs(diffs).max() <= 2 * path
