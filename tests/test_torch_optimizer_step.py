"""The training engine's optimizer step against the JAX engine: the first
3 steps of ``deepspeed_tpu_torch.initialize`` and ``deepspeed_tpu.initialize``
on the tiny Llama config in fp32, same weights and batches, for each
optimizer the port builds (adam with and without weight decay, adamw,
lamb, lion, sgd with momentum and with nesterov, adagrad): losses, grad
norms, the LR and every master. The port runs K7's plain versions for
adam/adamw/lamb/lion (on the card, the kernel) and PyTorch ops for sgd
and adagrad; the JAX engine runs optax."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models import init_llama as jax_init_llama
from deepspeed_tpu_torch.models.convert import lookup, params_from_jax
from deepspeed_tpu_torch.models.llama import LlamaConfig, init_llama_for_causal_lm
from deepspeed_tpu_torch.ops import fused_optimizer as fo
from deepspeed_tpu_torch.runtime.engine import flat_bounds

# the optimizer section of each case (lr 1e-3 under a linear WarmupLR)
OPTIMIZERS = {
    "adam": {"type": "Adam", "params": {"lr": 1e-3}},
    "adam_wd": {"type": "Adam", "params": {"lr": 1e-3, "weight_decay": 0.05}},
    "adamw": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
    "lamb": {"type": "Lamb", "params": {"lr": 1e-3, "weight_decay": 0.01}},
    "lion": {"type": "Lion", "params": {"lr": 1e-3, "weight_decay": 0.01}},
    "sgd_momentum": {"type": "SGD", "params": {"lr": 1e-3, "momentum": 0.9,
                                               "weight_decay": 0.01}},
    "sgd_nesterov": {"type": "SGD", "params": {"lr": 1e-3, "momentum": 0.9,
                                               "nesterov": True}},
    "adagrad": {"type": "Adagrad", "params": {"lr": 1e-3}},
}
# the updates use lr_at(0..2) of the linear WarmupLR: 1e-4, 4e-4, 7e-4
LR_PATH = 1e-4 + 4e-4 + 7e-4
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
# Adam-type updates are ratios (m / (sqrt(v) + eps), sign(m), trust x u):
# where a gradient cancels to fp32 noise the two engines take other shares
# of a step (tests/test_torch_training.py
# test_adam_outlier_is_a_cancelling_gradient). So at most MAX_FLIPPED
# elements may leave atol 1e-5 (1% of a step) + rtol 1e-5, none by more
# than the whole path of the updates on both sides.
MAX_FLIPPED = 4


def _config(optimizer):
    return {"train_batch_size": 1, "optimizer": optimizer,
            "scheduler": {"type": "WarmupLR", "params": {
                "warmup_min_lr": 1e-4, "warmup_max_lr": 1e-3, "warmup_num_steps": 3,
                "warmup_type": "linear"}},
            "gradient_clipping": 1.0}


def _engines(config, dtype=jnp.float32):
    """The JAX engine and the port's on the same seeded tiny-config
    weights (the port's micro-batch is the JAX global batch)."""
    jcfg = JaxLlamaConfig.tiny(dtype=dtype, attn_impl="flash", num_key_value_heads=2)
    jmodel, params = jax_init_llama(jcfg, seed=0)
    tcfg = LlamaConfig.tiny(dtype=torch.float32, num_key_value_heads=2)
    tmodel = params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg,
                             dtype=torch.float32, device="cpu", training=True)
    n_dev = jax.device_count()
    jeng, *_ = deepspeed_tpu.initialize(model=jmodel, model_parameters=params,
                                        config=dict(config, train_batch_size=n_dev))
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=tmodel, config=dict(config, train_batch_size=n_dev), device="cpu")
    return jeng, teng, n_dev


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, size=shape).astype(np.int32)


@pytest.mark.parametrize("case", sorted(OPTIMIZERS))
def test_engine_optimizer_steps_match_jax_engine(case):
    jeng, teng, n_dev = _engines(_config(OPTIMIZERS[case]))
    kernels = (fo.adam_step_, fo.lion_step_, fo.lamb_update_)
    before = [k.launches for k in kernels]
    for step in range(3):
        ids = _ids(10 * step, (n_dev, 16))
        jl = jeng.forward(jnp.asarray(ids), labels=jnp.asarray(ids))
        jeng.backward(jl)
        jeng.step()
        t_ids = torch.from_numpy(ids).long()
        tl = teng.forward(t_ids, labels=t_ids)
        teng.backward(tl)
        teng.step()
        np.testing.assert_allclose(tl.item(), float(jl), **LOSS_TOL)
        np.testing.assert_allclose(teng.get_lr()[0], float(jeng.get_lr()[0]), rtol=1e-6)
        np.testing.assert_allclose(teng.get_global_grad_norm(),
                                   jeng.get_global_grad_norm(), rtol=1e-5)
    assert teng.optimizer.count == 3 and teng.skipped_steps == 0
    # on the CPU the wrappers run the plain versions: no kernel launches
    assert [k.launches for k in kernels] == before
    jparams = jax.tree_util.tree_map(np.asarray, jeng.params)
    n_off = 0
    for name, master in teng.master_params().items():
        got, ref = master.numpy(), np.asarray(lookup(jparams, name))
        diff = np.abs(got - ref)
        n_off += int((diff > 1e-5 + 1e-5 * np.abs(ref)).sum())
        assert diff.max() <= 2 * LR_PATH, name
    assert n_off <= MAX_FLIPPED, f"{n_off} elements off"


def test_engine_state_is_flat_and_aligned():
    """One flat fp32 buffer each for the masters, the gradients and each
    moment, every parameter a view starting at a multiple of 64 elements;
    the bf16 compute copy one flat buffer of views, refreshed from the
    masters after a step."""
    assert flat_bounds([3, 64, 65, 1]) == ([(0, 3), (64, 128), (128, 193), (256, 257)], 320)
    cfg = LlamaConfig.tiny(dtype=torch.float32, num_key_value_heads=2)
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=init_llama_for_causal_lm(cfg, seed=0, device="cpu"),
        config=dict(_config(OPTIMIZERS["lion"]), bf16={"enabled": True}), device="cpu")
    flat = eng.optimizer.params
    assert flat.dim() == 1 and flat.dtype == torch.float32
    for master, (a, b) in zip(eng.master_params().values(), eng.optimizer.bounds):
        assert master.data_ptr() == flat[a:b].data_ptr() and a % 64 == 0
    assert set(eng.optimizer.state) == {"m"} and eng.optimizer.state["m"].shape == flat.shape
    params = list(eng.module.parameters())
    assert len({p.untyped_storage().data_ptr() for p in params}) == 1
    assert all(p.dtype == torch.bfloat16 for p in params)
    ids = torch.from_numpy(_ids(0, (2, 16))).long()
    eng.backward(eng.forward(ids, labels=ids))
    eng.step()
    for p, master in zip(params, eng.master_params().values()):
        assert torch.equal(p.detach(), master.to(torch.bfloat16))


def test_engine_one_cycle_and_get_mom_match_jax_engine():
    """A OneCycle schedule through both engines (SGD with momentum): the
    LR of every step, the engines' ``get_mom`` (the configured betas) and
    the schedule's cycled momentum report, and the masters."""
    config = dict(_config({"type": "SGD", "params": {"lr": 1e-3, "momentum": 0.9,
                                                     "betas": (0.85, 0.95)}}),
                  scheduler={"type": "OneCycle", "params": {
                      "cycle_min_lr": 1e-4, "cycle_max_lr": 1e-3, "cycle_first_step_size": 2,
                      "cycle_min_mom": 0.85, "cycle_max_mom": 0.95}})
    jeng, teng, n_dev = _engines(config)
    assert teng.get_mom() == [tuple(jeng.get_mom()[0])] == [(0.85, 0.95)]
    for step in range(3):
        ids = _ids(20 + step, (n_dev, 16))
        jl = jeng.forward(jnp.asarray(ids), labels=jnp.asarray(ids))
        jeng.backward(jl)
        jeng.step()
        t_ids = torch.from_numpy(ids).long()
        teng.backward(teng.forward(t_ids, labels=t_ids))
        teng.step()
        np.testing.assert_allclose(teng.get_lr()[0], float(jeng.get_lr()[0]), rtol=1e-6)
        np.testing.assert_allclose(teng.lr_scheduler.get_mom(),
                                   jeng.lr_scheduler.get_mom(), rtol=1e-12)
    jparams = jax.tree_util.tree_map(np.asarray, jeng.params)
    for name, master in teng.master_params().items():
        np.testing.assert_allclose(master.numpy(), np.asarray(lookup(jparams, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
