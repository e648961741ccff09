"""deepspeed_tpu_torch Mistral training against the JAX package, in fp32 on
the CPU: the HF policy's config, the loss and every gradient of a tiny
windowed model (JAX ``attn_impl="flash"``, Pallas in interpret mode), and
AdamW engine steps, with the attention route as resolved and pinned to the
folded kernels (K3) in both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models import init_llama as jax_init_llama
from deepspeed_tpu.module_inject.replace_policy import policy_for as jax_policy_for
from deepspeed_tpu_torch.models.convert import lookup, params_from_jax
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from deepspeed_tpu_torch.module_inject import MISTRAL_7B, policy_for
from tests.test_torch_training import (GRAD_TOL, LOSS_TOL, _assert_masters_match,
                                       _engine_config, _ids)


def test_mistral_policy_config_matches_jax():
    cfg = policy_for("mistral").config_from_hf(MISTRAL_7B)
    jcfg = jax_policy_for("mistral").config_from_hf(MISTRAL_7B)
    for name in cfg.__dataclass_fields__:
        if name != "dtype":  # torch.bfloat16 against jnp.bfloat16
            assert getattr(cfg, name) == getattr(jcfg, name), name
    assert policy_for("MistralForCausalLM").arch == "mistral"
    assert (cfg.hidden_size, cfg.intermediate_size, cfg.num_attention_heads,
            cfg.num_key_value_heads, cfg.vocab_size, cfg.rope_theta,
            cfg.sliding_window, cfg.tie_word_embeddings) == (
        4096, 14336, 32, 8, 32000, 10000.0, 4096, False)
    LlamaForCausalLM(LlamaConfig.tiny(sliding_window=cfg.sliding_window), device="cpu")


# tiny Mistral-like configs: a window on every layer, shorter than the
# 128-token sequence (and not a multiple of the kernels' 64-key tile); a
# window on layer 1 only with the attention-logit softcap
CONFIGS = {
    "window48": dict(sliding_window=48),
    "window40_layer1_softcap": dict(sliding_window=40, sliding_window_layers=(1, ),
                                    attn_logit_softcapping=30.0),
}
SEQ = 128


def _models(name):
    over = dict(num_key_value_heads=2, **CONFIGS[name])
    jcfg = JaxLlamaConfig.tiny(dtype=jnp.float32, attn_impl="flash", **over)
    jmodel, params = jax_init_llama(jcfg, seed=3)
    tcfg = LlamaConfig.tiny(dtype=torch.float32, **over)
    tmodel = params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg,
                             dtype=torch.float32, device="cpu", training=True)
    return jmodel, params, tmodel


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_windowed_loss_and_grads_match_jax(name):
    """Tolerances of test_torch_training.py (fp32 both sides, sums in
    another order)."""
    jmodel, params, tmodel = _models(name)
    ids = _ids(5, (2, SEQ))
    loss_ref, grads_ref = jax.jit(jax.value_and_grad(
        lambda p: jmodel.apply({"params": p}, jnp.asarray(ids),
                               labels=jnp.asarray(ids))))(params)
    t_ids = torch.from_numpy(ids).long()
    loss = tmodel(t_ids, labels=t_ids)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_ref), **LOSS_TOL)
    for pname, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(lookup(grads_ref, pname)),
                                   err_msg=pname, **GRAD_TOL)
    # the window changes the answer: without it the loss moves
    cfg = tmodel.config
    plain = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32, num_key_value_heads=2),
                             device="cpu")
    plain.load_state_dict(tmodel.state_dict())
    assert abs(plain(t_ids, labels=t_ids).item() - loss.item()) > 1e-4
    assert cfg.sliding_window is not None


def _run_engines(n_steps=3):
    """Both engines from the same weights over the same batches: per-step
    losses and the final masters."""
    jmodel, params, tmodel = _models("window48")
    n_dev = jax.device_count()
    jcfg = _engine_config(1, 1)
    jcfg["train_batch_size"] = n_dev
    jeng, *_ = deepspeed_tpu.initialize(model=jmodel, model_parameters=params,
                                        config=jcfg)
    teng, *_ = deepspeed_tpu_torch.initialize(model=tmodel, config=_engine_config(1, n_dev),
                                              device="cpu")
    losses = []
    for step in range(n_steps):
        ids = _ids(20 + step, (n_dev, SEQ))
        jl = jeng.forward(jnp.asarray(ids), labels=jnp.asarray(ids))
        jeng.backward(jl)
        jeng.step()
        t_ids = torch.from_numpy(ids).long()
        tl = teng.forward(t_ids, labels=t_ids)
        teng.backward(tl)
        teng.step()
        losses.append((tl.item(), float(jl)))
    masters = {n: m.clone() for n, m in teng.master_params().items()}
    return losses, masters, jax.tree_util.tree_map(np.asarray, jeng.params)


@pytest.fixture(scope="module")
def resolved_run():
    return _run_engines()


def test_engine_steps_match_jax_engine(resolved_run):
    """AdamW, linear WarmupLR, clipping, 3 steps of a windowed model; the
    tolerances of test_torch_training.py's engine test."""
    losses, masters, jparams = resolved_run
    for tl, jl in losses:
        np.testing.assert_allclose(tl, jl, **LOSS_TOL)
    _assert_masters_match(masters, jparams, atol=1e-5, rtol=1e-5)


def test_engine_steps_with_the_route_pinned_to_folded(resolved_run, monkeypatch):
    """``DS_TPU_ATTN_FWD/BWD=folded`` pins both packages' legs to the folded
    kernels (K3; the port's plain versions here): the same steps track the
    JAX engine, and the port repeats its per-head run exactly (K3's plain
    versions compute K1/K2's function)."""
    monkeypatch.setenv("DS_TPU_ATTN_FWD", "folded")
    monkeypatch.setenv("DS_TPU_ATTN_BWD", "folded")
    losses, masters, jparams = _run_engines()
    for (tl, jl), (tl_head, _) in zip(losses, resolved_run[0]):
        np.testing.assert_allclose(tl, jl, **LOSS_TOL)
        assert tl == tl_head
    _assert_masters_match(masters, jparams, atol=1e-5, rtol=1e-5)
    for name, m in masters.items():
        torch.testing.assert_close(m, resolved_run[1][name], atol=0, rtol=0)
