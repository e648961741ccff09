"""deepspeed_tpu_torch Gemma-2 training against the JAX package, in fp32 on
the CPU: the loss and every gradient of the tiny Gemma-2 of
``test_torch_gemma2.py`` (head_dim 256, the softcaps, the sandwich and
(1 + w) norms, a window on layer 0) against the JAX model with its flash
kernels in interpret mode, through the dense and the chunked CE, and
AdamW engine steps in both packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.llama import init_llama as jax_init
from deepspeed_tpu_torch.models.convert import lookup, params_from_jax
from tests.test_torch_gemma2 import _configs, _params
from tests.test_torch_training import (GRAD_TOL, LOSS_TOL, _assert_masters_match,
                                       _engine_config, _ids)

SEQ = 48  # twice the 24-token window of layer 0


def _train_models(ce_chunk_size=None):
    jcfg, tcfg = _configs(ce_chunk_size=ce_chunk_size)
    jmodel, _ = jax_init(dataclasses.replace(jcfg, attn_impl="flash"), seed=3)
    params = _params(seed=3, ce_chunk_size=ce_chunk_size)
    tmodel = params_from_jax(params, tcfg, dtype=torch.float32, device="cpu", training=True)
    return jmodel, params, tmodel


@pytest.mark.parametrize("ce_chunk_size", [None, 100], ids=["dense_ce", "chunked_ce"])
def test_loss_and_grads_match_jax(ce_chunk_size):
    """The tiny Gemma-2's loss and every gradient (the four norms' w among
    them) against the JAX model with its flash kernels in interpret mode,
    through the dense CE and the chunked CE (each with the final softcap);
    the tolerances of test_torch_training.py."""
    jmodel, params, tmodel = _train_models(ce_chunk_size)
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


def test_engine_steps_match_jax_engine():
    """AdamW, linear WarmupLR, clipping, 3 steps of the tiny Gemma-2 in both
    engines from the same weights and batches; the tolerances of
    test_torch_training.py's engine test."""
    jmodel, params, tmodel = _train_models()
    n_dev = jax.device_count()
    jcfg = _engine_config(1, 1)
    jcfg["train_batch_size"] = n_dev
    jeng, *_ = deepspeed_tpu.initialize(model=jmodel, model_parameters=params, config=jcfg)
    teng, *_ = deepspeed_tpu_torch.initialize(model=tmodel, config=_engine_config(1, n_dev),
                                              device="cpu")
    for step in range(3):
        ids = _ids(20 + step, (n_dev, SEQ))
        jl = jeng.forward(jnp.asarray(ids), labels=jnp.asarray(ids))
        jeng.backward(jl)
        jeng.step()
        t_ids = torch.from_numpy(ids).long()
        tl = teng.forward(t_ids, labels=t_ids)
        teng.backward(tl)
        teng.step()
        np.testing.assert_allclose(tl.item(), float(jl), **LOSS_TOL)
    _assert_masters_match({n: m.clone() for n, m in teng.master_params().items()},
                          jax.tree_util.tree_map(np.asarray, jeng.params),
                          atol=1e-5, rtol=1e-5)
