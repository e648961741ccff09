"""The port's data loader (``deepspeed_tpu_torch/runtime/dataloader.py``)
against the JAX package's on the same seeded datasets, on the CPU: batch
for batch the same samples (shuffle, epochs, ``drop_last``, tuple and
dict samples, a custom collate), ``RepeatingLoader``, and
``initialize(training_data=...)`` feeding ``train_batch`` as the JAX
engine's does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models import init_llama as jax_init_llama
from deepspeed_tpu.runtime import dataloader as jax_dl
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.llama import LlamaConfig
from deepspeed_tpu_torch.runtime import dataloader as dl


def _samples(kind, n=23, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "array":
        return [rng.integers(0, 256, 8).astype(np.int32) for _ in range(n)]
    if kind == "tuple":
        return [(rng.normal(size=4).astype(np.float32), np.int64(i)) for i in range(n)]
    return [{"ids": rng.integers(0, 256, 6).astype(np.int32),
             "w": rng.random(3).astype(np.float32)} for _ in range(n)]


def _same(got, ref):
    """A torch batch (tensor, tuple or dict) against a numpy one."""
    if isinstance(ref, tuple):
        assert isinstance(got, tuple) and len(got) == len(ref)
        return all(_same(g, r) for g, r in zip(got, ref))
    if isinstance(ref, dict):
        assert isinstance(got, dict) and got.keys() == ref.keys()
        return all(_same(got[k], ref[k]) for k in ref)
    assert isinstance(got, torch.Tensor)
    return got.dtype == torch.from_numpy(np.asarray(ref)).dtype and \
        np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("kind", ["array", "tuple", "dict"])
@pytest.mark.parametrize("shuffle,drop_last", [(False, True), (True, True), (True, False)])
def test_loader_batches_equal_the_jax_loaders(kind, shuffle, drop_last):
    """Three epochs (``set_epoch``), batch size 5 over 23 samples: the same
    length and the same samples in every batch."""
    data = _samples(kind)
    ours = dl.DeepSpeedDataLoader(data, 5, shuffle=shuffle, seed=7, drop_last=drop_last)
    ref = jax_dl.DeepSpeedDataLoader(data, 5, shuffle=shuffle, seed=7, drop_last=drop_last)
    assert len(ours) == len(ref) == (4 if drop_last else 5)
    orders = []
    for epoch in range(3):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == len(ref)
        assert all(_same(g, r) for g, r in zip(got, want))
        orders.append(got[0])
    if shuffle and kind == "array":  # each epoch draws its own order
        assert not torch.equal(orders[0], orders[1])


def test_custom_collate_and_default_collate():
    data = _samples("tuple", n=6)

    def collate(items):
        return torch.tensor([float(x.sum()) for x, _ in items])

    ours = dl.DeepSpeedDataLoader(data, 3, collate_fn=collate)
    ref = jax_dl.DeepSpeedDataLoader(data, 3, collate_fn=lambda it: np.asarray(
        [float(x.sum()) for x, _ in it], np.float32))
    for g, r in zip(ours, ref):
        np.testing.assert_array_equal(g.numpy(), r)
    assert _same(dl.default_collate([np.arange(3), np.arange(3)]),
                 jax_dl.default_collate([np.arange(3), np.arange(3)]))


def test_repeating_loader_restarts():
    data = _samples("array", n=6)
    ours = dl.RepeatingLoader(dl.DeepSpeedDataLoader(data, 4, drop_last=False))
    ref = jax_dl.RepeatingLoader(jax_dl.DeepSpeedDataLoader(data, 4, drop_last=False))
    assert len(ours) == len(ref) == 2
    for _ in range(5):  # past two epochs
        assert _same(next(ours), next(ref))
    assert iter(ours) is ours


def test_initialize_training_data_feeds_train_batch():
    """``initialize(training_data=..., collate_fn=...)`` returns the loader
    (batch size: the micro batch) as its third item; a ``RepeatingLoader``
    over it feeds gas-2 ``train_batch`` steps, whose losses match the JAX
    engine's on its own loader over the same dataset."""
    jcfg = JaxLlamaConfig.tiny(dtype=jnp.float32, attn_impl="flash", num_key_value_heads=2)
    jmodel, params = jax_init_llama(jcfg, seed=0)
    params = jax.tree_util.tree_map(np.asarray, params)
    tmodel = params_from_jax(params, LlamaConfig.tiny(dtype=torch.float32,
                                                      num_key_value_heads=2),
                             dtype=torch.float32, device="cpu", training=True)
    n_dev = jax.device_count()
    rng = np.random.default_rng(5)
    data = [rng.integers(0, 256, 16).astype(np.int32) for _ in range(12 * n_dev)]

    def both(items):
        x = np.stack(items)
        return x, x

    def config(micro):
        return {"train_micro_batch_size_per_gpu": micro, "gradient_accumulation_steps": 2,
                "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}

    jeng, _, jloader, _ = deepspeed_tpu.initialize(
        model=jmodel, model_parameters=params, config=config(1), training_data=data,
        collate_fn=lambda it: tuple(jnp.asarray(a) for a in both(it)))
    teng, topt, tloader, tsched = deepspeed_tpu_torch.initialize(
        model=tmodel, config=config(n_dev), training_data=data,
        collate_fn=lambda it: tuple(torch.from_numpy(a).long() for a in both(it)),
        device="cpu")
    assert isinstance(tloader, dl.DeepSpeedDataLoader) and tloader is teng.training_dataloader
    assert topt is teng.optimizer and tsched is None
    assert tloader.batch_size == n_dev and len(tloader) == len(jloader) == 12
    jit, tit = iter(dl.RepeatingLoader(jloader)), iter(dl.RepeatingLoader(tloader))
    for _ in range(8):  # past one epoch of 6 steps
        np.testing.assert_allclose(teng.train_batch(tit), jeng.train_batch(jit),
                                   rtol=1e-5, atol=1e-6)
    assert teng.global_steps == jeng.global_steps == 8
