"""The fused training window on a CUDA GPU. Every test skips without a card.

K7 reads its learning rate, update count and skip flag from device
memory: each body (Adam, AdamW, Lion, LAMB's pass and whole step) against
its plain version on the same device tensors over fp32 and bf16
gradients, within K7_ULPS; a set skip flag leaves every buffer bit for
bit. At two layers of Llama-3-8B's width (bf16, AdamW, WarmupLR, clip
1.0, the chunked CE), ``fused_train_steps`` over K stacked batches equals
K forward/backward/step calls from the same weights bit for bit, with no
synchronising call inside the window (``torch.cuda.set_sync_debug_mode``
"error"); in fp16 with skips forced by the loss scale, the skipped steps,
the scale, the LR and the masters equal the sequential run's.

This file imports neither ``jax`` nor ``deepspeed_tpu``; on the card run
it with ``python -m pytest --noconftest -q tests/test_torch_fused_train_cuda.py``."""

import dataclasses
import gc

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.llama import LlamaConfig, init_llama_for_causal_lm
from deepspeed_tpu_torch.ops import fused_optimizer as fo
from deepspeed_tpu_torch.runtime import loss_scaler as ls

pytestmark = pytest.mark.cuda

K7_ULPS = 2
N = 1 << 20
K = 4


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K7 and the window run on the card")
    return torch.device("cuda")


def ulp_distance(x, ref) -> int:
    """The largest distance in units in the last place between two float
    tensors of one dtype, both signs ordered on one integer line."""
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.float16: torch.int16}[ref.dtype]
    bits = torch.iinfo(ints).bits

    def key(t):
        i = t.contiguous().view(ints).long()
        return torch.where(i >= 0, i, -(1 << (bits - 1)) - i)

    return int((key(x) - key(ref)).abs().max().item())


def _state(device, g_dtype, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(scale, uniform=False):
        return scale * (torch.rand if uniform else torch.randn)(N, generator=gen, device=device)

    p, m, v = rnd(0.02), rnd(1e-4), rnd(1e-8, uniform=True)
    g = rnd(1e-3).to(g_dtype)
    return p, g, m, v


def _run(body, p, g, m, v, lr, step, skip, kernel):
    """One K7 body in place (``kernel``) or its plain version; returns the
    buffers it writes."""
    p, m, v = p.clone(), m.clone(), v.clone()
    u = torch.zeros(N, dtype=torch.float32, device=p.device)
    if body in ("adam", "adamw"):
        wd, l2 = (0.01, True) if body == "adam" else (0.1, False)
        if kernel:
            fo.adam_step_(p, g, m, v, lr, step, weight_decay=wd, l2=l2, skip=skip)
            return p, m, v
        return fo.adam_update_reference(p, g, m, v, lr, step, weight_decay=wd, l2=l2,
                                        skip=skip)
    if body == "lion":
        if kernel:
            fo.lion_step_(p, g, m, lr, weight_decay=0.1, skip=skip)
            return p, m
        return fo.lion_update_reference(p, g, m, lr, weight_decay=0.1, skip=skip)
    if kernel:
        fo.lamb_update_(g, m, v, step, out=u, skip=skip)
        fo.lamb_apply_trust_(p, u, lr, 0.01, [(0, N // 3), (N // 3, N)], skip)
        return p, m, v
    u, m, v = fo.lamb_update_reference(g, m, v, step, skip=skip, out=u)
    fo.lamb_apply_trust_(p, u, lr, 0.01, [(0, N // 3), (N // 3, N)], skip)
    return p, m, v


@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("body", ["adam", "adamw", "lion", "lamb"])
def test_k7_device_scalars_match_plain(body, g_dtype, cuda_device):
    """The kernel reads lr and step from device memory; against the plain
    version on the same tensors (two steps, count 1 and 7)."""
    p, g, m, v = _state(cuda_device, g_dtype)
    lr = fo.device_scalar(1e-3, cuda_device)
    for count in (1, 7):
        step = fo.device_scalar(count, cuda_device)
        got = _run(body, p, g, m, v, lr, step, None, kernel=True)
        ref = _run(body, p, g, m, v, lr, step, None, kernel=False)
        torch.cuda.synchronize()
        for x, r in zip(got, ref):
            assert ulp_distance(x, r) <= K7_ULPS, (body, count)


@pytest.mark.parametrize("body", ["adam", "adamw", "lion", "lamb"])
def test_k7_skip_flag_leaves_every_buffer(body, cuda_device):
    """A set flag (an overflowed step: inf in the gradient) writes
    nothing; the launch still counts."""
    p, g, m, v = _state(cuda_device, torch.float32, seed=1)
    g[123] = float("inf")
    lr, step = (fo.device_scalar(x, cuda_device) for x in (1e-3, 3))
    skip = torch.ones(1, dtype=torch.bool, device=cuda_device)
    counter = {"adam": fo.adam_step_, "adamw": fo.adam_step_, "lion": fo.lion_step_,
               "lamb": fo.lamb_update_}[body]
    before = counter.launches
    got = _run(body, p, g, m, v, lr, step, skip, kernel=True)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert all(torch.equal(x, r) for x, r in zip(got, (p, m, v)))


def _engine(cfg, config, seed=0):
    _free()  # what earlier tests of the process left cached
    model = init_llama_for_causal_lm(cfg, seed=seed)
    return deepspeed_tpu_torch.initialize(model=model, config=config)[0]


CFG = dataclasses.replace(LlamaConfig.llama3_8b(num_hidden_layers=2), ce_chunk_size=8192)


def _config(**extra):
    cfg = {"train_batch_size": 1,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-4, "weight_decay": 0.01}},
           "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 0.0,
                                                        "warmup_max_lr": 1e-4,
                                                        "warmup_num_steps": 3}},
           "gradient_clipping": 1.0, "bf16": {"enabled": True}}
    cfg.update(extra)
    return cfg


def _batches(device, k, seq=1024):
    gen = torch.Generator(device=device).manual_seed(3)
    return torch.randint(0, CFG.vocab_size, (k, 1, seq), generator=gen, device=device)


def _sequential(config, data):
    engine = _engine(CFG, config)
    losses = []
    for x in data:
        loss = engine.forward(x, labels=x)
        engine.backward(loss)
        engine.step()
        losses.append(loss.detach().float())
    out = {"losses": torch.stack(losses).cpu(), "masters": engine.optimizer.params.clone(),
           "lr": engine.get_lr(), "skipped": engine.skipped_steps,
           "scale": ls.to_host(engine.scale_state)}
    del engine
    _free()
    return out


def _free():
    gc.collect()
    torch.cuda.empty_cache()


def _window(config, data):
    engine = _engine(CFG, config)
    fetches = []
    fetch = engine._fetch

    def outside(t):  # the window's one host read, outside the check
        torch.cuda.set_sync_debug_mode(0)
        fetches.append(t.numel())
        return fetch(t)

    engine._fetch = outside
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses = engine.fused_train_steps(data, labels=data)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        del engine._fetch
    assert fetches == [2 * len(data)]
    out = {"losses": losses, "masters": engine.optimizer.params.clone(), "lr": engine.get_lr(),
           "skipped": engine.skipped_steps, "scale": ls.to_host(engine.scale_state)}
    del engine
    _free()
    return out


@pytest.mark.parametrize("precision", ["bf16", "fp16"])
def test_window_equals_sequential_steps_without_a_sync(precision, cuda_device):
    """K steps in one window against K forward/backward/step from the same
    seeded weights: losses and masters bit for bit, the LR, and (fp16,
    16 steps from a scale of 2^24, halved at each overflow, so the first
    steps skip) the skipped steps and the scale state. Nothing inside the
    window synchronises."""
    extra, k = {}, K
    if precision == "fp16":
        extra = {"bf16": {"enabled": False},
                 "fp16": {"enabled": True, "initial_scale_power": 24, "hysteresis": 1}}
        k = 16
    data = _batches(cuda_device, k)
    win = _window(_config(**extra), data)
    seq = _sequential(_config(**extra), data)
    assert torch.equal(win["losses"], seq["losses"])
    assert torch.equal(win["masters"], seq["masters"])
    assert win["lr"] == seq["lr"]
    assert win["skipped"] == seq["skipped"] and win["scale"] == seq["scale"]
    assert np.isfinite(win["losses"].numpy()).all()
    if precision == "fp16":
        assert 0 < win["skipped"] < k
