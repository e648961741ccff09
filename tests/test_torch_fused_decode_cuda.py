"""The fused decode window on a CUDA GPU: each step captured into a CUDA
graph and replayed. Every test skips without a card.

At two layers of each serving family's full width (Llama-3-8B in bf16
and with int8 weights and KV, StarCoder2-7B, BLOOM-7B1, Gemma-2-9B;
seeded random bf16 weights), a window of replayed steps gives the same
tokens and logprobs as eager per-step ``put`` calls, bit for bit, and
leaves the same KV behind (the next step's logits agree bit for bit). A
capture error raises and nothing runs the rest of the window eagerly. The
kernel wrappers' launch counts after a window read K times one step's.

This file imports neither ``jax`` nor ``deepspeed_tpu``; on the card run
it with ``python -m pytest --noconftest -q tests/test_torch_fused_decode_cuda.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.engine_v2 import SampleSpec, build_llama_engine
from deepspeed_tpu_torch.models.llama import LlamaConfig
from deepspeed_tpu_torch.module_inject import (BLOOM_7B1, GEMMA2_9B, STARCODER2_7B,
                                               policy_for)
from deepspeed_tpu_torch.ops.normalization import layer_norm, rms_norm
from deepspeed_tpu_torch.ops.paged_attention import paged_attention

pytestmark = pytest.mark.cuda

FAMILIES = {
    "llama3_8b": (lambda: LlamaConfig.llama3_8b(), {}),
    "llama3_8b_int8": (lambda: LlamaConfig.llama3_8b(),
                       {"quantize": "int8", "kv_cache_dtype": "int8"}),
    "starcoder2_7b": (lambda: policy_for("starcoder2").config_from_hf(STARCODER2_7B), {}),
    "bloom_7b1": (lambda: policy_for("bloom").config_from_hf(BLOOM_7B1), {}),
    "gemma2_9b": (lambda: policy_for("gemma2").config_from_hf(GEMMA2_9B), {}),
}
PROMPT_LENS = (60, 130, 7)  # windows of 16 cross 64-token blocks
K = 16


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the window's graphs have no CPU mode")
    return torch.device("cuda")


def _engine(family, num_kv_blocks=32):
    make, kw = FAMILIES[family]
    cfg = dataclasses.replace(make(), num_hidden_layers=2)
    return build_llama_engine(cfg, seed=0, dtype=torch.bfloat16, kv_block_size=64,
                              engine_config=RaggedInferenceEngineConfig(
                                  num_kv_blocks=num_kv_blocks), **kw)


def _prefill(engine, prompts):
    uids = list(range(len(prompts)))
    logits = engine.put(uids, prompts)
    return uids, logits[:len(uids)].argmax(-1).int().tolist()


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, n).tolist() for n in PROMPT_LENS]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_replayed_window_equals_eager_steps_bit_for_bit(cuda_device, family):
    graphed, eager = _engine(family), _engine(family)
    prompts = _prompts(graphed.model().config.vocab_size)
    uids, first = _prefill(graphed, prompts)
    _, first_e = _prefill(eager, prompts)
    assert first == first_e
    specs = [SampleSpec(temperature=0.0, want_logprobs=True, n_out=1) for _ in uids]
    toks, lps = graphed.fused_decode_steps(uids, first, K, specs=specs)
    assert len(graphed.model()._graphs) >= 1
    last = first
    for j in range(K):
        logits = eager.put(uids, [[t] for t in last])
        step = [SampleSpec(temperature=0.0, want_logprobs=True, n_out=1 + j) for _ in uids]
        last, lp = eager.sample_rows(uids, logits, step)
        assert toks[:, j].tolist() == last, j
        assert lps[:, j].tolist() == [float(np.float32(x)) for x in lp], j
    # the KV the replays wrote: the next step's logits, bit for bit
    nxt = [[int(t)] for t in toks[:, -1]]
    assert torch.equal(graphed.put(uids, nxt), eager.put(uids, nxt))


def test_launch_counts_after_a_window_are_k_times_a_step(cuda_device):
    engine = _engine("gemma2_9b")
    uids, first = _prefill(engine, [p[:5] for p in _prompts(256)])
    L = engine.model().config.num_hidden_layers
    counters = ((paged_attention, "decode_launches"), (paged_attention, "softcap_launches"),
                (rms_norm, "fp32_scale_launches"), (rms_norm, "launches"),
                (layer_norm, "launches"))
    before = [getattr(fn, name) for fn, name in counters]
    engine.fused_decode_steps(uids, first, K)  # the first step eager, then replays
    after = [getattr(fn, name) for fn, name in counters]
    assert [a - b for a, b in zip(after, before)] == [K * L, K * L, K * (4 * L + 1), 0, 0]
    (graph, ) = engine.model()._graphs.values()
    assert graph.counts[(paged_attention, "decode_launches")] == L
    assert engine.model().graph_pool_bytes > 0


def test_generate_defaults_to_the_graphed_window(cuda_device):
    engine = _engine("llama3_8b", num_kv_blocks=64)
    prompts = _prompts(engine.model().config.vocab_size)
    windows = []
    inner = engine.fused_decode_steps
    engine.fused_decode_steps = lambda *a, **k: windows.append(a[2]) or inner(*a, **k)
    out16 = engine.generate(prompts, max_new_tokens=24)
    del engine.fused_decode_steps
    assert windows and max(windows) == 16
    assert engine.model()._graphs
    assert engine.generate(prompts, max_new_tokens=24, fused_decode_window=1) == out16
    kw = dict(max_new_tokens=24, temperature=0.8, top_k=50, top_p=0.9, return_logprobs=True)
    s16, s1 = engine.generate(prompts, **kw), engine.generate(prompts, fused_decode_window=1, **kw)
    assert s16[0] == s1[0]
    np.testing.assert_allclose(np.concatenate(s16[1]), np.concatenate(s1[1]), atol=1e-5)
    assert engine.free_blocks == 64


def test_warmup_captures_the_windows_ahead(cuda_device):
    engine = _engine("bloom_7b1")
    captured = engine.warmup(prefill_lens=(64, ), batch_sizes=(3, ), fused_windows=(4, ),
                             fused_sampled_windows=(4, ), decode_context=40)
    assert captured == 2  # one greedy and one sampled step graph
    assert engine.free_blocks == 32
    graphs = dict(engine.model()._graphs)
    # the same live count and width: the window replays what warmup captured
    uids, first = _prefill(engine, [[1] * 60] * 3)
    engine.fused_decode_steps(uids, first, 4)
    assert engine.model()._graphs == graphs


# last in the file: after a failed capture PyTorch leaves its CUDA generator
# registered with the dead graph, and a later random draw raises
def test_capture_error_raises_and_nothing_runs_eagerly(cuda_device):
    engine = _engine("llama3_8b")
    uids, first = _prefill(engine, _prompts(engine.model().config.vocab_size))
    model = engine.model()
    calls = []
    inner = model._decode_step

    def failing_step(*args):
        calls.append(torch.cuda.is_current_stream_capturing())
        if calls[-1]:
            torch.cuda.synchronize()  # not allowed while a stream captures
        return inner(*args)

    model._decode_step = failing_step
    with pytest.raises(RuntimeError):
        engine.fused_decode_steps(uids, first, K)
    assert calls == [False, True]  # the key's eager first step, then the capture
    assert not model._graphs
    torch.cuda.synchronize()
