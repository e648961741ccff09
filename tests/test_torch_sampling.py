"""deepspeed_tpu_torch's on-device sampler (``ops/sampling.py``) against
the JAX package's, and the engine's sampled streams.

Each function gets the same seeded numpy logits on both sides (ties made
by rounding the logits to a coarse grid). ``sample_core`` takes its
Gumbel noise as an argument: the tests draw it from the JAX keys exactly
as the JAX ``sample_core`` does, so the tokens must be equal and the
logprobs within 1e-6. The engine tests run the port's tiny Llama on the
CPU: sampled streams equal at fused windows 1 and 4, repeated by a seed
and changed by another."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2.engine_v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.ops import sampling as jsamp
from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.engine_v2 import (InferenceEngineV2, SampleSpec,
                                                        build_llama_engine)
from deepspeed_tpu_torch.models.llama import LlamaConfig
from deepspeed_tpu_torch.ops import sampling as tsamp

S, V = 6, 300


def _logits(seed, ties=False):
    x = np.random.default_rng(seed).normal(size=(S, V)).astype(np.float32) * 3
    return np.round(x * 2) / 2 if ties else x  # a 0.5 grid: many equal values


def _t(x):
    return torch.from_numpy(np.array(x))


def _row_params(seed):
    rng = np.random.default_rng(seed)
    return dict(
        temps=np.array([0.0, 0.7, 1.0, 1.3, 0.9, 0.5], np.float32),
        top_ks=np.array([0, 5, 1, V, 40, -1], np.int32),
        top_ps=np.array([1.0, 0.9, 0.5, 0.0, 0.75, 1.0], np.float32),
        penalties=rng.uniform(1.0, 1.8, S).astype(np.float32),
        eos_ids=np.array([3, -1, 7, 0, 299, 12], np.int32),
        block=np.array([True, True, False, True, True, False]),
        seen=rng.random((S, V)) < 0.2)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_filters_match_jax_exactly(ties):
    x = _logits(1, ties)
    if ties:
        x[1, :8] = x[1].max() + 1  # eight equal values at the top of a top-5 row
    p = _row_params(1)
    np.testing.assert_array_equal(tsamp.filter_top_k(_t(x), _t(p["top_ks"])).numpy(),
                                  np.asarray(jsamp.filter_top_k(x, p["top_ks"])))
    np.testing.assert_array_equal(tsamp.filter_top_p(_t(x), _t(p["top_ps"])).numpy(),
                                  np.asarray(jsamp.filter_top_p(x, p["top_ps"])))
    if ties:  # the kth value's ties survive: more than k entries stay
        kept = np.isfinite(tsamp.filter_top_k(_t(x), _t(p["top_ks"])).numpy()).sum(-1)
        assert kept[1] == 8


def test_controls_match_jax_exactly():
    x = _logits(2)
    p = _row_params(2)
    np.testing.assert_array_equal(
        tsamp.apply_repetition_penalty(_t(x), _t(p["seen"]), _t(p["penalties"])).numpy(),
        np.asarray(jsamp.apply_repetition_penalty(x, p["seen"], p["penalties"])))
    np.testing.assert_array_equal(
        tsamp.mask_eos(_t(x), _t(p["eos_ids"]), _t(p["block"])).numpy(),
        np.asarray(jsamp.mask_eos(x, p["eos_ids"], p["block"])))
    got = tsamp.apply_logit_controls(_t(x), seen_mask=_t(p["seen"]),
                                     penalties=_t(p["penalties"]), eos_ids=_t(p["eos_ids"]),
                                     block_eos=_t(p["block"]))
    want = jsamp.apply_logit_controls(x, seen_mask=p["seen"], penalties=p["penalties"],
                                      eos_ids=p["eos_ids"], block_eos=p["block"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_selected_logprob_matches_jax():
    x = np.asarray(jsamp.filter_top_k(_logits(3), np.full(S, 7, np.int32)))
    toks = np.argmax(x, -1).astype(np.int32)
    np.testing.assert_allclose(tsamp.selected_logprob(_t(x), _t(toks)).numpy(),
                               np.asarray(jsamp.selected_logprob(x, toks)), atol=1e-6)


def _jax_noise(keys):
    """The noise the JAX ``sample_core`` draws from ``keys``: one split,
    the Gumbel draw from the second half."""
    subs = jax.vmap(lambda k: jax.random.split(k, 2))(keys)[:, 1]
    return np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (V, ), jnp.float32))(subs))


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("want_logprobs", [True, False])
def test_sample_core_with_jax_noise_matches_jax(ties, want_logprobs):
    x = _logits(4, ties)
    p = _row_params(4)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(10, 10 + S))
    want_t, want_lp, _ = jsamp.sample_core(x, keys, p["temps"], p["top_ks"], p["top_ps"],
                                           want_logprobs=want_logprobs)
    got_t, got_lp = tsamp.sample_core(_t(x), _t(_jax_noise(keys)), _t(p["temps"]),
                                      _t(p["top_ks"]), _t(p["top_ps"]),
                                      want_logprobs=want_logprobs)
    assert got_t.dtype == torch.int32
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp), atol=1e-6)


@pytest.mark.parametrize("use_penalty,use_eos_mask", [(False, False), (True, True)])
def test_sample_step_with_jax_noise_matches_jax(use_penalty, use_eos_mask):
    x = _logits(5)
    p = _row_params(5)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(S))
    want_t, want_lp, _ = jsamp.sample_step(
        x, keys, p["temps"], p["top_ks"], p["top_ps"], p["seen"], p["penalties"],
        p["eos_ids"], p["block"], want_logprobs=True, use_penalty=use_penalty,
        use_eos_mask=use_eos_mask)
    got_t, got_lp = tsamp.sample_step(
        _t(x), _t(_jax_noise(keys)), _t(p["temps"]), _t(p["top_ks"]), _t(p["top_ps"]),
        _t(p["seen"]), _t(p["penalties"]), _t(p["eos_ids"]), _t(p["block"]),
        want_logprobs=True, use_penalty=use_penalty, use_eos_mask=use_eos_mask)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp), atol=1e-6)


def test_gumbel_noise_is_a_pure_function_of_seed_position_and_column():
    seeds, pos = torch.tensor([5, 5, 6, 5]), torch.tensor([0, 1, 0, 0])
    g = tsamp.gumbel_noise(seeds, pos, 50_000)
    assert g.dtype == torch.float32 and g.shape == (4, 50_000)
    assert torch.isfinite(g).all()
    assert torch.equal(g[0], g[3])  # same (seed, position): same row
    assert not torch.equal(g[0], g[1]) and not torch.equal(g[0], g[2])
    # a wider vocabulary keeps each column's value
    assert torch.equal(tsamp.gumbel_noise(seeds, pos, 1000), g[:, :1000])
    # standard Gumbel: mean 0.5772 (Euler's constant), std pi / sqrt(6)
    assert abs(g.mean().item() - 0.5772) < 0.01
    assert abs(g.std().item() - 1.2825) < 0.01
    assert tsamp.sequence_seed(0, 1) != tsamp.sequence_seed(0, 2) != tsamp.sequence_seed(1, 2)


def test_process_logits_matches_jax():
    row = _logits(6)[0]
    hist = [1, 5, 5, 9, 299]
    proc = (lambda h, r: r * 0.5)
    for kw in (dict(), dict(repetition_penalty=1.4),
               dict(eos_token_id=5, block_eos=True),
               dict(repetition_penalty=0.8, eos_token_id=9, block_eos=True,
                    logits_processor=proc)):
        np.testing.assert_array_equal(InferenceEngineV2.process_logits(row, hist, **kw),
                                      JEngine.process_logits(row, hist, **kw))


# ---- the engine's sampled streams ----

STATE = dict(max_ragged_batch_size=32, max_ragged_sequence_count=8, max_context=128)
PROMPT_LENS = (5, 40, 11, 17)  # 40 > max_ragged_batch_size: chunked prefill


def _engine(**cfg):
    return build_llama_engine(LlamaConfig.tiny(num_key_value_heads=2), seed=3,
                              dtype=torch.float32, kv_block_size=16, device="cpu",
                              engine_config=RaggedInferenceEngineConfig(
                                  num_kv_blocks=64, state_manager=STATE, **cfg))


@pytest.fixture(scope="module")
def engine():
    return _engine()


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).tolist() for n in PROMPT_LENS]


@pytest.mark.parametrize("kw", [
    dict(temperature=0.9, top_k=5, top_p=0.9, return_logprobs=True, seed=17),
    dict(temperature=0.7, repetition_penalty=1.3, min_new_tokens=3, eos_token_id=2, seed=5),
    dict(temperature=0.0, return_logprobs=True, min_new_tokens=4, eos_token_id=7),
], ids=["topk_topp_logprobs", "penalty_min_new_eos", "greedy_logprobs"])
def test_sampled_streams_equal_at_windows_1_and_4(engine, kw):
    prompts = _prompts(3)
    runs = [engine.generate(prompts, max_new_tokens=10, fused_decode_window=K, **kw)
            for K in (1, 4)]
    if kw.get("return_logprobs"):
        (o1, lp1), (o4, lp4) = runs
        assert o1 == o4
        for a, b in zip(lp1, lp4):
            np.testing.assert_allclose(a, b, atol=1e-5)
            assert all(x <= 0 for x in a)
    else:
        assert runs[0] == runs[1]
        o1 = runs[0]
    assert all(len(o) <= 10 for o in o1)
    if "min_new_tokens" in kw:
        assert all(kw["eos_token_id"] not in o[:kw["min_new_tokens"]] for o in o1)
    assert engine.free_blocks == 64


def test_a_seed_repeats_its_stream_and_another_changes_it(engine):
    prompts = _prompts(4)
    kw = dict(max_new_tokens=8, temperature=1.0, fused_decode_window=4)
    a = engine.generate(prompts, seed=1, **kw)
    assert engine.generate(prompts, seed=1, **kw) == a
    assert engine.generate(prompts, seed=2, **kw) != a


def test_one_window_per_k_tokens_when_fully_sampled():
    """A sampled batch decodes K tokens per window: with windows of 4 the
    per-step puts are the prefill's only, and ``sample_rows`` runs once
    per prefill; at window 1 it runs once per token."""
    prompts = [p[:8] for p in _prompts(6)]
    new, K = 9, 4  # one token from the prefill, then two windows of 4

    def run(window):
        eng = _engine()
        calls = {"put": 0, "fused": 0, "sample": 0}
        for name, attr in (("put", "put"), ("fused", "fused_decode_steps"),
                           ("sample", "sample_rows")):
            orig = getattr(eng, attr)

            def wrapped(*a, _orig=orig, _name=name, **k):
                calls[_name] += 1
                return _orig(*a, **k)
            setattr(eng, attr, wrapped)
        return eng.generate(prompts, max_new_tokens=new, temperature=0.8, top_k=12, seed=9,
                            fused_decode_window=window), calls

    out1, c1 = run(1)
    out4, c4 = run(K)
    assert out1 == out4
    assert c4["fused"] == (new - 1) // K and c1["fused"] == 0
    assert c4["put"] == c1["put"] - (new - 1)
    assert c4["sample"] == 1 and c1["sample"] == new


def test_sample_rows_is_sample_step_on_the_specs_noise(engine):
    rows = torch.from_numpy(_logits(7)[:3])
    specs = [SampleSpec(temperature=0.8, top_k=9, seed=11, n_out=4, want_logprobs=True),
             SampleSpec(temperature=0.0, seed=12, n_out=0),
             SampleSpec(temperature=1.2, top_p=0.8, seed=11, n_out=5,
                        repetition_penalty=1.5, history=[1, 2, 3])]
    toks, lps = engine.sample_rows([0, 1, 2], rows, specs)
    noise = tsamp.gumbel_noise(torch.tensor([11, 12, 11]), torch.tensor([4, 0, 5]), V)
    mask = torch.zeros(3, V, dtype=torch.bool)
    mask[2, [1, 2, 3]] = True
    want_t, want_lp = tsamp.sample_step(
        rows, noise, torch.tensor([0.8, 0.0, 1.2]), torch.tensor([9, 0, 0]),
        torch.tensor([1.0, 1.0, 0.8]), mask, torch.tensor([1.0, 1.0, 1.5]),
        torch.tensor([-1, -1, -1]), torch.zeros(3, dtype=torch.bool), want_logprobs=True,
        use_penalty=True, use_eos_mask=False)
    assert toks == want_t.tolist()
    np.testing.assert_array_equal(np.array(lps, np.float32), want_lp.numpy())


def test_device_sampling_off_keeps_the_numpy_sampler():
    """sampling.device_sampling=False: sampled requests tick per-step on
    the numpy oracle, so the window setting cannot change their stream."""
    prompts = _prompts(8)
    off = dict(sampling=dict(device_sampling=False, fused_sampled_decode=False))
    kw = dict(max_new_tokens=6, temperature=0.8, seed=13)
    assert _engine(**off).generate(prompts, fused_decode_window=1, **kw) == \
        _engine(**off).generate(prompts, fused_decode_window=4, **kw)


def test_logits_processor_requests_run_on_the_host(engine):
    """A host processor keeps the numpy path: it sees every step's row."""
    seen = []

    def proc(history, row):
        seen.append(len(history))
        return row

    out = engine.generate([_prompts(9)[0]], max_new_tokens=5, temperature=0.5,
                          logits_processor=proc, fused_decode_window=4)
    assert len(out[0]) == 5 and len(seen) == 5
