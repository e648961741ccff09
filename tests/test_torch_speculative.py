"""deepspeed_tpu_torch's speculative decoding (prompt lookup, the per-token
verify window and the fused speculative window) and ``score`` against the
JAX package's.

The ops first: ``prompt_lookup_draft``, ``ngram_draft_ring`` and
``ring_append`` must equal JAX's on random histories and rings, and
``spec_verify_window`` must equal JAX's when fed the draws JAX's own key
chains make. Then the engines, on the same weights (the JAX tree, loaded
into the port with ``params_from_jax``), fp32: the JAX engine runs its
plain (dense) attention, the port runs on the CPU with its plain
versions. Three families: Llama, Llama with an int8 KV cache, and
StarCoder2's knobs (a sliding window on every layer, whose trailing-window
frees wait for the rollback). The port's greedy speculative streams,
per-token and fused at K 1, 4 and 16, must equal its plain greedy stream
and (Llama and the int8 cache) the JAX engine's speculative one token for
token, and its drafted and accepted counts JAX's ``last_spec_stats``;
StarCoder2's plain greedy stream is held to JAX's in
test_torch_fused_decode.py, so here its speculative streams are held to
its plain one. Then the rollback bookkeeping,
eos and stop trimming, JAX's validation errors, speculation over adopted
prefixes, ``score`` against JAX's within 1e-5, and sampled fused windows
against sampled per-token windows within the port (one stream: both draw
with ``ops/sampling.spec_draws``). One JAX engine a family, module-scoped,
one admission wave a run."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2.config_v2 import RaggedInferenceEngineConfig as JEngineConfig
from deepspeed_tpu.inference.v2.engine_v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2.engine_v2 import build_llama_engine as jax_build
from deepspeed_tpu.models.llama import LlamaConfig as JLlamaConfig
from deepspeed_tpu.models.llama import init_llama as jax_init
from deepspeed_tpu.ops import sampling as jsamp
from deepspeed_tpu_torch.inference.v2.config_v2 import (RaggedInferenceEngineConfig,
                                                        SamplingConfig)
from deepspeed_tpu_torch.inference.v2.engine_v2 import InferenceEngineV2, build_llama_engine
from deepspeed_tpu_torch.models.llama import LlamaConfig
from deepspeed_tpu_torch.ops import sampling as tsamp

NEW = 18
SPEC = dict(speculative="prompt_lookup", num_draft_tokens=4, draft_ngram=2)
FC = dict(norm_type="layernorm", mlp_type="gelu_tanh_fc", attention_bias=True,
          attention_out_bias=True, mlp_bias=True)
# family -> (config knobs, KV block, build options)
FAMILIES = {
    "llama": (dict(num_key_value_heads=4), 16, {}),
    "llama_int8_kv": (dict(num_key_value_heads=4), 16, {"kv_cache_dtype": "int8"}),
    "starcoder2": (dict(vocab_size=256, hidden_size=96, intermediate_size=192,
                        num_hidden_layers=2, num_attention_heads=6, num_key_value_heads=2,
                        max_position_embeddings=256, sliding_window=16, **FC), 4, {}),
}
SCORE_TOL = 1e-5


def _configs(family):
    knobs = FAMILIES[family][0]
    if "vocab_size" in knobs:
        return JLlamaConfig(**knobs, dtype=jnp.float32), LlamaConfig(**knobs)
    return (JLlamaConfig.tiny(**knobs, dtype=jnp.float32),
            LlamaConfig.tiny(**knobs, dtype=torch.float32))


def _params(family, seed=21):
    """The JAX tree, numpy leaves, with biases and norm scales moved by
    N(0, 0.1) so that they count."""
    _, params = jax_init(_configs(family)[0], seed=seed)
    rng = np.random.default_rng(seed)

    def move(path, x):
        x = np.asarray(x)
        if getattr(path[-1], "key", None) in ("bias", "scale"):
            return (x + 0.1 * rng.normal(size=x.shape)).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(move, params)


def _repetitive(rng, n=50):
    """Repetition makes prompt-lookup drafts fire."""
    motif = rng.integers(0, 64, size=6).tolist()
    return (motif * (n // 6 + 1))[:n]


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [_repetitive(rng), rng.integers(0, 200, size=20).tolist()]


def _port(family, params, prefix=False, **sampling):
    _, tcfg = _configs(family)
    _, block, kw = FAMILIES[family]
    return build_llama_engine(tcfg, params=params, dtype=torch.float32, kv_block_size=block,
                              device="cpu", engine_config=RaggedInferenceEngineConfig(
                                  num_kv_blocks=160, enable_prefix_caching=prefix,
                                  sampling=SamplingConfig(**sampling)), **kw)


@pytest.fixture(scope="module")
def jax_runs():
    """Each family's JAX engine: the speculative stream per token and its
    counts; for Llama also the fused window at K 4 and ``score``."""
    out = {}
    prompts = _prompts()
    for family, (_, block, kw) in FAMILIES.items():
        if family == "starcoder2":  # the port's own seeded weights
            out[family] = {"params": None}
            continue
        params = _params(family)
        je = jax_build(_configs(family)[0], params=params, dtype=jnp.float32,
                       kv_block_size=block, attn_backend="dense",
                       engine_config=JEngineConfig(num_kv_blocks=160), **kw)
        rec = {"params": params,
               "spec1": je.generate(prompts, max_new_tokens=NEW, fused_decode_window=1, **SPEC)}
        rec["spec1_stats"] = dict(je.last_spec_stats)
        if family == "llama":
            rec["spec4"] = je.generate(prompts, max_new_tokens=NEW, fused_decode_window=4,
                                       **SPEC)
            rec["spec4_stats"] = dict(je.last_spec_stats)
            rec["score"] = je.score([0, 1], prompts)
        out[family] = rec
    return out


@pytest.fixture(scope="module")
def port_runs(jax_runs):
    """Each family's port engine: plain greedy, then the speculative
    stream per token and fused at K 4 and 16, with their counts."""
    out = {}
    prompts = _prompts()
    for family in FAMILIES:
        eng = _port(family, jax_runs[family]["params"])
        rec = {"engine": eng, "plain": eng.generate(prompts, max_new_tokens=NEW)}
        for K in (1, 4, 16):
            rec[f"spec{K}"] = eng.generate(prompts, max_new_tokens=NEW, fused_decode_window=K,
                                           **SPEC)
            rec[f"spec{K}_stats"] = dict(eng.last_spec_stats)
        assert eng.free_blocks == 160
        out[family] = rec
    return out


# ---------------------------------------------------------------- the ops


@pytest.mark.parametrize("seed", range(3))
def test_prompt_lookup_draft_matches_jax(seed):
    """Random histories over a small alphabet: the same drafts with and
    without the window bound, and with the match cache over a growing
    history."""
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, 4, size=60).tolist()
    caches = ({}, {})
    for t in range(3, 60):
        for ngram in (1, 2, 3):
            for window in (0, 12):
                kw = dict(draft_ngram=ngram, max_tokens=4, match_window=window)
                assert InferenceEngineV2.prompt_lookup_draft(hist[:t], **kw) == \
                    JEngine.prompt_lookup_draft(hist[:t], **kw)
        kw = dict(draft_ngram=2, max_tokens=4, match_window=24)
        assert InferenceEngineV2.prompt_lookup_draft(hist[:t], match_cache=caches[0], **kw) == \
            JEngine.prompt_lookup_draft(hist[:t], match_cache=caches[1], **kw)
    assert caches[0] == caches[1]


@pytest.mark.parametrize("seed", range(3))
def test_ngram_draft_ring_and_ring_append_match_jax(seed):
    """Random rings (a small alphabet, so that n-grams match; lengths past
    the ring's width, short ones and empty ones), n-grams, draft caps and
    appends."""
    rng = np.random.default_rng(seed)
    S, W, G, d = 8, 24, 4, 4
    hist = rng.integers(0, 3, size=(S, W)).astype(np.int32)
    hist_len = rng.integers(0, 70, size=S).astype(np.int32)
    hist_len[0] = 0
    ngrams = rng.integers(1, G + 1, size=S).astype(np.int32)
    max_d = rng.integers(0, d + 1, size=S).astype(np.int32)
    jd, jl = jax.jit(jsamp.ngram_draft_ring, static_argnames=("max_ngram", "d"))(
        jnp.asarray(hist), jnp.asarray(hist_len), jnp.asarray(ngrams), jnp.asarray(max_d),
        max_ngram=G, d=d)
    td, tl = tsamp.ngram_draft_ring(torch.from_numpy(hist), torch.from_numpy(hist_len),
                                    torch.from_numpy(ngrams), torch.from_numpy(max_d),
                                    max_ngram=G, d=d)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert (np.asarray(jl) > 0).sum() >= 2  # drafts really fired
    live = np.asarray(jl) > 0  # the draft slots past dlen are read by nothing
    np.testing.assert_array_equal(td.numpy()[live], np.asarray(jd)[live])
    toks = rng.integers(0, 9, size=(S, 1 + d)).astype(np.int32)
    n = rng.integers(0, 2 + d, size=S).astype(np.int32)
    jh, jhl = jax.jit(jsamp.ring_append)(jnp.asarray(hist), jnp.asarray(hist_len),
                                         jnp.asarray(toks), jnp.asarray(n))
    th, thl = tsamp.ring_append(torch.from_numpy(hist.copy()), torch.from_numpy(hist_len),
                                torch.from_numpy(toks), torch.from_numpy(n))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(thl.numpy(), np.asarray(jhl))


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_draws(keys, d, V):
    """The draws JAX's ``spec_verify_window`` makes from its keys."""
    subs = jax.vmap(lambda k: jax.random.split(k, 2))(keys)[:, 1]
    rsub = jax.vmap(lambda k: jax.random.split(k, d + 1))(subs)
    u = jax.vmap(jax.vmap(lambda k: jax.random.uniform(k, ())))(rsub[:, :d])
    g = jax.vmap(lambda k: jax.random.gumbel(k, (V, ), jnp.float32))(rsub[:, d])
    return u, g


@pytest.mark.parametrize("seed", range(4))
def test_spec_verify_window_matches_jax_on_its_draws(seed):
    """Greedy, sampled (temperature, top-k, top-p) and degenerate (top-p
    0) rows, drafts partly copied from the argmax so that some accept, fed
    JAX's draws: the same emitted tokens and counts; the greedy verify of
    the fused window agrees on the greedy rows."""
    rng = np.random.default_rng(seed)
    S, d, V = 8, 3, 40
    logits = (rng.normal(size=(S, 1 + d, V)) * 2.0).astype(np.float32)
    drafts = rng.integers(0, V, size=(S, d)).astype(np.int32)
    top = logits.argmax(-1)
    copy = rng.random((S, d)) < 0.6
    drafts[copy] = top[:, :d][copy]
    dlen = rng.integers(0, d + 1, size=S).astype(np.int32)
    temps = np.array([0, 0.7, 1.0, 1.3, 0.9, 0, 1.0, 0.8], np.float32)
    top_ks = np.array([0, 5, 0, 10, 0, 0, 3, 0], np.int32)
    top_ps = np.array([1, 0.9, 1, 0.8, 0.0, 1, 1, 0.95], np.float32)
    keys = rng.integers(0, 2 ** 32, size=(S, 2), dtype=np.uint64).astype(np.uint32)
    jout, jn, _ = jax.jit(jsamp.spec_verify_window, static_argnames=("d", ))(
        jnp.asarray(logits), jnp.asarray(drafts), jnp.asarray(dlen), jnp.asarray(keys),
        jnp.asarray(temps), jnp.asarray(top_ks), jnp.asarray(top_ps), d=d)
    u, g = (np.array(x) for x in _jax_draws(jnp.asarray(keys), d, V))

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x))

    tout, tn = tsamp.spec_verify_window(t(logits), t(drafts), t(dlen), t(u), t(g), t(temps),
                                        t(top_ks), t(top_ps), d=d)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    for i in range(S):  # the emitted prefix; the rest is read by nothing
        np.testing.assert_array_equal(tout[i, :tn[i]].numpy(), np.asarray(jout)[i, :jn[i]])
    gout, gn = tsamp.greedy_verify_window(t(logits), t(drafts), t(dlen), d=d)
    greedy = temps <= 0
    np.testing.assert_array_equal(gn.numpy()[greedy], tn.numpy()[greedy])


def test_spec_draws_are_their_own_stream():
    """Uniforms in (0, 1), a Gumbel row, a pure function of (seed, output
    count), and not the token draws' noise at the same count."""
    seeds = torch.tensor([1, 2, 3], dtype=torch.int64)
    n_out = torch.tensor([0, 5, 5], dtype=torch.int32)
    u, g = tsamp.spec_draws(seeds, n_out, 4, 64)
    assert u.shape == (3, 4) and g.shape == (3, 64)
    assert bool(((u > 0) & (u < 1)).all()) and bool(torch.isfinite(g).all())
    u2, g2 = tsamp.spec_draws(seeds, n_out, 4, 64)
    assert torch.equal(u, u2) and torch.equal(g, g2)
    assert not torch.equal(tsamp.spec_draws(seeds, n_out + 1, 4, 64)[1], g)
    assert not torch.allclose(g, tsamp.gumbel_noise(seeds, n_out, 64))


# ---------------------------------------------------------------- the engines


@pytest.mark.parametrize("family", list(FAMILIES))
def test_greedy_speculative_streams_match_plain_and_jax(port_runs, jax_runs, family):
    """Per token and fused at K 4 and 16: the port's plain greedy stream
    and the JAX engine's speculative one, token for token (the windows'
    KV frees under StarCoder2's window wait for the rollback)."""
    got, ref = port_runs[family], jax_runs[family]
    if family != "starcoder2":
        assert got["plain"] == ref["spec1"]
    for K in (1, 4, 16):
        assert got[f"spec{K}"] == got["plain"], K
    assert all(len(o) == NEW for o in got["plain"])
    if family == "llama":
        assert ref["spec4"] == ref["spec1"]


def test_drafted_and_accepted_counts_match_jax(port_runs, jax_runs):
    """``last_spec_stats`` per token, and the fused window at K 4 for
    Llama: JAX's counts."""
    for family in ("llama", "llama_int8_kv"):
        assert port_runs[family]["spec1_stats"] == jax_runs[family]["spec1_stats"], family
        assert port_runs[family]["spec1_stats"]["drafted"] > 0
    assert port_runs["llama"]["spec4_stats"] == jax_runs["llama"]["spec4_stats"]


def test_fused_window_rollback_bookkeeping(jax_runs):
    """A random prompt and 1-gram drafts, mostly rejected: the fused
    window's stream is plain greedy's, and after a direct call a
    sequence's history advanced by exactly what it emitted."""
    params = jax_runs["llama"]["params"]
    prompt = np.random.default_rng(1).integers(0, 200, size=24).tolist()
    eng = _port("llama", params)
    ref = eng.generate([prompt], max_new_tokens=10)
    assert eng.generate([prompt], max_new_tokens=10, speculative="prompt_lookup",
                        num_draft_tokens=3, draft_ngram=1, fused_decode_window=4) == ref
    eng.put([7], [prompt[:-1]])
    seq = eng._state_manager.get_sequence(7)
    seen0 = seq.seen_tokens
    toks, drafted, accepted = eng.fused_spec_decode_steps([7], [list(prompt)], 2,
                                                          num_draft_tokens=3, draft_ngram=1)
    assert len(toks[0]) >= 2 and seq.seen_tokens == seen0 + len(toks[0])
    assert seq.in_flight_tokens == 0
    assert accepted[0] == len(toks[0]) - 2 and drafted[0] >= accepted[0] >= 0


def test_per_token_rollback_and_pending_tokens(jax_runs):
    """A verify window whose drafts are all wrong: ``accept_drafts`` keeps
    the argmax, rolls the history and the staged prefix-cache tokens back
    to the accepted position, and the next put continues from there as a
    cold sequence does."""
    params = jax_runs["llama"]["params"]
    prompt = np.random.default_rng(2).integers(0, 200, size=21).tolist()
    eng, cold = _port("llama", params, prefix=True), _port("llama", params)
    first = int(eng.put([3], [prompt])[0].argmax())
    cold.put([3], [prompt])
    seq = eng._state_manager.get_sequence(3)
    seen, pending = seq.seen_tokens, len(seq.pending_tokens)
    wrong = [(first + 1) % 200, 5, 6]
    logits = eng.put([3], [[first] + wrong], window_logits=True, defer_register={3})
    assert logits.shape[:2] == (1, 4)
    new, m = eng.accept_drafts(3, wrong, logits[0])
    assert m == 0 and len(new) == 1
    assert seq.seen_tokens == seen + 1 and len(seq.pending_tokens) == pending + 1
    ref = cold.put([3], [[first]])[0]
    torch.testing.assert_close(logits[0, 0], ref, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(eng.put([3], [new])[0], cold.put([3], [new])[0],
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("K", [1, 4])
def test_eos_and_stop_trim_as_plain_greedy(port_runs, K):
    """eos and a stop sequence inside an accepted window trim the stream
    where plain greedy stops."""
    eng = port_runs["llama"]["engine"]
    prompts = _prompts()
    plain = port_runs["llama"]["plain"]
    eos = plain[0][7]
    stop = plain[1][5:7]
    for kw in (dict(eos_token_id=eos), dict(stop=stop)):
        ref = eng.generate(prompts, max_new_tokens=NEW, **kw)
        assert eng.generate(prompts, max_new_tokens=NEW, fused_decode_window=K,
                            **SPEC, **kw) == ref
    assert len(ref[1]) < NEW


def test_validation_errors(port_runs):
    eng = port_runs["llama"]["engine"]
    prompt = _prompts()[0]
    with pytest.raises(ValueError, match="does not return logprobs"):
        eng.generate([prompt], max_new_tokens=2, speculative="prompt_lookup",
                     return_logprobs=True)
    for kw in (dict(repetition_penalty=1.2), dict(min_new_tokens=2),
               dict(logits_processor=lambda h, r: r)):
        with pytest.raises(ValueError, match="does not compose"):
            eng.generate([prompt], max_new_tokens=2, speculative="prompt_lookup", **kw)
    with pytest.raises(ValueError, match="unknown speculative"):
        eng.generate([prompt], max_new_tokens=2, speculative="medusa")
    with pytest.raises(ValueError, match="spec_max_ngram"):
        eng.put([1], [prompt])
        eng.fused_spec_decode_steps([1], [prompt], 2, num_draft_tokens=4, draft_ngram=9)
    eng.flush(1)
    sampled = _port("llama", None, device_sampling=False)
    with pytest.raises(ValueError, match="device_sampling"):
        sampled.generate([prompt], max_new_tokens=2, speculative="prompt_lookup",
                         temperature=0.7)


@pytest.mark.parametrize("kv", ["bf", "int8"])
def test_speculation_over_adopted_prefixes(jax_runs, kv):
    """A sibling prompt adopts a cached prefix (in the int8 cache, its
    codes and scales), then decodes speculatively, per token and fused:
    plain greedy's stream."""
    family = "llama" if kv == "bf" else "llama_int8_kv"
    params = jax_runs[family]["params"]
    rng = np.random.default_rng(2)
    shared = _repetitive(rng, n=40)
    ref = _port(family, params).generate([shared + [7, 9]], max_new_tokens=10)
    eng = _port(family, params, prefix=True)
    eng.generate([shared + [3, 5]], max_new_tokens=2)  # warms the cache
    for K in (1, 4):
        assert eng.generate([shared + [7, 9]], max_new_tokens=10, fused_decode_window=K,
                            **SPEC) == ref
    rep = eng.prefix_cache_report()
    assert rep["hits"] >= 2 and rep["saved_prefill_tokens"] >= 2 * 32


def test_score_matches_jax(port_runs, jax_runs):
    """Teacher-forced log-probabilities of two prompts in one forward:
    JAX's within 1e-5; each row's last fed logits are the plain forward's;
    ``score`` refuses a live sequence."""
    eng = port_runs["llama"]["engine"]
    prompts = _prompts()
    got = eng.score([0, 1], prompts, flush=False)
    for g, r, p in zip(got, jax_runs["llama"]["score"], prompts):
        assert g.shape == (len(p) - 1, )
        np.testing.assert_allclose(g, r, rtol=SCORE_TOL, atol=SCORE_TOL)
    with pytest.raises(ValueError, match="NEW sequences"):
        eng.score([0], [prompts[0]])
    eng.flush(0), eng.flush(1)
    assert eng.free_blocks == 160


def test_sampled_fused_windows_equal_per_token_windows(jax_runs):
    """Temperature, top-k and top-p under one seed: the fused speculative
    window at K 4 and 8 gives the per-token verify's stream (both draw with
    ``spec_draws`` at each window's output count, and cap their drafts
    alike), whole budgets emitted, and another seed another stream."""
    params = jax_runs["llama"]["params"]
    prompts = _prompts()
    kw = dict(max_new_tokens=NEW, temperature=0.8, top_k=20, top_p=0.9, seed=123, **SPEC)
    oracle = _port("llama", params, fused_speculative_decode=False)
    ref = oracle.generate(prompts, fused_decode_window=8, **kw)
    eng = _port("llama", params)
    for K in (4, 8):
        assert eng.generate(prompts, fused_decode_window=K, **kw) == ref, K
    assert all(len(o) == NEW for o in ref)
    assert eng.generate(prompts, fused_decode_window=8, **dict(kw, seed=7)) != ref


def test_warmup_runs_the_verify_and_spec_windows(jax_runs):
    """The warmup's verify window and fused speculative windows leave no
    sequence, no block and no cache entry behind."""
    eng = _port("llama", jax_runs["llama"]["params"], prefix=True)
    eng.warmup(prefill_lens=(32, ), batch_sizes=(2, ), draft_tokens=3,
               fused_spec_windows=(2, ), decode_context=20)
    assert eng.free_blocks == 160 and eng._state_manager.n_tracked_sequences == 0
    assert len(eng._state_manager.prefix_cache) == 0
