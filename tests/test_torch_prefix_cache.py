"""deepspeed_tpu_torch's radix prefix cache (``ragged/prefix_cache.py``,
the state manager's adoption, eviction and flush, the engine's
copy-on-write fork and ``num_return_sequences``) against the JAX
package's.

``PrefixKVCache`` first: operation sequences drawn by ``hypothesis``
(registrations, forks with their pins and commits, tails, ownership,
releases, evictions, clears) drive the port's and JAX's caches, and every
return value, statistic and report must be equal. Then the engines, on
the same weights (the JAX tree, loaded into the port with
``params_from_jax``), fp32, the JAX engine on its plain (dense)
attention, the port on the CPU with its plain versions: one scripted run
of puts, decodes and flushes (whole adoption, partial reuse, a
copy-on-write fork of a cached tail, a sub-block prompt's fork, eviction
under pressure) gives the same block ids, adopted blocks, histories,
cache entries and free counts in both packages, step by step, and logits
within 2e-5 of JAX's and of a cold port engine's, as JAX's own tests hold
them. Greedy ``num_return_sequences`` streams equal JAX's. Then the
port's own contract: block conservation under churn (the int8 cache
too), the sliding-window refusal and its report, ``reset_prefix_cache``,
the warmup's bypass, and sampled ``num_return_sequences``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from deepspeed_tpu.inference.v2.config_v2 import RaggedInferenceEngineConfig as JEngineConfig
from deepspeed_tpu.inference.v2.engine_v2 import build_llama_engine as jax_build
from deepspeed_tpu.inference.v2.ragged.prefix_cache import PrefixKVCache as JPrefixKVCache
from deepspeed_tpu.models.llama import LlamaConfig as JLlamaConfig
from deepspeed_tpu.models.llama import init_llama as jax_init
from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.engine_v2 import build_llama_engine
from deepspeed_tpu_torch.inference.v2.ragged.prefix_cache import PrefixKVCache
from deepspeed_tpu_torch.models.llama import LlamaConfig

BS = 16
TOL = 2e-5
BLOCKS = 12


# ---------------------------------------------------------------- the cache alone

_OPS = st.one_of(
    st.tuples(st.just("register"), st.integers(0, 2), st.integers(1, 3), st.integers(0, 11)),
    st.tuples(st.just("match_fork"), st.integers(0, 2), st.integers(0, 14)),
    st.tuples(st.just("commit_fork"), st.integers(0, 3)),
    st.tuples(st.just("release"), st.lists(st.integers(0, 15), max_size=3)),
    st.tuples(st.just("register_tail"), st.integers(0, 2), st.integers(0, 4),
              st.integers(0, 15)),
    st.tuples(st.just("take_ownership"), st.lists(st.integers(0, 15), max_size=4)),
    st.tuples(st.just("evict"), st.integers(0, 4)),
    st.tuples(st.just("clear")),
)


def _apply(pc, op, prompts, keys):
    """One operation on ``pc``; ``keys`` holds the last chain key a match
    returned, the parent of the next tail."""
    kind = op[0]
    if kind == "register":
        _, p, n, b0 = op
        return pc.register(prompts[p][:n * 4], [(b0 + i) % 16 for i in range(n)])
    if kind == "match_fork":
        _, p, n = op
        matched, key, fork = pc.match_fork(prompts[p][:n])
        keys[0] = key
        return matched, key, fork
    if kind == "commit_fork":
        return pc.commit_fork(op[1])
    if kind == "release":
        return pc.release(op[1])
    if kind == "register_tail":
        _, p, n, b = op
        return pc.register_tail(keys[0], prompts[p][12:12 + n], b)
    if kind == "take_ownership":
        return pc.take_ownership(op[1])
    if kind == "evict":
        return pc.evict(op[1])
    return pc.clear()


@settings(max_examples=60, deadline=None)
@given(st.lists(_OPS, max_size=30), st.integers(0, 2 ** 16))
def test_prefix_cache_operations_match_jax(ops, seed):
    """Three prompts of block 4 over a two-token alphabet share runs, so
    chains, forks and evictions meet; each step's result, and after it the
    statistics, the report, the reclaimable count and the entries, are
    JAX's."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 2, size=16).astype(np.int32)
    prompts = [base, base.copy(), rng.integers(0, 2, size=16).astype(np.int32)]
    prompts[1][6:] = rng.integers(0, 2, size=10)
    tpc, jpc = PrefixKVCache(4), JPrefixKVCache(4)
    tkeys, jkeys = [None], [None]
    for op in ops:
        got = _apply(tpc, op, prompts, tkeys)
        assert got == _apply(jpc, op, prompts, jkeys), op
        assert tpc.stats == jpc.stats and tpc.report() == jpc.report()
        assert tpc.reclaimable_blocks == jpc.reclaimable_blocks
        assert len(tpc) == len(jpc)
        assert {k: (e.block, e.refs, e.children, e.owned) for k, e in tpc._entries.items()} == \
            {k: (e.block, e.refs, e.children, e.owned) for k, e in jpc._entries.items()}


# ---------------------------------------------------------------- the engines


def _configs(kv=None):
    return (JLlamaConfig.tiny(num_key_value_heads=4, dtype=jnp.float32),
            LlamaConfig.tiny(num_key_value_heads=4, dtype=torch.float32))


def _port(params, prefix=True, blocks=BLOCKS, **kw):
    return build_llama_engine(_configs()[1], params=params, dtype=torch.float32,
                              kv_block_size=BS, device="cpu",
                              engine_config=RaggedInferenceEngineConfig(
                                  num_kv_blocks=blocks, enable_prefix_caching=prefix), **kw)


def _script(seed=3):
    """``(op, uid, tokens)`` steps: ``put`` a prompt (or a decode token),
    ``flush``. Whole adoption, partial reuse with a divergent tail, the
    fork of a cached sub-block tail, a prompt under one block, and a long
    prompt that the cached chains must make room for."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 200, size=2 * BS).tolist()
    t1, t2 = rng.integers(0, 200, size=7).tolist(), rng.integers(0, 200, size=9).tolist()
    short = rng.integers(0, 200, size=9).tolist()
    long = rng.integers(0, 200, size=7 * BS + 3).tolist()
    return [("put", 1, base + t1), ("flush", 1, None),
            ("put", 2, base + t1), ("put", 3, base + t2), ("put", 2, [5]),
            ("flush", 2, None), ("flush", 3, None),
            ("put", 4, short), ("flush", 4, None), ("put", 5, short),
            ("put", 6, long), ("put", 5, [7]), ("flush", 5, None),
            ("put", 7, base + t2), ("flush", 6, None), ("flush", 7, None)]


def _state(eng):
    sm = eng._state_manager
    pc = sm.prefix_cache
    # (JAX's descriptors carry the cache's fields only once it set them)
    seqs = {u: (list(s.kv_blocks), sorted(getattr(s, "adopted_blocks", ())), s.seen_tokens,
                getattr(s, "chain_blocks", 0), list(getattr(s, "pending_tokens", ())))
            for u, s in sm.tracked_sequences.items()}
    return (seqs, sorted(pc._by_block), dict(pc.stats), sm._allocator.free_blocks,
            sm.free_blocks)


@pytest.fixture(scope="module")
def runs():
    """The script on a JAX engine and a port engine with prefix caching,
    and on a cold port engine; then greedy ``num_return_sequences``."""
    jcfg, _ = _configs()
    _, params = jax_init(jcfg, seed=11)
    params = jax.tree_util.tree_map(np.asarray, params)
    je = jax_build(jcfg, params=params, dtype=jnp.float32, kv_block_size=BS,
                   attn_backend="dense",
                   engine_config=JEngineConfig(num_kv_blocks=BLOCKS, enable_prefix_caching=True))
    te, cold = _port(params), _port(params, prefix=False, blocks=64)
    steps = []
    for op, uid, toks in _script():
        if op == "flush":
            je.flush(uid), te.flush(uid), cold.flush(uid)
            steps.append((op, _state(je), _state(te), None))
            continue
        jl = np.asarray(je.put([uid], [toks], do_checks=False))[0]
        tl = te.put([uid], [toks], do_checks=False)[0].numpy()
        cl = cold.put([uid], [toks], do_checks=False)[0].numpy()
        steps.append((op, _state(je), _state(te), (jl, tl, cl)))
    prompts = [_script()[0][2], _script()[7][2]]
    greedy = {"jax": je.generate(prompts, max_new_tokens=4, num_return_sequences=3),
              "port": te.generate(prompts, max_new_tokens=4, num_return_sequences=3)}
    return {"params": params, "steps": steps, "greedy": greedy, "jax": je, "port": te}


def test_scripted_adoption_forks_and_eviction_match_jax(runs):
    """Each step's sequences (blocks, adopted blocks, history, chain,
    staged tokens), cached blocks, statistics and free counts are JAX's."""
    for i, (op, jstate, tstate, _) in enumerate(runs["steps"]):
        assert tstate == jstate, (i, op)
    stats = runs["steps"][-1][2][2]
    assert stats["cow_forks"] >= 2 and stats["hits"] >= 4
    # the long prompt's allocation evicted cached blocks and took them
    cached_before = set(runs["steps"][9][2][1])
    assert cached_before & set(runs["steps"][10][2][0][6][0])


def test_adopted_and_forked_logits_match_cold_and_jax(runs):
    """Adopted, partially reused and COW-forked prefills, and the decodes
    over them: within 2e-5 of the cold engine's and of JAX's."""
    for i, (op, _, _, logits) in enumerate(runs["steps"]):
        if logits is None:
            continue
        jl, tl, cl = logits
        np.testing.assert_allclose(tl, cl, rtol=TOL, atol=TOL, err_msg=str(i))
        np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL, err_msg=str(i))


def test_prefix_cache_report_matches_jax(runs):
    rep = runs["port"].prefix_cache_report()
    assert rep == runs["jax"].prefix_cache_report()
    assert rep["state"] == "enabled" and rep["saved_prefill_tokens"] > 0


def test_greedy_num_return_sequences_match_jax(runs):
    """N greedy samples per prompt, flattened in prompt order: JAX's, each
    the N=1 stream."""
    got = runs["greedy"]["port"]
    assert got == runs["greedy"]["jax"]
    assert len(got) == 6 and got[:3] == [got[0]] * 3 and got[3:] == [got[3]] * 3


def test_sampled_num_return_sequences(runs):
    """Sampled N>1: every sample adopts the prompt prefilled once, the
    samples differ, one seed gives one set of streams."""
    eng = _port(runs["params"], blocks=64)
    prompts = [np.random.default_rng(9).integers(0, 200, size=2 * BS + 4).tolist()]
    outs = eng.generate(prompts, max_new_tokens=5, temperature=1.0, num_return_sequences=3,
                        seed=4)
    assert len(outs) == 3 and all(len(o) == 5 for o in outs)
    assert len({tuple(o) for o in outs}) > 1
    rep = eng.prefix_cache_report()
    assert rep["hits"] == 3 and rep["saved_prefill_tokens"] >= 3 * 2 * BS
    assert eng.generate(prompts, max_new_tokens=5, temperature=1.0, num_return_sequences=3,
                        seed=4) == outs


@pytest.mark.parametrize("kv", [None, "int8"])
def test_block_conservation_under_churn(runs, kv):
    """Random puts, decodes and flushes over shared bases under allocator
    pressure: at every check the allocator's free blocks, the blocks only
    the cache holds and the live sequences' blocks add up to the pool;
    once every sequence is flushed everything is reclaimable, and
    eviction drains the cache."""
    total = 40
    eng = _port(runs["params"], blocks=total, kv_cache_dtype=kv)
    sm, pc = eng._state_manager, eng._state_manager.prefix_cache
    rng = np.random.default_rng(7)
    bases = [rng.integers(0, 200, size=2 * BS).tolist() for _ in range(3)]

    def conserved():
        live = set()
        for seq in sm.tracked_sequences.values():
            live.update(seq.kv_blocks)
        cached_only = {b for b in pc._by_block if b not in live}
        assert sm._allocator.free_blocks + len(cached_only) + len(live) == total

    live, uid = [], 0
    for step in range(60):
        op = rng.random()
        try:
            if op < 0.45 or not live:
                tail = rng.integers(0, 200, size=int(rng.integers(1, 12))).tolist()
                eng.put([uid], [bases[rng.integers(0, 3)] + tail], do_checks=False)
                live.append(uid)
                uid += 1
            elif op < 0.8:
                eng.put([live[rng.integers(0, len(live))]], [[int(rng.integers(0, 200))]],
                        do_checks=False)
            else:
                eng.flush(live.pop(rng.integers(0, len(live))))
        except Exception:  # allocator pressure: drop a sequence
            if live:
                eng.flush(live.pop())
        if step % 10 == 9:
            conserved()
    for u in live:
        eng.flush(u)
    conserved()
    assert sm._allocator.free_blocks + pc.reclaimable_blocks == total
    assert pc.stats["hits"] > 5
    sm._allocator.free(pc.evict(total))
    assert sm._allocator.free_blocks == total and len(pc) == 0


def test_sliding_window_refusal_and_report(runs):
    """A sliding-window model disables the cache, with its reason in the
    report; an engine that did not ask says ``not_enabled``."""
    cfg = LlamaConfig.tiny(num_key_value_heads=4, sliding_window=32, dtype=torch.float32)
    eng = build_llama_engine(cfg, dtype=torch.float32, kv_block_size=BS, device="cpu",
                             engine_config=RaggedInferenceEngineConfig(
                                 num_kv_blocks=32, enable_prefix_caching=True))
    assert eng._state_manager.prefix_cache is None
    assert eng.prefix_cache_report() == {"state": "disabled",
                                         "reason": "sliding_window_model"}
    assert _port(runs["params"], prefix=False).prefix_cache_report() == {
        "state": "disabled", "reason": "not_enabled"}


def test_reset_prefix_cache_flushes_live_adopters(runs):
    eng = _port(runs["params"], blocks=32)
    sm = eng._state_manager
    prompt = np.random.default_rng(5).integers(0, 200, size=2 * BS + 3).tolist()
    eng.put([1], [prompt])
    eng.flush(1)
    eng.put([2], [prompt])
    assert len(sm.get_sequence(2).adopted_blocks) == 2
    sm.reset_prefix_cache()
    assert sm.get_sequence(2) is None and len(sm.prefix_cache) == 0
    assert sm._allocator.free_blocks == 32
    eng.put([3], [prompt])
    eng.flush(3)
    assert len(sm.prefix_cache) == 2


def test_warmup_bypasses_the_cache(runs):
    """The warmup's scratch sequences adopt nothing and register nothing;
    a prompt of zeros after it is a miss."""
    eng = _port(runs["params"], blocks=64)
    eng.warmup(prefill_lens=(BS, 2 * BS + 4), batch_sizes=(2, ), decode_context=2 * BS)
    pc = eng._state_manager.prefix_cache
    assert len(pc) == 0 and pc.report()["entries"] == 0
    assert pc.stats["hits"] == 0 and eng.free_blocks == 64
    eng.put([1], [[0] * (2 * BS + 4)])
    assert not eng._state_manager.get_sequence(1).adopted_blocks
