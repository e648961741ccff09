"""deepspeed_tpu_torch's fused decode window (``fused_decode_steps``, the
window in ``generate``) against the JAX package's.

Five tiny families on the same weights (the JAX tree, loaded into the
port with ``params_from_jax``), fp32: Llama, Llama with an int8 KV cache,
StarCoder2's knobs (a sliding window on every layer, LayerNorm, biases,
the fc MLP), BLOOM's (ALiBi, the embedding LayerNorm) and Gemma-2's (the
softcaps, the (1 + w) norms, a window on the even layers, head_dim 256).
The JAX engine runs its plain (dense) attention; the port runs on the
CPU, where its wrappers take their plain versions and the window runs its
step eagerly. The port's greedy streams at windows 1, 4 and 16 must equal
the JAX engine's at windows 1 and 4 token for token. Then the window's
contract: eos and stop sequences trim mid-window as at window 1, a window
past the budget, the errors of ``fused_decode_steps``, the window sizing
against the JAX engine's, and the device-built decode batch against the
host's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2.config_v2 import RaggedInferenceEngineConfig as JEngineConfig
from deepspeed_tpu.inference.v2.engine_v2 import build_llama_engine as jax_build
from deepspeed_tpu.models.llama import LlamaConfig as JLlamaConfig
from deepspeed_tpu.models.llama import init_llama as jax_init
from deepspeed_tpu.module_inject.replace_policy import policy_for as jax_policy_for
from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.engine_v2 import build_llama_engine
from deepspeed_tpu_torch.inference.v2.ragged.ragged_wrapper import (RaggedBatchWrapper,
                                                                    decode_batch)
from deepspeed_tpu_torch.inference.v2.scheduling_utils import SchedulingError
from deepspeed_tpu_torch.models.llama import LlamaConfig
from deepspeed_tpu_torch.module_inject import policy_for

STATE = dict(max_ragged_batch_size=32, max_ragged_sequence_count=8, max_context=96)
PROMPT_LENS = (5, 11, 17)  # 33 tokens > max_ragged_batch_size: two admission waves
# the JAX comparison's prompts: one admission wave, so that each JAX engine
# compiles few programs
FAMILY_PROMPT_LENS = (5, 11, 13)
NEW = 10

FC = dict(norm_type="layernorm", mlp_type="gelu_tanh_fc", attention_bias=True,
          attention_out_bias=True, mlp_bias=True)
GEMMA_HF = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, head_dim=256,
                max_position_embeddings=128, rms_norm_eps=1e-6, rope_theta=10000.0,
                sliding_window=24, query_pre_attn_scalar=256, attn_logit_softcapping=2.0,
                final_logit_softcapping=2.0)
# family -> (config knobs or None for Gemma-2's policy, KV block, build options)
FAMILIES = {
    "llama": (dict(num_key_value_heads=2), 16, {}),
    "llama_int8_kv": (dict(num_key_value_heads=2), 16, {"kv_cache_dtype": "int8"}),
    "starcoder2": (dict(vocab_size=256, hidden_size=96, intermediate_size=192,
                        num_hidden_layers=2, num_attention_heads=6, num_key_value_heads=2,
                        max_position_embeddings=256, sliding_window=16, **FC), 4, {}),
    "bloom": (dict(vocab_size=256, hidden_size=64, intermediate_size=256,
                   num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
                   max_position_embeddings=64, pos_embedding="alibi", embed_layernorm=True,
                   tie_word_embeddings=True, **FC), 4, {}),
    "gemma2": (None, 4, {}),
}


def _configs(family):
    knobs, _, _ = FAMILIES[family]
    if knobs is None:
        return (dataclasses.replace(jax_policy_for("gemma2").config_from_hf(GEMMA_HF),
                                    dtype=jnp.float32),
                dataclasses.replace(policy_for("gemma2").config_from_hf(GEMMA_HF),
                                    dtype=torch.float32))
    if "vocab_size" in knobs:
        return JLlamaConfig(**knobs, dtype=jnp.float32), LlamaConfig(**knobs)
    return (JLlamaConfig.tiny(**knobs, dtype=jnp.float32),
            LlamaConfig.tiny(**knobs, dtype=torch.float32))


def _params(jcfg, seed=0):
    """The JAX tree, numpy leaves, with biases, norm scales and Gemma's
    stored norm deltas moved by N(0, 0.1) so that they count."""
    _, params = jax_init(jcfg, seed=seed)
    rng = np.random.default_rng(seed)

    def move(path, x):
        x = np.asarray(x)
        if getattr(path[-1], "key", None) in ("bias", "scale") or \
                (jcfg.norm_plus_one and "norm" in str(path)):
            return (x + 0.1 * rng.normal(size=x.shape)).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(move, params)


def _port(family, params=None, num_kv_blocks=64, state=STATE, seed=3):
    _, tcfg = _configs(family)
    _, block, kw = FAMILIES[family]
    return build_llama_engine(tcfg, params=params, seed=seed, dtype=torch.float32,
                              kv_block_size=block, device="cpu",
                              engine_config=RaggedInferenceEngineConfig(
                                  num_kv_blocks=num_kv_blocks, state_manager=state), **kw)


def _prompts(seed=0, lens=PROMPT_LENS):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).tolist() for n in lens]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_greedy_streams_match_jax_at_every_window(family):
    jcfg, _ = _configs(family)
    _, block, kw = FAMILIES[family]
    params = _params(jcfg)
    prompts = _prompts(1, FAMILY_PROMPT_LENS)
    je = jax_build(jcfg, params=params, dtype=jnp.float32, kv_block_size=block,
                   attn_backend="dense",
                   engine_config=JEngineConfig(num_kv_blocks=64, state_manager=STATE), **kw)
    want = {K: je.generate(prompts, max_new_tokens=NEW, fused_decode_window=K)
            for K in (1, 4)}
    assert want[1] == want[4]
    te = _port(family, params)
    for K in (1, 4, 16):
        assert te.generate(prompts, max_new_tokens=NEW, fused_decode_window=K) == want[1], K
        assert te.free_blocks == 64
    assert all(len(o) == NEW for o in want[1])


@pytest.fixture(scope="module")
def llama():
    return _port("llama")


def test_default_window_is_one_on_the_cpu(llama):
    calls = []
    orig = llama.fused_decode_steps
    llama.fused_decode_steps = lambda *a, **k: calls.append(a) or orig(*a, **k)
    try:
        llama.generate(_prompts(2), max_new_tokens=6)
        assert not calls
        llama.generate(_prompts(2), max_new_tokens=6, fused_decode_window=4)
        assert calls
    finally:
        del llama.fused_decode_steps


def test_eos_trims_mid_window_as_at_window_one(llama):
    prompts = _prompts(3)
    ref = llama.generate(prompts, max_new_tokens=12, fused_decode_window=1)
    eos = next(t for o in ref for t in o[2:-2])  # an eos in the middle of a stream
    r1 = llama.generate(prompts, max_new_tokens=12, eos_token_id=eos, fused_decode_window=1)
    r4 = llama.generate(prompts, max_new_tokens=12, eos_token_id=eos, fused_decode_window=4)
    assert r4 == r1 and any(len(o) < 12 for o in r1)
    assert llama.free_blocks == 64


def test_stop_sequence_trims_mid_window_as_at_window_one(llama):
    prompts = _prompts(4)
    ref = llama.generate(prompts, max_new_tokens=12, fused_decode_window=1)
    stop = max(ref, key=len)[3:5]
    r1 = llama.generate(prompts, max_new_tokens=12, stop=stop, fused_decode_window=1)
    r4 = llama.generate(prompts, max_new_tokens=12, stop=stop, fused_decode_window=4)
    assert r4 == r1 and any(len(o) < 12 for o in r1)
    assert llama.free_blocks == 64


def test_window_larger_than_the_budget(llama):
    prompts = _prompts(5)
    ref = llama.generate(prompts, max_new_tokens=5, fused_decode_window=1)
    got = llama.generate(prompts, max_new_tokens=5, fused_decode_window=64)
    assert got == ref and all(len(o) == 5 for o in got)


def test_fused_decode_steps_contract():
    eng = _port("llama", num_kv_blocks=4, state=dict(STATE, max_context=40))
    with pytest.raises(ValueError, match="not a live"):
        eng.fused_decode_steps([123], [1], 4)
    logits = eng.put([7], [[1, 2, 3]])
    seq = eng._state_manager.get_sequence(7)
    out = eng.fused_decode_steps([7], [int(logits[0].argmax())], 6)
    assert out.shape == (1, 6) and out.dtype == np.int32
    assert seq.seen_tokens == 9
    # past the context ceiling: refused, nothing changes
    free = eng.free_blocks
    with pytest.raises(SchedulingError):
        eng.fused_decode_steps([7], [int(out[0, -1])], 40)
    assert seq.seen_tokens == 9 and eng.free_blocks == free
    # the KV cache cannot hold the window: refused, no block taken
    eng.put([8], [list(range(30))])
    free = eng.free_blocks
    with pytest.raises(SchedulingError):
        eng.fused_decode_steps([7], [int(out[0, -1])], 24)
    assert eng.free_blocks == free and seq.seen_tokens == 9
    # the window's tokens are the per-step path's
    ref = eng.put([7], [[int(out[0, -1])]])
    again = eng.fused_decode_steps([8], [int(ref[0].argmax())], 2)
    assert again.shape == (1, 2)


def test_window_defers_the_trailing_window_frees():
    """StarCoder2's window on every layer: the window reserves every step's
    blocks and ``generate`` frees the dead leading blocks after it, as the
    per-step path frees them after each step."""
    eng = _port("starcoder2", num_kv_blocks=96)
    prompt = _prompts(6, lens=(24, ))[0]  # 6 blocks of 4; window 16
    ref = eng.generate([prompt], max_new_tokens=24, fused_decode_window=1)
    assert eng.generate([prompt], max_new_tokens=24, fused_decode_window=8) == ref
    assert eng.free_blocks == 96
    eng.put([77], [prompt])
    out = eng.fused_decode_steps([77], [1], 16)
    assert out.shape == (1, 16)
    seq = eng._state_manager.get_sequence(77)
    eng.model().maybe_free_kv(seq)
    assert len(seq.kv_blocks) < seq.cur_allocated_blocks


BUDGETS = [[1], [2], [3], [5, 9], [16, 16, 16], [1, 8, 30], [7, 1, 1], [40, 33]]


@pytest.mark.parametrize("cap", [1, 2, 4, 16])
def test_window_sizing_matches_jax(cap):
    """``fused_window`` and ``fused_partition`` over budgets and context
    headroom: the same windows and splits as the JAX engine's."""
    jcfg, _ = _configs("llama")
    state = dict(STATE, max_ragged_batch_size=64, max_context=48)
    je = jax_build(jcfg, params=_params(jcfg), dtype=jnp.float32, kv_block_size=16,
                   attn_backend="dense",
                   engine_config=JEngineConfig(num_kv_blocks=64, state_manager=state))
    te = _port("llama", state=state)
    for i, n in enumerate((3, 20, 45)):  # context headroom 45, 28 and 3
        for eng in (je, te):
            eng.put([i], [list(range(1, n + 1))])
    for budgets in BUDGETS:
        uids = list(range(len(budgets)))
        assert te.fused_window(uids, budgets, cap) == je.fused_window(uids, budgets, cap)
        assert te.fused_partition(uids, budgets, cap) == je.fused_partition(uids, budgets, cap)


@pytest.mark.parametrize("lens", [(1, ), (3, 17, 40), (5, 9, 2, 33, 64)])
def test_decode_batch_equals_the_host_batch(lens):
    """The device-built pure-decode batch holds the same arrays as the host
    ``finalize`` fast path, padding included."""
    eng = _port("llama")
    uids = list(range(len(lens)))
    for u, n in zip(uids, lens):
        eng.put([u], [list(range(1, n + 1))], do_checks=False)
    sm = eng._state_manager
    wrapper = RaggedBatchWrapper(STATE_CFG, block_size=16, device="cpu")
    for u in uids:
        seq = sm.get_sequence(u)
        eng.model().maybe_allocate_kv(seq, 1)
        wrapper.insert_sequence(seq, [7 + u])
    total = sm.kv_cache.num_blocks * sm.kv_cache.block_size
    host = wrapper.finalize(total_slots=total)
    S, B = host.block_table.shape
    n = len(uids)
    pad = lambda x: torch.tensor(list(x) + [0] * (S - n), dtype=torch.int32)  # noqa: E731
    table = torch.zeros(S, B, dtype=torch.int32)
    table[:n] = host.block_table[:n]
    dev = decode_batch(pad(7 + u for u in uids), pad(sm.get_sequence(u).seen_tokens for u in uids),
                       pad([1] * n), table, n_tokens=n, block_size=16, total_slots=total)
    assert dev.n_tokens == host.n_tokens == n
    for name in host._fields[:-1]:
        assert torch.equal(getattr(dev, name), getattr(host, name)), name


STATE_CFG = RaggedInferenceEngineConfig(state_manager=STATE).state_manager


def test_warmup_then_generate(llama):
    """``warmup`` runs the windows it is given on scratch sequences and
    gives their blocks back (no graphs on the CPU)."""
    assert llama.warmup(prefill_lens=(8, ), batch_sizes=(1, 3), fused_windows=(4, ),
                        fused_sampled_windows=(2, )) == 0
    assert llama.free_blocks == 64
    assert llama.generate(_prompts(7), max_new_tokens=6, fused_decode_window=4) == \
        llama.generate(_prompts(7), max_new_tokens=6, fused_decode_window=1)
