"""deepspeed_tpu_torch StarCoder2 serving against the JAX engine.

StarCoder2's knobs at tiny widths: hidden 96, 6 query heads over 2 KV
heads (G 3, head_dim 16), LayerNorm with bias, q/k/v/o biases, the biased
gelu-tanh fc MLP, a 16-token sliding window on every layer, 4-token KV
blocks, fp32. Both engines get the same weights: ``init_llama``'s JAX tree
with its biases and LayerNorm parameters moved off their zero/one
initial values (so they count), loaded into the port with
``params_from_jax``. The JAX engine runs its paged backend (the Pallas
kernel in interpret mode); the port runs on the CPU, where its kernel
wrappers take their plain versions. Then the engine's trailing-window KV
release (the counterparts of ``tests/unit/inference/v2/test_kv_free.py``)
and HF checkpoint conversion through both packages."""

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
from deepspeed_tpu.module_inject.replace_module import \
    convert_hf_checkpoint as jax_convert
from deepspeed_tpu.module_inject.replace_policy import policy_for as jax_policy_for
from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.engine_v2 import build_llama_engine
from deepspeed_tpu_torch.models.convert import jax_key_path
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaModel
from deepspeed_tpu_torch.module_inject import (STARCODER2_7B, convert_hf_checkpoint,
                                               policy_for)

KNOBS = dict(vocab_size=256, hidden_size=96, intermediate_size=192,
             num_hidden_layers=2, num_attention_heads=6, num_key_value_heads=2,
             max_position_embeddings=256, rope_theta=10000.0, norm_type="layernorm",
             mlp_type="gelu_tanh_fc", attention_bias=True, attention_out_bias=True,
             mlp_bias=True, sliding_window=16)
WINDOW, BLOCK = 16, 4
STATE = dict(max_ragged_batch_size=48, max_ragged_sequence_count=8, max_context=256)
PROMPT_LENS = (70, 9, 23, 5)  # 70 > max_ragged_batch_size: chunked prefill
# fp32 on both sides; only the summation order differs
TOL = dict(rtol=1e-5, atol=1e-5)


def _params(tied: bool, seed: int = 0):
    """The JAX tree of the tiny StarCoder2 config, numpy leaves, with
    biases and LayerNorm scales moved by N(0, 0.1)."""
    _, params = jax_init(JLlamaConfig(**KNOBS, tie_word_embeddings=tied,
                                      dtype=jnp.float32), seed=seed)
    rng = np.random.default_rng(seed)

    def move(path, x):
        x = np.asarray(x)
        if getattr(path[-1], "key", None) in ("bias", "scale"):
            return (x + 0.1 * rng.normal(size=x.shape)).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(move, params)


def _pair(params, tied, num_kv_blocks=96, **knobs):
    cfg = {**KNOBS, "tie_word_embeddings": tied, **knobs}
    je = jax_build(JLlamaConfig(**cfg), params=params, dtype=jnp.float32,
                   kv_block_size=BLOCK, attn_backend="paged",
                   engine_config=JEngineConfig(num_kv_blocks=num_kv_blocks,
                                               state_manager=STATE))
    te = build_llama_engine(LlamaConfig(**cfg), params=params, dtype=torch.float32,
                            kv_block_size=BLOCK, device="cpu",
                            engine_config=RaggedInferenceEngineConfig(
                                num_kv_blocks=num_kv_blocks, state_manager=STATE))
    return je, te


@pytest.fixture(scope="module", params=[True, False], ids=["tied", "untied"])
def engines(request):
    params = _params(request.param)
    return _pair(params, request.param) + (params, request.param)


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).tolist() for n in PROMPT_LENS]


def _live(engine, uid):
    return len(engine._state_manager.get_sequence(uid).kv_blocks)


def test_put_logits_match_jax(engines):
    """A prefill of two prompts, then decode steps far past the window:
    logits within 1e-5, the same live blocks per sequence and the same
    free blocks after every step."""
    je, te, _, _ = engines
    p = _prompts(1)
    uids = [100, 101]
    feeds = [[p[1], p[2]]] + [[[t], [t + 1]] for t in range(24)]
    for toks in feeds:
        jl = np.asarray(je.put(uids, toks))
        tl = te.put(uids, toks)
        assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
        np.testing.assert_allclose(tl.numpy(), jl, **TOL)
        assert [_live(te, u) for u in uids] == [_live(je, u) for u in uids]
        assert te.free_blocks == je.free_blocks
    assert _live(te, 101) < te._state_manager.get_sequence(101).cur_allocated_blocks
    for u in uids:
        je.flush(u)
        te.flush(u)
    assert je.free_blocks == te.free_blocks == 96


def test_generate_greedy_streams_match_jax(engines):
    """Chunked prefill of a prompt longer than the window and the batch,
    decode past the window, release while decoding: the same streams."""
    je, te, _, _ = engines
    prompts = _prompts(0)
    out_j = je.generate(prompts, max_new_tokens=20)
    out_t = te.generate(prompts, max_new_tokens=20)
    assert out_t == out_j
    assert all(len(o) == 20 for o in out_t)
    assert te.free_blocks == 96


def test_live_blocks_per_step_match_jax(engines):
    """Chunked prefills and decodes of three sequences in one engine, the
    JAX rule at every step: live = allocated - max(0, (seen - W + 1) //
    block), on both engines."""
    je, te, _, _ = engines
    p = _prompts(2)
    steps = [([0], [p[0][:40]]), ([0, 1], [p[0][40:], p[1]]), ([0, 1, 2], [[1], [2], p[2]])]
    steps += [([0, 1, 2], [[t], [t], [t]]) for t in range(12)]
    for uids, toks in steps:
        je.put(uids, toks)
        te.put(uids, toks)
        for u in uids:
            seq = te._state_manager.get_sequence(u)
            dead = max(0, (seq.seen_tokens - WINDOW + 1) // BLOCK)
            assert _live(te, u) == _live(je, u) == seq.cur_allocated_blocks - dead
        assert te.free_blocks == je.free_blocks
    for u in range(3):
        je.flush(u)
        te.flush(u)
    assert te.free_blocks == je.free_blocks == 96


def test_int8_engine_matches_jax(engines):
    """Weight-only int8 (q/k/v/o, fc1, fc2) and an int8 KV cache, against
    the JAX engine's dense backend with the same options (it dequantizes
    the gathered window in fp32, as the port's plain version does): logits
    within 1e-4, as the Llama int8 test."""
    _, _, params, tied = engines
    cfg = {**KNOBS, "tie_word_embeddings": tied}
    je = jax_build(JLlamaConfig(**cfg), params=params, dtype=jnp.float32,
                   kv_block_size=BLOCK, attn_backend="dense", quantize="int8",
                   kv_cache_dtype="int8",
                   engine_config=JEngineConfig(num_kv_blocks=96, state_manager=STATE))
    te = build_llama_engine(LlamaConfig(**cfg), params=params, dtype=torch.float32,
                            kv_block_size=BLOCK, device="cpu", quantize="int8",
                            kv_cache_dtype="int8",
                            engine_config=RaggedInferenceEngineConfig(
                                num_kv_blocks=96, state_manager=STATE))
    assert te.model().model.layers[0].mlp.fc1.kernel is None
    p = _prompts(3)
    for toks in ([p[1], p[2]], [[7], [9]], [[3], [4]]):
        np.testing.assert_allclose(te.put([0, 1], toks).numpy(),
                                   np.asarray(je.put([0, 1], toks)), rtol=1e-4, atol=1e-4)


# ---- trailing-window KV release (test_kv_free.py's cases) ----

def _port_engine(num_kv_blocks=64, seed=3, **knobs):
    cfg = LlamaConfig(**{**KNOBS, **knobs})
    return build_llama_engine(cfg, seed=seed, dtype=torch.float32, kv_block_size=BLOCK,
                              device="cpu", engine_config=RaggedInferenceEngineConfig(
                                  num_kv_blocks=num_kv_blocks, state_manager=STATE))


def test_window_frees_leading_blocks_mid_sequence():
    """Decoding far past the window holds ceil(W / block) + 1 live blocks,
    not ceil(seen / block); the table keeps every position."""
    eng = _port_engine()
    total = eng.free_blocks
    eng.put([0], [list(range(1, 9))])
    for _ in range(56):
        eng.put([0], [[5]])
    seq = eng._state_manager.get_sequence(0)
    assert seq.seen_tokens == 64
    assert len(seq.kv_blocks) <= 5
    assert eng.free_blocks == total - len(seq.kv_blocks)
    assert seq.cur_allocated_blocks == 16
    table = seq.block_table(16)
    assert not table[:16 - len(seq.kv_blocks)].any()  # freed: 0 placeholders
    eng.flush(0)
    assert eng.free_blocks == total


def test_freeing_does_not_change_logits():
    """Greedy decode with the release against the same engine with it
    off: equal logits (the freed positions were masked anyway)."""
    eng_a, eng_b = _port_engine(), _port_engine()
    eng_b.model().maybe_free_kv = lambda seq: None
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    la, lb = eng_a.put([0], [prompt])[0], eng_b.put([0], [prompt])[0]
    for _ in range(40):
        torch.testing.assert_close(la, lb, rtol=0, atol=0)
        t = int(torch.argmax(la))
        la, lb = eng_a.put([0], [[t]])[0], eng_b.put([0], [[t]])[0]
    assert _live(eng_a, 0) < _live(eng_b, 0)


def test_global_attention_never_frees():
    eng = _port_engine(sliding_window=None)
    eng.put([0], [[1, 2, 3, 4]])
    for _ in range(20):
        eng.put([0], [[5]])
    seq = eng._state_manager.get_sequence(0)
    assert len(seq.kv_blocks) == seq.cur_allocated_blocks == 6


def test_mixed_window_layers_never_free():
    """One global layer pins the whole history: nothing is released, and
    the windowed layer still masks (the logits differ from all-global)."""
    eng = _port_engine(sliding_window=8, sliding_window_layers=(0, ))
    glob = _port_engine(sliding_window=None)
    eng.put([0], [[1, 2, 3, 4]])
    glob.put([0], [[1, 2, 3, 4]])
    for _ in range(28):
        out, ref = eng.put([0], [[5]]), glob.put([0], [[5]])
    seq = eng._state_manager.get_sequence(0)
    assert len(seq.kv_blocks) == seq.cur_allocated_blocks == 8
    assert (out - ref).abs().max().item() > 1e-3


# ---- HF checkpoint conversion ----

def _hf_state_dict(cfg, policy, seed=0):
    """A seeded HF-named state dict of numpy arrays, named and shaped by
    the policy's own maps (torch ``[out, in]`` for transposed weights)."""
    rng = np.random.default_rng(seed)
    shapes = {"/".join(jax_key_path(n)): tuple(p.shape)
              for n, p in LlamaModel(cfg, dtype=torch.float32,
                                     device="meta").named_parameters()}
    maps = dict(policy.global_map(cfg.tie_word_embeddings))
    for layer in range(cfg.num_hidden_layers):
        maps.update(policy.weight_map(layer, attention_bias=cfg.attention_bias))
    out = {}
    for hf_name, (path, transpose) in maps.items():
        shape = shapes[path][::-1] if transpose else shapes[path]
        out[hf_name] = (0.05 * rng.normal(size=shape)).astype(np.float32)
    return out


HF_CONFIG = dict(vocab_size=256, hidden_size=96, intermediate_size=192,
                 num_hidden_layers=2, num_attention_heads=6, num_key_value_heads=2,
                 max_position_embeddings=256, rope_theta=10000.0, sliding_window=16,
                 norm_epsilon=1e-5, use_bias=True)


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_convert_hf_checkpoint_matches_jax(tied):
    """One seeded HF state dict through both packages: the same config,
    every parameter equal, and equal logits from the two engines."""
    hf_config = {**HF_CONFIG, "tie_word_embeddings": tied}
    cfg = policy_for("starcoder2").config_from_hf(hf_config)
    sd = _hf_state_dict(cfg, policy_for("starcoder2"), seed=1)
    if not tied:
        assert "lm_head.weight" in sd
    jcfg, jparams = jax_convert("starcoder2", sd, hf_config, dtype=jnp.float32)
    tcfg, model = convert_hf_checkpoint("starcoder2", {k: torch.from_numpy(v) for k, v in
                                                       sd.items()},
                                        hf_config, dtype=torch.float32, device="cpu")
    for f in dataclasses.fields(tcfg):
        if f.name != "dtype":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    for name, p in model.named_parameters():
        node = jparams["model"]
        for key in jax_key_path(name):
            node = node[key]
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(node), err_msg=name)
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    je = jax_build(jcfg, params=jparams, dtype=jnp.float32, kv_block_size=BLOCK,
                   attn_backend="paged",
                   engine_config=JEngineConfig(num_kv_blocks=32, state_manager=STATE))
    te = build_llama_engine(tcfg, params=model, dtype=torch.float32, kv_block_size=BLOCK,
                            device="cpu", engine_config=RaggedInferenceEngineConfig(
                                num_kv_blocks=32, state_manager=STATE))
    prompt = _prompts(4)[2]
    np.testing.assert_allclose(te.put([0], [prompt]).numpy(),
                               np.asarray(je.put([0], [prompt])), **TOL)


def test_convert_hf_checkpoint_missing_weight_raises():
    cfg = policy_for("starcoder2").config_from_hf(HF_CONFIG)
    sd = _hf_state_dict(cfg, policy_for("starcoder2"))
    del sd["model.layers.1.mlp.c_fc.bias"]
    with pytest.raises(KeyError) as got:
        convert_hf_checkpoint("starcoder2", sd, HF_CONFIG, dtype=torch.float32,
                              device="cpu")
    with pytest.raises(KeyError) as want:
        jax_convert("starcoder2", sd, HF_CONFIG, dtype=jnp.float32)
    assert str(got.value) == str(want.value)


def test_llama_policy_matches_jax():
    hf = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2)
    tcfg = policy_for("LlamaForCausalLM").config_from_hf(hf)
    jcfg = jax_policy_for("LlamaForCausalLM").config_from_hf(hf)
    assert tcfg.num_key_value_heads == jcfg.num_key_value_heads == 2
    assert policy_for("llama").weight_map(1) == jax_policy_for("llama").weight_map(1)
    assert policy_for("llama").global_map(False) == jax_policy_for("llama").global_map(False)


# Mistral is registered now (tests/test_torch_mistral.py); Qwen2 is not
@pytest.mark.parametrize("arch", ["qwen2", "Phi3ForCausalLM", "no_such_arch"])
def test_unported_arch_raises(arch):
    with pytest.raises(NotImplementedError, match=arch):
        policy_for(arch)


def test_starcoder2_7b_config():
    """The published config through both policies: the same LlamaConfig,
    the published widths, tied embeddings and 7.17 B parameters."""
    tcfg = policy_for("starcoder2").config_from_hf(STARCODER2_7B)
    jcfg = jax_policy_for("starcoder2").config_from_hf(STARCODER2_7B)
    for f in dataclasses.fields(tcfg):
        if f.name != "dtype":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert (tcfg.hidden_size, tcfg.num_hidden_layers, tcfg.num_attention_heads,
            tcfg.num_key_value_heads, tcfg.head_dim_, tcfg.sliding_window,
            tcfg.vocab_size) == (4608, 32, 36, 4, 128, 4096, 49152)
    assert tcfg.tie_word_embeddings and tcfg.norm_type == "layernorm"
    n = sum(p.numel() for p in LlamaModel(tcfg, device="meta").parameters())
    assert 7.16e9 < n < 7.18e9, n
