"""deepspeed_tpu_torch BLOOM serving against the JAX package.

ALiBi's slopes, K4 with the ALiBi bias (the port's plain version against
the JAX reference and the JAX kernel in interpret mode, with and without a
window, for one and several query heads per KV head), a tiny BLOOM (ALiBi,
the embedding LayerNorm, LayerNorm with bias, q/k/v/o biases, the biased
gelu-tanh fc MLP, tied embeddings, MHA) through both engines, and HF
checkpoint conversion with BLOOM's fused per-head ``query_key_value``.
Both engines get the same weights: ``init_llama``'s JAX tree with its
biases and LayerNorm parameters moved off their zero/one initial values,
loaded into the port with ``params_from_jax``. The JAX engine runs its
paged backend (the Pallas kernel in interpret mode); the port runs on the
CPU, where its kernel wrappers take their plain versions."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2.config_v2 import RaggedInferenceEngineConfig as JEngineConfig
from deepspeed_tpu.inference.v2.engine_v2 import build_llama_engine as jax_build
from deepspeed_tpu.models.llama import LlamaConfig as JLlamaConfig
from deepspeed_tpu.models.llama import alibi_slopes as jax_alibi_slopes
from deepspeed_tpu.models.llama import init_llama as jax_init
from deepspeed_tpu.module_inject.replace_module import \
    convert_hf_checkpoint as jax_convert
from deepspeed_tpu.module_inject.replace_policy import policy_for as jax_policy_for
from deepspeed_tpu.ops.paged_attention import paged_attention as jax_paged
from deepspeed_tpu.ops.paged_attention import paged_attention_reference as jax_paged_ref
from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.engine_v2 import build_llama_engine
from deepspeed_tpu_torch.models.convert import jax_key_path, params_from_jax
from deepspeed_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM, LlamaModel,
                                              alibi_slopes)
from deepspeed_tpu_torch.module_inject import BLOOM_7B1, convert_hf_checkpoint, policy_for
from deepspeed_tpu_torch.ops.paged_attention import paged_attention


@pytest.mark.parametrize("n", [1, 4, 6, 12, 32, 40])
def test_alibi_slopes_match_jax(n):
    got = alibi_slopes(n)
    assert got.dtype == np.float32 and got.shape == (n, )
    np.testing.assert_array_equal(got, jax_alibi_slopes(n))


# ---- K4 with ALiBi ----

# (seed, S, N, KV, G, D, ps, n_pages, B, seen, n_new, window)
ALIBI_CASES = {
    "g1_decode_prefill_padding": (0, 4, 3, 4, 1, 32, 8, 32, 5, [9, 0, 30, 0],
                                  [1, 3, 2, 0], None),
    "g3_mixed": (1, 3, 2, 2, 3, 16, 8, 24, 6, [20, 5, 40], [2, 1, 1], None),
    "g1_window": (2, 3, 4, 4, 1, 16, 8, 24, 6, [25, 0, 41], [1, 4, 2], 12),
    "g2_window": (3, 2, 2, 2, 2, 32, 8, 16, 6, [30, 17], [2, 1], 9),
}


@pytest.mark.parametrize("case", sorted(ALIBI_CASES))
@pytest.mark.parametrize("explicit", [False, True], ids=["use_alibi", "slopes"])
def test_paged_alibi_matches_jax(case, explicit):
    """The port's plain version with ALiBi against the JAX reference and
    the JAX kernel (interpret mode): fp32 within 2e-5, as the JAX tests.
    Explicit slopes are a seeded [KV, G] table, not alibi_slopes(H)."""
    seed, S, N, KV, G, D, ps, n_pages, B, seen, n_new, window = ALIBI_CASES[case]
    rng = np.random.default_rng(seed)
    cache = rng.normal(size=(4, n_pages * ps, KV * D)).astype(np.float32)
    q = rng.normal(size=(S, N, KV * G, D)).astype(np.float32)
    bt = rng.permutation(n_pages)[:S * B].reshape(S, B).astype(np.int32)
    seen = np.asarray(seen, np.int32)
    lens = seen + np.asarray(n_new, np.int32)
    kw = dict(page_size=ps, window=window)
    if explicit:
        slopes = rng.uniform(0.01, 0.5, size=(KV, G)).astype(np.float32)
        tkw, jkw = dict(slopes=torch.from_numpy(slopes)), dict(slopes=jnp.asarray(slopes))
    else:
        tkw = jkw = dict(use_alibi=True)
    out = paged_attention(*(torch.from_numpy(a) for a in (q, cache)), 1,
                          *(torch.from_numpy(a) for a in (bt, seen, lens)), **kw, **tkw)
    jargs = [jnp.asarray(a) for a in (q, cache)] + [1] + \
        [jnp.asarray(a) for a in (bt, seen, lens)]
    ref = jax_paged_ref(*jargs, **kw, **jkw)
    kern = jax_paged(*jargs, interpret=True, **kw, **jkw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(kern), atol=2e-5, rtol=2e-5)
    # the bias counts: without it the output moves
    plain = paged_attention(*(torch.from_numpy(a) for a in (q, cache)), 1,
                            *(torch.from_numpy(a) for a in (bt, seen, lens)), **kw)
    assert (plain - out).abs().max().item() > 1e-3
    if case == "g1_decode_prefill_padding":
        assert not out[3].any()  # the padding sequence sees no key


def test_paged_softcap_still_raises():
    """The softcap is ported (Gemma-2): with ALiBi too, the plain version
    caps before the bias as the JAX reference and kernel do (fp32 within
    2e-5); only a cap that is not positive still raises."""
    seed, S, N, KV, G, D, ps, n_pages, B, seen, n_new, window = ALIBI_CASES["g3_mixed"]
    rng = np.random.default_rng(seed)
    cache = rng.normal(size=(4, n_pages * ps, KV * D)).astype(np.float32)
    q = (3 * rng.normal(size=(S, N, KV * G, D))).astype(np.float32)
    bt = rng.permutation(n_pages)[:S * B].reshape(S, B).astype(np.int32)
    seen = np.asarray(seen, np.int32)
    lens = seen + np.asarray(n_new, np.int32)
    kw = dict(page_size=ps, window=window, use_alibi=True, softcap=5.0)
    targs = [torch.from_numpy(a) for a in (q, cache)] + [1] + \
        [torch.from_numpy(a) for a in (bt, seen, lens)]
    jargs = [jnp.asarray(a) for a in (q, cache)] + [1] + \
        [jnp.asarray(a) for a in (bt, seen, lens)]
    out = paged_attention(*targs, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_paged_ref(*jargs, **kw)),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jax_paged(*jargs, interpret=True, **kw)),
                               atol=2e-5, rtol=2e-5)
    uncapped = paged_attention(*targs, **{**kw, "softcap": None})
    assert (uncapped - out).abs().max().item() > 1e-3
    for bad in (0.0, -30.0):
        with pytest.raises(ValueError, match="softcap"):
            paged_attention(*targs, **{**kw, "softcap": bad})


# ---- a tiny BLOOM through both engines ----

BLOCK = 4
STATE = dict(max_ragged_batch_size=48, max_ragged_sequence_count=8, max_context=256)
PROMPT_LENS = (70, 9, 23, 5)  # 70 > max_ragged_batch_size: chunked prefill
TOL = dict(rtol=1e-5, atol=1e-5)  # fp32 on both sides: summation order only


def _knobs(heads):
    return dict(vocab_size=256, hidden_size=16 * heads, intermediate_size=64 * heads,
                num_hidden_layers=2, num_attention_heads=heads,
                num_key_value_heads=heads, max_position_embeddings=64,
                norm_type="layernorm", pos_embedding="alibi", embed_layernorm=True,
                mlp_type="gelu_tanh_fc", attention_bias=True, attention_out_bias=True,
                mlp_bias=True, tie_word_embeddings=True)


def _params(knobs, seed=0):
    """The JAX tree of a tiny BLOOM config, numpy leaves, with biases and
    LayerNorm scales moved by N(0, 0.1)."""
    _, params = jax_init(JLlamaConfig(**knobs, dtype=jnp.float32), seed=seed)
    rng = np.random.default_rng(seed)

    def move(path, x):
        x = np.asarray(x)
        if getattr(path[-1], "key", None) in ("bias", "scale"):
            return (x + 0.1 * rng.normal(size=x.shape)).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(move, params)


@pytest.fixture(scope="module", params=[4, 6], ids=["h4", "h6"])
def engines(request):
    knobs = _knobs(request.param)
    params = _params(knobs)
    assert "embed_layernorm" in params["model"]
    je = jax_build(JLlamaConfig(**knobs), params=params, dtype=jnp.float32,
                   kv_block_size=BLOCK, attn_backend="paged",
                   engine_config=JEngineConfig(num_kv_blocks=96, state_manager=STATE))
    te = build_llama_engine(LlamaConfig(**knobs), params=params, dtype=torch.float32,
                            kv_block_size=BLOCK, device="cpu",
                            engine_config=RaggedInferenceEngineConfig(
                                num_kv_blocks=96, state_manager=STATE))
    return je, te


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).tolist() for n in PROMPT_LENS]


def test_put_logits_match_jax(engines):
    """A prefill of two prompts, then decode steps past the 64-position
    rope table a rope model would index (ALiBi has none): logits within
    1e-5 at every step."""
    je, te = engines
    p = _prompts(1)
    uids = [100, 101]
    feeds = [[p[0][:40], p[3]], [p[0][40:], p[1]]] + [[[t], [t + 1]] for t in range(8)]
    for toks in feeds:
        jl = np.asarray(je.put(uids, toks))
        tl = te.put(uids, toks)
        assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
        np.testing.assert_allclose(tl.numpy(), jl, **TOL)
    assert te._state_manager.get_sequence(100).seen_tokens > 64
    for u in uids:
        je.flush(u)
        te.flush(u)
    assert je.free_blocks == te.free_blocks == 96


def test_generate_greedy_streams_match_jax(engines):
    je, te = engines
    prompts = _prompts(0)
    out_j = je.generate(prompts, max_new_tokens=8)
    out_t = te.generate(prompts, max_new_tokens=8)
    assert out_t == out_j
    assert all(len(o) == 8 for o in out_t)
    assert te.free_blocks == 96


def test_bloom_knobs_count():
    """The embedding LayerNorm and ALiBi each change the logits (against a
    port engine without them, on the same weights)."""
    knobs = _knobs(4)
    params = _params(knobs, seed=2)
    prompt = _prompts(3)[2]

    def logits(**over):
        cfg = LlamaConfig(**{**knobs, **over})
        model = params_from_jax(params, cfg, dtype=torch.float32, device="cpu")
        eng = build_llama_engine(cfg, params=model, dtype=torch.float32,
                                 kv_block_size=BLOCK, device="cpu",
                                 engine_config=RaggedInferenceEngineConfig(
                                     num_kv_blocks=32, state_manager=STATE))
        return eng.put([0], [prompt])

    base = logits()
    assert (base - logits(pos_embedding="rope")).abs().max().item() > 1e-3
    assert (base - logits(embed_layernorm=False)).abs().max().item() > 1e-3


def test_training_still_refuses_bloom():
    for option in (dict(pos_embedding="alibi"), dict(embed_layernorm=True)):
        with pytest.raises(NotImplementedError, match=next(iter(option))):
            LlamaForCausalLM(LlamaConfig.tiny(**option), device="cpu")


# ---- HF checkpoint conversion ----

HF_CONFIG = dict(vocab_size=256, hidden_size=96, n_layer=2, n_head=6,
                 layer_norm_epsilon=1e-5)


def _hf_state_dict(cfg, policy, seed=0):
    """A seeded HF-named BLOOM state dict of numpy arrays: the policy's
    maps (torch ``[out, in]`` for transposed weights) and each layer's
    fused ``query_key_value`` weight ``[3 * H * D, E]`` and bias."""
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
    for layer in range(cfg.num_hidden_layers):
        w, b = policy.special_hf_names(layer)
        out[w] = (0.05 * rng.normal(size=(3 * cfg.hidden_size, cfg.hidden_size))
                  ).astype(np.float32)
        out[b] = (0.05 * rng.normal(size=(3 * cfg.hidden_size, ))).astype(np.float32)
    return out


def test_convert_hf_checkpoint_matches_jax(caplog):
    """One seeded HF state dict through both packages: the same config,
    every parameter equal (q/k/v split out of the fused tensor per head),
    nothing left unconverted, and equal logits from the two engines."""
    cfg = policy_for("bloom").config_from_hf(HF_CONFIG)
    sd = _hf_state_dict(cfg, policy_for("bloom"), seed=1)
    jcfg, jparams = jax_convert("bloom", sd, HF_CONFIG, dtype=jnp.float32)
    with caplog.at_level("WARNING"):
        tcfg, model = convert_hf_checkpoint(
            "BloomForCausalLM", {k: torch.from_numpy(v) for k, v in sd.items()},
            HF_CONFIG, dtype=torch.float32, device="cpu")
    assert "unconverted" not in caplog.text
    for f in dataclasses.fields(tcfg):
        if f.name != "dtype":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    for name, p in model.named_parameters():
        node = jparams["model"]
        for key in jax_key_path(name):
            node = node[key]
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(node), err_msg=name)
    # head 1's q rows of layer 0 sit at rows [3 * D, 4 * D) of the fused tensor
    D = tcfg.head_dim_
    fused = sd["transformer.h.0.self_attention.query_key_value.weight"]
    np.testing.assert_array_equal(
        model.layers[0].self_attn.q_proj.kernel.detach().numpy()[:, D:2 * D],
        fused[3 * D:4 * D].T)
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


def test_convert_missing_fused_tensor_raises():
    cfg = policy_for("bloom").config_from_hf(HF_CONFIG)
    sd = _hf_state_dict(cfg, policy_for("bloom"))
    del sd["transformer.h.1.self_attention.query_key_value.bias"]
    with pytest.raises(KeyError, match="query_key_value.bias"):
        convert_hf_checkpoint("bloom", sd, HF_CONFIG, dtype=torch.float32, device="cpu")


def test_bloom_policy_refuses_post_layernorm_residual():
    with pytest.raises(ValueError):
        policy_for("bloom").config_from_hf(
            {**HF_CONFIG, "apply_residual_connection_post_layernorm": True})


def test_bloom_7b1_config():
    """The published config through both policies: the same LlamaConfig,
    the published widths (MHA, G = 1), and about 7.07 B parameters."""
    tcfg = policy_for("bloom").config_from_hf(BLOOM_7B1)
    jcfg = jax_policy_for("bloom").config_from_hf(BLOOM_7B1)
    for f in dataclasses.fields(tcfg):
        if f.name != "dtype":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert (tcfg.hidden_size, tcfg.intermediate_size, tcfg.num_hidden_layers,
            tcfg.num_attention_heads, tcfg.num_key_value_heads, tcfg.head_dim_,
            tcfg.vocab_size) == (4096, 16384, 30, 32, 32, 128, 250880)
    assert tcfg.pos_embedding == "alibi" and tcfg.embed_layernorm
    assert tcfg.tie_word_embeddings and tcfg.norm_type == "layernorm"
    n = sum(p.numel() for p in LlamaModel(tcfg, device="meta").parameters())
    assert 7.06e9 < n < 7.08e9, n
