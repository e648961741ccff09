"""deepspeed_tpu_torch Gemma-2 against the JAX package: the policies'
configs of the published google/gemma-2-9b, HF checkpoint conversion and
a tiny Gemma-2 served through both engines (its training:
``test_torch_gemma2_training.py``).

The tiny model keeps Gemma-2's knobs at small widths: hidden 64, 4 query
heads over 2 KV heads (G 2) of head_dim 256, the (1 + w) RMSNorm with the
sandwich norms, the embedding scale sqrt(64), the tanh-gelu gated MLP, a
24-token window on the even layer (layer 0) and global attention on the
odd one, tied embeddings. Its caps are smaller than Gemma-2's (attention
2, final 2) and its embedding is drawn 5x wider, so that both caps bite at
these widths; the norm deltas are drawn from N(0, 0.1), as HF's test of
the model draws them. Both engines get the same weights: the JAX
``init_llama`` tree, moved so, loaded into the port with
``params_from_jax``. The JAX engine runs its paged backend (the Pallas
kernel in interpret mode); the port runs on the CPU, where its kernel
wrappers take their plain versions."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2.config_v2 import RaggedInferenceEngineConfig as JEngineConfig
from deepspeed_tpu.inference.v2.engine_v2 import build_llama_engine as jax_build
from deepspeed_tpu.models.llama import init_llama as jax_init
from deepspeed_tpu.module_inject.replace_module import \
    convert_hf_checkpoint as jax_convert
from deepspeed_tpu.module_inject.replace_policy import policy_for as jax_policy_for
from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.engine_v2 import build_llama_engine
from deepspeed_tpu_torch.models.convert import jax_key_path, lookup, params_from_jax
from deepspeed_tpu_torch.models.llama import LlamaModel, RMSNormWeight
from deepspeed_tpu_torch.module_inject import GEMMA2_9B, convert_hf_checkpoint, policy_for
from deepspeed_tpu_torch.ops.normalization import rms_norm
from deepspeed_tpu_torch.ops.paged_attention import paged_attention

TINY_HF = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, head_dim=256,
               max_position_embeddings=128, rms_norm_eps=1e-6, rope_theta=10000.0,
               sliding_window=24, query_pre_attn_scalar=256, attn_logit_softcapping=2.0,
               final_logit_softcapping=2.0)
WINDOW, BLOCK = 24, 4
STATE = dict(max_ragged_batch_size=48, max_ragged_sequence_count=8, max_context=128)
PROMPT_LENS = (70, 9, 23, 5)  # 70 > max_ragged_batch_size: chunked prefill
# fp32 on both sides; only the summation order differs
TOL = dict(rtol=1e-5, atol=1e-5)


def _configs(**over):
    """The tiny config from both policies, in fp32, with ``over``."""
    jcfg = dataclasses.replace(jax_policy_for("gemma2").config_from_hf(TINY_HF),
                               dtype=jnp.float32, **over)
    tcfg = dataclasses.replace(policy_for("gemma2").config_from_hf(TINY_HF),
                               dtype=torch.float32, **over)
    return jcfg, tcfg


def _params(seed=0, **over):
    """The JAX tree of the tiny config, numpy leaves: the norm deltas
    (stored zeros) drawn from N(0, 0.1), the embedding 5x wider."""
    jcfg, _ = _configs(**over)
    _, params = jax_init(jcfg, seed=seed)
    rng = np.random.default_rng(seed)

    def move(path, x):
        x = np.asarray(x)
        key = getattr(path[-1], "key", None)
        if key == "weight":
            return (x + 0.1 * rng.normal(size=x.shape)).astype(np.float32)
        if key == "embedding":
            return (5 * x).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(move, params)


# ---- the published config ----

@pytest.mark.parametrize("arch", ["gemma2", "Gemma2ForCausalLM", "gemma", "GemmaForCausalLM"])
def test_gemma2_9b_config_matches_jax(arch):
    """GEMMA2_9B through both packages' policies gives the same config, field
    by field; Gemma-2's is the published model: 9,241,705,984 parameters
    (the tied embedding 917,504,000 and 42 layers of 198,195,200), G 2,
    head_dim 256, a 4096 window on the even layers."""
    tcfg = policy_for(arch).config_from_hf(GEMMA2_9B)
    jcfg = jax_policy_for(arch).config_from_hf(GEMMA2_9B)
    for f in dataclasses.fields(tcfg):
        if f.name != "dtype":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert tcfg.norm_plus_one and tcfg.tie_word_embeddings and tcfg.mlp_type == "geglu_tanh"
    assert tcfg.embed_scale == 3584 ** 0.5 and tcfg.head_dim_ == 256
    if "2" not in arch:
        assert not tcfg.sandwich_norm and tcfg.sliding_window is None
        return
    model = LlamaModel(tcfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == 9_241_705_984
    assert model.embed_tokens.weight.numel() == 917_504_000
    assert sum(p.numel() for p in model.layers[0].parameters()) == 198_195_200
    assert tcfg.num_attention_heads // tcfg.num_key_value_heads == 2
    assert tcfg.sliding_window == 4096 and tcfg.sliding_window_layers == tuple(range(0, 42, 2))
    assert (tcfg.attn_logit_softcapping, tcfg.final_logit_softcapping) == (50.0, 30.0)
    assert tcfg.attn_scale == 256 ** -0.5 and tcfg.rms_norm_eps == 1e-6


def test_embed_scale_rounds_to_the_compute_dtype():
    """sqrt(3584) = 59.866 multiplies bf16 embeddings as 59.75, as HF and the
    JAX model round it."""
    from deepspeed_tpu_torch.models.llama import embed_scale
    cfg = policy_for("gemma2").config_from_hf(GEMMA2_9B)
    assert embed_scale(cfg, torch.bfloat16).item() == 59.75
    assert embed_scale(cfg, torch.float32).item() == pytest.approx(59.866, abs=1e-3)


# ---- serving through both engines ----

@pytest.fixture(scope="module")
def engines():
    jcfg, tcfg = _configs()
    params = _params()
    je = jax_build(jcfg, params=params, dtype=jnp.float32, kv_block_size=BLOCK,
                   attn_backend="paged",
                   engine_config=JEngineConfig(num_kv_blocks=96, state_manager=STATE))
    te = build_llama_engine(tcfg, params=params, dtype=torch.float32, kv_block_size=BLOCK,
                            device="cpu", engine_config=RaggedInferenceEngineConfig(
                                num_kv_blocks=96, state_manager=STATE))
    return je, te


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).tolist() for n in PROMPT_LENS]


def test_put_logits_match_jax(engines):
    """A chunked prefill past the window, then decode steps: logits within
    1e-5 at every step. The port launches (here: runs the plain version
    of) K4's softcap instance once per layer and K5 4L+1 times per
    forward."""
    je, te = engines
    p = _prompts(1)
    uids = [100, 101]
    feeds = [[p[0][:38], p[3]], [p[0][38:], p[1]]] + [[[t], [t + 1]] for t in range(4)]
    for toks in feeds:
        jl = np.asarray(je.put(uids, toks))
        tl = te.put(uids, toks)
        assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
        np.testing.assert_allclose(tl.numpy(), jl, **TOL)
    assert te._state_manager.get_sequence(100).seen_tokens > 2 * WINDOW
    for u in uids:
        je.flush(u)
        te.flush(u)
    assert je.free_blocks == te.free_blocks == 96


def test_generate_greedy_streams_match_jax(engines):
    je, te = engines
    prompts = _prompts(0)
    out_j = je.generate(prompts, max_new_tokens=6)
    out_t = te.generate(prompts, max_new_tokens=6)
    assert out_t == out_j
    assert all(len(o) == 6 for o in out_t)
    assert te.free_blocks == 96


def _port_logits(params, prompt, dtype=torch.float32, **over):
    _, cfg = _configs(**over)
    model = params_from_jax(params, cfg, dtype=dtype, device="cpu")
    eng = build_llama_engine(cfg, params=model, dtype=dtype, kv_block_size=BLOCK,
                             device="cpu", engine_config=RaggedInferenceEngineConfig(
                                 num_kv_blocks=32, state_manager=STATE))
    budget = STATE["max_ragged_batch_size"]
    for ofs in range(0, len(prompt), budget):  # in chunks of the batch budget
        logits = eng.put([0], [prompt[ofs:ofs + budget]])
    return eng, logits


def test_gemma2_knobs_count():
    """Each Gemma-2 knob changes the logits (against a port engine without
    it, on the same weights): the two caps, the sandwich norms, the
    embedding scale, the (1 + w) norm, and the window on the even layers
    (against a window on every layer and against none)."""
    params = _params(seed=2)
    prompt = _prompts(3)[0]
    _, base = _port_logits(params, prompt)
    for over in (dict(attn_logit_softcapping=None), dict(final_logit_softcapping=None),
                 dict(sandwich_norm=False), dict(embed_scale=None),
                 dict(norm_plus_one=False), dict(sliding_window_layers=None),
                 dict(sliding_window=None)):
        _, got = _port_logits(params, prompt, **over)
        assert (base - got).abs().max().item() > 1e-3, over


def test_global_layers_keep_every_kv_block():
    """maybe_free_kv frees nothing while a layer attends globally (the
    odd layers): a prompt past the window keeps all its blocks, where a
    window on every layer releases the leading ones."""
    params = _params(seed=4)
    prompt = _prompts(5)[0]  # 70 tokens: 46 past the 24-token window
    eng, _ = _port_logits(params, prompt)
    seq = eng._state_manager.get_sequence(0)
    assert seq.seen_tokens == 70 and len(seq.kv_blocks) == seq.cur_allocated_blocks == 18
    assert eng.free_blocks == 32 - 18
    eng, _ = _port_logits(params, prompt, sliding_window_layers=None)
    seq = eng._state_manager.get_sequence(0)
    assert len(seq.kv_blocks) < seq.cur_allocated_blocks
    assert eng.free_blocks > 32 - 18


def test_bf16_serving_keeps_norm_deltas():
    """The point of the JAX test ``test_gemma2_bf16_serving_keeps_norm_deltas``:
    with norm deltas of ~1e-3 the bf16 engine's fp32 scale is 1 + w
    exactly (a bf16 sum would round the deltas away against 1.0), its
    logits stay close to the fp32 engine's on the same weights, and K5
    takes that fp32 scale beside bf16 rows."""
    params = _params(seed=6)
    rng = np.random.default_rng(7)

    def small_deltas(path, x):
        if getattr(path[-1], "key", None) == "weight":
            return (1e-3 * rng.normal(size=np.shape(x))).astype(np.float32)
        return np.asarray(x)

    params = jax.tree_util.tree_map_with_path(small_deltas, params)
    prompt = _prompts(8)[2]
    _, ref = _port_logits(params, prompt)
    eng, got = _port_logits(params, prompt, dtype=torch.bfloat16)
    scales = eng.model()._norm_scales
    norms = [m for m in eng.model().model.modules() if isinstance(m, RMSNormWeight)]
    assert len(scales) == len(norms) == 4 * 2 + 1
    for m in norms:
        assert scales[m].dtype == torch.float32
        kept = scales[m] - 1.0
        torch.testing.assert_close(kept, m.weight.float(), atol=2 ** -23, rtol=0)
        # a bf16 sum would move the deltas by more than half their size
        bf16_sum = scales[m].bfloat16().float() - 1.0
        assert (bf16_sum - kept).abs().max() > 0.5 * kept.abs().max()
    got = got.float()
    assert int(got.argmax()) == int(ref.argmax())
    assert (got - ref).abs().max().item() / ref.abs().max().item() < 0.08
    x = torch.randn(3, 64, dtype=torch.bfloat16)
    w = 1.0 + 1e-3 * torch.randn(64)
    assert rms_norm(x, w).dtype == torch.bfloat16


# ---- HF checkpoint conversion ----

def _hf_state_dict(cfg, policy, seed=0):
    """A seeded HF-named Gemma-2 state dict of numpy arrays (torch
    ``[out, in]`` for transposed weights): the four norms of each layer
    and the final norm hold stored deltas w, N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    shapes = {"/".join(jax_key_path(n)): tuple(p.shape)
              for n, p in LlamaModel(cfg, dtype=torch.float32,
                                     device="meta").named_parameters()}
    maps = dict(policy.global_map(cfg.tie_word_embeddings))
    for layer in range(cfg.num_hidden_layers):
        maps.update(policy.weight_map(layer))
    out = {}
    for hf_name, (path, transpose) in maps.items():
        shape = shapes[path][::-1] if transpose else shapes[path]
        scale = 0.1 if hf_name.endswith("norm.weight") else 0.05
        out[hf_name] = (scale * rng.normal(size=shape)).astype(np.float32)
    return out


def test_convert_hf_checkpoint_matches_jax(caplog):
    """One seeded HF state dict through both converters: the same config,
    every parameter equal (each layer's four norms hold the stored w, not
    1 + w), nothing left unconverted, and equal logits from the two
    engines."""
    cfg = policy_for("gemma2").config_from_hf(TINY_HF)
    sd = _hf_state_dict(cfg, policy_for("gemma2"), seed=1)
    assert sum(k.endswith("layernorm.weight") for k in sd) == 4 * cfg.num_hidden_layers
    jcfg, jparams = jax_convert("gemma2", sd, TINY_HF, dtype=jnp.float32)
    with caplog.at_level("WARNING"):
        tcfg, model = convert_hf_checkpoint(
            "Gemma2ForCausalLM", {k: torch.from_numpy(v) for k, v in sd.items()},
            TINY_HF, dtype=torch.float32, device="cpu")
    assert "unconverted" not in caplog.text
    for f in dataclasses.fields(tcfg):
        if f.name != "dtype":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      np.asarray(lookup(jparams["model"], name)),
                                      err_msg=name)
    np.testing.assert_array_equal(
        model.layers[1].pre_feedforward_layernorm.weight.detach().numpy(),
        sd["model.layers.1.pre_feedforward_layernorm.weight"])
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    je = jax_build(dataclasses.replace(jcfg, dtype=jnp.float32), params=jparams,
                   dtype=jnp.float32, kv_block_size=BLOCK, attn_backend="paged",
                   engine_config=JEngineConfig(num_kv_blocks=32, state_manager=STATE))
    te = build_llama_engine(tcfg, params=model, dtype=torch.float32, kv_block_size=BLOCK,
                            device="cpu", engine_config=RaggedInferenceEngineConfig(
                                num_kv_blocks=32, state_manager=STATE))
    prompt = _prompts(4)[2]
    np.testing.assert_allclose(te.put([0], [prompt]).numpy(),
                               np.asarray(je.put([0], [prompt])), **TOL)


def test_convert_missing_sandwich_norm_raises():
    cfg = policy_for("gemma2").config_from_hf(TINY_HF)
    sd = _hf_state_dict(cfg, policy_for("gemma2"))
    del sd["model.layers.0.post_feedforward_layernorm.weight"]
    with pytest.raises(KeyError, match="post_feedforward_layernorm"):
        convert_hf_checkpoint("gemma2", sd, TINY_HF, dtype=torch.float32, device="cpu")


def test_softcap_instance_counts_on_the_card_only():
    """On CPU tensors the wrappers run their plain versions and count no
    launch (the counts are the kernels')."""
    before = (paged_attention.softcap_launches, rms_norm.fp32_scale_launches)
    _port_logits(_params(seed=9), _prompts(9)[3])
    assert (paged_attention.softcap_launches, rms_norm.fp32_scale_launches) == before
