"""deepspeed_tpu_torch ragged Llama serving against the JAX engine.

Both engines get the same weights (``init_llama``'s JAX tree, loaded into
the port with ``params_from_jax``), the tiny config with 2 KV heads, fp32,
16-token KV blocks and 64 blocks. The JAX engine runs its paged-attention
path (the Pallas kernels in interpret mode); the port runs on the CPU,
where its kernel wrappers take their plain PyTorch versions. The int8
engine (weight-only int8 and an int8 KV cache) is held against the JAX
engine with the same options."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2.config_v2 import RaggedInferenceEngineConfig as JEngineConfig
from deepspeed_tpu.inference.v2.engine_v2 import build_llama_engine as jax_build
from deepspeed_tpu.models.llama import LlamaConfig as JLlamaConfig
from deepspeed_tpu.models.llama import init_llama as jax_init
from deepspeed_tpu.models.llama import precompute_rope as jax_rope
from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.engine_v2 import build_llama_engine
from deepspeed_tpu_torch.models.convert import params_from_jax, quantized_from_jax
from deepspeed_tpu_torch.inference.v2.model import layer_kernels
from deepspeed_tpu_torch.models.llama import LlamaConfig, init_llama, precompute_rope

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATE = dict(max_ragged_batch_size=32, max_ragged_sequence_count=8,
             max_context=128)
PROMPT_LENS = (5, 40, 11, 17)  # 40 > max_ragged_batch_size: chunked prefill


@pytest.fixture(scope="module")
def engines():
    _, params = jax_init(JLlamaConfig.tiny(num_key_value_heads=2), seed=3)
    params = jax.tree_util.tree_map(np.asarray, params)
    je = jax_build(JLlamaConfig.tiny(num_key_value_heads=2), params=params,
                   dtype=jnp.float32, kv_block_size=16, attn_backend="paged",
                   engine_config=JEngineConfig(num_kv_blocks=64,
                                               state_manager=STATE))
    te = build_llama_engine(LlamaConfig.tiny(num_key_value_heads=2),
                            params=params, dtype=torch.float32,
                            kv_block_size=16, device="cpu",
                            engine_config=RaggedInferenceEngineConfig(
                                num_kv_blocks=64, state_manager=STATE))
    return je, te, params


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).tolist() for n in PROMPT_LENS]


def test_put_logits_match_jax(engines):
    je, te, _ = engines
    p = _prompts(1)
    uids = [100, 101]
    # fp32 on both sides; only the summation order differs
    tol = dict(rtol=1e-5, atol=1e-5)
    jl = np.asarray(je.put(uids, [p[0], p[2]]))
    tl = te.put(uids, [p[0], p[2]])
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    np.testing.assert_allclose(tl.numpy(), jl, **tol)
    # a decode step on top of the prefilled history
    jl = np.asarray(je.put(uids, [[7], [9]]))
    tl = te.put(uids, [[7], [9]])
    np.testing.assert_allclose(tl.numpy(), jl, **tol)
    for u in uids:
        je.flush(u)
        te.flush(u)
    assert je.free_blocks == te.free_blocks == 64


def test_tied_embedding_logits_match_jax():
    """tie_word_embeddings: the unembed is the fp32 embedding table."""
    jcfg = JLlamaConfig.tiny(num_key_value_heads=2, tie_word_embeddings=True)
    _, params = jax_init(jcfg, seed=4)
    params = jax.tree_util.tree_map(np.asarray, params)
    assert "lm_head" not in params["model"]
    je = jax_build(jcfg, params=params, dtype=jnp.float32, kv_block_size=16,
                   attn_backend="paged",
                   engine_config=JEngineConfig(num_kv_blocks=8))
    te = build_llama_engine(
        LlamaConfig.tiny(num_key_value_heads=2, tie_word_embeddings=True),
        params=params, dtype=torch.float32, kv_block_size=16, device="cpu",
        engine_config=RaggedInferenceEngineConfig(num_kv_blocks=8))
    prompt = _prompts(2)[3]
    np.testing.assert_allclose(te.put([0], [prompt]).numpy(),
                               np.asarray(je.put([0], [prompt])),
                               rtol=1e-5, atol=1e-5)


def test_generate_greedy_streams_match_jax(engines):
    je, te, _ = engines
    prompts = _prompts(0)
    out_j = je.generate(prompts, max_new_tokens=6)
    out_t = te.generate(prompts, max_new_tokens=6)
    assert out_t == out_j
    assert all(len(o) == 6 for o in out_t)
    assert te.free_blocks == 64


def test_generate_when_the_cache_runs_out_matches_jax(engines):
    """Two 16-token blocks: the headroom admission cannot fit prompt +
    budget, so both engines admit on prefill feasibility alone, evict when
    the decode put runs the cache dry, and truncate the lone sequence."""
    _, _, params = engines
    jcfg = JLlamaConfig.tiny(num_key_value_heads=2)
    je = jax_build(jcfg, params=params, dtype=jnp.float32, kv_block_size=16,
                   attn_backend="paged",
                   engine_config=JEngineConfig(num_kv_blocks=2,
                                               state_manager=STATE))
    te = build_llama_engine(LlamaConfig.tiny(num_key_value_heads=2),
                            params=params, dtype=torch.float32,
                            kv_block_size=16, device="cpu",
                            engine_config=RaggedInferenceEngineConfig(
                                num_kv_blocks=2, state_manager=STATE))
    prompts = [_prompts(3)[3]]  # 17 tokens
    out_j = je.generate(prompts, max_new_tokens=30)
    out_t = te.generate(prompts, max_new_tokens=30)
    assert out_t == out_j
    assert 0 < len(out_t[0]) < 30
    assert te.free_blocks == 2


def test_scheduling_matches_jax(engines):
    je, te, _ = engines
    cases = [([1], [20]), ([1, 2], [20, 20]), ([1], [200]), ([1], [40]),
             (list(range(9)), [1] * 9), ([3], [16 * 64 + 1])]
    for uids, lens in cases:
        assert je.can_schedule(uids, lens).name == te.can_schedule(uids, lens).name
        assert je.query(uids[0], lens[0], 4) == te.query(uids[0], lens[0], 4)


@pytest.mark.parametrize("cfg", ["tiny", "llama3_8b"])
def test_rope_table_matches_jax(cfg):
    tc, jc = getattr(LlamaConfig, cfg)(), getattr(JLlamaConfig, cfg)()
    cos_t, sin_t = precompute_rope(tc.head_dim_, tc.max_position_embeddings,
                                   tc.rope_theta, device="cpu")
    cos_j, sin_j = jax_rope(jc.head_dim_, jc.max_position_embeddings,
                            jc.rope_theta)
    assert cos_t.dtype == torch.float32 and tuple(cos_t.shape) == cos_j.shape
    # same fp32 inverse frequencies and products; cos/sin of arguments up to
    # 8191 rad differ by the libraries' last-ulp rounding only
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), atol=1e-6)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), atol=1e-6)


def test_params_from_jax_loads_every_leaf(engines):
    _, _, params = engines
    model = params_from_jax(params, LlamaConfig.tiny(num_key_value_heads=2),
                            dtype=torch.float32, device="cpu")
    p = params["model"]
    np.testing.assert_array_equal(model.embed_tokens.weight.numpy(),
                                  p["embed_tokens"]["embedding"])
    np.testing.assert_array_equal(model.layers[1].mlp.down_proj.kernel.numpy(),
                                  p["layers_1"]["mlp"]["down_proj"]["kernel"])
    np.testing.assert_array_equal(model.layers[0].self_attn.k_proj.kernel.numpy(),
                                  p["layers_0"]["self_attn"]["k_proj"]["kernel"])
    np.testing.assert_array_equal(model.norm.weight.numpy(), p["norm"]["weight"])
    assert model.lm_head.kernel.dtype == torch.float32
    np.testing.assert_array_equal(model.lm_head.kernel.numpy(),
                                  p["lm_head"]["kernel"])
    bf = params_from_jax(params, LlamaConfig.tiny(num_key_value_heads=2),
                         dtype=torch.bfloat16, device="cpu")
    assert bf.layers[0].self_attn.q_proj.kernel.dtype == torch.bfloat16
    assert bf.lm_head.kernel.dtype == torch.float32


def test_init_llama_follows_jax_initializers():
    cfg = LlamaConfig.tiny(hidden_size=256, intermediate_size=512)
    m = init_llama(cfg, seed=0, dtype=torch.float32, device="cpu")
    again = init_llama(cfg, seed=0, dtype=torch.float32, device="cpu")
    k = m.layers[0].mlp.gate_proj.kernel  # [256, 512], lecun normal
    assert torch.equal(k, again.layers[0].mlp.gate_proj.kernel)
    std = (1.0 / 256) ** 0.5
    assert abs(k.std().item() - std) < 0.05 * std
    assert k.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-6
    assert abs(m.embed_tokens.weight.std().item() - 0.02) < 0.002
    assert torch.equal(m.norm.weight, torch.ones(256))
    assert m.lm_head.kernel.dtype == torch.float32


def test_unported_config_option_raises():
    # ALiBi serves now (BLOOM, tests/test_torch_bloom.py); OPT's learned
    # positions do not
    with pytest.raises(NotImplementedError, match="pos_embedding"):
        build_llama_engine(LlamaConfig.tiny(pos_embedding="learned"), device="cpu",
                           dtype=torch.float32)


def test_build_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_llama_engine()


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import importlib, pkgutil\n"
        "import chip_smoke, torch_serving_profile\n"
        "import deepspeed_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'deepspeed_tpu' or m.startswith('deepspeed_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


# ---- int8 serving: weight-only int8 and an int8 KV cache ----

KERNELS = (("self_attn", "q_proj"), ("self_attn", "k_proj"), ("self_attn", "v_proj"),
           ("self_attn", "o_proj"), ("mlp", "gate_proj"), ("mlp", "up_proj"),
           ("mlp", "down_proj"))


def _int8_pair(params, backend, num_kv_blocks=64):
    je = jax_build(JLlamaConfig.tiny(num_key_value_heads=2), params=params,
                   dtype=jnp.float32, kv_block_size=16, attn_backend=backend,
                   quantize="int8", kv_cache_dtype="int8",
                   engine_config=JEngineConfig(num_kv_blocks=num_kv_blocks,
                                               state_manager=STATE))
    te = build_llama_engine(LlamaConfig.tiny(num_key_value_heads=2),
                            params=params, dtype=torch.float32,
                            kv_block_size=16, device="cpu", quantize="int8",
                            kv_cache_dtype="int8",
                            engine_config=RaggedInferenceEngineConfig(
                                num_kv_blocks=num_kv_blocks, state_manager=STATE))
    return je, te


@pytest.fixture(scope="module")
def int8_engines(engines):
    """The JAX engine on its dense backend: it dequantizes the gathered KV
    window in fp32, as the port's plain paged attention does (its paged
    backend's Pallas kernel rounds K/V to bf16; see the test below)."""
    _, _, params = engines
    return _int8_pair(params, "dense") + (params, )


def test_int8_engine_stores_jax_weights(int8_engines):
    """Every layer kernel: the same int8 values and scales as the JAX
    engine's, bit for bit; the float kernels are released."""
    je, te, _ = int8_engines
    jp = je._model.params["model"]
    layers = te.model().model.layers
    for l, layer in enumerate(layers):
        for (part, name), dense in zip(KERNELS, layer_kernels(layer)):
            jq = quantized_from_jax(jp[f"layers_{l}"][part][name]["kernel"], device="cpu")
            tq = dense.quantized
            assert dense.kernel is None
            assert torch.equal(tq.values, jq.values), (l, name)
            assert torch.equal(tq.scales, jq.scales), (l, name)
            assert tq.shape == jq.shape and tq.dtype == jq.dtype == torch.float32
    assert te.model().model.lm_head.kernel.dtype == torch.float32
    cfg = LlamaConfig.tiny(num_key_value_heads=2)
    n = cfg.num_hidden_layers * (cfg.hidden_size * cfg.head_dim_ * (
        2 * cfg.num_attention_heads + 2 * cfg.num_key_value_heads)
        + 3 * cfg.hidden_size * cfg.intermediate_size)
    # one byte per weight (whole 512-blocks) and a 4-byte scale per block
    assert n <= te.model().layer_weight_bytes() <= n * (1 + 4 / 512) + 7 * 2 * 516
    assert te.model().kv_cache_config().cache_dtype == "int8"


def test_int8_engine_matches_jax(int8_engines):
    """Logits of a prefill and a decode step, and the KV cache they write.
    Both sides compute in fp32 from equal int8 weights; only summation
    orders differ, so a K/V value that lands within an fp32 rounding of a
    half-way point between two codes may round to the neighbour code: at
    most 1 apart, on at most 0.1% of the elements (none in the runs so far).
    Logits within 1e-4 (|logit| < 4)."""
    je, te, _ = int8_engines
    p = _prompts(1)
    uids = [100, 101]
    for toks in ([p[0], p[2]], [[7], [9]]):
        jl = np.asarray(je.put(uids, toks))
        tl = te.put(uids, toks)
        assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
        np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-4, atol=1e-4)
    jd, js = (np.asarray(a) for a in je._state_manager.kv_cache.cache)
    td, ts = te._state_manager.kv_cache.cache
    assert td.dtype == torch.int8 and ts.dtype == torch.float32
    diff = np.abs(td.numpy().astype(np.int32) - jd.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    assert (ts.numpy() > 0).sum() == (js > 0).sum() > 0  # the same slots written
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-5, atol=1e-9)
    for u in uids:
        je.flush(u)
        te.flush(u)
    assert je.free_blocks == te.free_blocks == 64


def test_int8_generate_greedy_streams_match_jax(int8_engines):
    je, te, _ = int8_engines
    prompts = _prompts(0)  # the 40-token prompt takes chunked prefill
    out_j = je.generate(prompts, max_new_tokens=6)
    out_t = te.generate(prompts, max_new_tokens=6)
    assert out_t == out_j
    assert te.free_blocks == 64


def test_int8_engine_against_the_jax_pallas_kernel(int8_engines):
    """The JAX engine's paged backend (the Pallas kernel in interpret mode)
    rounds each K/V element and scale to bf16 before its dots, where the
    port's plain version dequantizes in fp32: logits within 0.05 (0.0148 read
    on this prompt), the same greedy stream."""
    _, _, params = int8_engines
    je, te = _int8_pair(params, "paged", num_kv_blocks=16)
    prompt = _prompts(2)[3]
    np.testing.assert_allclose(te.put([0], [prompt]).numpy(),
                               np.asarray(je.put([0], [prompt])), atol=0.05)
    assert te.generate([prompt[:11]], max_new_tokens=4) == \
        je.generate([prompt[:11]], max_new_tokens=4)


def test_int8_prefill_and_decode_agree(int8_engines):
    """A prompt prefilled whole, and prefilled but for its last token which
    then comes as a decode step: the same last-token logits (the KV write
    quantizes each token's vectors alone, so the history is the same)."""
    _, te, _ = int8_engines
    p = _prompts(4)[3]
    full = te.put([0], [p])[0]
    te.flush(0)
    te.put([1], [p[:-1]])
    step = te.put([1], [[p[-1]]])[0]
    te.flush(1)
    torch.testing.assert_close(step, full, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kwargs, error", [
    (dict(quantization_mode="int8", quantize="int8"), None),
    (dict(quantization_mode="int8", quantize="fp6"), ValueError),
    (dict(quantization_mode="bogus"), ValueError),
    (dict(quantization_mode="wf6af16"), NotImplementedError),
    (dict(quantize="int4"), NotImplementedError),
    (dict(quantize="int3"), ValueError),
    (dict(kv_cache_dtype="fp8"), ValueError),
    (dict(kv_cache_dtype="bfloat16"), NotImplementedError),  # under an fp32 model
])
def test_quantization_options_match_jax(kwargs, error):
    """``quantization_mode`` maps onto ``quantize`` as in the JAX factory,
    with its errors; fp6 and int4 are not ported and say so."""
    mode = kwargs.pop("quantization_mode", None)
    build = dict(kwargs, dtype=torch.float32, kv_block_size=16, device="cpu",
                 engine_config=RaggedInferenceEngineConfig(
                     num_kv_blocks=4, quantization={"quantization_mode": mode}))
    if error is None:
        te = build_llama_engine(LlamaConfig.tiny(num_key_value_heads=2), **build)
        assert te.model().model.layers[0].mlp.up_proj.quantized is not None
        return
    with pytest.raises(error) as got:
        build_llama_engine(LlamaConfig.tiny(num_key_value_heads=2), **build)
    if error is ValueError and "kv_cache_dtype" not in kwargs and \
            kwargs.get("quantize") != "int3":
        # the mode errors come before any weight is made: the same message
        with pytest.raises(ValueError) as want:
            jax_build(JLlamaConfig.tiny(num_key_value_heads=2), dtype=jnp.float32,
                      engine_config=JEngineConfig(
                          num_kv_blocks=4, quantization={"quantization_mode": mode}),
                      **kwargs)
        assert str(got.value) == str(want.value)
