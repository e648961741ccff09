"""deepspeed_tpu_torch ragged bookkeeping against the JAX package: block
allocator, sequence descriptors, config validation, KV cache geometry and
the padded metadata ``RaggedBatchWrapper.finalize`` ships per forward."""

import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import config_v2 as jcfg
from deepspeed_tpu.inference.v2.ragged import kv_cache as jkv
from deepspeed_tpu.inference.v2.ragged.blocked_allocator import BlockedAllocator as JAlloc
from deepspeed_tpu.inference.v2.ragged.ragged_wrapper import RaggedBatchWrapper as JWrap
from deepspeed_tpu.inference.v2.ragged.sequence_descriptor import DSSequenceDescriptor as JSeq
from deepspeed_tpu_torch.inference.v2 import config_v2 as tcfg
from deepspeed_tpu_torch.inference.v2.ragged import kv_cache as tkv
from deepspeed_tpu_torch.inference.v2.ragged.blocked_allocator import BlockedAllocator as TAlloc
from deepspeed_tpu_torch.inference.v2.ragged.ragged_wrapper import RaggedBatchWrapper as TWrap
from deepspeed_tpu_torch.inference.v2.ragged.sequence_descriptor import DSSequenceDescriptor as TSeq

FIELDS = ("tokens", "token_seq", "token_pos", "token_slot", "seq_start",
          "seq_n_new", "seq_seen", "block_table", "last_token_idx", "q_tok_idx")


def test_allocator_matches_jax():
    ja, ta = JAlloc(10), TAlloc(10)
    script = [("a", 3), ("a", 2), ("f", [1, 4]), ("a", 4), ("f", [0]),
              ("a", 20), ("f", [0]), ("f", [11]), ("a", 1), ("f", 2)]
    for kind, arg in script:
        res = []
        for alloc in (ja, ta):
            try:
                r = alloc.allocate(arg) if kind == "a" else alloc.free(arg)
                res.append(("ok", None if r is None else r.tolist()))
            except ValueError as e:
                res.append(("err", str(e)))
        assert res[0] == res[1], (kind, arg, res)
        assert ja.free_blocks == ta.free_blocks
    with pytest.raises(ValueError):
        TAlloc(0)


def test_sequence_descriptor_matches_jax():
    js, ts = JSeq(7, 6), TSeq(7, 6)
    for d in (js, ts):
        d.extend_kv_cache(np.array([4, 9, 2]))
        d.pre_forward(40)
        d.post_forward()
        d.rollback(3)
    assert js.seen_tokens == ts.seen_tokens == 37
    np.testing.assert_array_equal(js.block_table(8), ts.block_table(8))
    assert js.free_prefix_blocks(2) == ts.free_prefix_blocks(2)
    np.testing.assert_array_equal(js.block_table(4), ts.block_table(4))
    assert js.kv_blocks == ts.kv_blocks
    for d in (js, ts):
        with pytest.raises(ValueError):
            d.extend_kv_cache(np.arange(5))
        with pytest.raises(ValueError):
            d.rollback(100)


@pytest.mark.parametrize("kwargs", [
    dict(),
    dict(max_ragged_sequence_count=4096),
    dict(max_ragged_batch_size=16, max_ragged_sequence_count=32),
    dict(offload=True),
    dict(memory_config_size=1.5),
    dict(memory_config_mode="allocate", memory_config_size=2.5),
    dict(memory_config_mode="allocate", memory_config_size=12),
    dict(memory_config_mode="bogus"),
])
def test_state_manager_config_validation_matches_jax(kwargs):
    errs = []
    for cls in (jcfg.DSStateManagerConfig, tcfg.DSStateManagerConfig):
        try:
            cls(**kwargs)
            errs.append(None)
        except ValueError as e:  # pydantic's ValidationError is a ValueError
            errs.append(str(e))
    if errs[0] is None:
        assert errs[1] is None
    else:
        assert errs[1] is not None and errs[1] in errs[0]
    if errs[1] is None:
        jc, tc = jcfg.DSStateManagerConfig(**kwargs), tcfg.DSStateManagerConfig(**kwargs)
        for f in ("max_tracked_sequences", "max_ragged_batch_size",
                  "max_ragged_sequence_count", "max_context",
                  "memory_config_mode", "memory_config_size", "offload"):
            assert getattr(jc, f) == getattr(tc, f)


def test_engine_config_defaults_match_jax():
    jc, tc = jcfg.RaggedInferenceEngineConfig(), tcfg.RaggedInferenceEngineConfig()
    assert jc.num_kv_blocks == tc.num_kv_blocks
    assert jc.state_manager.max_ragged_batch_size == tc.state_manager.max_ragged_batch_size
    tc = tcfg.RaggedInferenceEngineConfig(state_manager={"max_context": 64})
    assert tc.state_manager.max_context == 64
    jk, tk = jcfg.KVCacheConfig(), tcfg.KVCacheConfig()
    for f in ("type", "block_size", "num_allocation_groups", "cache_shape",
              "cache_dtype", "max_blocks_per_allocation_group"):
        assert getattr(jk, f) == getattr(tk, f)


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "float32", "int8"])
def test_kv_geometry_matches_jax(cache_dtype):
    kw = dict(block_size=64, cache_shape=(32, 8, 128), cache_dtype=cache_dtype)
    jk, tk = jcfg.KVCacheConfig(**kw), tcfg.KVCacheConfig(**kw)
    assert jkv.per_token_kv_bytes(jk) == tkv.per_token_kv_bytes(tk)
    assert jkv.estimate_kv_blocks(jk, 80 << 30, 0.85) == \
        tkv.estimate_kv_blocks(tk, 80 << 30, 0.85)
    cache = tkv.BlockedKVCache(tk, 4, device="cpu")
    assert cache.per_token_bytes == jkv.per_token_kv_bytes(jk)
    if cache_dtype == "int8":
        data, scales = cache.cache
        assert cache.quantized
        assert data.dtype == torch.int8 and tuple(data.shape) == (64, 4 * 64, 1024)
        assert scales.dtype == torch.float32 and tuple(scales.shape) == (64, 4 * 64, 8)
        assert (data.numel() + 4 * scales.numel()) == 4 * 64 * cache.per_token_bytes
    else:
        assert not cache.quantized
        assert tuple(cache.cache.shape) == (64, 4 * 64, 1024)
        assert cache.cache.dtype == getattr(torch, cache_dtype)


def test_int8_cache_allocation_and_budget():
    """``tests/unit/inference/v2/test_kv_cache_int8.py::
    test_int8_cache_allocation_and_budget`` on the port, beside the JAX
    cache: the same shapes, dtypes, bytes per token and block budgets."""
    kw = dict(block_size=16, cache_shape=(2, 4, 64))
    cfg = tcfg.KVCacheConfig(cache_dtype="int8", **kw)
    kv = tkv.BlockedKVCache(cfg, num_blocks=8, device="cpu")
    jkv_cache = jkv.BlockedKVCache(jcfg.KVCacheConfig(cache_dtype="int8", **kw), 8)
    data, scales = kv.cache
    assert data.dtype == torch.int8 and tuple(data.shape) == (4, 128, 4 * 64)
    assert scales.dtype == torch.float32 and tuple(scales.shape) == (4, 128, 4)
    assert tuple(data.shape) == jkv_cache.cache[0].shape
    assert tuple(scales.shape) == jkv_cache.cache[1].shape
    assert not data.any() and not scales.any()
    # ~half the bytes of bf16 (int8 + fp32-scale/64-dim overhead)
    bf16 = tkv.BlockedKVCache(tcfg.KVCacheConfig(cache_dtype="bfloat16", **kw),
                              num_blocks=8, device="cpu")
    assert kv.per_token_bytes == jkv_cache.per_token_bytes
    assert kv.per_token_bytes < 0.6 * bf16.per_token_bytes
    # the same memory budget schedules ~2x the blocks
    b_int8 = tkv.estimate_kv_blocks(cfg, 1 << 24, 1.0)
    b_bf16 = tkv.estimate_kv_blocks(tcfg.KVCacheConfig(cache_dtype="bfloat16", **kw),
                                    1 << 24, 1.0)
    assert b_int8 >= int(1.8 * b_bf16)
    assert b_int8 == jkv.estimate_kv_blocks(jkv_cache._config, 1 << 24, 1.0)
    # Llama-3-8B width: 2,112 B per token and layer in place of 4,096
    llama = tcfg.KVCacheConfig(block_size=64, cache_shape=(32, 8, 128),
                               cache_dtype="int8")
    assert tkv.per_token_kv_bytes(llama) == 32 * 2112


def test_quantization_config_matches_jax():
    jc, tc = jcfg.RaggedInferenceEngineConfig(), tcfg.RaggedInferenceEngineConfig()
    assert jc.quantization.quantization_mode is tc.quantization.quantization_mode is None
    tc = tcfg.RaggedInferenceEngineConfig(quantization={"quantization_mode": "int8"})
    assert tc.quantization.quantization_mode == "int8"


# (seen, n_new, blocks) per sequence
BATCHES = {
    "decode": [(5, 1, [3]), (16, 1, [1, 7, 5]), (0, 1, [2])],
    "mixed": [(5, 3, [3]), (0, 9, [4, 5]), (17, 1, [6, 0, 1])],
    "single_prefill": [(0, 20, [2, 3, 7])],
}


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_finalize_matches_jax(name):
    bs, total_slots = 8, 8 * 8
    wrappers = (JWrap(jcfg.DSStateManagerConfig(), block_size=bs),
                TWrap(tcfg.DSStateManagerConfig(), block_size=bs, device="cpu"))
    rng = np.random.default_rng(0)
    for uid, (seen, n_new, blocks) in enumerate(BATCHES[name]):
        toks = rng.integers(0, 100, n_new)
        for cls, wrap in ((JSeq, wrappers[0]), (TSeq, wrappers[1])):
            d = cls(uid, 16)
            d.extend_kv_cache(np.array(blocks))
            d.pre_forward(seen)
            d.post_forward()
            wrap.insert_sequence(d, toks)
    jb = wrappers[0].finalize(total_slots)
    tb = wrappers[1].finalize(total_slots)
    assert jb.bucket_key == tb.bucket_key
    assert tb.n_tokens == sum(n for _, n, _ in BATCHES[name])
    for f in FIELDS:
        ja, ta = np.asarray(getattr(jb, f)), getattr(tb, f)
        assert ta.dtype == torch.int32, f
        np.testing.assert_array_equal(ta.numpy(), ja, err_msg=f)
