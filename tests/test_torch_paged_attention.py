"""deepspeed_tpu_torch paged attention against the JAX package's kernel.

The same numpy inputs go through ``deepspeed_tpu.ops.paged_attention`` (the
Pallas kernel in interpret mode, as its own tests run it on the CPU) and
through the port's ``paged_attention``, which on CPU tensors takes the
plain PyTorch version. The cases are those of
``tests/unit/ops/test_paged_attention.py``, then the int8 cache of
``tests/unit/inference/v2/test_kv_cache_int8.py``, then the sliding window
over both caches, then decode steps at the serving families' head layouts
and the plain version's ``round_p`` order against the JAX kernel's, with
the page splits a kernel walks and the bound on what summation order can
move through its rounding of P."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from deepspeed_tpu.ops.paged_attention import paged_attention as jax_paged
from deepspeed_tpu.ops.paged_attention import paged_attention_reference as jax_paged_ref
from deepspeed_tpu_torch.ops.paged_attention import (paged_attention,
                                                     paged_attention_reference,
                                                     round_p_flip_bound)


def _setup(rng, S, N, KV, G, D, ps, n_pages, B, seen, n_new):
    cache = rng.normal(size=(2 * 2, n_pages * ps, KV * D)).astype(np.float32)
    q = rng.normal(size=(S, N, KV * G, D)).astype(np.float32)
    bt = rng.permutation(n_pages)[:S * B].reshape(S, B).astype(np.int32)
    seen = np.asarray(seen, np.int32)
    lens = seen + np.asarray(n_new, np.int32)
    return q, cache, bt, seen, lens


def _run_both(q, cache, bt, seen, lens, layer, ps, dtype):
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    out_j = jax_paged(jnp.asarray(q, jd), jnp.asarray(cache, jd), layer,
                      jnp.asarray(bt), jnp.asarray(seen), jnp.asarray(lens),
                      page_size=ps, interpret=True)
    out_t = paged_attention(torch.from_numpy(q).to(td),
                            torch.from_numpy(cache).to(td), layer,
                            torch.from_numpy(bt), torch.from_numpy(seen),
                            torch.from_numpy(lens), page_size=ps)
    assert out_t.dtype == td and tuple(out_t.shape) == q.shape
    return (np.asarray(out_j, dtype=np.float32), out_t.float().numpy())


# (seed, S, N, KV, G, D, ps, n_pages, B, seen, n_new, layer, dtype, atol):
# fp32 atol 2e-5 as in the JAX tests; bf16 3e-2 (outputs round to bf16,
# 2^-8 relative, and the JAX kernel also rounds p to bf16 before P.V)
CASES = {
    "mixed_decode_prefill_padding": (0, 4, 2, 2, 3, 32, 16, 32, 4,
                                     [5, 0, 37, 0], [2, 1, 2, 0], 1,
                                     "float32", 2e-5),
    "layer0": (1, 2, 1, 1, 2, 16, 8, 8, 2, [7, 3], [1, 1], 0, "float32", 2e-5),
    "layer1": (1, 2, 1, 1, 2, 16, 8, 8, 2, [7, 3], [1, 1], 1, "float32", 2e-5),
    "gqa_grouping": (2, 2, 1, 2, 4, 16, 8, 16, 2, [9, 2], [1, 1], 0,
                     "float32", 2e-5),
    "bf16_inputs": (3, 2, 1, 1, 1, 32, 16, 8, 2, [20, 11], [1, 1], 0,
                    "bfloat16", 3e-2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax_kernel(case):
    seed, S, N, KV, G, D, ps, n_pages, B, seen, n_new, layer, dtype, atol = CASES[case]
    rng = np.random.default_rng(seed)
    q, cache, bt, seen, lens = _setup(rng, S, N, KV, G, D, ps, n_pages, B,
                                      seen, n_new)
    out_j, out_t = _run_both(q, cache, bt, seen, lens, layer, ps, dtype)
    np.testing.assert_allclose(out_t, out_j, atol=atol)
    if case == "mixed_decode_prefill_padding":
        # the padding sequence (lens 0) sees no key: exact zeros
        assert not out_t[3].any()


def test_layer_indexing_reads_right_pages():
    rng = np.random.default_rng(1)
    q, cache, bt, seen, lens = _setup(rng, 2, 1, 1, 2, 16, 8, 8, 2, [7, 3], [1, 1])
    args = [torch.from_numpy(a) for a in (q, cache)]
    meta = [torch.from_numpy(a) for a in (bt, seen, lens)]
    a = paged_attention(args[0], args[1], 0, *meta, page_size=8)
    b = paged_attention(args[0], args[1], 1, *meta, page_size=8)
    assert float((a - b).abs().max()) > 1e-3


@pytest.mark.parametrize("option", [dict(window=4), dict(use_alibi=True),
                                    dict(softcap=5.0),
                                    dict(cache_scales=torch.ones(4, 64, 2))])
def test_unsupported_option_raises(option):
    rng = np.random.default_rng(4)
    q, cache, bt, seen, lens = _setup(rng, 2, 1, 2, 2, 16, 8, 8, 2, [3, 4], [1, 1])
    args = [torch.from_numpy(a) for a in (q, cache)]
    meta = [torch.from_numpy(a) for a in (bt, seen, lens)]
    if "window" in option or "use_alibi" in option or "softcap" in option:
        # ported: the JAX reference's window mask, ALiBi bias and softcap
        out = paged_attention(*args, 0, *meta, page_size=8, **option)
        want = jax_paged_ref(*(jnp.asarray(a) for a in (q, cache)), 0,
                             *(jnp.asarray(a) for a in (bt, seen, lens)),
                             page_size=8, **option)
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-5)
        return
    if "cache_scales" in option:
        # ported: an int8 cache with unit scales attends as the float cache
        # of its codes; scales beside a float cache are refused
        codes = torch.from_numpy(np.clip(np.round(cache * 40), -127, 127)
                                 .astype(np.int8))
        out = paged_attention(args[0], codes, 0, *meta, page_size=8, **option)
        want = paged_attention(args[0], codes.float(), 0, *meta, page_size=8)
        torch.testing.assert_close(out, want, atol=0, rtol=0)
        with pytest.raises(ValueError):
            paged_attention(args[0], args[1], 0, *meta, page_size=8, **option)
        return
    raise AssertionError(f"no case for {option}")


# ---- int8 cache ----

def _int8_setup(seed, S, N, KV, G, D, ps, n_pages, B, seen, n_new):
    """An int8 cache as the engine's KV write makes it: each (row, slot,
    head) vector of a normal cache quantized to codes with scale
    max(absmax / 127, 1e-8); one page of zeros (scale 1e-8)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(4, n_pages * ps, KV, D)).astype(np.float32)
    x[:, :ps] = 0.0
    sc = np.maximum(np.abs(x).max(-1) / 127.0, 1e-8).astype(np.float32)
    codes = np.clip(np.round(x / sc[..., None]), -127, 127).astype(np.int8)
    q = rng.normal(size=(S, N, KV * G, D)).astype(np.float32)
    bt = rng.permutation(n_pages)[:S * B].reshape(S, B).astype(np.int32)
    seen = np.asarray(seen, np.int32)
    lens = seen + np.asarray(n_new, np.int32)
    return q, codes.reshape(4, n_pages * ps, KV * D), sc, bt, seen, lens


def row_rel_err(x, ref):
    """The largest ||x - ref|| / ||ref|| over rows (a head's D values at one
    position), a row's norm floored at 2^-10 of the RMS row norm (padding
    rows are 0 on both sides)."""
    x, ref = x.reshape(-1, x.shape[-1]), ref.reshape(-1, ref.shape[-1])
    den = np.linalg.norm(ref, axis=-1)
    den = np.maximum(den, 2.0 ** -10 * np.sqrt((den ** 2).mean()))
    return float((np.linalg.norm(x - ref, axis=-1) / den).max())


# (seed, S, N, KV, G, D, ps, n_pages, B, seen, n_new, layer): mixed decode,
# prefill and padding; GQA; one query head per KV head; a prefill chunk
INT8_CASES = {
    "mixed_decode_prefill_padding": (0, 4, 2, 2, 3, 32, 16, 32, 4,
                                     [5, 0, 37, 0], [2, 1, 2, 0], 1),
    "gqa_grouping": (2, 2, 1, 2, 4, 16, 8, 16, 2, [9, 2], [1, 1], 0),
    "one_head": (3, 2, 1, 1, 1, 32, 16, 8, 2, [20, 11], [1, 1], 1),
    "prefill_chunk": (5, 3, 4, 2, 4, 128, 16, 24, 6, [50, 0, 70], [1, 4, 3], 1),
}
# The JAX reference dequantizes in fp32 like the port's plain version:
# summation order only (fp32 2e-5; bf16 outputs one ulp of |out| < 1).
# The Pallas kernel rounds each scale and each dequantized K/V element to
# bf16 (2^-9 relative each) before its dots: each output row within 2^-6
# of its norm (readings up to 8.3e-3 on these cases).
INT8_REF_ATOL = {"float32": 2e-5, "bfloat16": 2.0 ** -8}
INT8_ROW_TOL = 2.0 ** -6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(INT8_CASES))
def test_int8_cache_matches_jax(case, dtype):
    seed, S, N, KV, G, D, ps, n_pages, B, seen, n_new, layer = INT8_CASES[case]
    q, codes, sc, bt, seen, lens = _int8_setup(seed, S, N, KV, G, D, ps,
                                               n_pages, B, seen, n_new)
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jargs = (jnp.asarray(q, jd), jnp.asarray(codes), layer, jnp.asarray(bt),
             jnp.asarray(seen), jnp.asarray(lens))
    out_kernel = np.asarray(jax_paged(*jargs, page_size=ps, interpret=True,
                                      cache_scales=jnp.asarray(sc)), np.float32)
    out_ref = np.asarray(jax_paged_ref(*jargs, page_size=ps,
                                       cache_scales=jnp.asarray(sc)), np.float32)
    out_t = paged_attention(torch.from_numpy(q).to(td), torch.from_numpy(codes),
                            layer, torch.from_numpy(bt), torch.from_numpy(seen),
                            torch.from_numpy(lens), page_size=ps,
                            cache_scales=torch.from_numpy(sc))
    assert out_t.dtype == td and tuple(out_t.shape) == q.shape
    out_t = out_t.float().numpy()
    np.testing.assert_allclose(out_t, out_ref, atol=INT8_REF_ATOL[dtype], rtol=0)
    assert row_rel_err(out_t, out_kernel) <= INT8_ROW_TOL
    if case == "mixed_decode_prefill_padding":
        assert not out_t[3].any()


@pytest.mark.parametrize("bad", ["missing", "dtype", "shape"])
def test_int8_cache_needs_its_scales(bad):
    q, codes, sc, bt, seen, lens = _int8_setup(*INT8_CASES["gqa_grouping"][:-1])
    scales = {"missing": None, "dtype": torch.from_numpy(sc).double(),
              "shape": torch.from_numpy(sc[:, :, :1]).contiguous()}[bad]
    with pytest.raises(ValueError, match="cache_scales"):
        paged_attention(torch.from_numpy(q), torch.from_numpy(codes), 0,
                        torch.from_numpy(bt), torch.from_numpy(seen),
                        torch.from_numpy(lens), page_size=8, cache_scales=scales)


# ---- sliding window ----

# (seed, S, N, KV, G, D, ps, n_pages, B, seen, n_new, layer, window), G 3,
# window 16 over 4-token pages: decode rows past the window, a prefill
# chunk straddling its edge, a mixed batch with padding
WINDOW_CASES = {
    "decode_past_window": (6, 3, 1, 2, 3, 16, 4, 40, 10, [20, 33, 7], [1, 1, 1], 1, 16),
    "chunk_straddles_edge": (7, 2, 8, 2, 3, 16, 4, 40, 10, [12, 30], [8, 6], 0, 16),
    "mixed_padding": (8, 4, 4, 2, 3, 32, 4, 48, 10, [25, 0, 14, 0], [1, 4, 4, 0], 1, 16),
}


def _freed(bt, seen, window, ps):
    """The table with the entries the engine has freed set to 0: blocks
    wholly below the window of each sequence's first query."""
    bt = bt.copy()
    for i, s in enumerate(seen):
        bt[i, :max(0, int(s) - window + 1) // ps] = 0
    return bt


@pytest.mark.parametrize("cache_type", ["float", "int8"])
@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_window_matches_jax(case, cache_type):
    """The window's mask (``key > q - window``) against the JAX kernel
    (interpret mode, which also skips pages older than the window) and its
    reference, with freed placeholders in the table. Tolerances as above:
    fp32 2e-5; an int8 cache within 2e-5 of the JAX reference and each row
    within 2^-6 of the JAX kernel, which rounds K/V to bf16."""
    seed, S, N, KV, G, D, ps, n_pages, B, seen, n_new, layer, window = WINDOW_CASES[case]
    if cache_type == "int8":
        q, cache, sc, bt, seen, lens = _int8_setup(seed, S, N, KV, G, D, ps,
                                                   n_pages, B, seen, n_new)
    else:
        q, cache, bt, seen, lens = _setup(np.random.default_rng(seed), S, N, KV,
                                          G, D, ps, n_pages, B, seen, n_new)
        sc = None
    bt = _freed(bt, seen, window, ps)
    jargs = (jnp.asarray(q), jnp.asarray(cache), layer, jnp.asarray(bt),
             jnp.asarray(seen), jnp.asarray(lens))
    jkw = dict(page_size=ps, window=window,
               cache_scales=None if sc is None else jnp.asarray(sc))
    out_kernel = np.asarray(jax_paged(*jargs, interpret=True, **jkw), np.float32)
    out_ref = np.asarray(jax_paged_ref(*jargs, **jkw), np.float32)
    out_t = paged_attention(torch.from_numpy(q), torch.from_numpy(cache), layer,
                            torch.from_numpy(bt), torch.from_numpy(seen),
                            torch.from_numpy(lens), page_size=ps, window=window,
                            cache_scales=None if sc is None else torch.from_numpy(sc))
    out_t = out_t.numpy()
    np.testing.assert_allclose(out_t, out_ref, atol=2e-5, rtol=0)
    if sc is None:
        np.testing.assert_allclose(out_t, out_kernel, atol=2e-5)
    else:
        assert row_rel_err(out_t, out_kernel) <= INT8_ROW_TOL
    glob = paged_attention(torch.from_numpy(q), torch.from_numpy(cache), layer,
                           torch.from_numpy(bt), torch.from_numpy(seen),
                           torch.from_numpy(lens), page_size=ps,
                           cache_scales=None if sc is None else torch.from_numpy(sc))
    assert np.abs(glob.numpy() - out_t).max() > 0.05  # the window masks keys


# ---- softcap (Gemma-2) at head_dim 256 ----

# (seed, S, N, KV, G, D, ps, n_pages, B, seen, n_new, layer, window): G 2
# at D 256, mixed decode, prefill and padding rows, without and with a
# window; the cap of 2 bites on N(0, 1) scores
SOFTCAP_CASES = {
    "d256_global": (30, 4, 3, 2, 2, 256, 8, 40, 8, [9, 0, 40, 0], [1, 3, 2, 0], 1, None),
    "d256_window": (31, 3, 2, 2, 2, 256, 8, 40, 10, [60, 5, 33], [1, 2, 2], 0, 20),
}


@pytest.mark.parametrize("cache", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("case", sorted(SOFTCAP_CASES))
def test_softcap_d256_matches_jax(case, cache):
    """The port's plain version with the softcap against the JAX reference
    and the JAX kernel (interpret mode): fp32 within 2e-5 of both; bf16
    one output rounding (2^-8 of |out| < 1) from the kernel; an int8 cache
    as its other cases (the reference within INT8_REF_ATOL, the kernel row
    by row within INT8_ROW_TOL)."""
    seed, S, N, KV, G, D, ps, n_pages, B, seen, n_new, layer, window = SOFTCAP_CASES[case]
    kw = dict(page_size=ps, window=window, softcap=2.0)
    if cache == "int8":
        q, codes, sc, bt, seen, lens = _int8_setup(seed, S, N, KV, G, D, ps, n_pages, B,
                                                   seen, n_new)
        jargs = (jnp.asarray(q), jnp.asarray(codes), layer, jnp.asarray(bt),
                 jnp.asarray(seen), jnp.asarray(lens))
        ref = np.asarray(jax_paged_ref(*jargs, cache_scales=jnp.asarray(sc), **kw))
        kern = np.asarray(jax_paged(*jargs, interpret=True, cache_scales=jnp.asarray(sc),
                                    **kw))
        out = paged_attention(torch.from_numpy(q), torch.from_numpy(codes), layer,
                              torch.from_numpy(bt), torch.from_numpy(seen),
                              torch.from_numpy(lens), cache_scales=torch.from_numpy(sc),
                              **kw).numpy()
        np.testing.assert_allclose(out, ref, atol=INT8_REF_ATOL["float32"], rtol=0)
        assert row_rel_err(out, kern) <= INT8_ROW_TOL
        return
    rng = np.random.default_rng(seed)
    q, cache_np, bt, seen, lens = _setup(rng, S, N, KV, G, D, ps, n_pages, B, seen, n_new)
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[cache]
    jargs = (jnp.asarray(q, jd), jnp.asarray(cache_np, jd), layer, jnp.asarray(bt),
             jnp.asarray(seen), jnp.asarray(lens))
    targs = (torch.from_numpy(q).to(td), torch.from_numpy(cache_np).to(td), layer,
             torch.from_numpy(bt), torch.from_numpy(seen), torch.from_numpy(lens))
    out = paged_attention(*targs, **kw)
    kern = np.asarray(jax_paged(*jargs, interpret=True, **kw), np.float32)
    assert out.dtype == td
    if cache == "float32":
        np.testing.assert_allclose(out.numpy(), np.asarray(jax_paged_ref(*jargs, **kw)),
                                   atol=2e-5, rtol=0)
        np.testing.assert_allclose(out.numpy(), kern, atol=2e-5, rtol=0)
        uncapped = paged_attention(*targs, **{**kw, "softcap": None})
        assert (uncapped - out).abs().max().item() > 1e-2  # the cap bites
    else:
        # the JAX kernel also rounds p to bf16 before P.V
        np.testing.assert_allclose(out.float().numpy(), kern, atol=3e-2, rtol=0)


# ---- multi-row tiles: the shapes of the kernel's wgmma path ----

# (seed, S, N, KV, G, D, ps, B, seen, n_new, layer, options): at least 64
# folded rows N * G per (sequence, KV head), the rows that take the CUDA
# kernel's wgmma tiles of 128 (and, for fp32 queries, its fp32 chunk
# kernel's tiles of 64): one full tile, a tile and a partial one,
# two tiles and a partial one; G 1 and 9, D 128 and 256, pages of 16 and
# 64; a window straddling the chunk with freed entries, ALiBi, the softcap
# and the int8 cache; a padding sequence beside a chunk
MULTI_ROW_CASES = {
    "g1_d128_one_tile_padding": (40, 2, 64, 2, 1, 128, 16, 6, [30, 0], [64, 0], 1, {}),
    "g9_d128_window_freed": (41, 2, 16, 1, 9, 128, 16, 8, [70, 5], [16, 9], 0,
                             {"window": 40}),
    "g1_d256_softcap_ps64": (42, 1, 130, 2, 1, 256, 64, 4, [100], [130], 1,
                             {"softcap": 5.0}),
    "g1_d128_alibi": (43, 2, 96, 2, 1, 128, 16, 10, [40, 12], [96, 50], 1,
                      {"use_alibi": True}),
    "g9_d128_int8_ps64": (44, 2, 30, 1, 9, 128, 64, 3, [60, 0], [30, 0], 0, {"int8": True}),
    "g9_d256_window_int8_softcap": (45, 1, 8, 1, 9, 256, 16, 8, [90], [8], 1,
                                    {"window": 24, "int8": True, "softcap": 5.0}),
    # the fp32-query chunk kernel's shapes: G 2 (Gemma-2's grouping), N >=
    # 32 tokens a sequence; the window with freed entries beside a padding
    # sequence, the softcap, ALiBi, an int8 cache, and all of them at once
    "g2_chunk_window_freed_padding": (60, 3, 40, 1, 2, 32, 8, 16, [60, 0, 20], [40, 0, 33],
                                      1, {"window": 24}),
    "g2_chunk_softcap": (61, 2, 36, 2, 2, 64, 16, 8, [50, 9], [36, 20], 0, {"softcap": 5.0}),
    "g2_chunk_alibi": (62, 2, 32, 2, 2, 32, 8, 12, [30, 61], [32, 32], 1, {"use_alibi": True}),
    "g2_chunk_int8": (63, 2, 48, 1, 2, 64, 16, 8, [70, 5], [48, 10], 0, {"int8": True}),
    "g2_chunk_int8_window_softcap_padding": (64, 2, 33, 2, 2, 32, 8, 16, [80, 0], [33, 0], 1,
                                             {"int8": True, "window": 40, "softcap": 5.0}),
}


def _multi_row_setup(case):
    seed, S, N, KV, G, D, ps, B, seen, n_new, layer, opts = MULTI_ROW_CASES[case]
    opts = dict(opts)
    int8 = opts.pop("int8", False)
    n_pages = S * B + 1
    if int8:
        q, cache, sc, bt, seen, lens = _int8_setup(seed, S, N, KV, G, D, ps, n_pages, B,
                                                   seen, n_new)
    else:
        q, cache, bt, seen, lens = _setup(np.random.default_rng(seed), S, N, KV, G, D, ps,
                                          n_pages, B, seen, n_new)
        sc = None
    if "window" in opts:
        bt = _freed(bt, seen, opts["window"], ps)
    for i, n in enumerate(n_new):
        if n == 0:
            bt[i] = 0  # a padding sequence: zero table, no keys
    return q, cache, sc, bt, seen, lens, layer, dict(page_size=ps, **opts)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(MULTI_ROW_CASES))
def test_multi_row_tiles_match_jax(case, dtype):
    """The port's plain version at the wgmma path's shapes against the JAX
    reference and the JAX kernel (interpret mode). fp32 within 2e-5 of both
    (an int8 cache: of the reference, and row by row within INT8_ROW_TOL of
    the kernel, which rounds K/V to bf16); bf16 queries and float cache 3e-2
    from the kernel (it rounds p to bf16 before P.V; outputs round to
    bf16), an int8 cache INT8_REF_ATOL from the reference and INT8_ROW_TOL
    from the kernel. A padding sequence gives zeros."""
    q, cache, sc, bt, seen, lens, layer, kw = _multi_row_setup(case)
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    int8 = sc is not None
    cd = (jnp.int8, torch.int8) if int8 else (jd, td)
    jargs = (jnp.asarray(q, jd), jnp.asarray(cache, cd[0]), layer, jnp.asarray(bt),
             jnp.asarray(seen), jnp.asarray(lens))
    jkw = dict(kw, cache_scales=None if sc is None else jnp.asarray(sc))
    out_kernel = np.asarray(jax_paged(*jargs, interpret=True, **jkw), np.float32)
    out_ref = np.asarray(jax_paged_ref(*jargs, **jkw), np.float32)
    out = paged_attention(torch.from_numpy(q).to(td), torch.from_numpy(cache).to(cd[1]),
                          layer, torch.from_numpy(bt), torch.from_numpy(seen),
                          torch.from_numpy(lens),
                          cache_scales=None if sc is None else torch.from_numpy(sc), **kw)
    assert out.dtype == td and tuple(out.shape) == q.shape
    out = out.float().numpy()
    if int8:
        np.testing.assert_allclose(out, out_ref, atol=INT8_REF_ATOL[dtype], rtol=0)
        assert row_rel_err(out, out_kernel) <= INT8_ROW_TOL
    elif dtype == "float32":
        np.testing.assert_allclose(out, out_ref, atol=2e-5, rtol=0)
        np.testing.assert_allclose(out, out_kernel, atol=2e-5, rtol=0)
    else:
        np.testing.assert_allclose(out, out_kernel, atol=3e-2, rtol=0)
    for i in np.flatnonzero(lens == 0):
        assert not out[i].any()


# ---- decode steps at the serving families' head layouts ----

# (seed, S, KV, G, D, ps, B, seen, layer, options): one new token per
# sequence (N 1) over a few pages, at the head layouts of Llama-3 (G 4),
# StarCoder2 (G 9, a window with freed entries), BLOOM (G 1, ALiBi) and
# Gemma-2 (G 2 at D 256, the softcap, without and with a window); the
# shapes of K4's decode kernel on the card
DECODE_CASES = {
    "llama_g4_d128": (70, 3, 2, 4, 128, 16, 4, [40, 17, 63], 1, {}),
    "starcoder2_g9_d128_window": (71, 3, 1, 9, 128, 16, 5, [70, 33, 9], 0, {"window": 24}),
    "bloom_g1_d128_alibi": (72, 3, 2, 1, 128, 16, 4, [50, 3, 63], 1, {"use_alibi": True}),
    "gemma2_g2_d256_softcap": (73, 2, 2, 2, 256, 16, 4, [60, 21], 1, {"softcap": 5.0}),
    "gemma2_g2_d256_softcap_window": (74, 2, 2, 2, 256, 16, 5, [75, 30], 0,
                                      {"softcap": 5.0, "window": 32}),
}


def _decode_setup(case, int8):
    seed, S, KV, G, D, ps, B, seen, layer, opts = DECODE_CASES[case]
    n_pages = S * B + 1
    if int8:
        q, cache, sc, bt, seen, lens = _int8_setup(seed, S, 1, KV, G, D, ps, n_pages, B, seen,
                                                   [1] * S)
    else:
        q, cache, bt, seen, lens = _setup(np.random.default_rng(seed), S, 1, KV, G, D, ps,
                                          n_pages, B, seen, [1] * S)
        sc = None
    if "window" in opts:
        bt = _freed(bt, seen, opts["window"], ps)
    return q, cache, sc, bt, seen, lens, layer, dict(page_size=ps, **opts)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cache_type", ["float", "int8"])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_matches_jax(case, cache_type, dtype):
    """The port's plain version on decode steps against the JAX kernel
    (interpret mode) and reference, with the tolerances above: fp32 within
    2e-5 of both; bf16 queries over a bf16 cache 3e-2 from the kernel (it
    rounds p to bf16 before P.V; outputs round to bf16); an int8 cache
    INT8_REF_ATOL from the reference and INT8_ROW_TOL from the kernel, row
    by row."""
    int8 = cache_type == "int8"
    q, cache, sc, bt, seen, lens, layer, kw = _decode_setup(case, int8)
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    cd = (jnp.int8, torch.int8) if int8 else (jd, td)
    jargs = (jnp.asarray(q, jd), jnp.asarray(cache, cd[0]), layer, jnp.asarray(bt),
             jnp.asarray(seen), jnp.asarray(lens))
    jkw = dict(kw, cache_scales=None if sc is None else jnp.asarray(sc))
    out_kernel = np.asarray(jax_paged(*jargs, interpret=True, **jkw), np.float32)
    out_ref = np.asarray(jax_paged_ref(*jargs, **jkw), np.float32)
    out = paged_attention(torch.from_numpy(q).to(td), torch.from_numpy(cache).to(cd[1]),
                          layer, torch.from_numpy(bt), torch.from_numpy(seen),
                          torch.from_numpy(lens),
                          cache_scales=None if sc is None else torch.from_numpy(sc), **kw)
    assert out.dtype == td and tuple(out.shape) == q.shape
    out = out.float().numpy()
    if int8:
        np.testing.assert_allclose(out, out_ref, atol=INT8_REF_ATOL[dtype], rtol=0)
        assert row_rel_err(out, out_kernel) <= INT8_ROW_TOL
    elif dtype == "float32":
        np.testing.assert_allclose(out, out_ref, atol=2e-5, rtol=0)
        np.testing.assert_allclose(out, out_kernel, atol=2e-5, rtol=0)
    else:
        np.testing.assert_allclose(out, out_kernel, atol=3e-2, rtol=0)


def _staged(codes, sc):
    """An int8 cache's K/V as the JAX kernel feeds its dots: bf16(code) *
    bf16(scale), rounded to bf16 (exact in fp32, then one rounding)."""
    L2, slots, KVD = codes.shape
    KV = sc.shape[-1]
    x = torch.from_numpy(codes).float().reshape(L2, slots, KV, KVD // KV) * \
        torch.from_numpy(sc).bfloat16().float()[..., None]
    return x.bfloat16().reshape(L2, slots, KVD)


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_round_p_follows_the_jax_kernel(case):
    """``round_p=True`` takes P against the same running max as the JAX
    kernel, page by page, and rounds it to bf16 before P.V as the kernel
    does, so for fp32 queries over an int8 cache's staged bf16 values
    nothing but summation order separates the two: 2e-5. The one softmax
    over the row (``round_p=False``) is farther off."""
    q, codes, sc, bt, seen, lens, layer, kw = _decode_setup(case, True)
    staged = _staged(codes, sc)
    out_kernel = np.asarray(jax_paged(
        jnp.asarray(q), jnp.asarray(staged.float().numpy()).astype(jnp.bfloat16), layer,
        jnp.asarray(bt), jnp.asarray(seen), jnp.asarray(lens), interpret=True, **kw))
    targs = (torch.from_numpy(q), staged, layer, torch.from_numpy(bt),
             torch.from_numpy(seen), torch.from_numpy(lens))
    rounded = paged_attention_reference(*targs, round_p=True, **kw).numpy()
    plain = paged_attention_reference(*targs, **kw).numpy()
    np.testing.assert_allclose(rounded, out_kernel, atol=2e-5, rtol=0)
    assert np.abs(plain - out_kernel).max() > np.abs(rounded - out_kernel).max()


@pytest.mark.parametrize("split_pages", [1, 2, 3])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_round_p_splits_merge_as_the_combine(case, split_pages):
    """``split_pages`` starts a running max at every ``split_pages`` pages
    from each sequence's first live page and merges the splits as the
    kernels' combine does. Over an fp32 cache P is not rounded, so any
    split gives the one softmax over the row (2e-5) and the flip bound is
    zero; over an int8 cache's staged bf16 values, a split as wide as the
    table is the unsplit walk bit for bit, and one page a split rounds P
    against other maxima."""
    q, cache, _, bt, seen, lens, layer, kw = _decode_setup(case, False)
    args = [torch.from_numpy(a) for a in (q, cache)] + [layer] + \
        [torch.from_numpy(a) for a in (bt, seen, lens)]
    split = paged_attention_reference(*args, round_p=True, split_pages=split_pages, **kw)
    np.testing.assert_allclose(split.numpy(), paged_attention_reference(*args, **kw).numpy(),
                               atol=2e-5, rtol=0)
    assert not round_p_flip_bound(*args, split_pages=split_pages, **kw).any()
    q, codes, sc, bt, seen, lens, layer, kw = _decode_setup(case, True)
    targs = (torch.from_numpy(q), _staged(codes, sc), layer, torch.from_numpy(bt),
             torch.from_numpy(seen), torch.from_numpy(lens))
    whole = paged_attention_reference(*targs, round_p=True, **kw)
    assert torch.equal(
        paged_attention_reference(*targs, round_p=True, split_pages=bt.shape[1], **kw), whole)
    if split_pages == 1:
        split = paged_attention_reference(*targs, round_p=True, split_pages=1, **kw)
        assert (split - whole).abs().max().item() > 2e-5


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_round_p_flip_bound_covers_summation_order(case):
    """Queries moved by a few fp32 ulps (2^-22 relative, about what another
    summation order moves a score by) move the ``round_p`` version over an
    int8 cache's staged values, one page a split, by no more than 2e-5 plus
    ``round_p_flip_bound`` element by element. The bound is zero where no P
    of the row lies near a bf16 rounding tie, so at most outputs the check
    still tells a rounded P from an fp32 one: ``round_p=False`` lies
    outside it at more than half of them."""
    q, codes, sc, bt, seen, lens, layer, kw = _decode_setup(case, True)
    rest = (_staged(codes, sc), layer, torch.from_numpy(bt), torch.from_numpy(seen),
            torch.from_numpy(lens))
    qt = torch.from_numpy(q)
    control = paged_attention_reference(qt, *rest, round_p=True, split_pages=1, **kw)
    bound = round_p_flip_bound(qt, *rest, split_pages=1, **kw)
    for seed in range(3):
        noise = np.random.default_rng(seed).uniform(-1, 1, size=q.shape).astype(np.float32)
        moved = paged_attention_reference(qt * (1 + 2.0 ** -22 * torch.from_numpy(noise)),
                                          *rest, round_p=True, split_pages=1, **kw)
        assert ((moved - control).abs() <= 2e-5 + bound).all()
    unrounded = paged_attention_reference(qt, *rest, **kw)
    assert ((unrounded - control).abs() > 2e-5 + bound).float().mean().item() > 0.5


# (case, split_pages): splits only without a window, whose first live page
# (where the splits start) differs between the two page sizes
TILE_KEYS_CASES = [(case, split) for case in sorted(DECODE_CASES)
                   for split in ((None, ) if "window" in DECODE_CASES[case][-1]
                                 else (None, 1, 2))]


@pytest.mark.parametrize("case,split_pages", TILE_KEYS_CASES)
def test_round_p_tile_keys_steps_as_pages_of_that_size(case, split_pages):
    """``tile_keys`` (a kernel's key tile) steps the ``round_p`` walk's
    running max once per that many keys instead of once per page: over an
    int8 cache's staged values, with pages laid out in contiguous pairs, a
    walk with tile_keys = 2 x page_size rounds every P as the page walk
    over pages twice as large does (the table and the splits halved
    alike), so the two differ by fp32 summation order alone (1e-6; a P
    rounded against another max moves an output by ~1e-3), and so do their
    flip bounds; tile_keys = page_size is the page walk itself."""
    q, codes, sc, bt, seen, lens, layer, kw = _decode_setup(case, True)
    ps = kw.pop("page_size")
    staged = _staged(codes, sc)
    S, B = bt.shape
    Bw = (B + 1) // 2
    wide = np.arange(S * Bw, dtype=np.int32).reshape(S, Bw)  # pages of 2 ps
    narrow = np.stack([2 * wide, 2 * wide + 1], -1).reshape(S, 2 * Bw).astype(np.int32)
    L2, slots, KVD = staged.shape
    cache = torch.zeros(L2, 2 * ps * S * Bw, KVD, dtype=staged.dtype)
    for s in range(S):  # sequence s's keys at the same positions under both tables
        keys = torch.arange(min(B * ps, 2 * ps * Bw))
        cache[:, torch.from_numpy(narrow[s]).long()[keys // ps] * ps + keys % ps] = \
            staged[:, torch.from_numpy(bt[s]).long()[(keys // ps).clamp(max=B - 1)] * ps
                   + keys % ps]
    t = [torch.from_numpy(a) for a in (q, seen, lens)]
    args_n = (t[0], cache, layer, torch.from_numpy(narrow), t[1], t[2])
    args_w = (t[0], cache, layer, torch.from_numpy(wide), t[1], t[2])
    split_w = None if split_pages is None else split_pages
    split_n = None if split_pages is None else 2 * split_pages
    tiled = paged_attention_reference(*args_n, page_size=ps, round_p=True, tile_keys=2 * ps,
                                      split_pages=split_n, **kw)
    paged = paged_attention_reference(*args_w, page_size=2 * ps, round_p=True,
                                      split_pages=split_w, **kw)
    torch.testing.assert_close(tiled, paged, atol=1e-6, rtol=0)
    torch.testing.assert_close(
        round_p_flip_bound(*args_n, page_size=ps, tile_keys=2 * ps, split_pages=split_n, **kw),
        round_p_flip_bound(*args_w, page_size=2 * ps, split_pages=split_w, **kw),
        atol=1e-6, rtol=0)
    assert torch.equal(
        paged_attention_reference(*args_n, page_size=ps, round_p=True, tile_keys=ps, **kw),
        paged_attention_reference(*args_n, page_size=ps, round_p=True, **kw))
