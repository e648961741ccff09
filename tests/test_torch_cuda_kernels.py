"""deepspeed_tpu_torch CUDA kernels against their plain PyTorch versions, on
a CUDA GPU. Every test skips without one.

This file imports neither ``jax`` nor ``deepspeed_tpu``, so it also runs on
a machine that has only PyTorch: ``python -m pytest --noconftest -q
tests/test_torch_cuda_kernels.py`` (``--noconftest`` because the suite's
conftest imports ``jax``)."""

import math

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.inference.v2.model import quantize_kv
from deepspeed_tpu_torch.models.llama import alibi_slopes
from deepspeed_tpu_torch.ops import attention_folded as ff
from deepspeed_tpu_torch.ops import fused_optimizer as fo
from deepspeed_tpu_torch.ops.attention import (
    attention_delta, flash_attention, flash_attention_bwd_dkdv,
    flash_attention_bwd_dkdv_reference, flash_attention_bwd_dq,
    flash_attention_bwd_dq_reference, flash_attention_bwd_reference, flash_attention_fwd,
    flash_attention_fwd_reference)
from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.ops.normalization import (
    layer_norm, layer_norm_reference, rms_norm, rms_norm_reference)
from deepspeed_tpu_torch.ops.paged_attention import (
    KERNEL_COUNTERS, KERNELS, f32_chunk_min_rows, kernel_plan, paged_attention,
    paged_attention_reference, round_p_flip_bound, run_kernel, wgmma_min_rows)
from deepspeed_tpu_torch.ops.quantizer import (
    dequantize_int8_blockwise, dequantize_int8_blockwise_reference,
    quantize_int8_blockwise, quantize_int8_blockwise_reference)
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as sc
from deepspeed_tpu_torch.ops.sparse_attention import (sparse_attention,
                                                      splash_sparse_attention)
from deepspeed_tpu_torch.ops.sparse_attention import splash as sp

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


# ---- K4 paged attention ----

# (seed, S, N, KV, G, D, page_size, n_pages, B, seen, n_new, layer): the
# cases of tests/unit/ops/test_paged_attention.py, then Llama-3-8B widths
# (KV 8, G 4, D 128, 64-token pages) at decode, mixed and prefill batches —
# the last one large enough that the kernel runs without a page split
PAGED = {
    "mixed_small": (0, 4, 2, 2, 3, 32, 16, 32, 4, [5, 0, 37, 0], [2, 1, 2, 0], 1),
    "layer_small": (1, 2, 1, 1, 2, 16, 8, 8, 2, [7, 3], [1, 1], 1),
    "gqa_small": (2, 2, 1, 2, 4, 16, 8, 16, 2, [9, 2], [1, 1], 0),
    "decode_8b": (3, 8, 1, 8, 4, 128, 64, 160, 17,
                  [150, 278, 406, 534, 662, 790, 918, 1046], [1] * 8, 1),
    "mixed_8b": (4, 8, 16, 8, 4, 128, 64, 160, 16,
                 [100, 250, 400, 550, 700, 999, 300, 0],
                 [1, 1, 1, 1, 1, 1, 16, 0], 0),
    "prefill_8b": (5, 4, 512, 8, 4, 128, 64, 64, 8, [0, 0, 40, 0],
                   [128, 256, 384, 0], 1),
}
# fp32: summation order only. bf16: both round the fp32 result once to
# bf16 (|out| < 1 here: at most one or two ulps of 2^-8)
PAGED_TOL = {torch.float32: 2e-5, torch.bfloat16: 1.6e-2}


def _paged_inputs(case, dtype, device):
    seed, S, N, KV, G, D, ps, n_pages, B, seen, n_new, layer = PAGED[case]
    rng = np.random.default_rng(seed)
    cache = torch.from_numpy(rng.normal(size=(2 * 2, n_pages * ps, KV * D))
                             .astype(np.float32)).to(device, dtype)
    q = torch.from_numpy(rng.normal(size=(S, N, KV * G, D))
                         .astype(np.float32)).to(device, dtype)
    bt = rng.permutation(n_pages)[:S * B].reshape(S, B).astype(np.int32)
    seen = np.asarray(seen, np.int32)
    lens = seen + np.asarray(n_new, np.int32)
    meta = [torch.from_numpy(a).to(device) for a in (bt, seen, lens)]
    return (q, cache, layer, *meta), ps


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(PAGED))
def test_paged_attention_kernel_matches_plain(case, dtype, cuda_device):
    args, ps = _paged_inputs(case, dtype, cuda_device)
    before = paged_attention.launches
    out_k = paged_attention(*args, page_size=ps)
    assert paged_attention.launches == before + 1
    out_r = paged_attention_reference(*args, page_size=ps)
    torch.cuda.synchronize()
    assert out_k.dtype == dtype and out_k.shape == args[0].shape
    torch.testing.assert_close(out_k.float(), out_r.float(),
                               atol=PAGED_TOL[dtype], rtol=0)


def int8_cache(cache, D):
    """An int8 cache as the engine's KV write makes it from ``cache``: one
    scale per (row, slot, head) vector of D, max(absmax / 127, 1e-8)."""
    L2, slots, KVD = cache.shape
    codes, sc = quantize_kv(cache.reshape(L2, slots, KVD // D, D))
    return codes.reshape(L2, slots, KVD), sc


def staged_cache(codes, scales, D):
    """What K4 stages from an int8 cache, the TPU kernel's numerics: the
    scale rounded to bf16, each product rounded to bf16 (exact in fp32)."""
    L2, slots, KVD = codes.shape
    x = codes.float().reshape(L2, slots, KVD // D, D) * \
        scales.bfloat16().float()[..., None]
    return x.bfloat16().reshape(L2, slots, KVD)


def rows_share(x, ref):
    """The largest ||x|| / ||ref|| over rows, a row's norm of ref floored at
    2^-10 of its RMS row norm (padding rows are 0 on both sides)."""
    x, ref = x.float().flatten(0, -2), ref.float().flatten(0, -2)
    den = ref.norm(dim=-1)
    den = den.clamp_min(2.0 ** -10 * den.square().mean().sqrt())
    return (x.norm(dim=-1) / den).max().item()


def rows_err(x, ref):
    """The largest ||x - ref|| / ||ref|| over rows (floored as rows_share)."""
    return rows_share(x.float() - ref.float(), ref)


def assert_within(x, ref, atol):
    """|x - ref| <= atol element by element (``atol`` a number or a tensor
    of x's shape)."""
    excess = ((x.float() - ref.float()).abs() - atol).max().item()
    assert excess <= 0, f"|x - ref| exceeds its tolerance by {excess} at most"


# int8 cache. The kernel stages each K/V element as the TPU kernel does,
# bf16(code) * bf16(scale) rounded to bf16, where the plain version
# dequantizes in fp32. Against the plain version on those staged values
# (the control) it differs by summation order only (PAGED_TOL). Against the
# plain version itself, row by row, one bf16 rounding of K and V is
# allowed: the control's own row error on the same inputs (up to 1.6e-2 on
# these cases, emulated on the CPU), plus one rounding of the output.
OUT_ROUNDING = {torch.float32: 2.0 ** -14, torch.bfloat16: 2.0 ** -8}


def int8_control(q, codes, scales, layer, bt, seen, lens, **kw):
    """The plain version on the staged bf16 K/V (the control) and what
    summation order may add to it through the kernel's rounding of P:
    (control, element-wise slack). bf16 queries: the plain version, no
    slack (their tolerances hold output roundings). fp32 queries: K4's
    fp32-query kernels round P to bf16 before P V as the JAX kernel does
    (over bf16-staged K/V), against the running max of their split, which
    steps once per key tile (the CUDA-core kernel's: per page), so the
    control is the ``round_p=True`` version that follows the kernel's page
    split and steps (``kernel_plan``; ``kernel`` names one, else the
    plan's). The two then differ by summation order, which reaches the
    output where it moves a P across a bf16 rounding tie: the slack is
    ``round_p_flip_bound`` (one bf16 ulp of each P that lies that near a
    tie, times |v|, over the row's sum)."""
    kernel = kw.pop("kernel", None)
    staged = staged_cache(codes, scales, q.shape[-1])
    if q.dtype != torch.float32:
        control = paged_attention_reference(q, staged, layer, bt, seen, lens, **kw)
        return control, torch.zeros(control.shape, device=control.device)
    _, pages, keys = kernel_plan(q, codes, bt, page_size=kw["page_size"],
                                 window=kw.get("window"), kernel=kernel)
    args = (q, staged, layer, bt, seen, lens)
    return (paged_attention_reference(*args, round_p=True, split_pages=pages, tile_keys=keys,
                                      **kw),
            round_p_flip_bound(*args, split_pages=pages, tile_keys=keys, **kw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(PAGED))
def test_paged_attention_int8_kernel_matches_plain(case, dtype, cuda_device):
    (q, cache, layer, bt, seen, lens), ps = _paged_inputs(case, dtype, cuda_device)
    D = q.shape[-1]
    codes, scales = int8_cache(cache, D)
    before = (paged_attention.launches, paged_attention.int8_launches)
    out_k = paged_attention(q, codes, layer, bt, seen, lens, page_size=ps,
                            cache_scales=scales)
    assert (paged_attention.launches, paged_attention.int8_launches) == \
        (before[0], before[1] + 1)
    out_r = paged_attention_reference(q, codes, layer, bt, seen, lens,
                                      page_size=ps, cache_scales=scales)
    control, slack = int8_control(q, codes, scales, layer, bt, seen, lens, page_size=ps)
    torch.cuda.synchronize()
    assert out_k.dtype == dtype and out_k.shape == q.shape
    assert_within(out_k, control, PAGED_TOL[dtype] + slack)
    assert rows_err(out_k, out_r) <= \
        rows_err(control, out_r) + OUT_ROUNDING[dtype] + rows_share(slack, out_r)


def test_paged_attention_refuses_what_the_kernel_does_not_take(cuda_device):
    args, ps = _paged_inputs("gqa_small", torch.float32, cuda_device)
    q, cache, layer, bt, seen, lens = args
    with pytest.raises(TypeError):
        paged_attention(q.half(), cache.half(), layer, bt, seen, lens, page_size=ps)
    with pytest.raises(ValueError):
        paged_attention(q, cache, layer, bt.long(), seen, lens, page_size=ps)
    with pytest.raises(ValueError):
        paged_attention(q.transpose(1, 2), cache, layer, bt, seen, lens, page_size=ps)
    with pytest.raises(ValueError):  # the softcap must be positive
        paged_attention(q, cache, layer, bt, seen, lens, page_size=ps, softcap=0.0)
    with pytest.raises(ValueError):
        paged_attention(q, cache, layer, bt, seen, lens, page_size=ps, window=0)
    codes, scales = int8_cache(cache, q.shape[-1])
    with pytest.raises(ValueError):  # an int8 cache needs its scales
        paged_attention(q, codes, layer, bt, seen, lens, page_size=ps)
    with pytest.raises(ValueError):  # fp32 [2L, slots, KV]
        paged_attention(q, codes, layer, bt, seen, lens, page_size=ps,
                        cache_scales=scales.half())
    with pytest.raises(ValueError):  # scales belong to an int8 cache
        paged_attention(q, cache, layer, bt, seen, lens, page_size=ps,
                        cache_scales=scales)
    wide = torch.zeros(*q.shape[:3], 264, device=cuda_device)  # head_dim > 256
    with pytest.raises(ValueError):
        paged_attention(wide, torch.zeros(4, cache.shape[1], 2 * 264, device=cuda_device),
                        layer, bt, seen, lens, page_size=ps)


# ---- K4 with a sliding window ----

# (seed, S, N, KV, G, D, page_size, B, seen, n_new, layer, window): G 3 at
# narrow widths (decode, a chunk, padding); then StarCoder2-7B's widths
# (H 36, KV 4, G 9, D 128, 64-token pages, window 4096): a decode step of 8
# sequences, most past the window, and a 768-row prefill chunk straddling
# the window's edge beside one wholly past it
PAGED_WINDOW = {
    "window_small": (6, 4, 3, 2, 3, 32, 16, 10, [5, 40, 120, 0], [2, 1, 3, 0], 1, 24),
    "window_decode_sc2": (7, 8, 1, 4, 9, 128, 64, 126,
                          [4200, 5000, 4500, 6000, 300, 4095, 4096, 8000], [1] * 8,
                          1, 4096),
    "window_chunk_sc2": (8, 2, 768, 4, 9, 128, 64, 84, [3700, 4608], [768, 512], 0, 4096),
}


def _window_inputs(case, dtype, device):
    """Random cache and queries; the block table holds distinct pages, and
    the entries of blocks wholly below the window of a sequence's first
    query hold 0, as the engine leaves them once it has freed them."""
    seed, S, N, KV, G, D, ps, B, seen, n_new, layer, window = PAGED_WINDOW[case]
    rng = np.random.default_rng(seed)
    n_pages = S * B + 1
    cache = torch.from_numpy(rng.normal(size=(2 * 2, n_pages * ps, KV * D))
                             .astype(np.float32)).to(device, dtype)
    q = torch.from_numpy(rng.normal(size=(S, N, KV * G, D))
                         .astype(np.float32)).to(device, dtype)
    bt = (1 + rng.permutation(S * B)).reshape(S, B).astype(np.int32)
    freed = [max(0, s - window + 1) // ps for s in seen]
    for i, f in enumerate(freed):
        bt[i, :f] = 0
    seen = np.asarray(seen, np.int32)
    lens = seen + np.asarray(n_new, np.int32)
    meta = [torch.from_numpy(a).to(device) for a in (bt, seen, lens)]
    return (q, cache, layer, *meta), ps, window, freed


@pytest.mark.parametrize("int8", [False, True], ids=["float_cache", "int8_cache"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(PAGED_WINDOW))
def test_paged_attention_window_kernel_matches_plain(case, dtype, int8, cuda_device):
    """The window's mask and page skip against the plain version's mask,
    with the tolerances of the global cases. Then the freed entries point
    far past the cache: the kernel must read none of them (an out-of-range
    page would fault), and gives the same output bit for bit."""
    (q, cache, layer, bt, seen, lens), ps, window, freed = _window_inputs(
        case, dtype, cuda_device)
    kw = {}
    if int8:
        cache, kw["cache_scales"] = int8_cache(cache, q.shape[-1])
    counter = "int8_launches" if int8 else "launches"
    before = getattr(paged_attention, counter)
    out_k = paged_attention(q, cache, layer, bt, seen, lens, page_size=ps,
                            window=window, **kw)
    assert getattr(paged_attention, counter) == before + 1
    out_r = paged_attention_reference(q, cache, layer, bt, seen, lens, page_size=ps,
                                      window=window, **kw)
    global_r = paged_attention_reference(q, cache, layer, bt, seen, lens,
                                         page_size=ps, **kw)
    far = bt.clone()
    for i, f in enumerate(freed):
        far[i, :f] = 1 << 30
    out_far = paged_attention(q, cache, layer, far, seen, lens, page_size=ps,
                              window=window, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out_far, out_k)
    assert (out_r.float() - global_r.float()).abs().max().item() > 0.05  # the mask bites
    if int8:
        control, slack = int8_control(q, cache, kw["cache_scales"], layer, bt, seen, lens,
                                      page_size=ps, window=window)
        assert_within(out_k, control, PAGED_TOL[dtype] + slack)
        assert rows_err(out_k, out_r) <= \
            rows_err(control, out_r) + OUT_ROUNDING[dtype] + rows_share(slack, out_r)
    else:
        torch.testing.assert_close(out_k.float(), out_r.float(),
                                   atol=PAGED_TOL[dtype], rtol=0)


# ---- K6 quantizer and the dequantize helper ----

# Llama-3-8B's layer kernels, a ragged tail (numel not a multiple of 512)
# and a small one with an all-zero block
QUANT_SHAPES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
                (4103, ), (37, 100)]


def _quant_input(shape, dtype, device):
    x = torch.from_numpy(np.random.default_rng(len(shape) + shape[0]).normal(
        size=shape).astype(np.float32)).to(device, dtype)
    x.view(-1)[512:1024] = 0  # an all-zero block: scale 1
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", QUANT_SHAPES)
def test_quantize_kernel_equals_plain(shape, dtype, cuda_device):
    """IEEE division and round-half-to-even on both sides: bit for bit."""
    x = _quant_input(shape, dtype, cuda_device)
    before = quantize_int8_blockwise.launches
    v, s = quantize_int8_blockwise(x, 512)
    assert quantize_int8_blockwise.launches == before + 1
    v_ref, s_ref = quantize_int8_blockwise_reference(x, 512)
    torch.cuda.synchronize()
    assert v.dtype == torch.int8 and v.shape == v_ref.shape
    assert torch.equal(v, v_ref)
    assert torch.equal(s.view(torch.int32), s_ref.view(torch.int32))
    assert s[1].item() == 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4096, 14336), (4103, ), (37, 100), (3, 5)])
def test_dequantize_kernel_equals_plain(shape, dtype, cuda_device):
    """fp32 product, one rounding to the dtype: bit for bit. (4103,), (37,
    100) and (3, 5) take the one-element-per-thread kernel."""
    x = _quant_input(shape, torch.bfloat16, cuda_device) if shape[0] > 512 else \
        torch.randn(shape, device=cuda_device)
    v, s = quantize_int8_blockwise_reference(x, 512)
    before = dequantize_int8_blockwise.launches
    out = torch.empty(shape, dtype=dtype, device=cuda_device)
    got = dequantize_int8_blockwise(v, s, shape, 512, dtype=dtype, out=out)
    assert got is out and dequantize_int8_blockwise.launches == before + 1
    ref = dequantize_int8_blockwise_reference(v, s, shape, 512, dtype)
    torch.cuda.synchronize()
    assert torch.equal(got.view(-1).view(torch.uint8), ref.view(-1).view(torch.uint8))


def test_quantizer_refuses_what_the_kernel_does_not_take(cuda_device):
    x = torch.randn(64, 64, device=cuda_device)
    with pytest.raises(TypeError):
        quantize_int8_blockwise(x.half(), 512)
    with pytest.raises(ValueError):
        quantize_int8_blockwise(x.t(), 512)
    v, s = quantize_int8_blockwise(x, 512)
    with pytest.raises(ValueError):  # more elements than the values hold
        dequantize_int8_blockwise(v, s, (65, 64), 512)
    with pytest.raises(TypeError):
        dequantize_int8_blockwise(v, s, (64, 64), 512, dtype=torch.half)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block", [512, 2048, 1000, 64])
@pytest.mark.parametrize("shape", [(4096, 1024), (4103, ), (37, 100), (3, 5)])
def test_quantize_kernel_blocks_equal_plain(shape, block, dtype, cuda_device):
    """The register kernel at blocks 512 and 2048 (its last block ragged
    where numel is not a multiple: zeros past n), the element kernel at
    1000 and 64; fp32 and bf16; an all-zero block where the shape holds
    one: bit for bit."""
    x = _quant_input(shape, dtype, cuda_device) if math.prod(shape) > 1024 else \
        torch.randn(shape, device=cuda_device).to(dtype)
    before = quantize_int8_blockwise.launches
    v, s = quantize_int8_blockwise(x, block)
    assert quantize_int8_blockwise.launches == before + 1
    v_ref, s_ref = quantize_int8_blockwise_reference(x, block)
    torch.cuda.synchronize()
    assert v.shape == v_ref.shape and s.shape == s_ref.shape
    assert torch.equal(v, v_ref)
    assert torch.equal(s.view(torch.int32), s_ref.view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block", [512, 2048])
def test_quantize_unaligned_view_equals_plain(block, dtype, cuda_device):
    """A contiguous view one element past a 16-byte boundary takes the
    element kernel: bit for bit; the zero blocks' scales are 1."""
    flat = torch.randn(4 * 4096 + 1, device=cuda_device).to(dtype)
    x = flat[1:].view(4, 4096)
    x.view(-1)[:2048] = 0
    v, s = quantize_int8_blockwise(x, block)
    v_ref, s_ref = quantize_int8_blockwise_reference(x, block)
    torch.cuda.synchronize()
    assert torch.equal(v, v_ref)
    assert torch.equal(s.view(torch.int32), s_ref.view(torch.int32))
    assert s[0].item() == 1.0


# ---- K5b LayerNorm ----

# fp32: summation order only, and for the row of mean 300 a few ulps of
# 300 in its fp32 mean (2^-23 relative each), which move every centred
# value of that row; bf16: both round the fp32 result once
LN_SHIFT = 300.0
LN_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5 + 2.0 ** -21 * LN_SHIFT),
          torch.bfloat16: dict(rtol=2.0 ** -7, atol=1e-2)}


@pytest.mark.parametrize("dtype", sorted(LN_TOL, key=str))
@pytest.mark.parametrize("shape", [(8, 4608), (768, 4608), (37, 100), (3, 7),
                                   (2, 5, 256), (4, 10000)])
def test_layer_norm_kernel_matches_plain(shape, dtype, cuda_device):
    """StarCoder2's rows (4608: all in registers), odd widths (the scalar
    tail alone) and a row wider than the registers hold (registers, then
    the scalar tail); one row with a mean
    of 300 and a spread of 1, which E[x^2] - E[x]^2 would cancel."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=shape).astype(np.float32)
    x.reshape(-1, shape[-1])[0] += LN_SHIFT
    x = torch.from_numpy(x).to(cuda_device, dtype)
    w = torch.from_numpy((1 + 0.1 * rng.normal(size=shape[-1:])).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.normal(size=shape[-1:])).astype(np.float32))
    w, b = w.to(cuda_device, dtype), b.to(cuda_device, dtype)
    before = layer_norm.launches
    out_k = layer_norm(x, w, b, 1e-5)
    assert layer_norm.launches == before + 1
    assert out_k.dtype == dtype and out_k.shape == x.shape
    torch.testing.assert_close(out_k.float(), layer_norm_reference(x, w, b, 1e-5).float(),
                               **LN_TOL[dtype])


def test_layer_norm_refuses_what_the_kernel_does_not_take(cuda_device):
    x = torch.randn(4, 256, device=cuda_device, dtype=torch.bfloat16)
    ones = torch.ones(256, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(TypeError):  # bias dtype differs from x's
        layer_norm(x, ones, torch.zeros(256, device=cuda_device))
    with pytest.raises(TypeError):
        layer_norm(x.half(), ones.half(), ones.half())
    with pytest.raises(ValueError):
        layer_norm(x, ones, ones[:128])
    with pytest.raises(ValueError):
        layer_norm(x.t(), ones[:4], ones[:4])
    with pytest.raises(ValueError):
        layer_norm(x, ones.cpu(), ones)


def test_layer_norm_unaligned_view_takes_scalar_path(cuda_device):
    flat = torch.randn(4 * 4608 + 1, device=cuda_device, dtype=torch.bfloat16)
    x = flat[1:].view(4, 4608)  # contiguous, 2 bytes past a 16-byte boundary
    w = torch.full((4608, ), 1.5, device=cuda_device, dtype=torch.bfloat16)
    b = torch.full((4608, ), 0.25, device=cuda_device, dtype=torch.bfloat16)
    torch.testing.assert_close(layer_norm(x, w, b).float(),
                               layer_norm_reference(x, w, b).float(),
                               **LN_TOL[torch.bfloat16])


# ---- K5 RMSNorm ----

RMS_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6),
           torch.bfloat16: dict(rtol=2.0 ** -7, atol=1e-6)}


@pytest.mark.parametrize("dtype", sorted(RMS_TOL, key=str))
@pytest.mark.parametrize("shape", [(8, 4096), (768, 4096), (37, 100), (3, 7),
                                   (2, 5, 256)])
def test_rms_norm_kernel_matches_plain(shape, dtype, cuda_device):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda_device, dtype)
    w = torch.from_numpy((1 + 0.1 * rng.normal(size=shape[-1:])).astype(np.float32))
    w = w.to(cuda_device, dtype)  # the model dtype, as the engine holds it
    before = rms_norm.launches
    out_k = rms_norm(x, w, 1e-5)
    assert rms_norm.launches == before + 1
    torch.testing.assert_close(out_k.float(), rms_norm_reference(x, w, 1e-5).float(),
                               **RMS_TOL[dtype])


def test_rms_norm_refuses_what_the_kernel_does_not_take(cuda_device):
    x = torch.randn(4, 256, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(TypeError):  # a bf16 weight beside an fp32 x
        rms_norm(x.float(), torch.ones(256, device=cuda_device, dtype=torch.bfloat16))
    with pytest.raises(TypeError):  # fp16 is not a dtype of the port
        rms_norm(x.half(), torch.ones(256, device=cuda_device, dtype=torch.half))
    with pytest.raises(ValueError):
        rms_norm(x, torch.ones(128, device=cuda_device, dtype=torch.bfloat16))


def test_rms_norm_unaligned_view_takes_scalar_path(cuda_device):
    flat = torch.randn(4 * 4096 + 1, device=cuda_device, dtype=torch.bfloat16)
    x = flat[1:].view(4, 4096)  # contiguous, 2 bytes past a 16-byte boundary
    w = torch.ones(4096, device=cuda_device, dtype=torch.bfloat16)
    torch.testing.assert_close(rms_norm(x, w).float(),
                               rms_norm_reference(x, w).float(),
                               **RMS_TOL[torch.bfloat16])


# ---- K5/K5b: the row-norm kernel's plan and both weight placements ----

# (x dtype, weight dtype): bf16 and fp32 rows, and bf16 rows with the fp32
# scale (Gemma's 1 + w)
ROW_NORM_TYPES = {"bfloat16": (torch.bfloat16, torch.bfloat16),
                  "float32": (torch.float32, torch.float32),
                  "fp32_scale": (torch.bfloat16, torch.float32)}
# the entry points' weight loads: the kernel's plan, or forced before or
# after the statistic
ROW_NORM_LOADS = {"plan": -1, "early": 0, "late": 1}


def _row_norm_inputs(rows, d, dtypes, device, ln, seed=0):
    """Rows of N(0, 1) (for LayerNorm plus a per-row mean up to 3), the
    weight 1 + N(0, 0.1) (the fp32 scale 1 + N(0, 1e-3)), the bias N(0,
    0.1)."""
    rng = np.random.default_rng(seed)
    dtype, w_dtype = dtypes
    x = rng.normal(size=(rows, d)).astype(np.float32)
    if ln:
        x += 3 * rng.random(size=(rows, 1)).astype(np.float32)
    spread = 1e-3 if w_dtype != dtype else 0.1
    w = (1 + spread * rng.normal(size=d)).astype(np.float32)
    b = (0.1 * rng.normal(size=d)).astype(np.float32)
    return (torch.from_numpy(x).to(device, dtype), torch.from_numpy(w).to(device, w_dtype),
            torch.from_numpy(b).to(device, w_dtype))


def _row_norm(x, w, b, eps, loads):
    """One row norm (LayerNorm where ``b`` is given): the plan's through the
    wrapper, which counts it; forced weight loads through the C entry
    point."""
    if loads == "plan":
        return layer_norm(x, w, b, eps) if b is not None else rms_norm(x, w, eps)
    lib, out = _build.lib(), torch.empty_like(x)
    args = (x.shape[0], x.shape[1], eps, _build.dtype_code(x.dtype))
    stream = torch.cuda.current_stream().cuda_stream
    if b is not None:
        err = lib.dstt_layer_norm(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                                  *args, ROW_NORM_LOADS[loads], stream)
    else:
        err = lib.dstt_rms_norm(x.data_ptr(), w.data_ptr(), out.data_ptr(), *args,
                                _build.dtype_code(w.dtype), ROW_NORM_LOADS[loads], stream)
    _build.check(err, "row norm")
    return out


@pytest.mark.parametrize("loads", sorted(ROW_NORM_LOADS))
@pytest.mark.parametrize("types", sorted(ROW_NORM_TYPES))
@pytest.mark.parametrize("d", [100, 3584, 4096, 4608, 8192, 16384])
@pytest.mark.parametrize("rows", [1, 8, 37, 768, 769])
def test_rms_norm_matches_plain(rows, d, types, loads, cuda_device):
    """The plan's kernel (early weights below 256 rows, late from 256 for
    bf16 rows) and both weight placements forced, at decode, odd and
    prefill row counts and the models' widths (100: one vector a lane in
    fp32, the scalar kernel in bf16; 16384 bf16 and 8192, 16384 fp32: past 4
    vectors a lane, the scalar kernel), against the plain version at
    RMS_TOL; the plan's launch counted once in the weight's counter."""
    x, w, _ = _row_norm_inputs(rows, d, ROW_NORM_TYPES[types], cuda_device, False)
    counter = "fp32_scale_launches" if types == "fp32_scale" else "launches"
    before = getattr(rms_norm, counter)
    out = _row_norm(x, w, None, 1e-6, loads)
    assert getattr(rms_norm, counter) == before + (loads == "plan")
    assert out.dtype == x.dtype and out.shape == x.shape
    torch.testing.assert_close(out.float(), rms_norm_reference(x, w, 1e-6).float(),
                               **RMS_TOL[x.dtype])


@pytest.mark.parametrize("loads", sorted(ROW_NORM_LOADS))
@pytest.mark.parametrize("types", ["bfloat16", "float32"])
@pytest.mark.parametrize("d", [100, 3584, 4096, 4608, 8192, 16384])
@pytest.mark.parametrize("rows", [1, 8, 37, 768, 769])
def test_layer_norm_matches_plain(rows, d, types, loads, cuda_device):
    """As the RMSNorm cases, for LayerNorm at LN_TOL; rows with means up
    to 3 (centred from registers)."""
    x, w, b = _row_norm_inputs(rows, d, ROW_NORM_TYPES[types], cuda_device, True)
    before = layer_norm.launches
    out = _row_norm(x, w, b, 1e-5, loads)
    assert layer_norm.launches == before + (loads == "plan")
    torch.testing.assert_close(out.float(), layer_norm_reference(x, w, b, 1e-5).float(),
                               **LN_TOL[x.dtype])


@pytest.mark.parametrize("types", sorted(ROW_NORM_TYPES))
@pytest.mark.parametrize("ln", [False, True], ids=["rms", "ln"])
def test_row_norm_unaligned_view_takes_scalar_kernel(ln, types, cuda_device):
    """A contiguous view one element past a 16-byte boundary: the scalar
    kernel, against the plain version."""
    if ln and types == "fp32_scale":
        pytest.skip("LayerNorm takes w and b in x's dtype")
    dtype, w_dtype = ROW_NORM_TYPES[types]
    d = 4608 if ln else 3584
    x0, w, b = _row_norm_inputs(8, d, (dtype, w_dtype), cuda_device, ln)
    flat = torch.empty(8 * d + 1, device=cuda_device, dtype=dtype)
    x = flat[1:].view(8, d)
    x.copy_(x0)
    if ln:
        torch.testing.assert_close(layer_norm(x, w, b).float(),
                                   layer_norm_reference(x, w, b).float(), **LN_TOL[dtype])
    else:
        torch.testing.assert_close(rms_norm(x, w).float(), rms_norm_reference(x, w).float(),
                                   **RMS_TOL[dtype])


def test_row_norm_entry_refuses_bad_arguments(cuda_device):
    """The C entry points launch nothing on arguments they cannot run:
    weight loads other than -1, 0 or 1, no rows, no width, an fp32 x with
    a bf16 weight, an fp16 x."""
    lib = _build.lib()
    x = torch.randn(8, 4096, device=cuda_device, dtype=torch.bfloat16)
    w16 = torch.ones(4096, device=cuda_device, dtype=torch.bfloat16)
    out = torch.zeros_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    bf16, fp32 = _build.dtype_code(torch.bfloat16), _build.dtype_code(torch.float32)
    fp16 = _build.dtype_code(torch.float16)

    def rms(rows=8, d=4096, dtype=bf16, w_dtype=bf16, loads=-1):
        return lib.dstt_rms_norm(x.data_ptr(), w16.data_ptr(), out.data_ptr(), rows, d, 1e-6,
                                 dtype, w_dtype, loads, stream)
    assert rms(loads=2) != 0 and rms(loads=-2) != 0
    assert rms(rows=0) != 0 and rms(d=0) != 0
    assert rms(dtype=fp32, w_dtype=bf16) != 0 and rms(dtype=fp16, w_dtype=fp16) != 0
    assert lib.dstt_layer_norm(x.data_ptr(), w16.data_ptr(), w16.data_ptr(), out.data_ptr(),
                               8, 4096, 1e-5, bf16, 3, stream) != 0
    torch.cuda.synchronize()
    assert not out.any()
    assert rms() == 0
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), rms_norm_reference(x, w16, 1e-6).float(),
                               **RMS_TOL[torch.bfloat16])


# ---- K1/K2 flash attention (forward, dq pass, dk/dv pass) ----

# (B, S, H, KV, D, causal, dtype): the CPU tests' shapes in fp32 (G 1, 2,
# 4; S not a multiple of the 64-row tile; D 16..128), then bf16 at the
# training path's Llama-3-8B widths (H 32, KV 8, D 128): the main shape,
# a ragged S, and no causal mask
FLASH = {
    "g1_causal": (1, 64, 2, 2, 16, True, torch.float32),
    "g2_causal_s100": (2, 100, 4, 2, 32, True, torch.float32),
    "g4_causal_s80": (1, 80, 8, 2, 16, True, torch.float32),
    "g4_full_s100": (1, 100, 4, 1, 16, False, torch.float32),
    "d128_causal_s130": (1, 130, 4, 1, 128, True, torch.float32),
    "d64_full_s200": (1, 200, 4, 2, 64, False, torch.float32),
    "bf16_small": (2, 100, 4, 2, 32, True, torch.bfloat16),
    "bf16_8b_main": (2, 2048, 32, 8, 128, True, torch.bfloat16),
    "bf16_8b_s1000": (1, 1000, 32, 8, 128, True, torch.bfloat16),
    "bf16_8b_full": (1, 1000, 32, 8, 128, False, torch.bfloat16),
    "fp16_small": (2, 100, 4, 2, 32, True, torch.float16),
    "fp16_8b_main": (2, 2048, 32, 8, 128, True, torch.float16),
}


# the largest error of any row (a head's D values at one position),
# ||kernel - plain|| / ||plain||. fp32: the kernel's products sum in
# another order than the plain einsum. bf16: both round P (or dS) to bf16
# before its product and the output once, at other points (the kernel
# rounds P before dividing by the row sum): a few roundings of 2^-8 (bf16's
# unit roundoff) each; at the main shape the largest reading is 5.4e-3 and
# one bf16 rounding of the exact value gives 2.3e-3 (chip_smoke.py)
# fp16: the same roundings at fp16's unit roundoff, 2^-11: 2^-8
ROW_TOL = {torch.float32: 2.0 ** -14, torch.bfloat16: 2.0 ** -6, torch.float16: 2.0 ** -8}
# A row whose exact value cancels to ~0 (dq of a query that sees only its
# own key) carries the fp32 noise of that cancellation, 1.4e-6 of the RMS
# row norm on the H100: every row is allowed 2^-16 of the RMS row norm
ROW_FLOOR = 2.0 ** -16


def assert_rows_close(x, ref, msg=""):
    """Each row within ROW_TOL of its norm, or within ROW_FLOOR of the RMS
    row norm where that is larger."""
    assert x.dtype == ref.dtype and x.shape == ref.shape, msg
    xf, rf = x.float().flatten(0, -2), ref.float().flatten(0, -2)
    tol = ROW_TOL[ref.dtype]
    den = rf.norm(dim=-1)
    den = den.clamp_min(ROW_FLOOR / tol * den.square().mean().sqrt())
    err = ((xf - rf).norm(dim=-1) / den).max().item()
    assert err <= tol, f"{msg}: largest row error {err:.3g}"


def _flash_inputs(case, device):
    B, S, H, KV, D, causal, dtype = FLASH[case]
    rng = np.random.default_rng(sorted(FLASH).index(case))
    q, k, v, do = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                   .to(device, dtype) for shape in (
                       (B, S, H, D), (B, S, KV, D), (B, S, KV, D), (B, S, H, D)))
    return q, k, v, do, causal, dtype


@pytest.mark.parametrize("case", sorted(FLASH))
def test_flash_kernels_match_plain(case, cuda_device):
    q, k, v, do, causal, dtype = _flash_inputs(case, cuda_device)
    before = [f.launches for f in (flash_attention_fwd, flash_attention_bwd_dq,
                                   flash_attention_bwd_dkdv)]
    o, lse = flash_attention_fwd(q, k, v, causal)
    o_ref, lse_ref = flash_attention_fwd_reference(q, k, v, causal)
    torch.cuda.synchronize()
    assert_rows_close(o, o_ref, "o")
    # lse is fp32 in both: the scores' summation order only
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    # the backward passes take the plain forward's o and lse, so each is
    # held to its plain version on identical inputs
    delta = attention_delta(o_ref, do)
    dq = flash_attention_bwd_dq(q, k, v, do, lse_ref, delta, causal)
    dk, dv = flash_attention_bwd_dkdv(q, k, v, do, lse_ref, delta, causal)
    grads_ref = flash_attention_bwd_reference(q, k, v, o_ref, lse_ref, do, causal)
    torch.cuda.synchronize()
    for name, g, g_ref in zip("qkv", (dq, dk, dv), grads_ref):
        assert g.dtype == dtype
        assert_rows_close(g, g_ref, f"d{name}")
    assert [f.launches for f in (flash_attention_fwd, flash_attention_bwd_dq,
                                 flash_attention_bwd_dkdv)] == [b + 1 for b in before]


def test_flash_autograd_launches_all_three_kernels(cuda_device):
    q, k, v, do, causal, dtype = _flash_inputs("g2_causal_s100", cuda_device)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = [f.launches for f in (flash_attention_fwd, flash_attention_bwd_dq,
                                   flash_attention_bwd_dkdv)]
    out = flash_attention(*leaves, causal=causal)
    out.backward(do)
    assert [f.launches for f in (flash_attention_fwd, flash_attention_bwd_dq,
                                 flash_attention_bwd_dkdv)] == [b + 1 for b in before]
    o_ref, lse_ref = flash_attention_fwd_reference(q, k, v, causal)
    grads_ref = flash_attention_bwd_reference(q, k, v, o_ref, lse_ref, do, causal)
    assert_rows_close(out.detach(), o_ref, "o")
    for name, t, g_ref in zip("qkv", leaves, grads_ref):
        assert_rows_close(t.grad, g_ref, f"d{name}")


def test_flash_refuses_what_the_kernel_does_not_take(cuda_device):
    q, k, v, do, causal, _ = _flash_inputs("g1_causal", cuda_device)
    with pytest.raises(TypeError):
        flash_attention_fwd(q.double(), k.double(), v.double(), causal)
    with pytest.raises(ValueError):  # head_dim not a multiple of 8
        flash_attention_fwd(q[..., :12].contiguous(), k[..., :12].contiguous(),
                            v[..., :12].contiguous(), causal)
    with pytest.raises(ValueError):
        flash_attention_fwd(q.transpose(1, 2), k, v, causal)
    o, lse = flash_attention_fwd(q, k, v, causal)
    with pytest.raises(ValueError):  # lse must be fp32 [B, S, H]
        flash_attention_bwd_dq(q, k, v, do, lse.double(), lse, causal)


# ---- K1/K2 with window and softcap, K3 (the folded layout), the route ----

# (B, S, H, KV, D, causal, window, softcap, dtype): windows smaller than a
# 64-key tile, not a multiple of it, and covering the sequence; the softcap
# alone and with a window; a window without the causal mask; then bf16 at
# the smoke's main-path shapes (Llama-3-8B with softcap 50, Mistral's S
# 8192 with its 4096 window)
FLASH_OPTIONS = {
    "w16_s128": (1, 128, 4, 2, 32, True, 16, None, torch.float32),
    "w100_s300": (2, 300, 8, 2, 64, True, 100, None, torch.float32),
    "w500_s200": (1, 200, 4, 4, 128, True, 500, None, torch.float32),
    "softcap_s190": (1, 190, 4, 1, 64, True, None, 5.0, torch.float32),
    "w64_softcap_s333": (1, 333, 6, 3, 64, True, 64, 7.0, torch.float32),
    "w70_full_s256": (1, 256, 4, 4, 32, False, 70, 20.0, torch.float32),
    "bf16_w48_s200": (1, 200, 8, 2, 64, True, 48, None, torch.bfloat16),
    "fp16_w64_softcap": (1, 333, 6, 3, 64, True, 64, 7.0, torch.float16),
    "bf16_8b_softcap": (2, 2048, 32, 8, 128, True, None, 50.0, torch.bfloat16),
    "bf16_mistral": (1, 8192, 32, 8, 128, True, 4096, None, torch.bfloat16),
}


def _option_inputs(case, device):
    B, S, H, KV, D, causal, window, softcap, dtype = FLASH_OPTIONS[case]
    rng = np.random.default_rng(200 + sorted(FLASH_OPTIONS).index(case))
    q, k, v, do = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                   .to(device, dtype) for shape in (
                       (B, S, H, D), (B, S, KV, D), (B, S, KV, D), (B, S, H, D)))
    return (q, k, v, do), dict(causal=causal, window=window, softcap=softcap)


@pytest.mark.parametrize("layout", ["per_head", "folded"])
@pytest.mark.parametrize("case", sorted(FLASH_OPTIONS))
def test_flash_options_kernels_match_plain(case, layout, cuda_device):
    """K1/K2 (per head) and K3 (folded) with the window and softcap against
    the plain versions on the same inputs; ROW_TOL as above."""
    (q, k, v, do), opts = _option_inputs(case, cuda_device)
    kernels = ((flash_attention_fwd, flash_attention_bwd_dq, flash_attention_bwd_dkdv)
               if layout == "per_head" else
               (ff.folded_attention_fwd, ff.folded_attention_bwd_dq,
                ff.folded_attention_bwd_dkdv))
    before = [f.launches for f in kernels]
    o, lse = kernels[0](q, k, v, **opts)
    o_ref, lse_ref = flash_attention_fwd_reference(q, k, v, **opts)
    torch.cuda.synchronize()
    assert_rows_close(o, o_ref, "o")
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    delta = attention_delta(o_ref, do)
    args = (q, k, v, do, lse_ref, delta)
    dq = kernels[1](*args, **opts)
    dk, dv = kernels[2](*args, **opts)
    grads_ref = flash_attention_bwd_reference(q, k, v, o_ref, lse_ref, do, **opts)
    torch.cuda.synchronize()
    for name, g, g_ref in zip("qkv", (dq, dk, dv), grads_ref):
        assert_rows_close(g, g_ref, f"d{name}")
    assert [f.launches for f in kernels] == [b + 1 for b in before]


def test_folded_equals_per_head_kernels(cuda_device):
    """K3 launches K1/K2's kernels: the same bits on the same inputs."""
    _folded_equals_per_head("w64_softcap_s333", cuda_device)


def test_folded_equals_per_head_kernels_d256(cuda_device):
    """As above at head_dim 256 (the wgmma backward's 256-wide instances)."""
    _folded_equals_per_head("bf16_d256_w100_softcap", cuda_device)


def _folded_equals_per_head(case, cuda_device):
    (q, k, v, do), opts = (_option_inputs(case, cuda_device) if case in FLASH_OPTIONS
                           else _d256_inputs(case, cuda_device))
    o, lse = flash_attention_fwd(q, k, v, **opts)
    of, lsef = ff.folded_attention_fwd(q, k, v, **opts)
    delta = attention_delta(o, do)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **opts)
    dqf = ff.folded_attention_bwd_dq(q, k, v, do, lse, delta, **opts)
    dkv = flash_attention_bwd_dkdv(q, k, v, do, lse, delta, **opts)
    dkvf = ff.folded_attention_bwd_dkdv(q, k, v, do, lse, delta, **opts)
    for a, b in [(o, of), (lse, lsef), (dq, dqf), *zip(dkv, dkvf)]:
        assert torch.equal(a, b)


@pytest.mark.parametrize("fwd,bwd", [("pallas", "pallas"), ("folded", "folded"),
                                     ("xla", "folded"), ("folded", "xla"),
                                     ("pallas", "folded")])
def test_route_launches_the_kernels_it_resolved(fwd, bwd, cuda_device):
    """Each pin launches its legs' kernels once and nothing else, and the
    route's output and gradients match the plain versions. In fp32, as
    test_flash_autograd_launches_all_three_kernels: in bf16 a kernel
    forward's o differs from the plain one's by bf16 roundings, and the
    backward's delta = rowsum(dO * o) carries that into every gradient."""
    (q, k, v, do), opts = _option_inputs("w64_softcap_s333", cuda_device)
    per_leg = {"pallas": ((flash_attention_fwd, ), (flash_attention_bwd_dq,
                                                   flash_attention_bwd_dkdv)),
               "folded": ((ff.folded_attention_fwd, ), (ff.folded_attention_bwd_dq,
                                                        ff.folded_attention_bwd_dkdv)),
               "xla": ((), ())}
    counted = (flash_attention_fwd, flash_attention_bwd_dq, flash_attention_bwd_dkdv,
               ff.folded_attention_fwd, ff.folded_attention_bwd_dq,
               ff.folded_attention_bwd_dkdv)
    before = {f: f.launches for f in counted}
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, impl_fwd=fwd, impl_bwd=bwd, **opts)
    out.backward(do)
    torch.cuda.synchronize()
    expect = set(per_leg[fwd][0]) | set(per_leg[bwd][1])
    assert {f: f.launches - before[f] for f in counted} == {
        f: int(f in expect) for f in counted}
    o_ref, lse_ref = flash_attention_fwd_reference(q, k, v, **opts)
    grads_ref = flash_attention_bwd_reference(q, k, v, o_ref, lse_ref, do, **opts)
    assert_rows_close(out.detach(), o_ref, "o")
    for name, t, g_ref in zip("qkv", leaves, grads_ref):
        assert_rows_close(t.grad, g_ref, f"d{name}")


@pytest.mark.parametrize("cache", ["empty", "measured_xla"])
def test_route_at_d64_s1024_runs_the_kernels(cache, cuda_device, monkeypatch, tmp_path):
    """At head_dim 64, S 1024 and no window the JAX package's TPU heuristic
    sends the forward to xla; on the card the route runs K1 and K2 once
    each, also over a measured xla entry for the card's kind. fp32, as
    test_route_launches_the_kernels_it_resolved."""
    from deepspeed_tpu_torch.ops import kernel_dispatch as kd
    from deepspeed_tpu_torch.ops.autotune_cache import get_cache
    monkeypatch.setenv("DS_TPU_ATTN_CACHE_DIR", str(tmp_path))
    rng = np.random.default_rng(64)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(1, 1024, n, 64)).astype(np.float32))
                   .to(cuda_device) for n in (8, 2, 2, 8))
    if cache == "measured_xla":
        sig = kd.make_sig(q.shape, 2, 1024, q.dtype, True, None, None)
        for leg in ("fwd", "bwd"):
            get_cache().commit(kd.signature(leg, sig, kd.device_kind(q.device)),
                               {"impl": "xla", "block_q": 256, "block_k": 512})
    counted = (flash_attention_fwd, flash_attention_bwd_dq, flash_attention_bwd_dkdv,
               ff.folded_attention_fwd, ff.folded_attention_bwd_dq,
               ff.folded_attention_bwd_dkdv)
    before = [f.launches for f in counted]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counted, before)] == [1, 1, 1, 0, 0, 0]
    o_ref, lse_ref = flash_attention_fwd_reference(q, k, v, causal=True)
    grads_ref = flash_attention_bwd_reference(q, k, v, o_ref, lse_ref, do, causal=True)
    assert_rows_close(out.detach(), o_ref, "o")
    for name, t, g_ref in zip("qkv", leaves, grads_ref):
        assert_rows_close(t.grad, g_ref, f"d{name}")


# head_dim 256 (Gemma-2: G 2, the softcap, a window on some layers) in each
# dtype: fp32 with a ragged S; causal, windowed and full; a cap of 2 bites on
# N(0, 1) scores; then Gemma-2's widths (H 16, KV 8) over 2048 tokens, and
# the same with q 20x wider: scores ~N(0, 20^2) under the cap of 50, rows
# whose softmax is nearly one key, where dq's dS = P (dP - delta) cancels
# (dq summed dP in the mma accumulator read 2.5x the plain version's error
# against the exact value at S 8192 before its step sums)
# (B, S, H, KV, causal, window, softcap, dtype[, q scale])
FLASH_D256 = {
    "d256_causal_s130": (1, 130, 4, 2, True, None, None, torch.float32),
    "d256_w64_softcap_s333": (1, 333, 4, 2, True, 64, 2.0, torch.float32),
    "d256_w70_full_s200": (1, 200, 4, 4, False, 70, 20.0, torch.float32),
    "bf16_d256_s300": (1, 300, 8, 4, True, None, None, torch.bfloat16),
    "bf16_d256_w100_softcap": (1, 500, 8, 4, True, 100, 2.0, torch.bfloat16),
    "fp16_d256_full_s200": (1, 200, 4, 2, False, None, None, torch.float16),
    "fp16_d256_w100_softcap": (1, 500, 8, 4, True, 100, 2.0, torch.float16),
    "bf16_gemma2_s2048": (1, 2048, 16, 8, True, 512, 50.0, torch.bfloat16),
    "bf16_gemma2_q20_s2048": (1, 2048, 16, 8, True, 512, 50.0, torch.bfloat16, 20.0),
}
# Against the exact value (the plain version in fp64: no rounding of P, dS
# or the output) a kernel row may be at most twice as far off as the plain
# version's in the same dtype (chip_smoke.py's FLASH_EXACT_RATIO); rows
# whose exact value cancels to ~0 are floored at 2^-10 of the RMS row.
# Against the plain version itself, 2^-6 for every dtype: at head_dim 256
# a dq row sums 256-wide products of dS rounded to fp16 over hundreds of
# keys, and where it cancels the fp16 pair reads up to 4.8e-3 (2^-8 is
# fp16's row tolerance at narrower widths).
EXACT_RATIO, EXACT_FLOOR, D256_ROW_TOL = 2.0, 2.0 ** -10, 2.0 ** -6


def _d256_inputs(case, device):
    B, S, H, KV, causal, window, softcap, dtype, *q_scale = FLASH_D256[case]
    rng = np.random.default_rng(300 + sorted(FLASH_D256).index(case))
    q, k, v, do = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                   .to(device, dtype) for shape in (
                       (B, S, H, 256), (B, S, KV, 256), (B, S, KV, 256), (B, S, H, 256)))
    if q_scale:
        q = (q.float() * q_scale[0]).to(dtype)
    return (q, k, v, do), dict(causal=causal, window=window, softcap=softcap)


def _rows_vs(x, ref, floor):
    xf, rf = x.double().flatten(0, -2), ref.double().flatten(0, -2)
    den = rf.norm(dim=-1)
    den = den.clamp_min(floor * den.square().mean().sqrt())
    return ((xf - rf).norm(dim=-1) / den).max().item()


@pytest.mark.parametrize("layout", ["per_head", "folded"])
@pytest.mark.parametrize("case", sorted(FLASH_D256))
def test_flash_d256_kernels_match_plain(case, layout, cuda_device):
    """K1/K2 and K3 at head_dim 256 against the plain versions on the same
    inputs and against the exact value (tolerances above); each pass
    launches once."""
    (q, k, v, do), opts = _d256_inputs(case, cuda_device)
    kernels = ((flash_attention_fwd, flash_attention_bwd_dq, flash_attention_bwd_dkdv)
               if layout == "per_head" else
               (ff.folded_attention_fwd, ff.folded_attention_bwd_dq,
                ff.folded_attention_bwd_dkdv))
    before = [f.launches for f in kernels]
    o, lse = kernels[0](q, k, v, **opts)
    o_ref, lse_ref = flash_attention_fwd_reference(q, k, v, **opts)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    delta = attention_delta(o_ref, do)
    args = (q, k, v, do, lse_ref, delta)
    dq = kernels[1](*args, **opts)
    dk, dv = kernels[2](*args, **opts)
    dq_ref, dk_ref, dv_ref = flash_attention_bwd_reference(q, k, v, o_ref, lse_ref, do,
                                                           **opts)
    wide = [t.double() for t in (q, k, v, do, lse_ref, delta)]
    o_x = flash_attention_fwd_reference(*wide[:3], **opts)[0]
    scale = 256 ** -0.5
    dq_x = flash_attention_bwd_dq_reference(*wide, opts["causal"], scale, opts["window"],
                                            opts["softcap"])
    dk_x, dv_x = flash_attention_bwd_dkdv_reference(*wide, opts["causal"], scale,
                                                    opts["window"], opts["softcap"])
    torch.cuda.synchronize()
    for name, x, ref, exact in (("o", o, o_ref, o_x), ("dq", dq, dq_ref, dq_x),
                                ("dk", dk, dk_ref, dk_x), ("dv", dv, dv_ref, dv_x)):
        assert x.dtype == q.dtype and x.shape == ref.shape, name
        assert _rows_vs(x, ref, ROW_FLOOR / D256_ROW_TOL) <= D256_ROW_TOL, name
        if q.dtype != torch.float32:
            assert _rows_vs(x, exact, EXACT_FLOOR) <= \
                EXACT_RATIO * _rows_vs(ref, exact, EXACT_FLOOR), name
        else:
            assert _rows_vs(x, ref, ROW_FLOOR / ROW_TOL[q.dtype]) <= ROW_TOL[q.dtype], name
    assert [f.launches for f in kernels] == [b + 1 for b in before]


# ---- K2's backward on wgmma (bf16, fp16; head widths 65..256), K3 = K2 ----

# (B, S, H, KV, D, causal, window, softcap, dtype) about the tiles' edges:
# S 1 (every row sees one key), S 63 and 65 about the 64-key dk/dv block
# and dq key tile, S 33 one past the 32-key dq tile at head width 256, S 129
# one past the 128-row dq block at G 1, and S 1000; G 1, 2, 4 and 9; D 64
# (the mma.sync body), 80 and 192 (columns padded inside the 128- and
# 256-wide instances), 128 and 256; windows that cut a tile, with and
# without the causal mask; the softcap; fp16
WGMMA_BWD = {
    "s1_g1_d128": (1, 1, 1, 1, 128, True, None, None, torch.bfloat16),
    "s1_g4_d256_softcap": (2, 1, 8, 2, 256, True, None, 5.0, torch.bfloat16),
    "s33_g2_d256_fp16": (1, 33, 4, 2, 256, True, None, None, torch.float16),
    "s63_g2_d128_full": (2, 63, 4, 2, 128, False, None, None, torch.bfloat16),
    "s65_g1_d128_fp16": (1, 65, 2, 2, 128, True, None, None, torch.float16),
    "s65_g9_d128_w48": (1, 65, 18, 2, 128, True, 48, None, torch.bfloat16),
    "s129_g1_d256": (1, 129, 2, 2, 256, True, None, None, torch.bfloat16),
    "s200_g1_d256_full": (1, 200, 3, 3, 256, False, None, None, torch.bfloat16),
    "s300_g4_d80_w100_full_softcap": (2, 300, 8, 2, 80, False, 100, 3.0, torch.bfloat16),
    "s500_g2_d192_softcap_fp16": (1, 500, 4, 2, 192, True, None, 2.0, torch.float16),
    "s1000_g2_d64_w70": (1, 1000, 4, 2, 64, True, 70, None, torch.bfloat16),
    "s1000_g4_d128_w100_softcap": (1, 1000, 16, 4, 128, True, 100, 5.0, torch.bfloat16),
    "s1000_g9_d256_w300_softcap_fp16": (1, 1000, 18, 2, 256, True, 300, 5.0, torch.float16),
}


def _wgmma_inputs(case, device):
    B, S, H, KV, D, causal, window, softcap, dtype = WGMMA_BWD[case]
    rng = np.random.default_rng(400 + sorted(WGMMA_BWD).index(case))
    q, k, v, do = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                   .to(device, dtype) for shape in (
                       (B, S, H, D), (B, S, KV, D), (B, S, KV, D), (B, S, H, D)))
    return (q, k, v, do), dict(causal=causal, window=window, softcap=softcap)


@pytest.mark.parametrize("case", sorted(WGMMA_BWD))
def test_wgmma_backward_edges_bits_and_layouts(case, cuda_device):
    """dq, dk and dv against the plain versions on the same inputs (ROW_TOL,
    or D256_ROW_TOL past head width 128), equal bit for bit over two
    launches and between K2 and K3; at S 1000 also against the exact value
    (EXACT_RATIO). At S 1 every row sees one key, P is 1 and dS = dP -
    delta is 0 in exact arithmetic: dq and dk are held to 1e-3 instead."""
    (q, k, v, do), opts = _wgmma_inputs(case, cuda_device)
    D, dtype = q.shape[-1], q.dtype
    o_ref, lse_ref = flash_attention_fwd_reference(q, k, v, **opts)
    delta = attention_delta(o_ref, do)
    args = (q, k, v, do, lse_ref, delta)
    runs = [(flash_attention_bwd_dq(*args, **opts), *flash_attention_bwd_dkdv(*args, **opts))
            for _ in range(2)]
    folded = (ff.folded_attention_bwd_dq(*args, **opts),
              *ff.folded_attention_bwd_dkdv(*args, **opts))
    refs = flash_attention_bwd_reference(q, k, v, o_ref, lse_ref, do, **opts)
    wide = [t.double() for t in (q, k, v, do, lse_ref, delta)]
    rest = (opts["causal"], D ** -0.5, opts["window"], opts["softcap"])
    exact = (flash_attention_bwd_dq_reference(*wide, *rest),
             *flash_attention_bwd_dkdv_reference(*wide, *rest))
    torch.cuda.synchronize()
    tol = D256_ROW_TOL if D > 128 else ROW_TOL[dtype]
    for i, name in enumerate(("dq", "dk", "dv")):
        x = runs[0][i]
        assert x.dtype == dtype and x.shape == refs[i].shape, name
        assert torch.equal(x, runs[1][i]), f"{name}: two launches differ"
        assert torch.equal(x, folded[i]), f"{name}: K3 differs from K2"
        if q.shape[1] == 1 and name != "dv":
            assert x.float().abs().max().item() <= 1e-3, name
            continue
        assert _rows_vs(x, refs[i], ROW_FLOOR / tol) <= tol, name
        if q.shape[1] == 1000:
            assert _rows_vs(x, exact[i], EXACT_FLOOR) <= \
                EXACT_RATIO * _rows_vs(refs[i], exact[i], EXACT_FLOOR), name


def test_folded_refuses_what_the_kernel_does_not_take(cuda_device):
    (q, k, v, do), opts = _option_inputs("bf16_w48_s200", cuda_device)
    with pytest.raises(TypeError):
        ff.folded_attention_fwd(q.double(), k.double(), v.double(), **opts)
    with pytest.raises(ValueError):
        ff.folded_attention_fwd(q.transpose(1, 2), k, v, **opts)
    with pytest.raises(ValueError, match="window"):
        ff.folded_attention_fwd(q, k, v, causal=True, window=0)
    o, lse = ff.folded_attention_fwd(q, k, v, **opts)
    with pytest.raises(ValueError):  # lse must be fp32 [B, S, H]
        ff.folded_attention_bwd_dq(q, k, v, do, lse.double(), lse, **opts)


# ---- K7 fused optimizers (adam/adamw/L2, lion, lamb's first pass) ----

def ulp_distance(x, ref):
    """The largest distance in units in the last place between same-dtype
    float tensors (fp32, or the 16-bit types), both signs ordered on one
    integer line."""
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.float16: torch.int16}[ref.dtype]
    bits = torch.iinfo(ints).bits

    def key(t):
        i = t.contiguous().view(ints).long()
        return torch.where(i >= 0, i, -(1 << (bits - 1)) - i)

    return (key(x) - key(ref)).abs().max().item()


# (n, params dtype, grads dtype, offset): offset 1 takes a view one element
# into the buffers (not 16-byte aligned: the scalar path over everything)
K7_CASES = {
    "fp32_ragged": (12391, torch.float32, torch.float32, 0),
    "fp32_1m": (1 << 20, torch.float32, torch.float32, 0),
    "fp32_unaligned_view": (4099, torch.float32, torch.float32, 1),
    "bf16_params": (12391, torch.bfloat16, torch.float32, 0),
    "bf16_grads": (12388, torch.float32, torch.bfloat16, 0),
    "fp16_grads": (12388, torch.float32, torch.float16, 0),
}
# at most 2 ulps: the plain version repeats the kernel's roundings in its
# order, so they differ by at most the last bit of expf in the bias
# corrections (the same libdevice function on both sides)
K7_ULPS = 2


def _k7_inputs(case, device):
    n, p_dt, g_dt, off = K7_CASES[case]
    rng = np.random.default_rng(sorted(K7_CASES).index(case))

    def buf(a, dtype):
        return torch.from_numpy(a.astype(np.float32)).to(device, dtype)[off:]

    size = n + off
    p = buf(0.02 * rng.normal(size=size), p_dt)
    g = buf(1e-3 * rng.normal(size=size), g_dt)
    m = buf(1e-4 * rng.normal(size=size), torch.float32)
    v = buf(1e-8 * rng.random(size=size), torch.float32)
    g[:5] = 0  # sign(0) = 0 for lion; u = 0 for adam's fresh moments
    m[:5] = 0
    v[:5] = 0
    return p, g, m, v


@pytest.mark.parametrize("mode", ["adam", "adamw", "adam_l2"])
@pytest.mark.parametrize("case", sorted(K7_CASES))
def test_fused_adam_kernel_matches_plain(case, mode, cuda_device):
    p, g, m, v = _k7_inputs(case, cuda_device)
    wd = 0.0 if mode == "adam" else 0.01
    for step in (1, 7):
        lr, st = (fo.device_scalar(x, cuda_device) for x in (1e-3, step))
        ref = fo.adam_update_reference(p, g, m, v, lr, st, weight_decay=wd,
                                       l2=mode == "adam_l2")
        got = [t.clone() for t in (p, m, v)]
        before = fo.adam_step_.launches
        fo.adam_step_(got[0], g, got[1], got[2], lr, st, weight_decay=wd,
                      l2=mode == "adam_l2")
        torch.cuda.synchronize()
        assert fo.adam_step_.launches == before + 1
        for name, x, r in zip("pmv", got, ref):
            assert ulp_distance(x, r) <= K7_ULPS, (name, step)
        p, m, v = got


@pytest.mark.parametrize("wd", [0.0, 0.1])
@pytest.mark.parametrize("case", sorted(K7_CASES))
def test_fused_lion_kernel_matches_plain(case, wd, cuda_device):
    p, g, m, _ = _k7_inputs(case, cuda_device)
    ref = fo.lion_update_reference(p, g, m, 1e-4, weight_decay=wd)
    got = fo.fused_lion_step(p, g, m, 1e-4, weight_decay=wd)
    torch.cuda.synchronize()
    for name, x, r in zip("pm", got, ref):
        assert ulp_distance(x, r) <= K7_ULPS, name


@pytest.mark.parametrize("case", sorted(K7_CASES))
def test_fused_lamb_kernel_matches_plain(case, cuda_device):
    p, g, m, v = _k7_inputs(case, cuda_device)
    before = fo.lamb_update_.launches
    u, m_k, v_k = fo._lamb_pass(g, m, v, fo.device_scalar(3, cuda_device), 0.9, 0.999,
                                1e-6)
    assert fo.lamb_update_.launches == before + 1
    ref = fo.lamb_update_reference(g, m, v, 3)
    torch.cuda.synchronize()
    for name, x, r in zip("umv", (u, m_k, v_k), ref):
        assert ulp_distance(x, r) <= K7_ULPS, name
    # the whole step, trust ratio per segment included
    n = p.numel()
    segs = (0, n // 3, n // 2, n)
    got = fo.fused_lamb_step(p, g, m, v, 1e-3, 3, weight_decay=0.01, segments=segs)
    ref = fo.fused_lamb_step_reference(p, g, m, v, 1e-3, 3, weight_decay=0.01,
                                       segments=segs)
    for name, x, r in zip("pmv", got, ref):
        assert ulp_distance(x, r) <= K7_ULPS, name


def test_lamb_update_in_place_over_the_gradient(cuda_device):
    p, g, m, v = _k7_inputs("fp32_ragged", cuda_device)
    ref = fo.lamb_update_reference(g, m, v, 2)
    u = fo.lamb_update_(g, m, v, fo.device_scalar(2, cuda_device), out=g)
    assert u is g
    for x, r in zip((g, m, v), ref):
        assert ulp_distance(x, r) <= K7_ULPS


def test_fused_optimizer_refuses_what_the_kernel_does_not_take(cuda_device):
    p, g, m, v = _k7_inputs("fp32_ragged", cuda_device)
    lr, one = (fo.device_scalar(x, cuda_device) for x in (1e-3, 1))
    with pytest.raises(TypeError):  # moments must be fp32
        fo.adam_step_(p, g, m.bfloat16(), v, lr, one)
    with pytest.raises(ValueError):  # one length
        fo.lion_step_(p, g[:-1], m, lr)
    with pytest.raises(ValueError):  # flat buffers
        fo.adam_step_(p.view(-1, 1), g.view(-1, 1), m.view(-1, 1), v.view(-1, 1), lr, one)
    with pytest.raises(ValueError):  # one device
        fo.lamb_update_(g, m.cpu(), v, one)
    with pytest.raises(TypeError):  # the per-step scalars are device tensors
        fo.adam_step_(p, g, m, v, 1e-3, one)


# ---- the whole engine, tiny config: GPU kernels vs CPU plain path ----

def test_engine_gpu_matches_cpu(cuda_device):
    from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.inference.v2.engine_v2 import build_llama_engine
    from deepspeed_tpu_torch.models.llama import LlamaConfig, init_llama
    cfg = LlamaConfig.tiny(num_key_value_heads=2)
    engines = []
    for device in ("cpu", cuda_device):
        model = init_llama(cfg, seed=1, dtype=torch.float32, device="cpu").to(device)
        engines.append(build_llama_engine(
            cfg, params=model, dtype=torch.float32, kv_block_size=16,
            device=device, engine_config=RaggedInferenceEngineConfig(
                num_kv_blocks=64, state_manager=dict(
                    max_ragged_batch_size=32, max_ragged_sequence_count=8,
                    max_context=128))))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (5, 40, 11)]
    logits = [e.put([7, 8], [prompts[0], prompts[2]]).cpu() for e in engines]
    torch.testing.assert_close(logits[1], logits[0], atol=1e-4, rtol=1e-4)
    for e in engines:
        e.flush(7)
        e.flush(8)
    outs = [e.generate(prompts, max_new_tokens=8) for e in engines]
    assert outs[0] == outs[1]


def test_int8_engine_gpu_matches_cpu(cuda_device):
    """Weight-only int8 and an int8 KV cache, tiny config in fp32: K6 at
    build gives the same int8 weights on both; K4 stages K/V in bf16 where
    the CPU's plain version dequantizes in fp32, so logits within 0.05 (the
    CPU tests read 0.015 between the JAX engine's Pallas and dense paths)."""
    from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.inference.v2.engine_v2 import build_llama_engine
    from deepspeed_tpu_torch.models.llama import LlamaConfig, init_llama
    cfg = LlamaConfig.tiny(num_key_value_heads=2)
    engines = []
    for device in ("cpu", cuda_device):
        model = init_llama(cfg, seed=1, dtype=torch.float32, device="cpu").to(device)
        engines.append(build_llama_engine(
            cfg, params=model, dtype=torch.float32, kv_block_size=16,
            device=device, quantize="int8", kv_cache_dtype="int8",
            engine_config=RaggedInferenceEngineConfig(num_kv_blocks=64)))
    qa, qb = (e.model().model.layers[1].mlp.down_proj.quantized for e in engines)
    assert torch.equal(qa.values, qb.values.cpu()) and torch.equal(qa.scales, qb.scales.cpu())
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (5, 40, 11)]
    logits = [e.put([7, 8], [prompts[0], prompts[2]]).cpu() for e in engines]
    torch.testing.assert_close(logits[1], logits[0], atol=0.05, rtol=0)


def test_training_engine_gpu_matches_cpu(cuda_device):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaConfig, init_llama_for_causal_lm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = LlamaConfig.tiny(dtype=torch.float32, num_key_value_heads=2)
    config = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
              "gradient_clipping": 1.0}
    rng = np.random.default_rng(0)
    batches = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 70))) for _ in range(4)]
    runs = []
    for device in ("cpu", cuda_device):
        model = init_llama_for_causal_lm(cfg, seed=2, device="cpu")
        engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=config, device=device)
        losses = [engine.train_batch(iter([(ids, ids) for ids in batches[i:i + 2]]))
                  for i in (0, 2)]
        runs.append((losses, {n: m.cpu() for n, m in engine.master_params().items()}))
    (loss_cpu, p_cpu), (loss_gpu, p_gpu) = runs
    # fp32 both sides, sums in another order (2 steps at lr 1e-3): 5e-5 is
    # 5% of a step. Adam's m/(sqrt(v)+eps) is a ratio: where a gradient
    # cancels to fp32 noise, the default eps 1e-8 lets the two sides take
    # other shares of a step. At most MAX_FLIPPED such elements, none
    # beyond the whole path of both sides' updates (2 x 2 steps x lr).
    np.testing.assert_allclose(loss_gpu, loss_cpu, rtol=1e-5)
    n_off = 0
    for name in p_cpu:
        diff = (p_gpu[name] - p_cpu[name]).abs()
        assert diff.max().item() <= 2 * 2 * 1e-3, name
        n_off += int((diff > 5e-5).sum())
    assert n_off <= MAX_FLIPPED, f"{n_off} elements off"


MAX_FLIPPED = 4


@pytest.mark.parametrize("optimizer", [
    {"type": "Adam", "params": {"lr": 1e-3, "weight_decay": 0.01}},
    {"type": "Lion", "params": {"lr": 1e-4, "weight_decay": 0.01}},
    {"type": "Lamb", "params": {"lr": 1e-3, "weight_decay": 0.01}},
], ids=["adam_l2", "lion", "lamb"])
def test_training_engine_optimizers_gpu_match_cpu(optimizer, cuda_device):
    """The engine's K7 step on the card against the plain version on the
    CPU, 3 steps on the same weights and batches: one launch per step."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaConfig, init_llama_for_causal_lm
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LlamaConfig.tiny(dtype=torch.float32, num_key_value_heads=2)
    config = {"train_batch_size": 2, "optimizer": optimizer, "gradient_clipping": 1.0}
    rng = np.random.default_rng(1)
    batches = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 70))) for _ in range(3)]
    kernel = {"Adam": fo.adam_step_, "Lion": fo.lion_step_,
              "Lamb": fo.lamb_update_}[optimizer["type"]]
    runs = []
    for device in ("cpu", cuda_device):
        model = init_llama_for_causal_lm(cfg, seed=3, device="cpu")
        engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=config, device=device)
        before = kernel.launches
        for ids in batches:
            engine.backward(engine.forward(ids, labels=ids))
            engine.step()
        assert kernel.launches - before == (3 if device != "cpu" else 0)
        runs.append({n: m.cpu() for n, m in engine.master_params().items()})
    # as test_training_engine_gpu_matches_cpu: 5% of a step, at most
    # MAX_FLIPPED elements beyond it, none beyond the path of both sides
    lr = optimizer["params"]["lr"]
    n_off = 0
    for name in runs[0]:
        diff = (runs[1][name] - runs[0][name]).abs()
        assert diff.max().item() <= 2 * 3 * lr, name
        n_off += int((diff > 0.05 * lr).sum())
    assert n_off <= MAX_FLIPPED, f"{n_off} elements off"


# ---- K4 with ALiBi (BLOOM) ----

# (seed, S, N, KV, G, D, page_size, n_pages, B, seen, n_new, layer, window):
# BLOOM-7B1's widths (KV 32, G 1, D 128, 64-token pages) at decode and a
# prefill wave, small G 1 and G 3 cases, and ALiBi under a window
PAGED_ALIBI = {
    "g1_small": (9, 4, 2, 4, 1, 32, 16, 32, 4, [5, 0, 37, 0], [2, 1, 2, 0], 1, None),
    "g3_small": (10, 2, 3, 2, 3, 16, 8, 16, 6, [9, 20], [3, 1], 0, None),
    "g1_window": (11, 3, 4, 4, 1, 64, 16, 40, 8, [50, 0, 90], [1, 4, 2], 1, 40),
    "decode_bloom": (12, 8, 1, 32, 1, 128, 64, 280, 33,
                     [2048, 1536, 1024, 1024, 512, 256, 128, 128], [1] * 8, 1, None),
    "prefill_bloom": (13, 4, 768, 32, 1, 128, 64, 64, 12, [0, 0, 0, 0],
                      [768, 512, 128, 0], 0, None),
}


def _alibi_inputs(case, dtype, device):
    seed, S, N, KV, G, D, ps, n_pages, B, seen, n_new, layer, window = PAGED_ALIBI[case]
    rng = np.random.default_rng(seed)
    cache = torch.from_numpy(rng.normal(size=(2 * 2, n_pages * ps, KV * D))
                             .astype(np.float32)).to(device, dtype)
    q = torch.from_numpy(rng.normal(size=(S, N, KV * G, D))
                         .astype(np.float32)).to(device, dtype)
    bt = rng.permutation(n_pages)[:S * B].reshape(S, B).astype(np.int32)
    seen = np.asarray(seen, np.int32)
    lens = seen + np.asarray(n_new, np.int32)
    meta = [torch.from_numpy(a).to(device) for a in (bt, seen, lens)]
    return (q, cache, layer, *meta), ps, window


@pytest.mark.parametrize("int8", [False, True], ids=["float_cache", "int8_cache"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(PAGED_ALIBI))
def test_paged_attention_alibi_kernel_matches_plain(case, dtype, int8, cuda_device):
    """The ALiBi instance against the plain version, with the tolerances of
    the other K4 cases; it counts in ``alibi_launches`` only, and the bias
    moves the output."""
    (q, cache, layer, bt, seen, lens), ps, window = _alibi_inputs(case, dtype, cuda_device)
    kw = dict(page_size=ps, window=window)
    if int8:
        cache, kw["cache_scales"] = int8_cache(cache, q.shape[-1])
    counts = lambda: (paged_attention.launches, paged_attention.int8_launches,  # noqa: E731
                      paged_attention.alibi_launches)
    before = counts()
    out_k = paged_attention(q, cache, layer, bt, seen, lens, use_alibi=True, **kw)
    assert counts() == (before[0], before[1], before[2] + 1)
    out_r = paged_attention_reference(q, cache, layer, bt, seen, lens, use_alibi=True,
                                      **kw)
    no_bias = paged_attention_reference(q, cache, layer, bt, seen, lens, **kw)
    torch.cuda.synchronize()
    assert out_k.dtype == dtype and out_k.shape == q.shape
    assert (out_r.float() - no_bias.float()).abs().max().item() > 0.05
    rounding = alibi_rounding(q, cache, seen, kw.get("cache_scales"))
    if int8:
        control, slack = int8_control(q, cache, kw["cache_scales"], layer, bt, seen, lens,
                                      page_size=ps, window=window, use_alibi=True)
        assert_within(out_k, control, PAGED_TOL[dtype] + rounding + slack)
        assert rows_err(out_k, out_r) <= \
            rows_err(control, out_r) + OUT_ROUNDING[dtype] + rounding + rows_share(slack, out_r)
    else:
        torch.testing.assert_close(out_k.float(), out_r.float(),
                                   atol=PAGED_TOL[dtype] + rounding, rtol=0)


def alibi_rounding(q, cache, seen, cache_scales=None):
    """What the fp32 rounding of the biased scores may add to an output:
    a score carrying a bias b rounds to 2^-24 |b|, which moves its weight
    by that much relative, so an output by up to 2^-23 * max |b| * max |v|.
    The largest bias is the largest slope times the farthest (query, key)
    distance; it is ~300 on a padding query row of the prefill cases (a
    query past its sequence's length still attends to the sequence's keys),
    where the kernel and the plain version sum the q.k products in another
    order before the bias is added."""
    H = q.shape[2]
    far = int((seen.long() + q.shape[1] - 1).max())
    bias = float(alibi_slopes(H).max()) * far
    v_max = cache.float().abs().max().item()
    if cache_scales is not None:
        v_max *= cache_scales.max().item()
    return 2.0 ** -23 * bias * v_max


def test_paged_attention_explicit_slopes_and_softcap(cuda_device):
    """Explicit [KV, G] slopes take the ALiBi instance with those slopes;
    with a softcap too, the softcap instance caps before the bias."""
    (q, cache, layer, bt, seen, lens), ps, _ = _alibi_inputs("g3_small", torch.float32,
                                                             cuda_device)
    slopes = torch.linspace(0.05, 0.6, 6, device=cuda_device).reshape(2, 3)
    out_k = paged_attention(q, cache, layer, bt, seen, lens, page_size=ps, slopes=slopes)
    out_r = paged_attention_reference(q, cache, layer, bt, seen, lens, page_size=ps,
                                      slopes=slopes)
    torch.cuda.synchronize()
    torch.testing.assert_close(out_k, out_r, atol=PAGED_TOL[torch.float32], rtol=0)
    with pytest.raises(ValueError, match="slopes"):
        paged_attention(q, cache, layer, bt, seen, lens, page_size=ps, slopes=slopes[:1])
    before = paged_attention.softcap_launches
    capped = paged_attention(q, cache, layer, bt, seen, lens, page_size=ps, slopes=slopes,
                             softcap=2.0)
    assert paged_attention.softcap_launches == before + 1
    capped_r = paged_attention_reference(q, cache, layer, bt, seen, lens, page_size=ps,
                                         slopes=slopes, softcap=2.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(capped, capped_r, atol=PAGED_TOL[torch.float32], rtol=0)
    assert (capped_r - out_r).abs().max().item() > 0.05


def test_bloom_engine_gpu_matches_cpu(cuda_device):
    """A tiny BLOOM (ALiBi, embedding LayerNorm, biases, tied embeddings)
    through the serving engine on the card and on the CPU, same weights:
    K4's ALiBi instance L times and K5b 2L+2 times per forward."""
    from deepspeed_tpu_torch.inference.v2.config_v2 import RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.inference.v2.engine_v2 import build_llama_engine
    from deepspeed_tpu_torch.models.llama import init_llama
    from deepspeed_tpu_torch.module_inject import policy_for
    cfg = policy_for("bloom").config_from_hf(dict(vocab_size=256, hidden_size=96,
                                                  n_layer=2, n_head=6))
    engines = []
    for device in ("cpu", cuda_device):
        model = init_llama(cfg, seed=1, dtype=torch.float32, device="cpu")
        with torch.no_grad():
            gen = torch.Generator().manual_seed(2)
            for name, p in model.named_parameters():
                if name.endswith((".bias", ".scale")):
                    p.add_(0.1 * torch.randn(p.shape, generator=gen))
        engines.append(build_llama_engine(
            cfg, params=model.to(device), dtype=torch.float32, kv_block_size=16,
            device=device, engine_config=RaggedInferenceEngineConfig(
                num_kv_blocks=64, state_manager=dict(
                    max_ragged_batch_size=32, max_ragged_sequence_count=8,
                    max_context=256))))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (5, 30, 11)]
    from deepspeed_tpu_torch.ops.normalization import layer_norm
    before = (paged_attention.alibi_launches, layer_norm.launches)
    logits = [e.put([7, 8], [prompts[0], prompts[2]]).cpu() for e in engines]
    assert (paged_attention.alibi_launches - before[0],
            layer_norm.launches - before[1]) == (2, 6)
    torch.testing.assert_close(logits[1], logits[0], atol=1e-4, rtol=1e-4)
    for e in engines:
        e.flush(7)
        e.flush(8)
    outs = [e.generate(prompts, max_new_tokens=8) for e in engines]
    assert outs[0] == outs[1]


# ---- K8 splash block-sparse attention ----

# (B, H, layout heads, S, D, block, family, dtype): every block size and
# head_dim the kernels take, in each dtype, over the four layout families
# and a broadcast (one-head) layout
SPLASH = {
    "f32_b16_d16": (1, 2, 2, 256, 16, 16, "fixed", torch.float32),
    "f32_b32_d32": (2, 2, 1, 256, 32, 32, "bigbird", torch.float32),
    "f32_b64_d64": (1, 4, 4, 512, 64, 64, "longformer", torch.float32),
    "f32_b128_d128": (1, 2, 2, 512, 128, 128, "variable", torch.float32),
    "bf16_b16_d64": (2, 4, 4, 1024, 64, 16, "fixed", torch.bfloat16),
    "bf16_b32_d128": (1, 4, 1, 512, 128, 32, "bigbird", torch.bfloat16),
    "bf16_b64_d32": (2, 2, 2, 512, 32, 64, "longformer", torch.bfloat16),
    "bf16_b128_d16": (1, 2, 2, 768, 16, 128, "variable", torch.bfloat16),
    "f16_b16_d128": (1, 2, 2, 256, 128, 16, "bigbird", torch.float16),
    "f16_b32_d64": (1, 4, 4, 512, 64, 32, "variable", torch.float16),
    "f16_b64_d16": (2, 2, 1, 512, 16, 64, "fixed", torch.float16),
    "f16_b128_d32": (1, 2, 2, 512, 32, 128, "longformer", torch.float16),
    # block 16 with long rows under each family's defaults: BigBird's and
    # Longformer's global block, fixed's 4 local blocks (bidirectional), so
    # that groups share blocks and the plans split rows into segments
    "bf16_b16_bigbird_global": (1, 4, 4, 2048, 64, 16, "bigbird_global", torch.bfloat16),
    "bf16_b16_longformer_global": (2, 2, 1, 2048, 64, 16, "longformer_global",
                                   torch.bfloat16),
    "bf16_b16_fixed_local4": (1, 4, 4, 2048, 64, 16, "fixed_local4", torch.bfloat16),
    "f16_b16_longformer_global_d128": (1, 2, 2, 2048, 128, 16, "longformer_global",
                                       torch.float16),
    "f32_b16_bigbird_global_d32": (1, 2, 2, 2048, 32, 16, "bigbird_global", torch.float32),
}
# the cases whose plans split a row (forward) or a key block (dk/dv)
SPLASH_SPLIT = ("bf16_b16_bigbird_global", "bf16_b16_longformer_global", "bf16_b16_fixed_local4",
                "f16_b16_longformer_global_d128", "f32_b16_bigbird_global_d32")


def _splash_layout(family, heads, block, S):
    kw = dict(num_heads=heads, block=block)
    cfg = {"fixed": lambda: sc.FixedSparsityConfig(num_local_blocks=2, **kw),
           "bigbird": lambda: sc.BigBirdSparsityConfig(num_random_blocks=2,
                                                       different_layout_per_head=True,
                                                       **kw),
           "longformer": lambda: sc.BSLongformerSparsityConfig(
               global_block_indices=[0, 2], **kw),
           "variable": lambda: sc.VariableSparsityConfig(
               num_random_blocks=1, local_window_blocks=[1, 2], **kw),
           "bigbird_global": lambda: sc.BigBirdSparsityConfig(**kw),
           "longformer_global": lambda: sc.BSLongformerSparsityConfig(**kw),
           "fixed_local4": lambda: sc.FixedSparsityConfig(**kw)}[family]()
    return cfg.make_layout(S)


def _splash_inputs(B, H, S, D, dtype, device, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(B, H, S, D)).astype(np.float32))
            .to(device, dtype) for _ in range(4)]


def _check_splash(q, k, v, do, layout, block, limit=None):
    """Each K8 pass against its plain version on identical inputs; each
    kernel launches once, the merge and the sums once where the plans split
    a group."""
    tables = sp.SplashTables.build(layout, block, q.device, limit)
    kernels = (sp.splash_attention_fwd, sp.splash_attention_bwd_dq,
               sp.splash_attention_bwd_dkdv, sp.splash_fwd_merge, sp.splash_dq_sum,
               sp.splash_dkdv_sum)
    split, split_t = int(tables.plan.n_merges > 0), int(tables.plan_t.n_merges > 0)
    before = [f.launches for f in kernels]
    after = [b + n for b, n in zip(before, (1, 1, 1, split, split, split_t))]
    o, lse = sp.splash_attention_fwd(q, k, v, tables)
    o_ref, lse_ref = sp.splash_attention_fwd_reference(q, k, v, layout, block)
    delta = attention_delta(o_ref, do)
    dq = sp.splash_attention_bwd_dq(q, k, v, do, lse_ref, delta, tables)
    dk, dv = sp.splash_attention_bwd_dkdv(q, k, v, do, lse_ref, delta, tables)
    dq_ref = sp.splash_attention_bwd_dq_reference(q, k, v, do, lse_ref, delta, layout,
                                                  block)
    dk_ref, dv_ref = sp.splash_attention_bwd_dkdv_reference(q, k, v, do, lse_ref, delta,
                                                            layout, block)
    torch.cuda.synchronize()
    assert [f.launches for f in kernels] == after
    assert_rows_close(o, o_ref, "o")
    seen = lse_ref < sp.LSE_EMPTY
    torch.testing.assert_close(lse[seen], lse_ref[seen], atol=1e-4, rtol=1e-5)
    assert (lse[~seen] == sp.LSE_EMPTY).all()
    for name, g, g_ref in (("dq", dq, dq_ref), ("dk", dk, dk_ref), ("dv", dv, dv_ref)):
        assert g.dtype == q.dtype
        assert_rows_close(g, g_ref, name)
    return o, dq, dk, dv


@pytest.mark.parametrize("case", sorted(SPLASH))
def test_splash_kernels_match_plain(case, cuda_device):
    """K8's forward, dq and dk/dv against their plain versions on identical
    inputs (the backward passes take the plain forward's lse), row by row
    with the flash tolerances; each launches once (the merge and the sum
    where a plan splits)."""
    B, H, Lh, S, D, block, family, dtype = SPLASH[case]
    layout = _splash_layout(family, Lh, block, S)
    q, k, v, do = _splash_inputs(B, H, S, D, dtype, cuda_device, sorted(SPLASH).index(case))
    if case in SPLASH_SPLIT:
        tables = sp.SplashTables.build(layout, block, cuda_device)
        assert tables.plan.n_merges + tables.plan_t.n_merges > 0
    _check_splash(q, k, v, do, layout, block)


@pytest.mark.parametrize("block", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16], ids=str)
def test_splash_every_union_split(block, dtype, cuda_device):
    """A plan limited to one block a segment (every union of two or more
    blocks split, the merge and the sums over many segments) against the
    plain versions; each head's layout differs, so the plans are per head
    and the partials of every head are summed."""
    nb, H, D = 6, 2, 64
    layout = _splash_layout("bigbird", H, block, nb * block)
    q, k, v, do = _splash_inputs(2, H, nb * block, D, dtype, cuda_device, 40 + block)
    tables = sp.SplashTables.build(layout, block, cuda_device, 1)
    assert tables.plan.n_merges and tables.plan_t.n_merges
    assert tables.plan.heads == tables.plan_t.heads == H
    _check_splash(q, k, v, do, layout, block, limit=1)


@pytest.mark.parametrize("case", SPLASH_SPLIT[:2])
def test_splash_is_deterministic(case, cuda_device):
    """Two launches of the forward, dq and dk/dv on the same inputs give the
    same bits: split groups are merged and summed in segment order, with
    no float atomics."""
    B, H, Lh, S, D, block, family, dtype = SPLASH[case]
    layout = _splash_layout(family, Lh, block, S)
    q, k, v, do = _splash_inputs(B, H, S, D, dtype, cuda_device, 7)
    tables = sp.SplashTables.build(layout, block, cuda_device)
    assert tables.plan.n_merges and tables.plan_t.n_merges
    o, lse = sp.splash_attention_fwd(q, k, v, tables)
    delta = attention_delta(o, do)
    first = [o, lse, sp.splash_attention_bwd_dq(q, k, v, do, lse, delta, tables),
             *sp.splash_attention_bwd_dkdv(q, k, v, do, lse, delta, tables)]
    again = [*sp.splash_attention_fwd(q, k, v, tables),
             sp.splash_attention_bwd_dq(q, k, v, do, lse, delta, tables),
             *sp.splash_attention_bwd_dkdv(q, k, v, do, lse, delta, tables)]
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), first, again):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("block", [16, 64, 128])
def test_splash_empty_rows_and_unseen_keys(block, cuda_device):
    """A q-block that sees nothing gets o = 0 and lse = +1e30, exactly 0
    gradients; k-blocks no q-block sees get dk = dv = 0."""
    nb, H, D = 4, 2, 32
    S = block * nb
    layout = np.zeros((H, nb, nb), np.bool_)
    layout[:, 1:, :2] = True
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = _splash_inputs(1, H, S, D, dtype, cuda_device, block)
        o, dq, dk, dv = _check_splash(q, k, v, do, layout, block)
        assert not o[:, :, :block].any() and not dq[:, :, :block].any()
        assert not dk[:, :, 2 * block:].any() and not dv[:, :, 2 * block:].any()
        for t in (o, dq, dk, dv):
            assert torch.isfinite(t.float()).all()


def test_splash_autograd_and_dispatch_launch_the_kernels(cuda_device):
    """sparse_attention on the card with no padding mask runs K8: the
    forward and backward each launch once per call and match the dense
    path; with a padding mask the dense path runs and launches nothing."""
    B, H, S, D, block = 2, 4, 512, 64, 16
    layout = _splash_layout("bigbird", H, block, S)
    q, k, v, do = _splash_inputs(B, H, S, D, torch.bfloat16, cuda_device, 99)
    kernels = (sp.splash_attention_fwd, sp.splash_attention_bwd_dq,
               sp.splash_attention_bwd_dkdv)
    before = [f.launches for f in kernels]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = sparse_attention(*leaves, layout, block)
    out.backward(do)
    assert [f.launches for f in kernels] == [b + 1 for b in before]
    dense = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = sparse_attention(*dense, layout, block, use_kernel=False)
    ref.backward(do)
    assert [f.launches for f in kernels] == [b + 1 for b in before]
    assert_rows_close(out.detach(), ref.detach(), "o")
    for name, a, b in zip(("dq", "dk", "dv"), leaves, dense):
        assert_rows_close(a.grad, b.grad, name)
    sparse_attention(q, k, v, layout, block, torch.ones(B, S, device=cuda_device))
    assert [f.launches for f in kernels] == [b + 1 for b in before]


def test_sparse_self_attention_holds_its_kernel_tables(cuda_device):
    """SparseSelfAttention keeps K8's function beside its layout: a second
    call at the same length neither rebuilds the tables nor looks them up
    by the layout's bytes, and gives the same output."""
    from deepspeed_tpu_torch.ops.sparse_attention import (FixedSparsityConfig,
                                                          SparseSelfAttention)
    attn = SparseSelfAttention(FixedSparsityConfig(num_heads=4, block=16))
    q, k, v, _ = _splash_inputs(1, 4, 256, 64, torch.bfloat16, cuda_device, 5)
    first = attn(q, k, v)
    lookups = sp._cached_splash_fn.cache_info()
    launches = sp.splash_attention_fwd.launches
    second = attn(q, k, v)
    info = sp._cached_splash_fn.cache_info()
    assert (info.hits, info.misses) == (lookups.hits, lookups.misses)
    assert sp.splash_attention_fwd.launches == launches + 1
    assert torch.equal(first, second)


def test_splash_refuses_what_the_kernel_does_not_take(cuda_device):
    layout = _splash_layout("fixed", 2, 16, 256)
    q, k, v, _ = _splash_inputs(1, 2, 256, 64, torch.bfloat16, cuda_device, 0)
    tables = sp.SplashTables.build(layout, 16, cuda_device)
    with pytest.raises(TypeError):
        sp.splash_attention_fwd(q.double(), k.double(), v.double(), tables)
    q20 = torch.zeros(1, 2, 256, 20, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        sp.splash_attention_fwd(q20, q20, q20, tables)
    lay8 = np.ones((2, 32, 32), np.bool_)
    with pytest.raises(ValueError, match="block"):
        sp.splash_attention_fwd(q, k, v, sp.SplashTables.build(lay8, 8, cuda_device))
    with pytest.raises(ValueError, match="cover"):
        sp.splash_attention_fwd(q[:, :, :128], k[:, :, :128], v[:, :, :128], tables)
    with pytest.raises(ValueError, match="contiguous"):
        sp.splash_attention_fwd(q.transpose(2, 3).contiguous().transpose(2, 3), k, v,
                                tables)
    with pytest.raises(ValueError, match="key_padding_mask"):
        sparse_attention(q, k, v, layout, 16, torch.ones(1, 256, device=cuda_device),
                         use_kernel=True)
    # the function's own checks, as the JAX package's
    with pytest.raises(ValueError, match="not divisible"):
        splash_sparse_attention(q[:, :, :100], k[:, :, :100], v[:, :, :100], layout, 16)


# ---- Gemma-2: K4's softcap at head_dim 256, K5 with an fp32 scale ----

# (seed, S, N, KV, G, D, page_size, B, seen, n_new, layer, window, softcap,
# q scale): small G 2 cases (a cap of 2 bites on N(0, 1) scores), then
# Gemma-2-9B's widths (H 16, KV 8, D 256, scale 256^-0.5, 64-token pages,
# cap 50) with q scaled by 40 so that about half the scores pass cap / 2: a
# decode step of 8 sequences (the page split) without and with the window
# 4096, and a 768-row prefill chunk straddling the window's edge
PAGED_SOFTCAP = {
    "small_g2": (20, 4, 2, 2, 2, 32, 16, 4, [5, 0, 37, 0], [2, 1, 2, 0], 1, None, 2.0, 1.0),
    "small_d256_window": (21, 3, 3, 2, 2, 256, 16, 8, [50, 0, 90], [1, 3, 2], 0, 40, 2.0,
                          1.0),
    "decode_gemma2": (22, 8, 1, 8, 2, 256, 64, 82,
                      [127, 640, 1280, 2048, 3000, 4200, 4700, 5119], [1] * 8, 1, None, 50.0,
                      40.0),
    "decode_gemma2_window": (23, 8, 1, 8, 2, 256, 64, 82,
                             [127, 640, 1280, 2048, 3000, 4200, 4700, 5119], [1] * 8, 1,
                             4096, 50.0, 40.0),
    "chunk_gemma2_window": (24, 1, 768, 8, 2, 256, 64, 70, [3700], [768], 0, 4096, 50.0,
                            40.0),
}
# the largest row error against the plain version: fp32 summation order and
# tanhf's last ulp (scores up to 50); bf16 one rounding of each output
SOFTCAP_ROW_TOL = {torch.float32: 2.0 ** -14, torch.bfloat16: 2.0 ** -7}


def _softcap_inputs(case, dtype, device):
    """As _window_inputs: distinct pages, the entries below a window's
    reach zeroed as the engine leaves them. The cache (1.4 GB of fp32 at
    Gemma-2's widths) is drawn on the card."""
    seed, S, N, KV, G, D, ps, B, seen, n_new, layer, window, cap, qs = PAGED_SOFTCAP[case]
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    n_pages = S * B + 1
    cache = torch.randn(2 * 2, n_pages * ps, KV * D, generator=gen, device=device).to(dtype)
    q = (qs * torch.randn(S, N, KV * G, D, generator=gen, device=device)).to(dtype)
    bt = (1 + rng.permutation(S * B)).reshape(S, B).astype(np.int32)
    if window:
        for i, s in enumerate(seen):
            bt[i, :max(0, s - window + 1) // ps] = 0
    seen = np.asarray(seen, np.int32)
    lens = seen + np.asarray(n_new, np.int32)
    meta = [torch.from_numpy(a).to(device) for a in (bt, seen, lens)]
    return (q, cache, layer, *meta), dict(page_size=ps, window=window, softcap=cap)


@pytest.mark.parametrize("int8", [False, True], ids=["float_cache", "int8_cache"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(PAGED_SOFTCAP))
def test_paged_attention_softcap_kernel_matches_plain(case, dtype, int8, cuda_device):
    """The softcap instance against the plain version row by row; it counts
    in ``softcap_launches`` only, and the cap moves the output."""
    (q, cache, layer, bt, seen, lens), kw = _softcap_inputs(case, dtype, cuda_device)
    if int8:
        cache, kw["cache_scales"] = int8_cache(cache, q.shape[-1])
    counts = lambda: (paged_attention.launches, paged_attention.int8_launches,  # noqa: E731
                      paged_attention.alibi_launches, paged_attention.softcap_launches)
    before = counts()
    out_k = paged_attention(q, cache, layer, bt, seen, lens, **kw)
    assert counts() == before[:3] + (before[3] + 1, )
    out_r = paged_attention_reference(q, cache, layer, bt, seen, lens, **kw)
    uncapped = paged_attention_reference(q, cache, layer, bt, seen, lens,
                                         **{**kw, "softcap": None})
    torch.cuda.synchronize()
    assert out_k.dtype == dtype and out_k.shape == q.shape
    assert (out_r.float() - uncapped.float()).abs().max().item() > 0.05  # the cap bites
    tol = SOFTCAP_ROW_TOL[dtype]
    if int8:
        control, slack = int8_control(
            q, cache, kw["cache_scales"], layer, bt, seen, lens,
            **{k: v for k, v in kw.items() if k != "cache_scales"})
        assert rows_err(out_k, control) <= tol + rows_share(slack, control)
        assert rows_err(out_k, out_r) <= \
            rows_err(control, out_r) + OUT_ROUNDING[dtype] + tol + rows_share(slack, out_r)
    else:
        assert rows_err(out_k, out_r) <= tol


@pytest.mark.parametrize("shape", [(8, 3584), (768, 3584), (37, 100), (3, 7), (2, 5, 256)])
def test_rms_norm_fp32_scale_kernel_matches_plain(shape, cuda_device):
    """A bf16 x with an fp32 weight (Gemma's 1 + w, deltas of ~1e-3 that a
    bf16 weight would round away): the fp32-scale instance, counted in
    ``fp32_scale_launches``, against the plain version."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda_device,
                                                                        torch.bfloat16)
    w = torch.from_numpy((1 + 1e-3 * rng.normal(size=shape[-1:])).astype(np.float32))
    w = w.to(cuda_device)
    before = (rms_norm.launches, rms_norm.fp32_scale_launches)
    out_k = rms_norm(x, w, 1e-6)
    assert (rms_norm.launches, rms_norm.fp32_scale_launches) == (before[0], before[1] + 1)
    assert out_k.dtype == torch.bfloat16
    torch.testing.assert_close(out_k.float(), rms_norm_reference(x, w, 1e-6).float(),
                               **RMS_TOL[torch.bfloat16])


# ---- K1's forward on wgmma (bf16, fp16; head widths 65..256), K3 = K1 ----

# (B, S, H, KV, D, causal, window, softcap, dtype) about the tiles' edges:
# S 1 (every row sees one key), 63 and 65 about the 64-key tile, 129 one
# past the 128-row block at G 1, and 1000; G 1, 3, 4 and 9; D 72 and 200
# (columns padded inside the 128- and 256-wide instances), 128 and 256;
# causal, a window with and without it, the softcap; bf16 and fp16
FLASH_FWD_WGMMA = {
    "s1_g1_d128": (1, 1, 1, 1, 128, True, None, None, torch.bfloat16),
    "s63_g3_d72": (2, 63, 6, 2, 72, True, None, None, torch.bfloat16),
    "s65_g4_d128_fp16": (1, 65, 8, 2, 128, True, None, None, torch.float16),
    "s129_g9_d200_softcap": (1, 129, 18, 2, 200, True, None, 5.0, torch.bfloat16),
    "s129_g1_d256_full_fp16": (1, 129, 2, 2, 256, False, None, None, torch.float16),
    "s1000_g1_d256_softcap": (2, 1000, 2, 2, 256, True, None, 30.0, torch.bfloat16),
    "s1000_g3_d72_w70_full": (1, 1000, 6, 2, 72, False, 70, None, torch.bfloat16),
    "s1000_g4_d128_w100_softcap": (1, 1000, 16, 4, 128, True, 100, 5.0, torch.bfloat16),
    "s1000_g9_d256_w300_fp16": (1, 1000, 18, 2, 256, True, 300, None, torch.float16),
}


@pytest.mark.parametrize("case", sorted(FLASH_FWD_WGMMA))
def test_wgmma_forward_edges_bits_and_layouts(case, cuda_device):
    """o against the plain version row by row (ROW_TOL, D256_ROW_TOL past
    head width 128) and lse within summation order; o and lse equal bit for
    bit over two launches and between K1 and K3; at S 1000 o also against
    the exact value (EXACT_RATIO); each launch counted once."""
    B, S, H, KV, D, causal, window, softcap, dtype = FLASH_FWD_WGMMA[case]
    rng = np.random.default_rng(500 + sorted(FLASH_FWD_WGMMA).index(case))
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .to(cuda_device, dtype) for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))
    opts = dict(causal=causal, window=window, softcap=softcap)
    before = (flash_attention_fwd.launches, ff.folded_attention_fwd.launches)
    runs = [flash_attention_fwd(q, k, v, **opts) for _ in range(2)]
    folded = ff.folded_attention_fwd(q, k, v, **opts)
    assert (flash_attention_fwd.launches, ff.folded_attention_fwd.launches) == \
        (before[0] + 2, before[1] + 1)
    o_ref, lse_ref = flash_attention_fwd_reference(q, k, v, **opts)
    o_x = flash_attention_fwd_reference(q.double(), k.double(), v.double(), **opts)[0]
    torch.cuda.synchronize()
    o, lse = runs[0]
    assert o.dtype == dtype and o.shape == q.shape and lse.shape == (B, S, H)
    for a, b in (runs[1], folded):
        assert torch.equal(o, a) and torch.equal(lse, b)
    tol = D256_ROW_TOL if D > 128 else ROW_TOL[dtype]
    assert _rows_vs(o, o_ref, ROW_FLOOR / tol) <= tol
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    if S == 1000:
        assert _rows_vs(o, o_x, EXACT_FLOOR) <= EXACT_RATIO * _rows_vs(o_ref, o_x, EXACT_FLOOR)


# ---- K4's multi-row tiles on wgmma ----

# (seed, S, N, KV, G, D, page_size, B, seen, n_new, layer, options): the
# CPU tests' multi-row cases (tests/test_torch_paged_attention.py
# MULTI_ROW_CASES) in bf16: one full 128-row tile, a tile and a partial
# one, two tiles and a partial one; G 1 and 9, D 128 and 256, pages of 16
# and 64; a window straddling the chunk with freed entries, ALiBi, the
# softcap and the int8 cache; a padding sequence beside a chunk; then
# Llama-3-8B's widths: a 768-row chunk deep in the cache over the int8
# cache, and a chunk of 100 rows (not a tile multiple) beside a padding
# sequence and a decode row
PAGED_WGMMA = {
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
    "llama_chunk_int8_deep": (46, 1, 768, 8, 4, 128, 64, 48, [2200], [768], 1,
                              {"int8": True}),
    "llama_ragged_chunk_padding": (47, 3, 25, 8, 4, 128, 64, 8, [300, 0, 77], [25, 0, 1],
                                   0, {}),
}


def _paged_wgmma_inputs(case, device, table=PAGED_WGMMA, dtype=torch.bfloat16):
    """Random ``dtype`` cache and queries (an int8 cache quantized from
    it), distinct pages, a window's freed entries and a padding sequence's
    table zeroed as the engine leaves them."""
    seed, S, N, KV, G, D, ps, B, seen, n_new, layer, opts = table[case]
    opts = dict(opts)
    int8 = opts.pop("int8", False)
    rng = np.random.default_rng(seed)
    n_pages = S * B + 1
    cache = torch.from_numpy(rng.normal(size=(2 * 2, n_pages * ps, KV * D))
                             .astype(np.float32)).to(device, dtype)
    q = torch.from_numpy(rng.normal(size=(S, N, KV * G, D))
                         .astype(np.float32)).to(device, dtype)
    bt = (1 + rng.permutation(S * B)).reshape(S, B).astype(np.int32)
    freed = [max(0, s - opts["window"] + 1) // ps if "window" in opts else 0 for s in seen]
    for i, (f, n) in enumerate(zip(freed, n_new)):
        bt[i, :f] = 0
        if n == 0:
            bt[i] = 0
    seen = np.asarray(seen, np.int32)
    lens = seen + np.asarray(n_new, np.int32)
    meta = [torch.from_numpy(a).to(device) for a in (bt, seen, lens)]
    if int8:
        cache, opts["cache_scales"] = int8_cache(cache, D)
    return (q, cache, layer, *meta), dict(page_size=ps, **opts), freed


@pytest.mark.parametrize("case", sorted(PAGED_WGMMA))
def test_paged_attention_wgmma_matches_plain(case, cuda_device):
    """The wgmma tiles against the plain version row by row, the rule of
    chip_smoke.py's K4 cases: the largest row error at most one bf16
    rounding of the exact fp32 output plus 2^-8 (an int8 cache: against the
    plain version on the staged bf16 K/V, and against the plain version
    itself the staged version's own error plus 2^-8); max abs within
    PAGED_TOL. One launch, counted in wgmma_launches and in its option's
    counter. Freed entries pointed far past the cache are never read: the
    same output bit for bit. A padding sequence gives zeros."""
    _held_row_by_row(*_paged_wgmma_inputs(case, cuda_device), "wgmma_launches")


def _held_row_by_row(args, kw, freed, counter):
    """One launch of ``args`` with ``kw``, counted in ``counter`` and in its
    option's counter, held as test_paged_attention_wgmma_matches_plain
    says."""
    q, cache, layer, bt, seen, lens = args
    others = ("softcap_launches", "alibi_launches", "int8_launches", "launches")
    counts = lambda: [getattr(paged_attention, c) for c in (counter, ) + others]  # noqa: E731
    before = counts()
    out_k = paged_attention(q, cache, layer, bt, seen, lens, **kw)
    after = counts()
    assert after[0] == before[0] + 1 and sum(after[1:]) == sum(before[1:]) + 1
    out_r = paged_attention_reference(q, cache, layer, bt, seen, lens, **kw)
    D = q.shape[-1]
    scales = kw.get("cache_scales")
    plain_kw = {k: v for k, v in kw.items() if k != "cache_scales"}
    staged = staged_cache(cache, scales, D) if scales is not None else cache
    exact = paged_attention_reference(q.float(), staged, layer, bt, seen, lens, **plain_kw)
    control = exact.to(torch.bfloat16)
    torch.cuda.synchronize()
    assert out_k.dtype == torch.bfloat16 and out_k.shape == q.shape
    rounding = rows_err(control, exact)
    if scales is None:
        assert rows_err(out_k, out_r) <= rounding + 2.0 ** -8
        torch.testing.assert_close(out_k.float(), out_r.float(), atol=PAGED_TOL[torch.bfloat16],
                                   rtol=0)
    else:
        assert rows_err(out_k, control) <= rounding + 2.0 ** -8
        assert rows_err(out_k, out_r) <= rows_err(control, out_r) + 2.0 ** -8
        torch.testing.assert_close(out_k.float(), control.float(),
                                   atol=PAGED_TOL[torch.bfloat16], rtol=0)
    for i in (lens == 0).nonzero().flatten().tolist():
        assert not out_k[i].any()
    if any(freed):
        far = bt.clone()
        for i, f in enumerate(freed):
            far[i, :f] = 1 << 30
        out_far = paged_attention(q, cache, layer, far, seen, lens, **kw)
        torch.cuda.synchronize()
        assert torch.equal(out_far, out_k)
    return out_k


# ---- K4's decode kernel ----

# (seed, S, N, KV, G, D, page_size, B, seen, n_new, layer, options) in
# bf16, held as the wgmma tiles are: histories 1, 2, 63, 64, 65 and 3000
# keys beside a padding sequence (G 1, D 128, pages of 64: one split for
# the short ones, many for the long one); G 2 at D 256 with the softcap
# over pages of 16; G 4 over an int8 cache with a window and its freed
# entries; G 8 at D 64 with ALiBi over pages of 128; G 9 with the window,
# the softcap and the int8 cache at D 256; G 16 at D 16; chunks of 3 rows
# at G 9, D 64 (27 rows: two row tiles) under a window, and 16 rows at G 4,
# D 64 (64 rows; the tiles take neither at that width); one sequence of 64
# keys (one split)
PAGED_DECODE = {
    "g1_d128_histories_padding": (50, 7, 1, 2, 1, 128, 64, 48,
                                  [0, 1, 62, 63, 64, 2999, 0], [1, 1, 1, 1, 1, 1, 0], 1, {}),
    "g2_d256_softcap_ps16": (51, 4, 1, 2, 2, 256, 16, 80, [1000, 77, 1279, 15], [1] * 4, 0,
                             {"softcap": 5.0}),
    "g4_d128_int8_window_freed": (52, 4, 1, 2, 4, 128, 64, 40, [2500, 300, 1700, 2000],
                                  [1] * 4, 1, {"window": 700, "int8": True}),
    "g8_d64_alibi_ps128": (53, 3, 1, 2, 8, 64, 128, 12, [1400, 129, 700], [1] * 3, 1,
                           {"use_alibi": True}),
    "g9_d256_window_int8_softcap": (54, 3, 1, 1, 9, 256, 64, 30, [1800, 64, 1000], [1] * 3,
                                    0, {"window": 512, "int8": True, "softcap": 5.0}),
    "g16_d16_ps16": (55, 3, 1, 2, 16, 16, 16, 40, [600, 5, 63], [1] * 3, 1, {}),
    "g9_d64_chunk3_window": (56, 2, 3, 2, 9, 64, 64, 20, [1200, 40], [3, 2], 1,
                             {"window": 300}),
    "g4_d64_rows64": (57, 2, 16, 2, 4, 64, 16, 20, [200, 0], [16, 0], 0, {}),
    "one_split": (58, 1, 1, 1, 4, 128, 16, 4, [63], [1], 1, {}),
}


@pytest.mark.parametrize("case", sorted(PAGED_DECODE))
def test_paged_decode_matches_plain(case, cuda_device):
    """K4's decode kernel against the plain version row by row with the
    tiles' rule (test_paged_attention_wgmma_matches_plain): one launch,
    counted in decode_launches and its option's counter, freed entries
    never read, padding sequences zero; and a second launch gives the same
    bits."""
    args, kw, freed = _paged_wgmma_inputs(case, cuda_device, PAGED_DECODE)
    out_k = _held_row_by_row(args, kw, freed, "decode_launches")
    again = paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(again, out_k)


def test_cuda_core_kernel_rounds_p_as_the_jax_kernel(cuda_device):
    """fp32 queries over an int8 cache: the CUDA-core kernel (run_kernel)
    and the fp32 decode kernel the plan takes round P to bf16 before P V
    over the staged bf16 K/V (the JAX kernel's p.astype(v.dtype)) and give
    fp32 outputs, so summation order is the only other difference. With a
    block table of one page there is one split; the CUDA-core kernel's
    running max steps per page, the plain version's, the decode kernel's
    per key tile (tile_keys): each within 2e-5 of
    paged_attention_reference(..., round_p=True) on the staged values that
    steps as it does, and more than ten times that from round_p=False."""
    rng = np.random.default_rng(60)
    S, KV, G, D, ps = 8, 2, 4, 128, 64
    cache = torch.from_numpy(rng.normal(size=(4, (S + 1) * ps, KV * D)).astype(np.float32))
    codes, scales = int8_cache(cache.to(cuda_device), D)
    q = torch.from_numpy(rng.normal(size=(S, 1, KV * G, D)).astype(np.float32)).to(cuda_device)
    bt = torch.arange(1, S + 1, dtype=torch.int32, device=cuda_device)[:, None]
    seen = torch.tensor([63, 40, 20, 63, 5, 33, 62, 50], dtype=torch.int32, device=cuda_device)
    lens = seen + 1
    staged = staged_cache(codes, scales, D)
    unrounded = paged_attention_reference(q, staged, 1, bt, seen, lens, page_size=ps)
    for kernel in ("cuda cores", "fp32 decode"):
        counts = lambda: [getattr(paged_attention, c) for c in KERNEL_COUNTERS]  # noqa: E731
        before = counts()
        out_k = (run_kernel(kernel, q, codes, 1, bt, seen, lens, page_size=ps,
                            cache_scales=scales) if kernel == "cuda cores" else
                 paged_attention(q, codes, 1, bt, seen, lens, page_size=ps,
                                 cache_scales=scales))
        assert [a - b for a, b in zip(counts(), before)] == [int(k == kernel) for k in KERNELS]
        _, pages, keys = kernel_plan(q, codes, bt, page_size=ps, kernel=kernel)
        assert pages >= 1 and keys == (ps if kernel == "cuda cores" else 32)
        rounded = paged_attention_reference(q, staged, 1, bt, seen, lens, page_size=ps,
                                            round_p=True, tile_keys=keys)
        torch.cuda.synchronize()
        assert out_k.dtype == torch.float32
        torch.testing.assert_close(out_k, rounded, atol=2e-5, rtol=0)
        assert (out_k - unrounded).abs().max().item() > 10 * 2e-5


# ---- K4's fp32-query kernels ----

# (seed, S, N, KV, G, D, page_size, B, seen, n_new, layer, options) in
# fp32, each run through both fp32-query kernels (run_kernel) and through
# the plan: decode shapes (N 1; G 2 at D 256 with the softcap over pages
# of 16, split; G 4 at D 128 over an int8 cache with a window and its
# freed entries over pages of 64; G 8 at D 64 with ALiBi over pages of 128;
# one sequence of 63 keys, one split) and chunk shapes (G 2 at D 256 with
# the window, the cap and a padding sequence; G 4 at D 128 over an int8
# cache over pages of 16, split; G 1 at D 64 with ALiBi over pages of 128;
# G 2 at D 68 over an int8 cache, whose codes go by 4-byte copies; G 2 at D
# 256 with 1088 rows over 8 KV heads, which fill the card unsplit)
PAGED_F32 = {
    "decode_g2_d256_softcap_ps16": (80, 4, 1, 2, 2, 256, 16, 80, [1000, 77, 1279, 15],
                                    [1] * 4, 0, {"softcap": 5.0}),
    "decode_g4_d128_int8_window_ps64": (81, 4, 1, 2, 4, 128, 64, 40,
                                        [2500, 300, 1700, 2000], [1] * 4, 1,
                                        {"window": 700, "int8": True}),
    "decode_g8_d64_alibi_ps128": (82, 3, 1, 2, 8, 64, 128, 12, [1400, 129, 700], [1] * 3, 1,
                                  {"use_alibi": True}),
    "decode_one_split": (83, 1, 1, 1, 4, 128, 16, 4, [63], [1], 1, {}),
    "chunk_g2_d256_window_softcap_padding": (84, 2, 40, 2, 2, 256, 64, 12, [600, 0],
                                             [40, 0], 1, {"window": 300, "softcap": 5.0}),
    "chunk_g4_d128_int8_ps16": (85, 2, 24, 2, 4, 128, 16, 40, [500, 90], [24, 11], 0,
                                {"int8": True}),
    "chunk_g1_d64_alibi_ps128": (86, 2, 70, 2, 1, 64, 128, 8, [800, 33], [70, 70], 1,
                                 {"use_alibi": True}),
    "chunk_g2_d68_int8": (87, 2, 20, 2, 2, 68, 16, 12, [150, 7], [20, 20], 0, {"int8": True}),
    "chunk_g2_d256_unsplit": (88, 1, 544, 8, 2, 256, 64, 25, [1000], [544], 1, {}),
}


@pytest.mark.parametrize("case", sorted(PAGED_F32))
def test_paged_f32_kernels_match_plain(case, cuda_device):
    """Both fp32-query kernels (and the plan's pick, the chunk kernel from
    f32_chunk_min_rows() folded rows) against the plain version. Over an
    fp32 cache: the largest row error ||kernel - plain|| / ||plain|| <=
    2^-14 and max abs <= 2e-5 (fp32 throughout; summation order and the
    branch-free tanh's last ulps). Over an int8 cache: within 2e-5 +
    round_p_flip_bound of the plain version that follows the kernel's split
    and running-max steps with P rounded (int8_control), and row by row
    against the plain version within the control's own error + 2^-14. One
    launch each, counted in its kernel's counter; a padding sequence gives
    zeros; freed entries pointed far past the cache are never read (the
    same bits); a second launch gives the same bits."""
    args, kw, freed = _paged_wgmma_inputs(case, cuda_device, PAGED_F32, torch.float32)
    q, cache, layer, bt, seen, lens = args
    rows = q.shape[1] * q.shape[2] // (cache.shape[-1] // q.shape[-1])
    planned = "fp32 chunk" if rows >= f32_chunk_min_rows() else "fp32 decode"
    assert kernel_plan(q, cache, bt, page_size=kw["page_size"], window=kw.get("window"))[0] \
        == planned
    scales = kw.get("cache_scales")
    plain_kw = {k: v for k, v in kw.items() if k != "cache_scales"}
    out_r = paged_attention_reference(*args, **kw)
    counts = lambda: [getattr(paged_attention, c) for c in KERNEL_COUNTERS]  # noqa: E731
    for kernel in ("fp32 chunk", "fp32 decode", None):
        before = counts()
        out_k = (paged_attention(*args, **kw) if kernel is None else
                 run_kernel(kernel, *args, **kw))
        ran = kernel or planned
        assert [a - b for a, b in zip(counts(), before)] == [int(k == ran) for k in KERNELS]
        if scales is None:
            torch.cuda.synchronize()
            assert rows_err(out_k, out_r) <= 2.0 ** -14
            torch.testing.assert_close(out_k, out_r, atol=2e-5, rtol=0)
        else:
            control, slack = int8_control(q, cache, scales, layer, bt, seen, lens, kernel=ran,
                                          **plain_kw)
            torch.cuda.synchronize()
            assert_within(out_k, control, 2e-5 + slack)
            assert rows_err(out_k, out_r) <= \
                rows_err(control, out_r) + 2.0 ** -14 + rows_share(slack, out_r)
        for i in (lens == 0).nonzero().flatten().tolist():
            assert not out_k[i].any()
        again = run_kernel(ran, *args, **kw)
        if any(freed):
            far = bt.clone()
            for i, f in enumerate(freed):
                far[i, :f] = 1 << 30
            again = run_kernel(ran, q, cache, layer, far, seen, lens, **kw)
        torch.cuda.synchronize()
        assert torch.equal(again, out_k)


@pytest.mark.parametrize("cache_kind", ["float", "int8"])
@pytest.mark.parametrize("D", [4, 64, 68, 128, 132, 256])
@pytest.mark.parametrize("G", [1, 2, 4, 9])
def test_plan_routes_every_fp32_query_to_the_fp32_kernels(G, D, cache_kind, cuda_device):
    """Every fp32-query shape at D % 4 == 0 goes to the fp32 decode kernel
    under f32_chunk_min_rows() (33) folded rows N * G and to the fp32 chunk
    kernel from there, at every page size and with a window; never to the
    CUDA-core kernel."""
    rows = f32_chunk_min_rows()
    assert rows == 33
    cache = torch.zeros(4, 128, 2 * D, dtype=torch.float32 if cache_kind == "float"
                        else torch.int8, device=cuda_device)
    bt = torch.zeros(3, 8, dtype=torch.int32, device=cuda_device)
    first = -(-rows // G)
    for N in sorted({1, 2, first - 1, first, first + 1, 64, 512, 1024} - {0}):
        q = torch.zeros(3, N, 2 * G, D, dtype=torch.float32, device=cuda_device)
        want = "fp32 chunk" if N * G >= rows else "fp32 decode"
        for ps, window in ((16, None), (64, 100), (128, None)):
            assert kernel_plan(q, cache, bt, page_size=ps, window=window)[0] == want


# (N, G, D, q dtype, cache, kernel): the plan's rule. At least
# wgmma_min_rows(D) (17; 33 past head width 128) folded rows N * G of a
# bf16 query over a bf16 or int8 cache at head widths 65..256 take the
# wgmma tiles; under that, and at any row count at head widths up to 64, a
# bf16 query at D % 16 == 0 takes the decode kernel (decode, 16 rows, 32
# rows at 256, head width 64, D 16); fp32 queries at D % 4 == 0 take the
# fp32 chunk kernel from f32_chunk_min_rows() (33) folded rows, the fp32
# decode kernel below; bf16 widths that are not a multiple of 16 (an int8
# cache at 72, a bf16 decode at 72) and fp32 widths that are not a multiple
# of 4 take the CUDA-core kernel
PAGED_PATHS = [
    (1, 4, 128, torch.bfloat16, "bf16", "decode"),
    (1, 9, 256, torch.bfloat16, "int8", "decode"),
    (4, 4, 128, torch.bfloat16, "bf16", "decode"),
    (5, 4, 128, torch.bfloat16, "int8", "wgmma"),
    (2, 9, 128, torch.bfloat16, "bf16", "wgmma"),
    (7, 9, 128, torch.bfloat16, "bf16", "wgmma"),
    (16, 4, 128, torch.bfloat16, "bf16", "wgmma"),
    (8, 9, 256, torch.bfloat16, "int8", "wgmma"),
    (64, 1, 72, torch.bfloat16, "bf16", "wgmma"),
    (64, 1, 72, torch.bfloat16, "int8", "cuda cores"),
    (64, 4, 128, torch.float32, "float", "fp32 chunk"),
    (9, 4, 72, torch.float32, "int8", "fp32 chunk"),
    (8, 4, 72, torch.float32, "int8", "fp32 decode"),
    (7, 4, 72, torch.float32, "float", "fp32 decode"),
    (1, 4, 70, torch.float32, "float", "cuda cores"),
    (64, 4, 64, torch.bfloat16, "bf16", "decode"),
    (1, 4, 72, torch.bfloat16, "bf16", "cuda cores"),
    (1, 16, 16, torch.bfloat16, "int8", "decode"),
    (1, 4, 128, torch.float32, "int8", "fp32 decode"),
    (17, 2, 256, torch.float32, "float", "fp32 chunk"),
    (16, 2, 256, torch.float32, "float", "fp32 decode"),
    (1, 2, 256, torch.float32, "int8", "fp32 decode"),
    (16, 2, 256, torch.bfloat16, "bf16", "decode"),
    (17, 2, 256, torch.bfloat16, "int8", "wgmma"),
]


@pytest.mark.parametrize("N,G,D,dtype,cache_kind,kernel", PAGED_PATHS)
def test_paged_attention_path_and_counter(N, G, D, dtype, cache_kind, kernel, cuda_device):
    """Which kernel a launch runs, by the kernels' counters
    (KERNEL_COUNTERS), and that each path agrees with the plain version
    (PAGED_TOL; fp32 queries over an int8 cache against the round_p control
    that follows the kernel's split, with its flip bound, as int8_control)."""
    rng = np.random.default_rng(N * 1000 + G * 10 + D)
    S, KV, ps, B = 3, 2, 16, 12
    cache = torch.from_numpy(rng.normal(size=(4, (S * B + 1) * ps, KV * D))
                             .astype(np.float32)).to(cuda_device,
                                                     torch.float32 if cache_kind == "float"
                                                     else dtype)
    q = torch.from_numpy(rng.normal(size=(S, N, KV * G, D)).astype(np.float32)).to(
        cuda_device, dtype)
    bt = torch.from_numpy((1 + rng.permutation(S * B)).reshape(S, B).astype(np.int32)).to(
        cuda_device)
    seen = torch.tensor([100, 33, 0], dtype=torch.int32, device=cuda_device)
    lens = seen + torch.tensor([N, max(1, N // 2), 0], dtype=torch.int32, device=cuda_device)
    kw = dict(page_size=ps)
    if cache_kind == "int8":
        cache, kw["cache_scales"] = int8_cache(cache.bfloat16(), D)
    counts = lambda: [getattr(paged_attention, c) for c in KERNEL_COUNTERS]  # noqa: E731
    before = counts()
    out_k = paged_attention(q, cache, 1, bt, seen, lens, **kw)
    after = counts()
    assert [a - b for a, b in zip(after, before)] == [int(k == kernel) for k in KERNELS]
    assert kernel_plan(q, cache, bt, page_size=ps)[0] == kernel
    slack = 0.0
    if cache_kind == "int8":
        out_r, slack = int8_control(q, cache, kw.pop("cache_scales"), 1, bt, seen, lens, **kw)
    else:
        out_r = paged_attention_reference(q, cache, 1, bt, seen, lens, **kw)
    torch.cuda.synchronize()
    assert_within(out_k, out_r, PAGED_TOL[dtype] + slack)


@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("G", [1, 2, 4, 9])
def test_wgmma_min_rows_is_the_plan_boundary(G, D, cuda_device):
    """At each serving family's G and head width, the plan takes the decode
    kernel for the last N whose N * G folded rows are under
    wgmma_min_rows(D) and the wgmma tiles from the first N at or past it
    (17 rows up to head width 128, 33 past it)."""
    rows = wgmma_min_rows(D)
    assert rows == (17 if D <= 128 else 33)
    cache = torch.zeros(4, 64, 2 * D, dtype=torch.bfloat16, device=cuda_device)
    bt = torch.zeros(2, 4, dtype=torch.int32, device=cuda_device)
    first = -(-rows // G)
    for N, kernel in ((first - 1, "decode"), (first, "wgmma")):
        if N:
            q = torch.zeros(2, N, 2 * G, D, dtype=torch.bfloat16, device=cuda_device)
            assert kernel_plan(q, cache, bt, page_size=16)[0] == kernel
