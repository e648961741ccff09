"""Paged (blocked-flash) attention for the ragged engine (port of
``deepspeed_tpu/ops/paged_attention.py``).

Cache layout as in the JAX package: ``[2*layers, num_slots, kv_heads*D]``
with k at row ``2l``, v at row ``2l+1`` and ``num_slots = num_pages *
page_size``. Queries ``[S, N, H, D]`` with H = KV*G in kv-major order. An
int8 cache comes with ``cache_scales`` ``[2*layers, num_slots, kv_heads]``
fp32, one scale per (row, slot, head).

``paged_attention`` dispatches on the query's device: a CPU tensor takes
the plain PyTorch version (``paged_attention_reference``, the dense-gather
path, which dequantizes an int8 window in fp32), a CUDA tensor launches
``csrc/paged_attention.cu`` or raises. ``paged_attention.launches`` counts
launches over a float cache, ``paged_attention.int8_launches`` over an
int8 cache, ``paged_attention.alibi_launches`` those with ALiBi and
``paged_attention.softcap_launches`` those with the softcap (over either
cache; each launch counts once, in the first of softcap, ALiBi, int8 and
float that applies). Beside them, one counter per kernel (KERNELS):
``paged_attention.wgmma_launches`` counts the launches that ran the
multi-row tiles on wgmma (a bf16 query over a bf16 or int8 cache with at
least ``wgmma_min_rows(D)`` folded rows ``N * G`` per sequence and KV
head, at head widths 65..256), ``paged_attention.decode_launches`` those
that ran the bf16 decode kernel (a bf16 query over either cache at head
widths ``D % 16 == 0`` that the tiles do not take: decode steps, small
chunks, heads up to 64 wide), ``paged_attention.f32_chunk_launches`` and
``paged_attention.f32_decode_launches`` those that ran the fp32-query
chunk kernel (from ``f32_chunk_min_rows()`` folded rows) and decode
kernel (below it), over an fp32 or int8 cache at head widths ``D % 4 ==
0``, and ``paged_attention.cuda_core_launches`` those that ran the
CUDA-core kernel (the other widths). The kernel's plan decides
(``dstt_paged_attention_plan``; ``kernel_plan`` reads it); ``run_kernel``
launches a named one, for measurements. All take the JAX kernel's sliding
``window``: a query at absolute position ``q`` sees keys ``q - window <
key <= q``, and the kernel never reads a page wholly older than the
window of the chunk's first query. The softcap (Gemma-2, ``softcap=c``)
takes the scaled scores to ``c * tanh(s / c)`` before any bias or mask
(the JAX kernel's ``:122-124``). ALiBi (BLOOM, ``use_alibi``/``slopes``)
adds ``slopes[kv, g] * (key_pos - q_abs)`` in fp32 to the scores before
the masks (``:125-131``); ``slopes`` ``[KV, G]`` fp32 defaults to
``alibi_slopes(H).reshape(KV, G)``. Head widths up to 256.
"""

import ctypes
import functools
import math
from typing import Optional

import torch

from . import _build

NEG_INF = -1e30
# the kernels of csrc/paged_attention.cu, by the code its plan returns
KERNELS = ("cuda cores", "wgmma", "decode", "fp32 chunk", "fp32 decode")
# each kernel's launch counter on paged_attention
KERNEL_COUNTERS = ("cuda_core_launches", "wgmma_launches", "decode_launches",
                   "f32_chunk_launches", "f32_decode_launches")


def _check_options(softcap):
    if softcap is not None and not softcap > 0:
        raise ValueError(f"paged_attention: softcap must be positive, got {softcap!r}")


@functools.lru_cache(maxsize=64)
def _default_slopes(H: int, device: torch.device) -> torch.Tensor:
    """``alibi_slopes(H)`` on ``device``, copied there once (a copy per
    call could not be captured in a CUDA graph)."""
    from ..models.llama import alibi_slopes
    return torch.from_numpy(alibi_slopes(H)).to(device)


def _alibi_slopes(use_alibi, slopes, H: int, KV: int, device):
    """The ``[KV, G]`` fp32 slope table, or None without ALiBi: ``slopes``
    as given (explicit slopes imply ALiBi), else ``alibi_slopes(H)`` in
    kv-major head order."""
    if slopes is None and not use_alibi:
        return None
    if slopes is None:
        slopes = _default_slopes(H, torch.device(device))
    slopes = torch.as_tensor(slopes)
    if slopes.numel() != H:
        raise ValueError(f"paged_attention: slopes must hold [KV, G] = [{KV}, "
                         f"{H // KV}] values, got {tuple(slopes.shape)}")
    return slopes.to(device=device, dtype=torch.float32).reshape(KV, H // KV).contiguous()


def _check_cache_scales(cache, cache_scales, D: int) -> None:
    """An int8 cache needs fp32 scales ``[2L, slots, KV]``; a float cache
    takes none."""
    if cache.dtype != torch.int8:
        if cache_scales is not None:
            raise ValueError("paged_attention: cache_scales come with an int8 "
                             f"cache, not a {cache.dtype} one")
        return
    L2, slots, KVD = cache.shape
    want = (L2, slots, KVD // D)
    if (cache_scales is None or cache_scales.dtype != torch.float32
            or tuple(cache_scales.shape) != want):
        got = (None if cache_scales is None
               else f"{cache_scales.dtype} {tuple(cache_scales.shape)}")
        raise ValueError(f"paged_attention: an int8 cache needs cache_scales "
                         f"float32 {want}, got {got}")


def paged_attention_reference(q, cache, layer: int, block_table, seq_seen,
                              seq_lens, *, page_size: int,
                              window: Optional[int] = None,
                              attn_scale: Optional[float] = None,
                              use_alibi: bool = False, slopes=None,
                              cache_scales=None,
                              softcap: Optional[float] = None,
                              round_p: bool = False,
                              split_pages: Optional[int] = None,
                              tile_keys: Optional[int] = None):
    """Dense-gather reference: gathers each sequence's ``B*page_size``
    history window (an int8 window dequantized in fp32; freed table entries
    gather block 0 and are masked), caps the scaled scores, adds the ALiBi
    bias, masks, softmaxes in fp32.

    ``round_p`` follows the JAX kernel's own order instead of one softmax
    over the row: page by page, a running max, each page's ``P = exp(s -
    m)`` rounded to bf16 before its P V over a bf16 or int8 cache (the
    kernel's ``p.astype(v.dtype)``; an fp32 cache keeps fp32), the unrounded
    P summed into the row's sum, one division at the end. Where P is
    rounded the max it is taken against decides the rounding, so the pages
    are walked in order. With ``split_pages`` the walk follows a kernel's
    page split (``kernel_plan``): from each sequence's first live page,
    every ``split_pages`` pages start a running max of their own, and the
    splits merge as the kernels' combine does (each rescaled to the common
    max, summed, one division). With ``tile_keys`` the running max steps
    once per ``tile_keys`` keys from multiples of it (a kernel's key tile,
    ``kernel_plan``) and at each split's start, not once per page: each P
    is rounded against the running max of its step."""
    return _reference(q, cache, layer, block_table, seq_seen, seq_lens, page_size, window,
                      attn_scale, use_alibi, slopes, cache_scales, softcap, round_p,
                      split_pages, tile_keys)[0]


# fp32 ulps from a bf16 rounding tie within which round_p_flip_bound takes
# a P to round either way (a relative move of P of up to 2^-14)
FLIP_BAND_ULPS = 512


def round_p_flip_bound(q, cache, layer: int, block_table, seq_seen, seq_lens, *,
                       page_size: int, window: Optional[int] = None,
                       attn_scale: Optional[float] = None, use_alibi: bool = False,
                       slopes=None, cache_scales=None, softcap: Optional[float] = None,
                       split_pages: Optional[int] = None, tile_keys: Optional[int] = None):
    """How far ``paged_attention_reference(..., round_p=True,
    split_pages=..., tile_keys=...)`` may move, element by element (``[S, N, H, D]``
    fp32), when its scores move by summation order alone: a P within
    FLIP_BAND_ULPS fp32 ulps of a bf16 rounding tie may round the other
    way, which moves it by one bf16 ulp (at most 2^-7 P) and the output by
    that times |v| over the row's sum. Zero over an fp32 cache, whose P is
    not rounded."""
    return _reference(q, cache, layer, block_table, seq_seen, seq_lens, page_size, window,
                      attn_scale, use_alibi, slopes, cache_scales, softcap, True,
                      split_pages, tile_keys, FLIP_BAND_ULPS)[1]


def _reference(q, cache, layer, block_table, seq_seen, seq_lens, page_size, window,
               attn_scale, use_alibi, slopes, cache_scales, softcap, round_p, split_pages,
               tile_keys=None, band=None):
    """paged_attention_reference's output and, with ``band``, the round_p
    walk's flip bound (round_p_flip_bound)."""
    _check_options(softcap)
    S, N, H, D = q.shape
    _check_cache_scales(cache, cache_scales, D)
    B = block_table.shape[1]
    L = B * page_size
    KV = cache.shape[-1] // D
    G = H // KV
    scale = attn_scale if attn_scale is not None else 1.0 / (D ** 0.5)
    dev = q.device
    j = torch.arange(L, dtype=torch.int64, device=dev)
    slot_grid = block_table.long()[:, j // page_size] * page_size + j % page_size
    k_h = cache[2 * layer][slot_grid].reshape(S, L, KV, D)   # [S, L, KV, D]
    v_h = cache[2 * layer + 1][slot_grid].reshape(S, L, KV, D)
    if cache_scales is not None:  # int8 cache: dequant the gathered window
        k_h = k_h.float() * cache_scales[2 * layer][slot_grid][..., None]
        v_h = v_h.float() * cache_scales[2 * layer + 1][slot_grid][..., None]
    k_h = k_h.movedim(2, 1).float()                          # [S, KV, L, D]
    v_h = v_h.movedim(2, 1).float()
    qf = q.reshape(S, N, KV, G, D).float()
    scores = torch.einsum("snkgd,skld->snkgl", qf, k_h) * scale
    if softcap is not None:  # before the bias and the masks
        scores = softcap * torch.tanh(scores / softcap)
    key_pos = torch.arange(L, dtype=torch.int32, device=dev)[None, None, :]
    q_abs = seq_seen[:, None] + torch.arange(N, dtype=torch.int32,
                                             device=dev)[None, :]
    mask = (key_pos <= q_abs[:, :, None]) & (key_pos < seq_lens[:, None, None])
    if window is not None:
        mask &= key_pos > q_abs[:, :, None] - window
    slope_table = _alibi_slopes(use_alibi, slopes, H, KV, dev)
    if slope_table is not None:
        dist = (key_pos[:, :, None, None, :]
                - q_abs[:, :, None, None, None]).float()       # [S, N, 1, 1, L]
        scores = scores + slope_table[None, None, :, :, None] * dist
    mask = mask[:, :, None, None, :]
    scores = torch.where(mask, scores, torch.full((), NEG_INF, device=dev))
    if round_p:
        starts = None
        if split_pages is not None:
            first = (torch.clamp(seq_seen - window + 1, min=0) // page_size
                     if window is not None else torch.zeros_like(seq_seen))
            rel = torch.arange(B, device=dev)[None, :] - first[:, None].long()
            starts = (rel > 0) & (rel % split_pages == 0)          # [S, B]
        out, bound = _pagewise(
            scores, mask, v_h, page_size,
            torch.float32 if cache.dtype == torch.float32 else torch.bfloat16, starts, band,
            tile_keys)
        if bound is not None:
            bound = bound.reshape(S, N, H, D)
    else:
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("snkgl,skld->snkgd", probs, v_h)
        out = torch.where(mask.any(-1, keepdim=True), out, torch.zeros((), device=dev))
        bound = None
    return out.reshape(S, N, H, D).to(q.dtype), bound


def _merge(a, b):
    """Two partial (max, sum, accumulator) triples of the same rows as the
    kernels' combine merges splits: each with a nonzero sum rescaled to the
    larger max, then added."""
    (m1, l1, a1), (m2, l2, a2) = a, b
    mx = torch.maximum(torch.where(l1 > 0, m1, NEG_INF), torch.where(l2 > 0, m2, NEG_INF))
    w1 = torch.where(l1 > 0, torch.exp(m1 - mx), 0.0)
    w2 = torch.where(l2 > 0, torch.exp(m2 - mx), 0.0)
    return mx, l1 * w1 + l2 * w2, a1 * w1[..., None] + a2 * w2[..., None]


def _pagewise(scores, mask, v_h, page_size: int, p_dtype, starts=None, band=None,
              tile_keys=None):
    """The JAX kernel's online softmax over ``scores`` ``[S, N, KV, G, L]``
    (masked entries NEG_INF) and ``v_h`` ``[S, KV, L, D]``, one page after
    another, P rounded to ``p_dtype`` for its product with V. Where
    ``starts`` ``[S, pages]`` is set, a sequence's page starts a split: the
    partial so far is merged into the finished ones and the running max,
    sum and accumulator start afresh. The running max steps once per page,
    or with ``tile_keys`` once per ``tile_keys`` keys from multiples of it
    and at each split's start: a step's P are taken against the running
    max that includes the whole step. With ``band`` (fp32 ulps) a second
    accumulator beside the first takes 2^-7 P |V| of each bf16-rounded P
    within ``band`` of a rounding tie: (output, that over the row's sum),
    else (output, None)."""
    dev = scores.device
    zero = torch.zeros((), device=dev)
    D = v_h.shape[-1]
    flips = band is not None and p_dtype == torch.bfloat16
    step = page_size if tile_keys is None else tile_keys
    unit = math.gcd(page_size, step)  # keys walked at a time
    n_units = scores.shape[-1] // unit
    first = torch.arange(n_units, device=dev) * unit  # each unit's first key
    split0 = torch.zeros(scores.shape[0], n_units, dtype=torch.bool, device=dev)
    if starts is not None:
        on_page = first % page_size == 0
        split0[:, on_page] = starts[:, first[on_page] // page_size]
    # each unit's step: a new one at multiples of ``step`` and at split
    # starts; the max of the step a unit lies in
    step_id = ((first % step == 0)[None, :] | split0).long().cumsum(-1) - 1
    unit_max = scores.unflatten(-1, (n_units, unit)).amax(-1)
    idx = step_id[:, None, None, None, :].expand_as(unit_max)
    step_max = torch.full_like(unit_max, NEG_INF).scatter_reduce(
        -1, idx, unit_max, "amax").gather(-1, idx)

    def fresh():
        m = torch.full(scores.shape[:-1], NEG_INF, device=dev)
        return m, torch.zeros_like(m), torch.zeros(*m.shape, 2 * D if flips else D, device=dev)

    done = fresh()
    m, total, acc = fresh()
    for u in range(n_units):
        k0 = u * unit
        if starts is not None and bool(split0[:, u].any()):
            new = split0[:, u]

            def pick(old, young):  # young where this unit starts a split
                return tuple(torch.where(new.view(-1, *[1] * (x.dim() - 1)), y, x)
                             for x, y in zip(old, young))
            done = pick(done, _merge(done, (m, total, acc)))
            m, total, acc = pick((m, total, acc), fresh())
        sc, mk = scores[..., k0:k0 + unit], mask[..., k0:k0 + unit]
        m_new = torch.maximum(m, step_max[..., u]).clamp_min(NEG_INF)
        alpha = torch.exp(m - m_new)
        p = torch.where(mk, torch.exp(sc - m_new[..., None]), zero)
        total = alpha * total + p.sum(-1)
        v = v_h[:, :, k0:k0 + unit]
        pv = torch.einsum("snkgl,skld->snkgd", p.to(p_dtype).float(), v)
        if flips:  # the low 16 bits of P's fp32 word against the tie 0x8000
            near = ((p.view(torch.int32) & 0xFFFF) - 0x8000).abs() <= band
            pv = torch.cat([pv, torch.einsum("snkgl,skld->snkgd",
                                             torch.where(near, p * 2.0 ** -7, zero),
                                             v.abs())], -1)
        acc = acc * alpha[..., None] + pv
        m = m_new
    if starts is not None:
        _, total, acc = _merge(done, (m, total, acc))
    out = torch.where(total[..., None] > 0,
                      acc / torch.where(total == 0, 1.0, total)[..., None], zero)
    if band is None:
        return out, None
    return (out[..., :D], out[..., D:]) if flips else (out, torch.zeros_like(out))


@functools.lru_cache(maxsize=256)
def _plan(device_index: int, S: int, N: int, H: int, D: int, KV: int, B: int,
          page_size: int, window: int, dtype: int, cache_dtype: int, kernel: int):
    """The kernel's grid plan (made in csrc/paged_attention.cu) for this
    shape on this device: the fp32 words of workspace its page splits need,
    the code of the kernel it runs (an index into KERNELS; ``kernel`` -1
    for the plan's choice, else that kernel's code), the pages of each
    split and the keys of each step of a row's running max."""
    n = ctypes.c_longlong(0)
    chosen, pages, keys = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _build.check(_build.lib().dstt_paged_attention_plan(
            S, N, H, D, KV, B, page_size, window, dtype, cache_dtype, kernel,
            ctypes.byref(n), ctypes.byref(chosen), ctypes.byref(pages), ctypes.byref(keys)),
            "paged_attention")
    return n.value, chosen.value, pages.value, keys.value


def kernel_plan(q, cache, block_table, *, page_size: int, window: Optional[int] = None,
                kernel: Optional[str] = None):
    """What ``paged_attention`` (or ``run_kernel(kernel, ...)``) launches
    for these CUDA tensors: the name of the kernel (one of KERNELS), the
    pages of each of its splits, counted from each sequence's first live
    page, and the keys of each step of a row's running max (``split_pages``
    and ``tile_keys`` of ``paged_attention_reference``)."""
    S, N, H, D = q.shape
    _, chosen, pages, keys = _plan(
        q.device.index, S, N, H, D, cache.shape[-1] // D, block_table.shape[1], page_size,
        int(window or 0), _build.dtype_code(q.dtype), _build.dtype_code(cache.dtype),
        -1 if kernel is None else KERNELS.index(kernel))
    return KERNELS[chosen], pages, keys


def wgmma_min_rows(D: int) -> int:
    """The folded rows ``N * G`` per (sequence, KV head) from which the plan
    takes the wgmma tiles at head width ``D`` (csrc/paged_attention.cuh
    wgmma_min_rows)."""
    return _build.lib().dstt_paged_wgmma_min_rows(D)


def f32_chunk_min_rows() -> int:
    """The folded rows ``N * G`` per (sequence, KV head) from which the plan
    takes the fp32-query chunk kernel, below which the fp32 decode kernel
    (csrc/paged_f32.cuh kChunkMinRows)."""
    return _build.lib().dstt_paged_f32_chunk_min_rows()


def paged_attention(q, cache, layer: int, block_table, seq_seen, seq_lens,
                    *, page_size: int, window: Optional[int] = None,
                    attn_scale: Optional[float] = None,
                    use_alibi: bool = False, slopes=None, cache_scales=None,
                    softcap: Optional[float] = None):
    """Blocked-flash attention over a paged KV cache.

    Args:
      q: ``[S, N, H, D]`` queries (N new tokens per sequence).
      cache: ``[2L, num_slots, KV*D]`` full paged cache (never sliced), in
        q's dtype or int8.
      layer: which layer's pages to read.
      block_table: ``[S, B]`` int32 page ids per sequence.
      seq_seen: ``[S]`` int32 history length before this step.
      seq_lens: ``[S]`` int32 seen + n_new (valid key region).
      window: sliding window in keys (None = global attention).
      attn_scale: overrides ``1/sqrt(D)``.
      use_alibi: add BLOOM's ALiBi bias with ``alibi_slopes(H)``.
      slopes: explicit ``[KV, G]`` ALiBi slopes (implies ALiBi).
      cache_scales: ``[2L, num_slots, KV]`` fp32 scales of an int8 cache.
      softcap: Gemma-2's attention-logit cap (None = no cap).
    Returns:
      ``[S, N, H, D]`` in q.dtype.
    """
    if q.device.type == "cpu":
        return paged_attention_reference(
            q, cache, layer, block_table, seq_seen, seq_lens,
            page_size=page_size, window=window, attn_scale=attn_scale,
            use_alibi=use_alibi, slopes=slopes, cache_scales=cache_scales,
            softcap=softcap)
    return _launch(-1, q, cache, layer, block_table, seq_seen, seq_lens,
                   page_size=page_size, window=window, attn_scale=attn_scale,
                   use_alibi=use_alibi, slopes=slopes, cache_scales=cache_scales,
                   softcap=softcap)


def run_kernel(kernel: str, q, cache, layer: int, block_table, seq_seen, seq_lens,
               **kw):
    """``paged_attention`` on CUDA tensors through the kernel named
    ``kernel`` (one of KERNELS) whatever the plan would choose, for
    measurements such as the tiles' crossover; raises where that kernel
    does not take the dtypes or head width. Counted as the wrapper counts."""
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: run_kernel launches kernels; got {q.device}")
    return _launch(KERNELS.index(kernel), q, cache, layer, block_table, seq_seen,
                   seq_lens, **kw)


def _launch(kernel: int, q, cache, layer: int, block_table, seq_seen, seq_lens,
            *, page_size: int, window: Optional[int] = None,
            attn_scale: Optional[float] = None, use_alibi: bool = False, slopes=None,
            cache_scales=None, softcap: Optional[float] = None):
    _check_options(softcap)
    if window is not None and window < 1:
        raise ValueError(f"paged_attention: the kernel takes window >= 1, got {window}")
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    S, N, H, D = q.shape
    L2, slots, KVD = cache.shape
    if KVD % D or H % (KVD // D):
        raise ValueError(f"paged_attention: cache minor dim {KVD} does not "
                         f"hold whole heads of D={D} dividing H={H}")
    if D > 256:
        raise ValueError(f"paged_attention: the kernel takes head_dim <= 256, got {D}")
    if not 0 <= layer < L2 // 2:
        raise ValueError(f"paged_attention: layer {layer} out of range")
    if slots % page_size:
        raise ValueError(f"paged_attention: {slots} slots is not a whole "
                         f"number of pages of {page_size}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            cache.dtype not in (q.dtype, torch.int8):
        raise TypeError(f"paged_attention: q {q.dtype} / cache {cache.dtype};"
                        " q must be float32 or bfloat16, the cache q's dtype "
                        "or int8")
    if cache.dtype == torch.int8 and D % 4:
        raise ValueError(f"paged_attention: an int8 cache needs head_dim % 4 "
                         f"== 0, got {D}")
    _check_cache_scales(cache, cache_scales, D)
    slope_table = _alibi_slopes(use_alibi, slopes, H, KVD // D, q.device)
    B = block_table.shape[1]
    for name, t, shape in (("block_table", block_table, (S, B)),
                           ("seq_seen", seq_seen, (S, )),
                           ("seq_lens", seq_lens, (S, ))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"paged_attention: {name} must be int32 {shape},"
                             f" got {t.dtype} {tuple(t.shape)}")
    tensors = (q, cache, block_table, seq_seen, seq_lens) + (
        () if cache_scales is None else (cache_scales, ))
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_attention: all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention: inputs must be contiguous")
    out = torch.empty_like(q)
    scale = attn_scale if attn_scale is not None else 1.0 / (D ** 0.5)
    KV = KVD // D
    window = int(window or 0)  # 0: global attention
    codes = (_build.dtype_code(q.dtype), _build.dtype_code(cache.dtype))
    ws_len, chosen, _, _ = _plan(q.device.index, S, N, H, D, KV, B, page_size, window,
                                 *codes, kernel)
    workspace = (torch.empty(ws_len, dtype=torch.float32, device=q.device)
                 if ws_len else None)
    lib = _build.lib()
    with torch.cuda.device(q.device):
        err = lib.dstt_paged_attention(
            q.data_ptr(), cache.data_ptr(),
            None if cache_scales is None else cache_scales.data_ptr(),
            None if slope_table is None else slope_table.data_ptr(),
            out.data_ptr(), block_table.data_ptr(), seq_seen.data_ptr(),
            seq_lens.data_ptr(), S, N, H, D, KV, B, slots, int(layer),
            page_size, window, float(scale), float(softcap or 0.0), *codes, chosen,
            None if workspace is None else workspace.data_ptr(), ws_len,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_attention")
    if softcap is not None:
        paged_attention.softcap_launches += 1
    elif slope_table is not None:
        paged_attention.alibi_launches += 1
    elif cache.dtype == torch.int8:
        paged_attention.int8_launches += 1
    else:
        paged_attention.launches += 1
    counter = KERNEL_COUNTERS[chosen]
    setattr(paged_attention, counter, getattr(paged_attention, counter) + 1)
    return out


paged_attention.launches = 0
for _counter in KERNEL_COUNTERS:
    setattr(paged_attention, _counter, 0)
paged_attention.int8_launches = 0
paged_attention.alibi_launches = 0
paged_attention.softcap_launches = 0
