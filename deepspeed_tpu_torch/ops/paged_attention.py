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
float that applies). ``paged_attention.wgmma_launches`` counts, beside
them, the launches that ran the multi-row tiles on wgmma (a bf16 query
over a bf16 or int8 cache with at least 64 folded rows ``N * G`` per
sequence and KV head, at head widths 65..256); the others, decode among
them, run the CUDA-core kernel. The kernel's plan decides
(``dstt_paged_attention_plan``). All take the JAX kernel's sliding
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
from typing import Optional

import torch

from . import _build

NEG_INF = -1e30


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
                              softcap: Optional[float] = None):
    """Dense-gather reference: gathers each sequence's ``B*page_size``
    history window (an int8 window dequantized in fp32; freed table entries
    gather block 0 and are masked), caps the scaled scores, adds the ALiBi
    bias, masks, softmaxes in fp32."""
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
    scores = torch.where(mask[:, :, None, None, :], scores,
                         torch.full((), NEG_INF, device=dev))
    probs = torch.softmax(scores, dim=-1)
    any_visible = mask.any(-1)[:, :, None, None, None]
    out = torch.einsum("snkgl,skld->snkgd", probs, v_h)
    out = torch.where(any_visible, out, torch.zeros((), device=dev))
    return out.reshape(S, N, H, D).to(q.dtype)


@functools.lru_cache(maxsize=256)
def _plan(device_index: int, S: int, N: int, H: int, D: int, KV: int, B: int,
          page_size: int, window: int, dtype: int, cache_dtype: int):
    """The kernel's grid plan (made in csrc/paged_attention.cu) for this
    shape on this device: the fp32 words of workspace its page splits need,
    and whether it runs the wgmma kernel."""
    n, wgmma = ctypes.c_longlong(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _build.check(_build.lib().dstt_paged_attention_plan(
            S, N, H, D, KV, B, page_size, window, dtype, cache_dtype,
            ctypes.byref(n), ctypes.byref(wgmma)), "paged_attention")
    return n.value, bool(wgmma.value)


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
    ws_len, wgmma = _plan(q.device.index, S, N, H, D, KV, B, page_size, window, *codes)
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
            page_size, window, float(scale), float(softcap or 0.0), *codes,
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
    if wgmma:
        paged_attention.wgmma_launches += 1
    return out


paged_attention.launches = 0
paged_attention.wgmma_launches = 0
paged_attention.int8_launches = 0
paged_attention.alibi_launches = 0
paged_attention.softcap_launches = 0
