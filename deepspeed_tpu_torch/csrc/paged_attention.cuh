// Paged (blocked-flash) attention of N new tokens per sequence over the
// ragged engine's paged KV cache.
//
// Replaces the TPU kernel deepspeed_tpu/ops/paged_attention.py:60
// _paged_attn_kernel (driven by paged_attention :166). It computes the same
// function, not the same grid:
//   q      [S, N, H, D]     H = KV*G query heads, kv-major (head h*G+g uses
//                           KV head h)
//   cache  [2L, slots, KV*D] k at row 2*layer, v at row 2*layer+1, flat
//                           slot = page*page_size + offset; fp32, bf16 (the
//                           query's dtype) or int8
//   cache_scales [2L, slots, KV] fp32, for an int8 cache only: element d of
//                           head h at a slot is cache * scale[row, slot, h]
//   block_table [S, B], seen [S], lens [S] (int32)
//   out    [S, N, H, D]     in q's dtype
//   slopes [KV, G] fp32     ALiBi only (BLOOM): query head h*G+g's slope
// Query row (n, g) of sequence s sees key position p iff p <= seen+n and
// p < lens, and, with a sliding window W > 0, p > seen+n - W (the TPU
// kernel's mask, :106); scores are q.k*scale, then with a softcap c
// (Gemma-2) c * tanh(s / c) (the TPU kernel's :122-124, before any bias or
// mask), plus with ALiBi slopes[h, g] * (p - (seen+n)) in fp32 (the TPU
// kernel's :125-131; the bias depends only on positions and the head, so
// every split of a sequence's pages biases alike); softmax online in fp32;
// a row that sees no key outputs 0 (the TPU kernel's l == 0 finalize).
// Head widths up to 256 (Gemma-2's): a lane keeps DPL = 4 or 8 output
// dims of each query row it owns.
//
// Bound on the H100: bytes for decode (each query row meets every history
// key once, about 4 flops per 2 bytes of K/V read), and, for long prefill
// chunks, the CUDA-core flops, since this first version does the two
// products on CUDA cores, not on tensor cores. What the design does:
// - One thread block per (tile of query rows, KV head, sequence). The G
//   query heads that share a KV head sit in one block, so each K/V page is
//   read from device memory once per tile, never once per query head (GQA
//   native, as on the TPU). The block reads its sequence's block table
//   itself (the TPU kernel had it scalar-prefetched).
// - The TPU's sequential page axis becomes a loop inside the block: a page
//   of K and V for this head ([page_size, D] each) is staged in shared
//   memory, and every warp updates its query rows' running max, sum and
//   fp32 accumulator in registers. Nothing carries between blocks.
// - The loop stops at the last page the tile can see (causal from seen+n,
//   bounded by lens), so short sequences do not pay for the block-table
//   bucket, and padding sequences (lens 0) read nothing.
// - With a window W it also starts late: page b is live only if
//   (b+1)*page_size - 1 > seen - W (the TPU kernel's skip, :90, with seen the
//   chunk's first query), and a tile skips the pages older than the window
//   of its own first query too. Pages before the first live one are never
//   staged: the engine has freed them (their table entries hold block 0,
//   which another sequence owns) once the sequence decoded past them.
// - Decode has few query rows (S * KV blocks of G rows: 64 blocks for 8
//   sequences, half the SMs, each walking its pages alone). When the grid
//   is small, plan() splits each sequence's pages over `splits` blocks
//   (flash-decoding): each writes its rows' partial max, sum and fp32
//   accumulator to a workspace, and combine_kernel rescales them to the
//   common max and divides. The result is the same online softmax, summed
//   in another order. With a window the splits cover the live span, at
//   most ceil((W + N - 1) / page_size) + 1 pages from the sequence's first
//   live page, not the whole table width: a split past the span, or whose
//   pages the tile skips, writes l = 0 and no accumulator, and the combine
//   leaves it out. The caller asks dstt_paged_attention_workspace for the
//   workspace size, so the grid rule lives only in this file.
// - Scores: one lane per key, the K row padded in shared memory to an odd
//   number of 4-byte words so the 32 lanes hit 32 banks. P.V: one lane per
//   output dim, with the page's probabilities broadcast from shared memory.
// - int8 cache (the TPU kernel's int8 branch, paged_attention.py:111-117):
//   the page is dequantized as it is staged, with the Pallas kernel's
//   numerics: the scale rounds to bf16, and the product bf16(code) *
//   bf16(scale) rounds to bf16 (exact in fp32, then one rounding), so the
//   staged K/V are the bf16 values the TPU kernel feeds its dot. The rest of
//   the kernel reads them as it reads a bf16 page. It moves about half the
//   bytes of a bf16 page: D + 4 bytes per (slot, head) instead of 2*D.
// Later versions move both products to wgmma with TMA-fed page rings.
#pragma once

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace dstt {

constexpr int kAttnWarps = 4;
constexpr int kAttnThreads = kAttnWarps * 32;
constexpr int kMaxPage = 128;  // keys per page: at most 4 per lane
constexpr int kMaxHeadDim = 256;  // output dims: at most 8 per lane
constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF

struct PagedArgs {
  const void* q;
  const void* cache;
  const float* cache_scales;  // int8 cache only
  const float* slopes;        // [KV, G] ALiBi slopes; ALiBi instances only
  void* out;
  const int* block_table;
  const int* seen;
  const int* lens;
  int S, N, H, D, KV, B;
  long long slots;
  int layer, page_size;
  int window;  // sliding window in keys; 0 = global attention
  float scale;
  float softcap;  // s = softcap * tanh(s / softcap); softcap instances only
  // split over pages: block split k covers pages [f + k*P, f + (k+1)*P),
  // f the sequence's first live page (0 without a window); with
  // splits > 1 each split writes its partial (max, sum, accumulator) to
  // ws_ml / ws_acc and combine_kernel merges them
  int splits, pages_per_split;
  float* ws_acc;  // [S, KV, N*G, splits, D]
  float* ws_ml;   // [S, KV, N*G, splits, 2]
};

// What a page is staged as in shared memory: the cache's own type, or bf16
// for an int8 cache (dequantized while staged)
template <typename C> struct Staged { using type = C; };
template <> struct Staged<int8_t> { using type = __nv_bfloat16; };

// K rows in shared memory are padded to an odd count of 4-byte words
template <typename T>
__host__ __device__ inline int k_stride_words(int D) {
  int w = D * (int)sizeof(T) / 4;
  return (w % 2 == 0) ? w + 1 : w;
}

template <typename T>
__host__ inline size_t smem_bytes(int D, int page_size, int rows_per_block) {
  size_t k = (size_t)page_size * k_stride_words<T>(D) * 4;
  size_t v = (size_t)page_size * D * sizeof(T);
  v = (v + 15) / 16 * 16;
  size_t qs = (size_t)rows_per_block * D * 4;
  size_t ps = (size_t)kAttnWarps * page_size * 4;
  return ((k + 15) / 16 * 16) + v + qs + ps;
}

// Four int8 codes (one 32-bit word, little-endian) times a bf16 scale,
// each product rounded to bf16: two words of bf16 pairs
__device__ __forceinline__ uint2 dequant4(uint32_t w, float scale) {
  uint2 out;
  uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float lo = (float)(int8_t)((w >> (16 * k)) & 0xff) * scale;
    const float hi = (float)(int8_t)((w >> (16 * k + 8)) & 0xff) * scale;
    __nv_bfloat162 h = __halves2bfloat162(__float2bfloat16(lo), __float2bfloat16(hi));
    o[k] = *reinterpret_cast<uint32_t*>(&h);
  }
  return out;
}

// T: the query's and output's type; C: the cache's (T, or int8).
// DPL: output dims per lane (D <= 32*DPL); RPW: query rows per warp;
// kAlibi: add the ALiBi bias; kCap: the softcap (template flags, so the
// other instances keep their code as it was)
template <typename T, typename C, int DPL, int RPW, bool kAlibi, bool kCap>
__global__ void __launch_bounds__(kAttnThreads)
paged_attention_kernel(PagedArgs a) {
  using S = typename Staged<C>::type;
  constexpr bool kInt8Cache = std::is_same<C, int8_t>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D, ps = a.page_size;
  const int G = a.H / a.KV;
  const int rows = a.N * G;
  constexpr int RPB = kAttnWarps * RPW;  // query rows per block
  const int kw = k_stride_words<S>(D);  // padded K row, in words
  const int vw = D * (int)sizeof(S) / 4;  // V row, in words

  uint32_t* Ks = reinterpret_cast<uint32_t*>(smem);
  size_t off = ((size_t)ps * kw * 4 + 15) / 16 * 16;
  uint32_t* Vs = reinterpret_cast<uint32_t*>(smem + off);
  off += ((size_t)ps * D * sizeof(S) + 15) / 16 * 16;
  float* Qs = reinterpret_cast<float*>(smem + off);
  off += (size_t)RPB * D * 4;
  float* Ps = reinterpret_cast<float*>(smem + off);

  const int tile = blockIdx.x / a.splits, split = blockIdx.x % a.splits;
  const int h = blockIdx.y, s = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = tile * RPB;
  const int hist = a.lens[s];
  const int seen = a.seen[s];
  const T* q = reinterpret_cast<const T*>(a.q);
  T* out = reinterpret_cast<T*>(a.out);

  // this tile's query rows -> shared memory (fp32), zeros past the end
  for (int i = threadIdx.x; i < RPB * D; i += kAttnThreads) {
    const int r = row0 + i / D, d = i % D;
    float v = 0.f;
    if (r < rows) {
      const int n = r / G, head = h * G + r % G;
      v = to_float(q[((long long)(s * a.N + n) * a.H + head) * D + d]);
    }
    Qs[i] = v;
  }

  // pages this tile can see: keys up to min(lens, seen + last n + 1)
  const int n_last = min(a.N - 1, (min(row0 + RPB, rows) - 1) / G);
  const int last_key = min(hist - 1, seen + n_last);
  const int n_pages = last_key < 0 ? 0 : min(a.B, last_key / ps + 1);
  // with a window: the sequence's first live page (where the splits
  // start) and this tile's, from the query of its first row
  int seq_first = 0, tile_first = 0;
  if (a.window > 0) {
    seq_first = max(0, seen - a.window + 1) / ps;
    tile_first = max(0, seen + row0 / G - a.window + 1) / ps;
  }
  const int b_begin = max(tile_first, seq_first + split * a.pages_per_split);
  const int b_end = min(n_pages, seq_first + (split + 1) * a.pages_per_split);

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[rr][i] = 0.f;
  }

  const size_t kvd = (size_t)a.KV * D;
  const C* kbase = reinterpret_cast<const C*>(a.cache) +
                   (size_t)(2 * a.layer) * a.slots * kvd + (size_t)h * D;
  const C* vbase = kbase + (size_t)a.slots * kvd;
  float* Pw = Ps + warp * ps;

  for (int b = b_begin; b < b_end; ++b) {
    const long long page = a.block_table[(long long)s * a.B + b];
    __syncthreads();  // previous page fully consumed (and Qs written)
    for (int j = warp; j < ps; j += kAttnWarps) {
      const size_t slot = (size_t)page * ps + j;
      const uint32_t* kg = reinterpret_cast<const uint32_t*>(kbase + slot * kvd);
      const uint32_t* vg = reinterpret_cast<const uint32_t*>(vbase + slot * kvd);
      if constexpr (kInt8Cache) {
        // the scales of (slot, head h) in k row 2*layer and v row 2*layer+1;
        // the TPU kernel's order: bf16(code) * bf16(scale), rounded to bf16
        const float* ksc = a.cache_scales + ((size_t)(2 * a.layer) * a.slots + slot) * a.KV + h;
        const float k_scale = __bfloat162float(__float2bfloat16(ksc[0]));
        const float v_scale = __bfloat162float(__float2bfloat16(ksc[(size_t)a.slots * a.KV]));
        for (int c = lane; c < D / 4; c += 32) {
          const uint2 kd = dequant4(kg[c], k_scale), vd = dequant4(vg[c], v_scale);
          Ks[j * kw + 2 * c] = kd.x;
          Ks[j * kw + 2 * c + 1] = kd.y;
          Vs[j * vw + 2 * c] = vd.x;
          Vs[j * vw + 2 * c + 1] = vd.y;
        }
      } else {
        for (int c = lane; c < vw; c += 32) {
          Ks[j * kw + c] = kg[c];
          Vs[j * vw + c] = vg[c];
        }
      }
    }
    __syncthreads();
    const S* Kt = reinterpret_cast<const S*>(Ks);
    const S* Vt = reinterpret_cast<const S*>(Vs);
    const int kstride = kw * 4 / (int)sizeof(S);  // padded K row, in elements
    const int key0 = b * ps;

#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int rl = warp * RPW + rr;
      const int r = row0 + rl;
      if (r >= rows) continue;  // warp-uniform
      const int q_abs = seen + r / G;
      if (key0 > q_abs || key0 >= hist) continue;  // page fully masked
      if (a.window > 0 && key0 + ps - 1 <= q_abs - a.window)
        continue;  // page wholly older than this row's window
      const float* qr = Qs + rl * D;
      const float slope = kAlibi ? a.slopes[h * G + r % G] : 0.f;

      float sc[kMaxPage / 32];
      float mx = kNegInf;
#pragma unroll
      for (int t = 0; t < kMaxPage / 32; ++t) {
        const int j = lane + 32 * t;
        float v = kNegInf;
        if (j < ps) {
          const int key = key0 + j;
          if (key <= q_abs && key < hist && (a.window <= 0 || key > q_abs - a.window)) {
            const S* kr = Kt + j * kstride;
            // four independent chains: the loop is latency-bound otherwise
            float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
            int d = 0;
            for (; d + 4 <= D; d += 4) {
              d0 += qr[d] * to_float(kr[d]);
              d1 += qr[d + 1] * to_float(kr[d + 1]);
              d2 += qr[d + 2] * to_float(kr[d + 2]);
              d3 += qr[d + 3] * to_float(kr[d + 3]);
            }
            for (; d < D; ++d) d0 += qr[d] * to_float(kr[d]);
            v = ((d0 + d1) + (d2 + d3)) * a.scale;
            if constexpr (kCap) v = a.softcap * tanhf(v / a.softcap);
            // the plain version's order: the product, then the sum, each
            // rounded (no fma)
            if constexpr (kAlibi) v = __fadd_rn(v, __fmul_rn(slope, (float)(key - q_abs)));
          }
        }
        sc[t] = v;
        mx = fmaxf(mx, v);
      }
      mx = warp_max(mx);
      const float m_new = fmaxf(m[rr], mx);
      const float alpha = expf(m[rr] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int t = 0; t < kMaxPage / 32; ++t) {
        const int j = lane + 32 * t;
        if (j < ps) {
          const float p = sc[t] > kNegInf ? expf(sc[t] - m_new) : 0.f;
          Pw[j] = p;
          psum += p;
        }
      }
      l[rr] = alpha * l[rr] + warp_sum(psum);
      m[rr] = m_new;
      __syncwarp();
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) {
          float p0 = 0.f, p1 = 0.f;
          int j = 0;
          for (; j + 2 <= ps; j += 2) {
            p0 += Pw[j] * to_float(Vt[j * D + d]);
            p1 += Pw[j + 1] * to_float(Vt[(j + 1) * D + d]);
          }
          if (j < ps) p0 += Pw[j] * to_float(Vt[j * D + d]);
          acc[rr][i] = acc[rr][i] * alpha + (p0 + p1);
        }
      }
      __syncwarp();  // Pw is rewritten by the next row
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = row0 + warp * RPW + rr;
    if (r >= rows) continue;
    if (a.splits > 1) {
      const size_t part = (((size_t)s * a.KV + h) * rows + r) * a.splits + split;
      if (l[rr] > 0.f) {  // combine_kernel reads no accumulator of an empty split
        float* wa = a.ws_acc + part * D;
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          if (d < D) wa[d] = acc[rr][i];
        }
      }
      if (lane == 0) {
        a.ws_ml[2 * part] = m[rr];
        a.ws_ml[2 * part + 1] = l[rr];
      }
      continue;
    }
    const int n = r / G, head = h * G + r % G;
    T* orow = out + ((long long)(s * a.N + n) * a.H + head) * D;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) orow[d] = from_float<T>(l[rr] > 0.f ? acc[rr][i] / l[rr] : 0.f);
    }
  }
}

// Merge the splits of one query row: rescale each split's sum and
// accumulator to the common max, add, divide. One warp per row. Each
// split's weight exp(m_k - max) is computed once, by one lane of a chunk of
// 32 splits, and broadcast; lane i keeps output dims i, i+32, ... (DPL of
// them, as the launched attention kernel) in registers across the splits.
template <typename T, int DPL>
__global__ void __launch_bounds__(kAttnThreads)
combine_kernel(PagedArgs a) {
  const int G = a.H / a.KV, rows = a.N * G, D = a.D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * kAttnWarps + warp, h = blockIdx.y, s = blockIdx.z;
  if (r >= rows) return;
  const size_t part0 = (((size_t)s * a.KV + h) * rows + r) * a.splits;
  const float* ml = a.ws_ml + 2 * part0;
  float mx = kNegInf;
  for (int k = lane; k < a.splits; k += 32) mx = fmaxf(mx, ml[2 * k]);
  mx = warp_max(mx);
  float lsum = 0.f, v[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) v[i] = 0.f;
  for (int k0 = 0; k0 < a.splits; k0 += 32) {
    const int k = k0 + lane;
    // an empty split (l = 0) wrote no accumulator: weight 0, never read
    const float w = k < a.splits && ml[2 * k + 1] > 0.f ? expf(ml[2 * k] - mx) : 0.f;
    if (k < a.splits) lsum += ml[2 * k + 1] * w;
    const int nk = min(32, a.splits - k0);
    for (int j = 0; j < nk; ++j) {
      const float wj = __shfl_sync(0xffffffffu, w, j);
      if (wj == 0.f) continue;  // warp-uniform
      const float* acc = a.ws_acc + (part0 + k0 + j) * D;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) v[i] += acc[d] * wj;
      }
    }
  }
  lsum = warp_sum(lsum);
  const int n = r / G, head = h * G + r % G;
  T* orow = reinterpret_cast<T*>(a.out) + ((long long)(s * a.N + n) * a.H + head) * D;
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    if (d < D) orow[d] = from_float<T>(lsum > 0.f ? v[i] / lsum : 0.f);
  }
}

template <typename T, typename C, int DPL, int RPW, bool kAlibi, bool kCap>
cudaError_t launch_paged(const PagedArgs& a, cudaStream_t stream) {
  const int rows = a.N * (a.H / a.KV);
  constexpr int RPB = kAttnWarps * RPW;
  const size_t smem = smem_bytes<typename Staged<C>::type>(a.D, a.page_size, RPB);
  auto kern = paged_attention_kernel<T, C, DPL, RPW, kAlibi, kCap>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((rows + RPB - 1) / RPB * a.splits, a.KV, a.S);
  kern<<<grid, kAttnThreads, smem, stream>>>(a);
  if (a.splits > 1) {
    const dim3 cgrid((rows + kAttnWarps - 1) / kAttnWarps, a.KV, a.S);
    combine_kernel<T, DPL><<<cgrid, kAttnThreads, 0, stream>>>(a);
  }
  return cudaSuccess;
}

template <typename T, typename C, int DPL, bool kAlibi, bool kCap>
cudaError_t launch_paged_rpw(const PagedArgs& a, int rpw, cudaStream_t stream) {
  return rpw == 1 ? launch_paged<T, C, DPL, 1, kAlibi, kCap>(a, stream)
                  : launch_paged<T, C, DPL, 4, kAlibi, kCap>(a, stream);
}

template <typename T, typename C, int DPL, bool kCap>
cudaError_t launch_paged_alibi(const PagedArgs& a, int rpw, cudaStream_t stream) {
  return a.slopes ? launch_paged_rpw<T, C, DPL, true, kCap>(a, rpw, stream)
                  : launch_paged_rpw<T, C, DPL, false, kCap>(a, rpw, stream);
}

template <typename T, typename C, int DPL>
cudaError_t launch_paged_cap(const PagedArgs& a, int rpw, cudaStream_t stream) {
  return a.softcap > 0.f ? launch_paged_alibi<T, C, DPL, true>(a, rpw, stream)
                         : launch_paged_alibi<T, C, DPL, false>(a, rpw, stream);
}

// The instances of one (query, cache) type pair: DPL 4 serves head widths
// up to 128 (Llama's, and the narrow test widths), DPL 8 Gemma-2's 256.
// Each pair is compiled in a source of its own (paged_attention_<pair>.cu),
// so the build runs them in parallel; the entry points in
// paged_attention.cu only call them.
template <typename T, typename C>
cudaError_t launch_cache(const PagedArgs& a, int rpw, cudaStream_t stream) {
  return a.D <= 128 ? launch_paged_cap<T, C, 4>(a, rpw, stream)
                    : launch_paged_cap<T, C, 8>(a, rpw, stream);
}

extern template cudaError_t launch_cache<float, float>(const PagedArgs&, int, cudaStream_t);
extern template cudaError_t launch_cache<__nv_bfloat16, __nv_bfloat16>(const PagedArgs&, int,
                                                                       cudaStream_t);
extern template cudaError_t launch_cache<float, int8_t>(const PagedArgs&, int, cudaStream_t);
extern template cudaError_t launch_cache<__nv_bfloat16, int8_t>(const PagedArgs&, int,
                                                                cudaStream_t);

}  // namespace dstt
