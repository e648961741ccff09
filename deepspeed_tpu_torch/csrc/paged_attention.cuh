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
// key once, about 4 flops per 2 bytes of bf16 K/V read); operations for
// prefill chunks (a 768-token chunk meets thousands of keys per row). Five
// kernels; paged_attention.cu's plan() picks one per launch by the query's
// dtype, the head width and the folded rows N * G per (sequence, KV head):
// - bf16 queries, at least wgmma_min_rows(D) rows (17; 33 past head width
//   128), head widths 65..256 (D % 8 == 0; an int8 cache D % 16 == 0): the
//   multi-row tiles on wgmma (paged_attention_wgmma_kernel, below): prefill
//   chunks, admission waves, mixed batches. It is K1's forward sweep
//   (flash_attention.cuh fwd_sweep) with a source of its own (PagedSrc):
//   one block per (128 folded rows, KV head, sequence, split), a
//   warpgroup per 64 rows, key tiles of 64 (32 at head width 256) gathered
//   through the block table (key j is slot block_table[s, j / page_size] *
//   page_size + j % page_size, 16-byte cp.async rows into the swizzled
//   tile, any page size), positions seen + f / G, ALiBi's head h * G + f % G
//   (FastDiv for both), S = Q K^T and o += P V on the tensor cores with P
//   rounded to bf16 as the JAX kernel rounds it (:147). An int8 tile's
//   codes and scales are copied two tiles ahead and each thread dequantizes
//   the codes it copied, with the numerics below, into the bf16 tile. The
//   block's keys are [kmin, kmax]: from its first row's window (the entries
//   the engine freed below it are never read) or its split's first page,
//   to the last key its last row sees; keys outside are never copied and
//   always masked. Where the grid is under a wave of SMs, the pages are
//   split as below. On a 768-row Gemma-2 chunk the CUDA-core kernel took
//   13.2 ms against a 0.05 ms bound on the H100; the tiles ~0.31 ms
//   (PERF.md, section 6).
// - bf16 queries under that row count at D % 16 == 0: the bf16 decode
//   kernel (paged_decode_kernel, paged_decode.cuh): decode steps, small
//   chunks; mma.sync with warps splitting the keys and a cp.async ring.
// - fp32 queries at D % 4 == 0 over an fp32 or int8 cache: from
//   f32::kChunkMinRows rows (33) the fp32 chunk kernel, below them the fp32
//   decode kernel (paged_f32_chunk_kernel, paged_f32_decode_kernel,
//   paged_f32.cuh): register-blocked FFMA products on the CUDA cores (true
//   fp32, no TF32), cp.async rings, lean splits.
// - The rest: the CUDA-core kernel (paged_attention_kernel, below): bf16
//   queries that neither the tiles nor the bf16 decode kernel take (a width
//   that is not a multiple of 16, where the tiles do not take the shape)
//   and fp32 queries at D % 4 != 0. No model of the repo has such a width; the
//   kernel is also held for measurements (run_kernel("cuda cores")). Over
//   bf16-staged K/V (a bf16 cache, or an int8 cache under fp32 queries) it
//   rounds P to bf16 before P V as the JAX kernel does, and sums it
//   unrounded into the row's sum; fp32 over an fp32 cache keeps P in fp32,
//   as the JAX kernel's p.astype(v.dtype) does. Its note and what held it
//   back are below; each of the other kernels' notes says what its design
//   does about that.
// What the CUDA-core kernel's design does:
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
// - Few query rows (an fp32 decode step: S * KV blocks of G rows, 64
//   blocks for 8 sequences, half the SMs, each walking its pages alone).
//   When the grid is small, plan() splits each sequence's pages over
//   `splits` blocks (flash-decoding): each writes its rows' partial max,
//   sum and fp32 accumulator to a workspace, and combine_kernel rescales
//   them to the common max and divides. The result is the same online softmax, summed
//   in another order. With a window the splits cover the live span, at
//   most ceil((W + N - 1) / page_size) + 1 pages from the sequence's first
//   live page, not the whole table width: a split past the span, or whose
//   pages the tile skips, writes l = 0 and no accumulator, and the combine
//   leaves it out. The caller asks dstt_paged_attention_plan for the
//   workspace size and the kernel, so the grid rule lives only in
//   paged_attention.cu.
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
#pragma once

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "flash_attention.cuh"

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
          // P V takes P in the staged type where that is bf16 (the JAX
          // kernel's p.astype(v.dtype)); the row's sum takes it unrounded
          Pw[j] = std::is_same<S, __nv_bfloat16>::value
                      ? __bfloat162float(__float2bfloat16(p)) : p;
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

// Merge the splits of one query row (every K4 kernel's): rescale each
// split's sum and accumulator to the common max, add, divide. One block per
// row; every thread reads the splits' (max, sum) and keeps output dims
// threadIdx.x and + 128 over all of them, each split's loads independent of
// the last's. An empty split (sum 0) wrote no accumulator and is never read.
template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
combine_kernel(PagedArgs a) {
  const int G = a.H / a.KV, rows = a.N * G, D = a.D;
  const int r = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const size_t part0 = (((size_t)s * a.KV + h) * rows + r) * a.splits;
  const float* ml = a.ws_ml + 2 * part0;
  const float* acc = a.ws_acc + part0 * D;
  float mx = kNegInf;
  for (int k = 0; k < a.splits; ++k)
    if (ml[2 * k + 1] > 0.f) mx = fmaxf(mx, ml[2 * k]);
  constexpr int kPer = kMaxHeadDim / kAttnThreads;
  float lsum = 0.f, v[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) v[i] = 0.f;
#pragma unroll 4
  for (int k = 0; k < a.splits; ++k) {
    const float lk = ml[2 * k + 1];
    const float w = lk > 0.f ? expf(ml[2 * k] - mx) : 0.f;
    lsum += lk * w;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int d = threadIdx.x + kAttnThreads * i;
      if (d < D) v[i] += (w > 0.f ? acc[(size_t)k * D + d] : 0.f) * w;
    }
  }
  const int n = r / G, head = h * G + r % G;
  T* orow = reinterpret_cast<T*>(a.out) + ((long long)(s * a.N + n) * a.H + head) * D;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int d = threadIdx.x + kAttnThreads * i;
    if (d < D) orow[d] = from_float<T>(lsum > 0.f ? v[i] / lsum : 0.f);
  }
}

// Raise kernel `kern`'s dynamic shared memory limit to `smem` bytes on the
// current device, once per device (`ready`: the caller's flags for that
// kernel): the call costs the host microseconds on every decode launch.
template <typename K>
cudaError_t allow_smem(K kern, size_t smem, bool (&ready)[64]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && ready[dev])) return e;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && dev < 64) ready[dev] = true;
  return e;
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
  if (a.splits > 1) combine_kernel<T><<<dim3(rows, a.KV, a.S), kAttnThreads, 0, stream>>>(a);
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

// ---- multi-row tiles on wgmma: bf16 queries over a bf16 or int8 cache ----

// folded rows (n * G + g) per (sequence, KV head) from which a launch takes
// the wgmma kernel (plan()), below which the decode kernel, which reads
// every K/V tile once per 16 rows. Measured on the H100 (PERF.md, section
// 6; chip_smoke.py's crossover sweep at the serving families' widths). Up
// to head width 128, one more than the decode kernel's 16-row block: the
// decode kernel wins at 8 and 16 rows at G 4 and 9 at G 9, the tiles from
// 20 (G 4) and 18 (G 9); at G 1 the decode kernel stays ~7% ahead up to 24
// rows and they tie at 32. Past 128 (Gemma-2's 256, G 2), one more than two
// decode blocks: the tiles (one 128-row block an SM) take ~0.17 ms whatever
// the rows, the decode kernel 0.13 at 18-32 rows and 0.19 at 48. The
// wrapper reads it through dstt_paged_wgmma_min_rows.
constexpr int kWgmmaMinRows = 17;
constexpr int kWgmmaMinRowsWide = 33;

inline int wgmma_min_rows(int D) { return D > 128 ? kWgmmaMinRowsWide : kWgmmaMinRows; }

// K4's keys and rows for flash::fwd_sweep (flash_attention.cuh): folded row
// f = n * G + g of sequence s and KV head h is query (n, h * G + g) at
// position seen + n; key j is slot block_table[s, j / page_size] *
// page_size + j % page_size of the cache's rows 2 * layer (K) and
// 2 * layer + 1 (V). The block's keys are [kmin, kmax]: from the first
// row's window (the freed entries below it are never read) or its split's
// first page, to the last key its last row sees (causal, < lens) or its
// split's last page. Keys outside it are never copied and always masked.
template <typename C, bool kAlibiFlag>
struct PagedSrc {
  using T = __nv_bfloat16;
  static constexpr bool kAlibi = kAlibiFlag;
  static constexpr bool kStaged = std::is_same<C, int8_t>::value;
  flash::FastDiv G, PS;
  int rows, D, ps, KV, window, seen, kmin, kmax;
  float scale, softcap;
  const T* q;
  const int* bt;        // this sequence's block-table row
  const C* kc;          // the cache row of K, at KV head h
  const C* vc;          // of V
  const float* ksc;     // int8: the scales of K's row, at KV head h
  const float* vsc;     // of V
  const float* slopes;  // ALiBi: the slopes of KV head h's G query heads
  long long q_base;     // element row of (sequence s, n 0, head h * G)
  int H;

  __device__ __forceinline__ PagedSrc(const PagedArgs& a, int s, int h, int f0, int split)
      : G(a.H / a.KV), PS(a.page_size), rows(a.N * (a.H / a.KV)), D(a.D), ps(a.page_size),
        KV(a.KV), window(a.window), seen(a.seen[s]), scale(a.scale), softcap(a.softcap),
        q(reinterpret_cast<const T*>(a.q)), bt(a.block_table + (long long)s * a.B), H(a.H) {
    const long long kvd = (long long)a.KV * a.D;
    kc = reinterpret_cast<const C*>(a.cache) + 2LL * a.layer * a.slots * kvd + (long long)h * a.D;
    vc = kc + a.slots * kvd;
    ksc = a.cache_scales ? a.cache_scales + 2LL * a.layer * a.slots * a.KV + h : nullptr;
    vsc = ksc ? ksc + a.slots * a.KV : nullptr;
    slopes = a.slopes ? a.slopes + (long long)h * (int)G.d : nullptr;
    q_base = (long long)s * a.N * a.H + (long long)h * (int)G.d;
    const int n_first = (int)G(f0), n_last = (int)G(min(f0 + flash::kWgRows, rows) - 1);
    const int hist = a.lens[s];
    kmin = window > 0 ? max(0, seen + n_first - window + 1) : 0;
    kmax = min(hist - 1, seen + n_last);
    // the split's pages, from the sequence's first live page (as
    // paged_attention_kernel)
    const int seq_first = window > 0 ? max(0, seen - window + 1) / ps : 0;
    kmin = max(kmin, (seq_first + split * a.pages_per_split) * ps);
    kmax = min(kmax, min(a.B, seq_first + (split + 1) * a.pages_per_split) * ps - 1);
  }
  __device__ __forceinline__ long long q_row(int f) const {
    if (f >= rows) return -1LL;
    const int n = (int)G(f);
    return q_base + (long long)n * H + (f - n * (int)G.d);
  }
  __device__ __forceinline__ int pos(int f) const { return seen + (int)G(f); }
  template <int KT>
  __device__ __forceinline__ void key_tiles(int, int, int& t_begin, int& t_end) const {
    t_begin = max(kmin, 0) / KT;
    t_end = kmin <= kmax ? kmax / KT + 1 : t_begin;
  }
  template <int KT>
  __device__ __forceinline__ bool edge(int k0, int p_first, int p_last) const {
    return k0 < kmin || k0 + KT - 1 > kmax || k0 + KT - 1 > p_first ||
           (window > 0 && p_last - k0 >= window);
  }
  __device__ __forceinline__ bool masked(int p, int key) const {
    return (key < kmin) | (key > kmax) | (key > p) | ((window > 0) & (p - key >= window));
  }
  __device__ __forceinline__ float slope(int f) const {
    return slopes[f - (int)G(f) * (int)G.d];
  }
  // the cache row (in units of D) of key k0 + r, -1 outside [kmin, kmax]
  __device__ __forceinline__ long long key_row(int key) const {
    if (key < kmin || key > kmax) return -1LL;
    const int page = (int)PS(key);
    return ((long long)bt[page] * ps + (key - page * ps)) * KV;
  }
  template <int KT, int DMAX>
  __device__ __forceinline__ void load(int t, T* Kb, T* Vb, unsigned char* slot) const {
    const int k0 = t * KT;
    if constexpr (!kStaged) {
      flash::load_pair<T, DMAX, KT>(Kb, kc, Vb, vc, D, [&](int r) { return key_row(k0 + r); });
    } else {
      // the int8 codes ([KT][DMAX] bytes of K, then of V), 16 codes a copy,
      // and each copied row's two scales into this thread's own slots
      constexpr int kChunks = DMAX / 16, kStride = flash::kWgThreads / kChunks;
      static_assert(KT % kStride == 0, "key rows a multiple of the threads' row stride");
      float* sc = reinterpret_cast<float*>(slot + 2 * KT * DMAX);
      const int c = threadIdx.x % kChunks, r0 = threadIdx.x / kChunks;
#pragma unroll
      for (int j = 0; j < KT / kStride; ++j) {
        const int r = r0 + j * kStride;
        const long long g = key_row(k0 + r);
        const bool valid = g >= 0 && c * 16 < D;
        const long long off = valid ? g * D + c * 16 : 0;
        flash::cp_async<16>(slot + r * DMAX + c * 16, kc + off, valid);
        flash::cp_async<16>(slot + (KT + r) * DMAX + c * 16, vc + off, valid);
        flash::cp_async<4>(sc + (2 * j) * flash::kWgThreads + threadIdx.x,
                           g >= 0 ? ksc + g : ksc, g >= 0);
        flash::cp_async<4>(sc + (2 * j + 1) * flash::kWgThreads + threadIdx.x,
                           g >= 0 ? vsc + g : vsc, g >= 0);
      }
    }
  }
  // the codes this thread copied into the bf16 K and V tiles, the TPU
  // kernel's numerics: bf16(code) * bf16(scale), rounded to bf16
  // (dequant4); columns past D were copied as zero codes
  template <int KT, int DMAX>
  __device__ __forceinline__ void dequant(const unsigned char* slot, T* Kb, T* Vb) const {
    constexpr int kChunks = DMAX / 16, kStride = flash::kWgThreads / kChunks;
    const float* sc = reinterpret_cast<const float*>(slot + 2 * KT * DMAX);
    const int c = threadIdx.x % kChunks, r0 = threadIdx.x / kChunks;
#pragma unroll
    for (int j = 0; j < KT / kStride; ++j) {
      const int r = r0 + j * kStride;
#pragma unroll
      for (int kv = 0; kv < 2; ++kv) {
        const uint4 w = *reinterpret_cast<const uint4*>(slot + (kv * KT + r) * DMAX + c * 16);
        const float scale_r = __bfloat162float(
            __float2bfloat16(sc[(2 * j + kv) * flash::kWgThreads + threadIdx.x]));
        const uint2 a0 = dequant4(w.x, scale_r), a1 = dequant4(w.y, scale_r);
        const uint2 a2 = dequant4(w.z, scale_r), a3 = dequant4(w.w, scale_r);
        T* dst = kv ? Vb : Kb;
        *reinterpret_cast<uint4*>(dst + wgmma::swizzled<KT>(r, c * 16)) =
            make_uint4(a0.x, a0.y, a1.x, a1.y);
        *reinterpret_cast<uint4*>(dst + wgmma::swizzled<KT>(r, c * 16 + 8)) =
            make_uint4(a2.x, a2.y, a3.x, a3.y);
      }
    }
  }
};

// 128 folded query rows (n * G + g) of one (sequence, KV head), a warpgroup
// per 64, through flash::fwd_sweep; the row tiles run last-first (later
// rows see more keys). With splits > 1 each block covers one split of the
// sequence's pages and writes its rows' (max, sum, fp32 accumulator) to the
// workspace for combine_kernel, as paged_attention_kernel does.
template <typename C, int DMAX, bool kAlibi, bool kCap>
__global__ void __launch_bounds__(flash::kWgThreads, 1)
paged_attention_wgmma_kernel(PagedArgs a) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tiles = (int)gridDim.x / a.splits;
  const int tile = tiles - 1 - (int)blockIdx.x / a.splits, split = (int)blockIdx.x % a.splits;
  const int f0 = tile * flash::kWgRows, h = blockIdx.y, s = blockIdx.z;
  const PagedSrc<C, kAlibi> src(a, s, h, f0, split);
  float o[DMAX / 2], m[2], l[2];
  flash::fwd_sweep<T, DMAX, kCap>(src, f0, flash::align_1024(smem_raw), o, m, l);
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  long long rows_at[2];
  if (a.splits > 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int f = f0 + 64 * wg + 16 * warp + (lane >> 2) + 8 * i;
      const long long part =
          f < src.rows ? (((long long)s * a.KV + h) * src.rows + f) * a.splits + split : -1LL;
      if (part >= 0 && (lane & 3) == 0) {
        a.ws_ml[2 * part] = l[i] > 0.f ? m[i] : kNegInf;
        a.ws_ml[2 * part + 1] = l[i];
      }
      rows_at[i] = l[i] > 0.f ? part : -1LL;  // combine_kernel reads no empty split
    }
    flash::store_acc<float>(a.ws_acc, o, rows_at, a.D, lane);
    return;
  }
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rows_at[i] = src.q_row(f0 + 64 * wg + 16 * warp + (lane >> 2) + 8 * i);
    inv[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < DMAX / 2; ++i) o[i] *= inv[(i >> 1) & 1];
  flash::store_acc<T>(reinterpret_cast<T*>(a.out), o, rows_at, a.D, lane);
}

template <typename C, int DMAX>
constexpr size_t paged_wgmma_smem() {
  return flash::fwd_wgmma_smem<__nv_bfloat16, DMAX, std::is_same<C, int8_t>::value>();
}

template <typename C, int DMAX, bool kAlibi, bool kCap>
cudaError_t launch_paged_wgmma_inst(const PagedArgs& a, cudaStream_t stream) {
  auto kern = paged_attention_wgmma_kernel<C, DMAX, kAlibi, kCap>;
  const size_t smem = paged_wgmma_smem<C, DMAX>();
  static bool ready[64] = {};
  cudaError_t e = allow_smem(kern, smem, ready);
  if (e != cudaSuccess) return e;
  const int rows = a.N * (a.H / a.KV);
  const dim3 grid((rows + flash::kWgRows - 1) / flash::kWgRows * a.splits, a.KV, a.S);
  kern<<<grid, flash::kWgThreads, smem, stream>>>(a);
  if (a.splits > 1)
    combine_kernel<__nv_bfloat16><<<dim3(rows, a.KV, a.S), kAttnThreads, 0, stream>>>(a);
  return cudaSuccess;
}

// The wgmma instances over one cache type at one head width (ALiBi and the
// softcap as template flags), each (cache, width) compiled in a source of
// its own (paged_attention_wgmma_{bf16,int8}{,_d256}.cu)
template <typename C, int DMAX>
cudaError_t launch_paged_wgmma(const PagedArgs& a, cudaStream_t stream) {
  const bool cap = a.softcap > 0.f;
  if (a.slopes)
    return cap ? launch_paged_wgmma_inst<C, DMAX, true, true>(a, stream)
               : launch_paged_wgmma_inst<C, DMAX, true, false>(a, stream);
  return cap ? launch_paged_wgmma_inst<C, DMAX, false, true>(a, stream)
             : launch_paged_wgmma_inst<C, DMAX, false, false>(a, stream);
}

extern template cudaError_t launch_paged_wgmma<__nv_bfloat16, 128>(const PagedArgs&,
                                                                   cudaStream_t);
extern template cudaError_t launch_paged_wgmma<__nv_bfloat16, 256>(const PagedArgs&,
                                                                   cudaStream_t);
extern template cudaError_t launch_paged_wgmma<int8_t, 128>(const PagedArgs&, cudaStream_t);
extern template cudaError_t launch_paged_wgmma<int8_t, 256>(const PagedArgs&, cudaStream_t);

extern template cudaError_t launch_cache<float, float>(const PagedArgs&, int, cudaStream_t);
extern template cudaError_t launch_cache<__nv_bfloat16, __nv_bfloat16>(const PagedArgs&, int,
                                                                       cudaStream_t);
extern template cudaError_t launch_cache<float, int8_t>(const PagedArgs&, int, cudaStream_t);
extern template cudaError_t launch_cache<__nv_bfloat16, int8_t>(const PagedArgs&, int,
                                                                cudaStream_t);

}  // namespace dstt
