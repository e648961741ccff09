// Flash attention for training: the forward (K1) and the two backward passes
// (K2: dq, and dk/dv), on the tensor cores, per KV head (K1/K2) or with all
// KV heads of a tile in one block (K3, the folded layout).
//
// Replaces the TPU kernels deepspeed_tpu/ops/attention.py:88 _fwd_kernel
// (launched by _flash_fwd :237), :273 _dq_kernel (launched at :457) and :350
// _dkdv_kernel (launched at :473), and deepspeed_tpu/ops/attention_folded.py
// :69 _fwd_kernel, :146 _dq_kernel and :215 _dkdv_kernel (flash_fwd_folded
// :319, flash_bwd_folded :357 and :373). The same function, on another grid:
//   q [B, S, H, D], k/v [B, S, KV, D] (the folded [B, S, KV*D] is the same
//   memory), H = KV*G; query head kv*G+g reads KV head kv (GQA, K/V never
//   repeated).
//   s = (q . k) * scale in fp32; with softcap, s = cap * tanh(s / cap)
//   (attention.py softcap_scores :45) before any mask; causal keeps key <=
//   query position; a window keeps q_pos - k_pos < window (:119-120); keys
//   past S (the ragged edge of the last tile) are masked here.
//   forward: o = softmax(s) v in q's dtype, lse [B, S, H] fp32 (LSE_MASKED,
//   1e30, and o = 0 for a row that sees no key; both layouts, where the
//   folded Pallas kernel writes -1e30).
//   backward (delta = rowsum(dO * O) [B, S, H] fp32 comes from the caller):
//   P = exp(s - lse), dS = P * (dP - delta) * scale with dP = dO v^T, times
//   1 - t^2 under softcap (t = tanh(s / cap), the derivative of the cap),
//   dq = dS k, dk = dS^T q and dv = P^T dO, both summed over the G query
//   heads of each KV head.
//
// Numerics: bf16 or fp16 operands on mma.sync m16n8k16 with fp32
// accumulation, the softmax and its statistics in fp32. P (forward and
// dk/dv) and dS (dq and dk/dv) are rounded to the input dtype before their
// products, as the Pallas kernel does. The fp16 instance (fp16 training
// under loss scaling) is the bf16 one with the f16 form of the product:
// ldmatrix moves 16-bit elements either way. An fp32 instantiation runs the
// same tiles on the CUDA cores in fp32 (tests and fp32 parity runs; no
// tensor-core product is fp32).
//
// Bound on the H100: operations. At Llama-3-8B width (D 128, G 4) a key row
// is reused by 64 query rows of a block, so a block does ~64 flops per byte
// of K/V it reads: the forward is 4*D flops per visible (query, key) pair
// and head, the backward 14*D (68.8 and 241 GFLOP at B 2, S 2048, H 32,
// causal; 0.070 and 0.243 ms at 989 TFLOP/s). A window cuts the visible
// pairs (Mistral at S 8192, window 4096: 25.2M of 33.6M per head). What the
// design does:
// - The TPU's GQA fold stays: a block owns 64 folded query rows of one
//   (batch, KV head), rows ordered query-major (row f is position f/G, head
//   f%G), so every G query heads that share a KV head meet each staged K/V
//   tile once, and any G works. Four warps own 16 rows each.
// - The TPU's sequential kv grid axis becomes a loop inside the block over
//   64-key tiles staged in shared memory, with the online softmax (m, l,
//   fp32 accumulator) in registers. Tiles wholly above the causal diagonal
//   or wholly older than the window are never staged or visited; only edge
//   tiles (diagonal, window edge, ragged end) build masks.
// - dq: one block per (64 folded rows, KV head, batch) sweeping the K/V
//   tiles, P rebuilt from lse. dk/dv: one block per (64 keys, KV head,
//   batch) sweeping 32-row tiles of folded query rows between the first row
//   that sees its keys (causal) and the last (window), which runs over the
//   G heads too: that sum is the GQA reduction of _dkdv_kernel :388-400,
//   done without atomics, so dk and dv are deterministic.
// - K3, the folded layout: one block per (64 folded rows, batch), or (64
//   keys, batch) for dk/dv, covering every KV head of its tile, as the
//   folded Pallas grid (B, num_q, num_kv) does. A folded [64, KV*D] K tile
//   and its V tile (256 KB at KV 8, D 128 in bf16) exceed the 227 KB of
//   shared memory, so the block streams the KV heads through it: it runs
//   the per-head body for KV head 0, 1, ... in turn on the same buffers.
//   Rows are read in the natural [B, S, H, D] layout with the same strided
//   pattern as K1, so neither layout transposes anything. The forward and
//   dq blocks take the query tiles last-first, so under causal the longest
//   blocks start first and the short ones fill the tail.
// - Fragments come from shared memory by ldmatrix (the transposing form for
//   an operand held [k][n]: V, dO, K and Q on the right of a product), rows
//   padded by 16 bytes so each 8-row phase meets 32 different banks.
// - The swept tiles are double-buffered with cp.async: the next tile's copy
//   is in flight while the current one is used.
// - Head width 256 (Gemma-2): a warp's 16 x 256 fp32 accumulator is 128
//   registers a thread, so the forward and dq sweep 32-key tiles (their
//   score fragments halve), and a dk/dv block owns 128 of the 256 columns
//   of dk and dv (two blocks per 64 keys, each recomputing the full-width
//   S^T and dP^T: 1.5x the dk/dv products), since dk and dv of 16 keys at
//   256 columns would be 256 registers, past the 255 a thread has. The fp32
//   instance at 256 also takes 16-key tiles and 16-row dk/dv steps so its
//   staged tiles fit the 227 KB of shared memory (Tiles below).
// Later versions: more rows per warp, P kept in registers, then TMA and
// wgmma; K3 could prefetch the next KV head's first tile across heads.
#pragma once

#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace dstt {
namespace flash {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // folded query rows per block (fwd, dq)
constexpr int kKeys = 64;           // keys per K/V tile; keys per dk/dv block
constexpr int kBwdRows = 32;        // folded query rows per step of the dk/dv sweep
constexpr int kPad = 8;             // elements of padding per shared-memory row
constexpr float kLseMasked = 1e30f;  // attention.py LSE_MASKED

// the tiles of a (T, DMAX) instance: keys per K/V tile of the forward and
// dq sweeps, folded query rows per step of the dk/dv sweep, and the
// columns of dk and dv one dk/dv block owns (kColSplits blocks per 64
// keys). The widths <= 128 keep 64, 32 and every column.
template <typename T, int DMAX>
struct Tiles {
  static constexpr bool kWide = DMAX > 128;
  static constexpr bool kWideF32 = kWide && std::is_same<T, float>::value;
  static constexpr int kKeyTile = kWideF32 ? 16 : kWide ? 32 : kKeys;
  static constexpr int kRowTile = kWideF32 ? 16 : kBwdRows;
  static constexpr int kCols = kWide ? 128 : DMAX;
  static constexpr int kColSplits = DMAX / kCols;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;    // backward: dO [B, S, H, D]
  const float* lse;    // backward: [B, S, H]
  const float* delta;  // backward: [B, S, H]
  void* out;           // forward: o; dq pass: dq; dk/dv pass: dk
  void* out2;          // dk/dv pass: dv
  float* lse_out;      // forward: [B, S, H]
  int B, S, H, KV, D;
  float scale;
  int causal;
  int window;     // keys with q_pos - k_pos >= window are masked; 0: none
  float softcap;  // s = softcap * tanh(s / softcap); 0: none
};

// element row (in units of D) of folded query row f of (b, kv), in q/o/dO,
// which is also its index in lse and delta
__device__ __forceinline__ long long q_row(const Args& a, int b, int kv, int f) {
  const int G = a.H / a.KV;
  return ((long long)b * a.S + f / G) * a.H + kv * G + f % G;
}

__device__ __forceinline__ long long kv_row(const Args& a, int b, int kv, int key) {
  return ((long long)b * a.S + key) * a.KV + kv;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// asynchronous global -> shared copies of `bytes` (4 or 16); a copy that is
// not `valid` reads nothing and writes zeros
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  if (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(valid ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most kPending committed groups of this thread are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Start staging n rows of DMAX elements into shared memory (row stride
// DMAX+kPad): row r is src[row(r) * D : +D] where row(r) >= 0, zeros
// otherwise, and the columns D..DMAX are zero. 16-byte copies by the NT
// threads of the block (the wrapper checks D % 8 == 0 and 16-byte aligned
// pointers); the caller commits and waits.
template <typename T, int DMAX, int NT = kThreads, typename RowFn>
__device__ __forceinline__ void load_tile(T* dst, int n, const T* src, int D, RowFn row) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kChunks = DMAX / V;
  for (int i = threadIdx.x; i < n * kChunks; i += NT) {
    const int r = i / kChunks, c = (i % kChunks) * V;
    const long long g = row(r);
    const bool valid = g >= 0 && c < D;
    cp_async<16>(dst + r * (DMAX + kPad) + c, valid ? src + g * D + c : src, valid);
  }
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
// and each lane receives, in r[i], the two elements (row lane/4, columns
// 2*(lane%4) and +1) of matrix i (of its transpose with kTrans)
template <bool kTrans>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  if (kTrans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

// c += a b on the tensor cores, 16-bit operands of T (bf16 or fp16)
template <typename T>
__device__ __forceinline__ void mma_16bit(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// C[16 x 8*N8] += A[16 x K] B for one warp. A is row-major in shared
// memory; B is read as Bt[n][k] (kNT: the product A Bt^T) or as B[k][n],
// row stride ldb; K, a multiple of 16, is fixed at compile time so the
// loop unrolls and loads overlap products. Accumulator layout of m16n8 (PTX
// ISA): lane l holds rows l/4 and l/4+8, columns 2*(l%4) and 2*(l%4)+1 of
// each 8-column tile.
//
// bf16 and fp16: the A fragment (16 x 16) is one ldmatrix.x4: lanes 0-15 point at
// rows 0-15 of column 0, lanes 16-31 at rows 0-15 of column 8. The B
// fragments of two 8-column tiles are one more: for Bt, rows n..n+15 at
// columns k and k+8; for B[k][n], the transposing load of rows k..k+15 at
// columns n and n+8.
//
// kStepSums: each 16-deep step's product goes to a fresh fragment that is
// then added to C in rounded fp32. The tensor cores add products into the
// accumulator after aligning them to the largest magnitude among them and
// C, cutting the bits below; with a large C that drops ~2^-23 |C| per
// product, all in one direction. dq's dP = dO V^T needs the fresh sums:
// dS = P (dP - delta) subtracts two nearly equal numbers where a row's
// softmax is nearly one key, and the cut bits of a 256-deep dP took dq's
// error to 2.5x the plain version's at head width 256 with scores of
// ~N(0, 20^2) under the softcap. The fresh sums cost dq ~10% of its time,
// and no case at head width 128 or below shows the drift, so dq takes
// them at head width 256 only.
template <typename T, bool kNT, int K, bool kStepSums = false, int N8>
__device__ __forceinline__ void warp_gemm(float (&c)[N8][4], const T* A, int lda,
                                          const T* B, int ldb, int lane) {
  if constexpr (std::is_same<T, float>::value) {
    // fp32: each lane sums its accumulator elements on the CUDA cores
    const int g = lane >> 2, q2 = (lane & 3) * 2;
#pragma unroll 1
    for (int k0 = 0; k0 < K; k0 += 16)
#pragma unroll
      for (int n = 0; n < N8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = g + (e >> 1) * 8, col = n * 8 + q2 + (e & 1);
          float s = 0.f;
#pragma unroll
          for (int kk = k0; kk < k0 + 16; ++kk)
            s += A[row * lda + kk] * (kNT ? B[col * ldb + kk] : B[kk * ldb + col]);
          c[n][e] += s;
        }
  } else {
    static_assert(N8 % 2 == 0, "B fragments load two 8-column tiles at a time");
    const int r8 = lane & 7, hi = (lane >> 4) * 8, mid = ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t a[4];
      ldmatrix_x4<false>(a, A + (lane & 15) * lda + k0 + hi);
#pragma unroll
      for (int n = 0; n < N8; n += 2) {
        uint32_t b[4];
        if (kNT)
          ldmatrix_x4<false>(b, B + (n * 8 + r8 + hi) * ldb + k0 + mid);
        else
          ldmatrix_x4<true>(b, B + (k0 + r8 + mid) * ldb + n * 8 + hi);
        if constexpr (kStepSums) {
          float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
          mma_16bit<T>(t0, a, b[0], b[1]);
          mma_16bit<T>(t1, a, b[2], b[3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            c[n][e] += t0[e];
            c[n + 1][e] += t1[e];
          }
        } else {
          mma_16bit<T>(c[n], a, b[0], b[1]);
          mma_16bit<T>(c[n + 1], a, b[2], b[3]);
        }
      }
    }
  }
}

template <int N8>
__device__ __forceinline__ void zero(float (&c)[N8][4]) {
#pragma unroll
  for (int n = 0; n < N8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
}

// two adjacent elements (the pair a lane holds in an accumulator row) in one store
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ void store2(__half* p, float x, float y) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(x, y);
}

// sum / max over the four lanes that share an accumulator row
__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float row_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// store a warp's [16 x 8*N8] fp32 accumulator rows (rows[i] >= 0: element
// row of accumulator row lane/4 + 8*i) as T into columns c0.. of the row,
// columns < D
template <typename T, int N8>
__device__ __forceinline__ void store_rows(T* out, const float (&c)[N8][4],
                                           const long long rows[2], const float mul[2],
                                           int D, int lane, int c0 = 0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] < 0) continue;
    T* o = out + rows[i] * D + c0;
#pragma unroll
    for (int n = 0; n < N8; ++n) {
      const int col = n * 8 + (lane & 3) * 2;
      if (c0 + col < D)  // D % 8 == 0: col + 1 too
        store2(o + col, c[n][2 * i] * mul[i], c[n][2 * i + 1] * mul[i]);
    }
  }
}

// the score of one pair, q . k times the scale, then (kCap) the softcap; t
// receives the softcap's tanh (0 without a softcap, so 1 - t^2 is 1). The
// softcap is a template flag, not a test in the tile loop: with a runtime
// test the kernels without a softcap ran slower (dq by a third at B 2,
// S 2048, H 32, D 128 on the H100)
template <bool kCap>
__device__ __forceinline__ float capped(const Args& a, float qk, float& t) {
  float x = qk * a.scale;
  t = 0.f;
  if constexpr (kCap) {
    t = tanhf(x / a.softcap);
    x = a.softcap * t;
  }
  return x;
}

// whether the (query position, key) pair is masked
__device__ __forceinline__ bool masked_pair(const Args& a, int pos, int key) {
  return key >= a.S || (a.causal && key > pos) || (a.window > 0 && pos - key >= a.window);
}

// the key tiles of KT keys [t_begin, t_end) that query positions
// p_first..p_last can see: none above the causal diagonal, none wholly
// older than the window
template <int KT>
__device__ __forceinline__ void key_tiles(const Args& a, int p_first, int p_last, int& t_begin,
                                          int& t_end) {
  t_begin = a.window > 0 ? max(0, p_first - a.window + 1) / KT : 0;
  t_end = a.causal ? p_last / KT + 1 : (a.S + KT - 1) / KT;
}

// a tile of KT keys at k0 where some pair of positions p_first..p_last is
// masked (the others, interior tiles, skip the mask)
template <int KT>
__device__ __forceinline__ bool edge_tile(const Args& a, int k0, int p_first, int p_last) {
  return (a.causal && k0 + KT - 1 > p_first) || k0 + KT > a.S ||
         (a.window > 0 && p_last - k0 >= a.window);
}

// forward of the 64 folded query rows f0.. of (batch b, KV head kv)
template <typename T, int DMAX, bool kCap>
__device__ __forceinline__ void fwd_block(const Args& a, int f0, int kv, int b,
                                          unsigned char* smem) {
  constexpr int KT = Tiles<T, DMAX>::kKeyTile;
  constexpr int LD = DMAX + kPad, LP = KT + kPad, N8 = DMAX / 8;
  T* Qs = reinterpret_cast<T*>(smem);
  T* KVs = Qs + kRows * LD;     // two buffers of [K tile, V tile]
  T* Ps = KVs + 4 * KT * LD;    // [kRows][LP], 16 rows per warp

  const int G = a.H / a.KV, rows = a.S * G, D = a.D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* q = reinterpret_cast<const T*>(a.q);
  const T* k = reinterpret_cast<const T*>(a.k);
  const T* v = reinterpret_cast<const T*>(a.v);
  auto load_kv = [&](int t) {  // K/V tile t into buffer t % 2
    const int k0 = t * KT;
    auto key_row = [&](int r) { return k0 + r < a.S ? kv_row(a, b, kv, k0 + r) : -1LL; };
    T* Kb = KVs + (t & 1) * 2 * KT * LD;
    load_tile<T, DMAX>(Kb, KT, k, D, key_row);
    load_tile<T, DMAX>(Kb + KT * LD, KT, v, D, key_row);
  };

  int fr[2], pos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    fr[i] = f0 + warp * 16 + (lane >> 2) + 8 * i;
    pos[i] = fr[i] / G;
  }
  const int p_first = f0 / G;
  const int p_last = (min(f0 + kRows, rows) - 1) / G;
  int t_begin, t_end;
  key_tiles<KT>(a, p_first, p_last, t_begin, t_end);

  load_tile<T, DMAX>(Qs, kRows, q, D, [&](int r) {
    return f0 + r < rows ? q_row(a, b, kv, f0 + r) : -1LL;
  });
  load_kv(t_begin);
  cp_async_commit();

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[N8][4];
  zero(acc);
  const T* Qw = Qs + warp * 16 * LD;
  T* Pw = Ps + warp * 16 * LP;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * KT;
    // the next tile's copy runs while this one is used; the buffer it
    // fills was released by the __syncthreads ending the previous step
    if (t + 1 < t_end) {
      load_kv(t + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and Q) visible to every warp
    const T* Ks = KVs + (t & 1) * 2 * KT * LD;
    const T* Vs = Ks + KT * LD;

    float s[KT / 8][4];
    zero(s);
    warp_gemm<T, true, DMAX>(s, Qw, LD, Ks, LD, lane);
    const bool edge = edge_tile<KT>(a, k0, p_first, p_last);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < KT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, key = k0 + n * 8 + (lane & 3) * 2 + (e & 1);
        float tc;
        float x = capped<kCap>(a, s[n][e], tc);
        if (edge && masked_pair(a, pos[i], key)) x = -INFINITY;
        s[n][e] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    float mu[2], corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], row_max(mx[i]));
      mu[i] = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet
      corr[i] = expf(m[i] - mu[i]);
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < KT / 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float p0 = expf(s[n][2 * i] - mu[i]), p1 = expf(s[n][2 * i + 1] - mu[i]);
        rs[i] += p0 + p1;
        store2(Pw + ((lane >> 2) + 8 * i) * LP + n * 8 + (lane & 3) * 2, p0, p1);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + row_sum(rs[i]);
#pragma unroll
    for (int n = 0; n < N8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
    __syncwarp();
    warp_gemm<T, false, KT>(acc, Pw, LP, Vs, LD, lane);
    __syncthreads();  // every warp is done with this K/V buffer (and its Pw)
  }

  long long orow[2];
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    orow[i] = fr[i] < rows ? q_row(a, b, kv, fr[i]) : -1LL;
    inv[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;
    if (orow[i] >= 0 && (lane & 3) == 0)
      a.lse_out[orow[i]] = l[i] > 0.f ? m[i] + logf(l[i]) : kLseMasked;
  }
  store_rows<T>(reinterpret_cast<T*>(a.out), acc, orow, inv, D, lane);
}

// dq of the 64 folded query rows f0.. of (batch b, KV head kv)
template <typename T, int DMAX, bool kCap>
__device__ __forceinline__ void dq_block(const Args& a, int f0, int kv, int b,
                                         unsigned char* smem) {
  constexpr int KT = Tiles<T, DMAX>::kKeyTile;
  constexpr int LD = DMAX + kPad, LP = KT + kPad, N8 = DMAX / 8;
  T* Qs = reinterpret_cast<T*>(smem);
  T* Os = Qs + kRows * LD;    // dO
  T* KVs = Os + kRows * LD;   // two buffers of [K tile, V tile]
  T* Ps = KVs + 4 * KT * LD;  // dS, [kRows][LP]

  const int G = a.H / a.KV, rows = a.S * G, D = a.D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* k = reinterpret_cast<const T*>(a.k);
  const T* v = reinterpret_cast<const T*>(a.v);
  auto load_kv = [&](int t) {  // K/V tile t into buffer t % 2
    const int k0 = t * KT;
    auto key_row = [&](int r) { return k0 + r < a.S ? kv_row(a, b, kv, k0 + r) : -1LL; };
    T* Kb = KVs + (t & 1) * 2 * KT * LD;
    load_tile<T, DMAX>(Kb, KT, k, D, key_row);
    load_tile<T, DMAX>(Kb + KT * LD, KT, v, D, key_row);
  };

  int pos[2];
  long long qr[2];
  float lse[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int f = f0 + warp * 16 + (lane >> 2) + 8 * i;
    pos[i] = f / G;
    qr[i] = f < rows ? q_row(a, b, kv, f) : -1LL;
    lse[i] = qr[i] >= 0 ? a.lse[qr[i]] : kLseMasked;  // masked rows: P = 0
    dl[i] = qr[i] >= 0 ? a.delta[qr[i]] : 0.f;
  }
  const int p_first = f0 / G;
  const int p_last = (min(f0 + kRows, rows) - 1) / G;
  int t_begin, t_end;
  key_tiles<KT>(a, p_first, p_last, t_begin, t_end);

  auto q_tile_row = [&](int r) { return f0 + r < rows ? q_row(a, b, kv, f0 + r) : -1LL; };
  load_tile<T, DMAX>(Qs, kRows, reinterpret_cast<const T*>(a.q), D, q_tile_row);
  load_tile<T, DMAX>(Os, kRows, reinterpret_cast<const T*>(a.dout), D, q_tile_row);
  load_kv(t_begin);
  cp_async_commit();

  float dq[N8][4];
  zero(dq);
  const T* Qw = Qs + warp * 16 * LD;
  const T* Ow = Os + warp * 16 * LD;
  T* Pw = Ps + warp * 16 * LP;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * KT;
    if (t + 1 < t_end) {  // as in fwd_block
      load_kv(t + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Ks = KVs + (t & 1) * 2 * KT * LD;
    const T* Vs = Ks + KT * LD;

    float s[KT / 8][4], dp[KT / 8][4];
    zero(s);
    zero(dp);
    warp_gemm<T, true, DMAX>(s, Qw, LD, Ks, LD, lane);
    warp_gemm<T, true, DMAX, (DMAX > 128)>(dp, Ow, LD, Vs, LD, lane);  // see warp_gemm
    const bool edge = edge_tile<KT>(a, k0, p_first, p_last);
#pragma unroll
    for (int n = 0; n < KT / 8; ++n) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, key = k0 + n * 8 + (lane & 3) * 2 + (e & 1);
        float tc;
        const float x = capped<kCap>(a, s[n][e], tc);
        const float p = edge && masked_pair(a, pos[i], key) ? 0.f : expf(x - lse[i]);
        ds[e] = p * (dp[n][e] - dl[i]) * a.scale * (1.f - tc * tc);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
        store2(Pw + ((lane >> 2) + 8 * i) * LP + n * 8 + (lane & 3) * 2, ds[2 * i],
               ds[2 * i + 1]);
    }
    __syncwarp();
    warp_gemm<T, false, KT>(dq, Pw, LP, Ks, LD, lane);
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f};
  store_rows<T>(reinterpret_cast<T*>(a.out), dq, qr, one, D, lane);
}

// dk and dv, columns c0.. (Tiles::kCols of them), of the 64 keys k0.. of
// (batch b, KV head kv)
template <typename T, int DMAX, bool kCap>
__device__ __forceinline__ void dkdv_block(const Args& a, int k0, int c0, int kv, int b,
                                           unsigned char* smem) {
  constexpr int BR = Tiles<T, DMAX>::kRowTile;
  constexpr int LD = DMAX + kPad, LP = BR + kPad, N8 = Tiles<T, DMAX>::kCols / 8;
  constexpr int C8 = BR / 8;
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + kKeys * LD;
  T* QOs = Vs + kKeys * LD;   // two buffers of [Q tile, dO tile]
  T* Ps = QOs + 4 * BR * LD;  // P^T, then dS^T: [kKeys][LP], 16 key rows per warp
  // two buffers of [lse, delta] of the row tile
  float* LDs = reinterpret_cast<float*>(Ps + kKeys * LP);

  const int G = a.H / a.KV, rows = a.S * G, D = a.D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* q = reinterpret_cast<const T*>(a.q);
  const T* dout = reinterpret_cast<const T*>(a.dout);

  // the row tile at f0 into buffer `buf`: Q, dO, and lse/delta (zeros for
  // rows past the end, which the mask below drops)
  auto load_rows = [&](int f0, int buf) {
    auto q_tile_row = [&](int r) { return f0 + r < rows ? q_row(a, b, kv, f0 + r) : -1LL; };
    T* Qb = QOs + buf * 2 * BR * LD;
    load_tile<T, DMAX>(Qb, BR, q, D, q_tile_row);
    load_tile<T, DMAX>(Qb + BR * LD, BR, dout, D, q_tile_row);
    if (threadIdx.x < BR) {
      const long long r = q_tile_row(threadIdx.x);
      float* Lb = LDs + buf * 2 * BR;
      cp_async<4>(Lb + threadIdx.x, r >= 0 ? a.lse + r : a.lse, r >= 0);
      cp_async<4>(Lb + BR + threadIdx.x, r >= 0 ? a.delta + r : a.delta, r >= 0);
    }
  };

  int key[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) key[i] = k0 + warp * 16 + (lane >> 2) + 8 * i;
  // under causal, folded rows before position k0 see none of these keys;
  // under a window, rows at or past position k0 + kKeys - 1 + window see
  // none either
  const int f_begin = a.causal ? (int)((long long)k0 * G / BR) * BR : 0;
  const int f_end =
      a.window > 0
          ? (int)min((long long)rows, ((long long)k0 + kKeys - 1 + a.window) * G)
          : rows;

  auto key_row = [&](int r) { return k0 + r < a.S ? kv_row(a, b, kv, k0 + r) : -1LL; };
  load_tile<T, DMAX>(Ks, kKeys, reinterpret_cast<const T*>(a.k), D, key_row);
  load_tile<T, DMAX>(Vs, kKeys, reinterpret_cast<const T*>(a.v), D, key_row);
  if (f_begin < f_end) load_rows(f_begin, 0);
  cp_async_commit();

  float dk[N8][4], dv[N8][4];
  zero(dk);
  zero(dv);
  const T* Kw = Ks + warp * 16 * LD;
  const T* Vw = Vs + warp * 16 * LD;
  T* Pw = Ps + warp * 16 * LP;

  for (int f0 = f_begin, it = 0; f0 < f_end; f0 += BR, ++it) {
    const int buf = it & 1;
    if (f0 + BR < f_end) {  // the next row tile's copy runs meanwhile
      load_rows(f0 + BR, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this row tile (and K, V) visible to every warp
    const T* Qs = QOs + buf * 2 * BR * LD;
    const T* Os = Qs + BR * LD;  // dO
    const float* Ls = LDs + buf * 2 * BR;
    const float* Dl = Ls + BR;

    // S^T = K Q^T: rows are this warp's 16 keys, columns the tile's BR rows
    float s[C8][4], dp[C8][4], dcap[C8][4];
    zero(s);
    zero(dp);
    warp_gemm<T, true, DMAX>(s, Kw, LD, Qs, LD, lane);
    const int p_last = (min(f0 + BR, rows) - 1) / G;
    const bool edge = (a.causal && k0 + kKeys - 1 > f0 / G) || k0 + kKeys > a.S ||
                      f0 + BR > rows || (a.window > 0 && p_last - k0 >= a.window);
#pragma unroll
    for (int n = 0; n < C8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, col = n * 8 + (lane & 3) * 2 + (e & 1);
        const bool masked =
            edge && (f0 + col >= rows || masked_pair(a, (f0 + col) / G, key[i]));
        float tc;
        const float x = capped<kCap>(a, s[n][e], tc);
        dcap[n][e] = 1.f - tc * tc;
        s[n][e] = masked ? 0.f : expf(x - Ls[col]);
      }
#pragma unroll
    for (int n = 0; n < C8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        store2(Pw + ((lane >> 2) + 8 * i) * LP + n * 8 + (lane & 3) * 2, s[n][2 * i],
               s[n][2 * i + 1]);
    __syncwarp();
    warp_gemm<T, false, BR>(dv, Pw, LP, Os + c0, LD, lane);  // dv += P^T dO
    warp_gemm<T, true, DMAX>(dp, Vw, LD, Os, LD, lane);      // dP^T = V dO^T
    __syncwarp();  // every lane has read P^T before dS^T overwrites it
#pragma unroll
    for (int n = 0; n < C8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = n * 8 + (lane & 3) * 2;
        store2(Pw + ((lane >> 2) + 8 * i) * LP + col,
               s[n][2 * i] * (dp[n][2 * i] - Dl[col]) * a.scale * dcap[n][2 * i],
               s[n][2 * i + 1] * (dp[n][2 * i + 1] - Dl[col + 1]) * a.scale *
                   dcap[n][2 * i + 1]);
      }
    __syncwarp();
    warp_gemm<T, false, BR>(dk, Pw, LP, Qs + c0, LD, lane);  // dk += dS^T Q
    __syncthreads();  // every warp is done with this row-tile buffer
  }

  long long kr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) kr[i] = key[i] < a.S ? kv_row(a, b, kv, key[i]) : -1LL;
  const float one[2] = {1.f, 1.f};
  store_rows<T>(reinterpret_cast<T*>(a.out), dk, kr, one, D, lane, c0);
  store_rows<T>(reinterpret_cast<T*>(a.out2), dv, kr, one, D, lane, c0);
}

// bytes of shared memory per block; at D 256: bf16/fp16 106,496 (fwd),
// 140,288 (dq), 140,800 (dk/dv); fp32 141,312, 208,896 and 209,152
template <typename T, int DMAX>
constexpr size_t fwd_smem() {  // Q, two K/V buffers, P
  constexpr int KT = Tiles<T, DMAX>::kKeyTile;
  return ((size_t)(kRows + 4 * KT) * (DMAX + kPad) + kRows * (KT + kPad)) * sizeof(T);
}

template <typename T, int DMAX>
constexpr size_t dq_smem() {  // Q, dO, two K/V buffers, dS
  constexpr int KT = Tiles<T, DMAX>::kKeyTile;
  return ((size_t)(2 * kRows + 4 * KT) * (DMAX + kPad) + kRows * (KT + kPad)) * sizeof(T);
}

template <typename T, int DMAX>
constexpr size_t dkdv_smem() {  // K, V, two Q/dO buffers, P^T/dS^T, two lse/delta buffers
  constexpr int BR = Tiles<T, DMAX>::kRowTile;
  return ((size_t)(2 * kKeys + 4 * BR) * (DMAX + kPad) + kKeys * (BR + kPad)) * sizeof(T) +
         4 * BR * sizeof(float);
}

enum Pass { kFwd, kDq, kDkdv };
using Kernel = void (*)(Args);

// The two layouts' kernels. K1/K2 (flash_attention.cu): one block per (64
// folded query rows, KV head, batch), or per (64 keys, column split, KV
// head, batch) for dk/dv.
template <typename T, int DMAX, bool kCap>
__global__ void __launch_bounds__(kThreads) fwd_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  fwd_block<T, DMAX, kCap>(a, blockIdx.x * kRows, blockIdx.y, blockIdx.z, smem);
}

template <typename T, int DMAX, bool kCap>
__global__ void __launch_bounds__(kThreads) dq_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  dq_block<T, DMAX, kCap>(a, blockIdx.x * kRows, blockIdx.y, blockIdx.z, smem);
}

template <typename T, int DMAX, bool kCap>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  using Ti = Tiles<T, DMAX>;
  dkdv_block<T, DMAX, kCap>(a, (blockIdx.x / Ti::kColSplits) * kKeys,
                            (blockIdx.x % Ti::kColSplits) * Ti::kCols, blockIdx.y, blockIdx.z,
                            smem);
}

// K3 (flash_attention_folded.cu): one block per (64 folded query rows,
// batch), or (64 keys, column split, batch) for dk/dv, walking every KV
// head through the same buffers. The query tiles run last-first: under
// causal the longest blocks start first and the short ones fill the tail.
template <typename T, int DMAX, bool kCap>
__global__ void __launch_bounds__(kThreads) folded_fwd_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int f0 = (int)(gridDim.x - 1 - blockIdx.x) * kRows;
  for (int kv = 0; kv < a.KV; ++kv) {
    fwd_block<T, DMAX, kCap>(a, f0, kv, blockIdx.y, smem);
    __syncthreads();  // the next head restages Q and K/V in the same buffers
  }
}

template <typename T, int DMAX, bool kCap>
__global__ void __launch_bounds__(kThreads) folded_dq_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int f0 = (int)(gridDim.x - 1 - blockIdx.x) * kRows;
  for (int kv = 0; kv < a.KV; ++kv) {
    dq_block<T, DMAX, kCap>(a, f0, kv, blockIdx.y, smem);
    __syncthreads();
  }
}

// under causal the first key tiles have the most rows to sweep: natural order
template <typename T, int DMAX, bool kCap>
__global__ void __launch_bounds__(kThreads) folded_dkdv_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  using Ti = Tiles<T, DMAX>;
  for (int kv = 0; kv < a.KV; ++kv) {
    dkdv_block<T, DMAX, kCap>(a, (blockIdx.x / Ti::kColSplits) * kKeys,
                              (blockIdx.x % Ti::kColSplits) * Ti::kCols, kv, blockIdx.y, smem);
    __syncthreads();
  }
}

// Layout::kernel<T, DMAX, kCap>(pass) and Layout::grid(pass, a, splits)
// name the kernels of one layout and their grids (splits: dk/dv blocks per
// 64 keys). Layout::run_d256 launches the head-width-256 instances, which
// are compiled in sources of their own (flash_attention_d256.cu,
// flash_attention_folded_d256.cu), so the build runs them in parallel with
// the narrower ones.
struct PerHead {
  template <typename T, int DMAX, bool kCap>
  static Kernel kernel(Pass pass) {
    if (pass == kFwd) return &fwd_kernel<T, DMAX, kCap>;
    if (pass == kDq) return &dq_kernel<T, DMAX, kCap>;
    return &dkdv_kernel<T, DMAX, kCap>;
  }
  static dim3 grid(Pass pass, const Args& a, int splits) {
    if (pass == kDkdv) return dim3((a.S + kKeys - 1) / kKeys * splits, a.KV, a.B);
    return dim3((a.S * (a.H / a.KV) + kRows - 1) / kRows, a.KV, a.B);
  }
  static int run_d256(Pass pass, const Args& a, int dtype, cudaStream_t stream);
};

struct Folded {
  template <typename T, int DMAX, bool kCap>
  static Kernel kernel(Pass pass) {
    if (pass == kFwd) return &folded_fwd_kernel<T, DMAX, kCap>;
    if (pass == kDq) return &folded_dq_kernel<T, DMAX, kCap>;
    return &folded_dkdv_kernel<T, DMAX, kCap>;
  }
  static dim3 grid(Pass pass, const Args& a, int splits) {
    if (pass == kDkdv) return dim3((a.S + kKeys - 1) / kKeys * splits, a.B);
    return dim3((a.S * (a.H / a.KV) + kRows - 1) / kRows, a.B);
  }
  static int run_d256(Pass pass, const Args& a, int dtype, cudaStream_t stream);
};

template <class Layout, typename T, int DMAX, bool kCap>
cudaError_t launch_cap(Pass pass, const Args& a, cudaStream_t stream) {
  const Kernel kern = Layout::template kernel<T, DMAX, kCap>(pass);
  const size_t smem = pass == kFwd  ? fwd_smem<T, DMAX>()
                      : pass == kDq ? dq_smem<T, DMAX>()
                                    : dkdv_smem<T, DMAX>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<Layout::grid(pass, a, Tiles<T, DMAX>::kColSplits), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <class Layout, typename T, int DMAX>
cudaError_t launch(Pass pass, const Args& a, cudaStream_t stream) {
  return a.softcap > 0.f ? launch_cap<Layout, T, DMAX, true>(pass, a, stream)
                         : launch_cap<Layout, T, DMAX, false>(pass, a, stream);
}

// the instances of one head width DMAX, by dtype
template <class Layout, int DMAX>
int run_width(Pass pass, const Args& a, int dtype, cudaStream_t s) {
  switch (dtype) {
    case kFloat32: return (int)launch<Layout, float, DMAX>(pass, a, s);
    case kBFloat16: return (int)launch<Layout, __nv_bfloat16, DMAX>(pass, a, s);
    case kFloat16: return (int)launch<Layout, __half, DMAX>(pass, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <class Layout>
int run(Pass pass, const Args& a, int dtype, void* stream) {
  const bool shape_ok = a.B > 0 && a.B <= 65535 && a.S > 0 && a.KV > 0 && a.KV <= 65535 &&
                        a.H % a.KV == 0 && a.D > 0 && a.D <= 256 && a.D % 8 == 0 &&
                        (long long)a.S * (a.H / a.KV) < (1LL << 31) && a.window >= 0 &&
                        a.softcap >= 0.f;
  if (!shape_ok) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (a.D <= 64) return run_width<Layout, 64>(pass, a, dtype, s);
  if (a.D <= 128) return run_width<Layout, 128>(pass, a, dtype, s);
  return Layout::run_d256(pass, a, dtype, s);
}

// the entry points' arguments, shared by both layouts
inline Args make_args(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* out, void* out2,
                      void* lse_out, int B, int S, int H, int KV, int D, float scale,
                      int causal, int window, float softcap) {
  return Args{q, k, v, dout, (const float*)lse, (const float*)delta, out, out2,
              (float*)lse_out, B, S, H, KV, D, scale, causal, window, softcap};
}

}  // namespace flash
}  // namespace dstt
