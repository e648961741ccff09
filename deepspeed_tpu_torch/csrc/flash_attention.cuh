// Flash attention for training: the forward (K1) and the two backward passes
// (K2: dq, and dk/dv). K3, the folded layout, launches the same kernels on
// the same per-head grid (flash_attention_folded.cu).
//
// Replaces the TPU kernels deepspeed_tpu/ops/attention.py:88 _fwd_kernel
// (launched by _flash_fwd :237), :273 _dq_kernel (launched at :457) and :350
// _dkdv_kernel (launched at :473), and deepspeed_tpu/ops/attention_folded.py
// :69 _fwd_kernel, :146 _dq_kernel and :215 _dkdv_kernel (flash_fwd_folded
// :319, flash_bwd_folded :357 and :373). The same function on both layouts:
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
// Numerics: 16-bit operands on the tensor cores with fp32 accumulation, the
// softmax and its statistics in fp32. P (forward and dk/dv) and dS (dq and
// dk/dv) are rounded to the input dtype before their products, as the
// Pallas kernel does; dS is formed from the fp32 P. fp16 (fp16 training
// under loss scaling) is bf16's body with the f16 form of each product. An
// fp32 instantiation runs the mma.sync bodies' tiles on the CUDA cores in
// fp32 (tests and fp32 parity runs; no main path runs it).
//
// Bound on the H100: operations. At Llama-3-8B width (D 128, G 4) the
// forward is 4*D flops per visible (query, key) pair and head, the backward
// 14*D (68.8 and 241 GFLOP at B 2, S 2048, H 32, causal; 0.070 and 0.243 ms
// at 989 TFLOP/s). A window cuts the visible pairs (Mistral at S 8192,
// window 4096: 25.2M of 33.6M per head). The TPU's GQA fold stays in every
// body: a block's folded query rows are ordered query-major (row f is
// position f/G, head f%G), so the G query heads that share a KV head meet
// each staged K/V tile once, and any G works. Tiles wholly above the causal
// diagonal or wholly older than the window are never staged or visited;
// only edge tiles (diagonal, window edge, ragged end) build masks. K/V (or
// Q/dO) tiles are double-buffered: the next tile's copy is in flight while
// the current one is used.
//
// Every pass in bf16 and fp16 at head widths 65..256 (fwd_wgmma_kernel,
// dq_wgmma_kernel, dkdv_wgmma_kernel) is built on Hopper's warpgroup
// products (wgmma.cuh). What held the mma.sync bodies back: one m16n8k16
// warp product at a time, each warp reloading its whole B operand from
// shared memory; P and dS written to shared memory and read back as the
// next product's A operand; 32-row dk/dv steps with a barrier each; and at
// head width 256 two dk/dv blocks per 64 keys, each recomputing the
// full-width S^T and dP^T (1.5x the products). What the design does:
// - Every product is a wgmma.m64nNk16 of one warpgroup (128 threads)
//   reading its operands through shared-memory descriptors: Q, dO, K and V
//   are staged once, [rows][D] in the 128-byte swizzle, and serve as K-major
//   operands (S = Q K^T, dP = dO V^T, S^T = K Q^T, dP^T = V dO^T) and, by
//   the transposed-B form, as MN-major ones (o += P V, dq += dS K, dv +=
//   P^T dO, dk += dS^T Q). A score accumulator rounded to 16 bits is the A
//   operand of the next product as it lies in registers (wgmma.cuh): P,
//   P^T and dS never go through shared memory as operands.
// - Forward: one block per (128 folded query rows, KV head, batch), a
//   warpgroup per 64 rows sweeping double-buffered K/V tiles (64 keys; 32
//   at head width 256, where o alone is 128 registers a thread): S = Q K^T,
//   the scale, cap and masks, the online max and sum in registers, o
//   rescaled once the previous tile's product retired, o += P V. The row
//   tiles run last-first. The sweep (fwd_sweep) takes its keys and rows from
//   a source type, so K4's multi-row tiles (paged_attention.cuh) run the
//   same code over K/V gathered through a block table. Measured on the
//   H100 (PERF.md, section 6): the sweep with each tile's softmax overlapped
//   with the previous tile's P V (a third K/V stage), with both warpgroups'
//   S issued ahead of either's P V, or with copies two tiles ahead was no
//   faster than this one; an overlapped step whose P V was issued under a
//   branch made ptxas serialize every product of the kernel (note C7514).
// - dk/dv: one block per (64 keys, KV head, batch), two warpgroups with
//   one role each: warpgroup 0 computes S^T = K Q^T, P^T and dv += P^T dO;
//   warpgroup 1 computes dP^T = V dO^T, dS^T and dk += dS^T Q. Each owns one
//   accumulator of all DMAX columns (64 or 128 registers a thread), so at
//   head width 256 one block owns its keys' 256 columns and S^T and dP^T
//   are computed once. dS^T needs P^T: warpgroup 0 passes its fp32 P^T
//   (and, under the softcap, 1 - t^2) through shared memory, each thread
//   the elements that the same thread of warpgroup 1 holds of dP^T. K and V
//   stay in shared memory for the whole sweep; Q, dO, lse and delta come in
//   64-row steps over the folded rows that see the keys (from the first
//   under causal to the last under a window), which runs over the G heads
//   too: that sum is the GQA reduction of _dkdv_kernel :388-400, done
//   without atomics, so dk and dv are deterministic. Two barriers a step.
// - dq: one block per (128 folded query rows, KV head, batch), a
//   warpgroup per 64 rows, each with its own S, dP, dS (registers) and dq
//   accumulator, sweeping the K/V tiles (64 keys; 32 at head width 256,
//   where dq alone is 128 registers a thread). The row tiles run
//   last-first, so under causal the longest blocks start first and the
//   short ones fill the tail.
// - dP's drift: the tensor cores add each product into the accumulator
//   after aligning it to the largest magnitude among them, cutting the bits
//   below; with a large accumulator that drops ~2^-23 |C| per product, all
//   in one direction. dS = P (dP - delta) subtracts two nearly equal
//   numbers where a row's softmax is nearly one key, and the cut bits of a
//   256-deep dP took dq's error to 2.5x the plain version's at head width
//   256 with scores of ~N(0, 20^2) under the softcap; of a 128-deep dP, to
//   2.25-2.94x on two seeds of three at Mistral's S 8192 under the 4096
//   window. So dq sums dP from fresh 16-deep products added in fp32 (two in
//   flight at a time) at every width, which brings it to the plain
//   version's error (dq 1.25x slower at that shape; PERF.md, section 6). The
//   forward's S reads within the plain version's error against the exact
//   value (chip_smoke.py's control).
// - One block an SM (up to 231 KB of shared memory at head width 256 under
//   the softcap, up to 255 registers a thread); the two warpgroups' products
//   overlap each other on the SM's tensor cores.
// - Around the products, a step's own instructions set its time (clock64
//   probes and the SASS on the H100): each score's exp sat in a branch of
//   its own (a short-circuit mask test, tanhf's internal paths), and a load
//   of lse could not pass the previous score's store of P^T (the compiler
//   cannot rule out aliasing), so the 32 scores of a thread ran one after
//   the other; and each 16-byte copy found its row with three integer
//   divisions in a loop. So masks are built without branches
//   and only on edge tiles, tanh has a branch-free form (tanh_nb), every
//   read of a step comes before its first write, a row's offset is found
//   once for the two tensors staged with it by a multiply-and-shift
//   division (FastDiv), and the next tile's copies are issued behind the
//   step's first products. That took K2's backward at the 8B training shape
//   from 2.11 to 0.85 ms on the H100 (PERF.md, section 6), and K1's forward
//   from 0.475 to ~0.26 ms.
// The mma.sync bodies (fwd_block, dq_block, dkdv_block) stay for every
// pass in fp32 and at head width <= 64 (fp32 parity runs and small models;
// no main path of the smoke runs them).
// Later versions: TMA for the staged tiles from a producer warp under
// mbarriers, so that the two warpgroups no longer meet at a barrier every
// tile and one's softmax can run under the other's products; the next
// step's S^T issued before this step's dk/dv products complete.
#pragma once

#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace dstt {
namespace flash {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // folded query rows per block (fwd, dq)
constexpr int kKeys = 64;           // keys per K/V tile; keys per dk/dv block
constexpr int kBwdRows = 32;        // folded query rows per step of the dk/dv sweep
constexpr int kPad = 8;             // elements of padding per shared-memory row
constexpr float kLseMasked = 1e30f;  // attention.py LSE_MASKED

// the tiles of a DMAX instance of the mma.sync bodies (fp32 at every width,
// the 16-bit types at <= 64): keys per K/V tile of the forward and dq
// sweeps, folded query rows per step of the dk/dv sweep, and the columns of
// dk and dv one dk/dv block owns (kColSplits blocks per 64 keys). At head
// width 256 (fp32 only) the instance takes 16-key tiles and 16-row dk/dv
// steps so its staged tiles fit the 227 KB of shared memory, and its dk/dv
// blocks own 128 columns each (dk and dv of 16 keys at 256 columns would be
// 256 registers). The widths <= 128 keep 64, 32 and every column.
template <int DMAX>
struct Tiles {
  static constexpr bool kWide = DMAX > 128;
  static constexpr int kKeyTile = kWide ? 16 : kKeys;
  static constexpr int kRowTile = kWide ? 16 : kBwdRows;
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
template <typename T, bool kNT, int K, int N8>
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
        mma_16bit<T>(c[n], a, b[0], b[1]);
        mma_16bit<T>(c[n + 1], a, b[2], b[3]);
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
  constexpr int KT = Tiles<DMAX>::kKeyTile;
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
  constexpr int KT = Tiles<DMAX>::kKeyTile;
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
    warp_gemm<T, true, DMAX>(dp, Ow, LD, Vs, LD, lane);
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
  constexpr int BR = Tiles<DMAX>::kRowTile;
  constexpr int LD = DMAX + kPad, LP = BR + kPad, N8 = Tiles<DMAX>::kCols / 8;
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

// bytes of shared memory per block of the mma.sync bodies; at D 256 (fp32):
// 141,312 (fwd), 208,896 (dq) and 209,152 (dk/dv)
template <typename T, int DMAX>
constexpr size_t fwd_smem() {  // Q, two K/V buffers, P
  constexpr int KT = Tiles<DMAX>::kKeyTile;
  return ((size_t)(kRows + 4 * KT) * (DMAX + kPad) + kRows * (KT + kPad)) * sizeof(T);
}

template <typename T, int DMAX>
constexpr size_t dq_smem() {  // Q, dO, two K/V buffers, dS
  constexpr int KT = Tiles<DMAX>::kKeyTile;
  return ((size_t)(2 * kRows + 4 * KT) * (DMAX + kPad) + kRows * (KT + kPad)) * sizeof(T);
}

template <typename T, int DMAX>
constexpr size_t dkdv_smem() {  // K, V, two Q/dO buffers, P^T/dS^T, two lse/delta buffers
  constexpr int BR = Tiles<DMAX>::kRowTile;
  return ((size_t)(2 * kKeys + 4 * BR) * (DMAX + kPad) + kKeys * (BR + kPad)) * sizeof(T) +
         4 * BR * sizeof(float);
}

enum Pass { kFwd, kDq, kDkdv };
using Kernel = void (*)(Args);

// The mma.sync kernels: one block per (64 folded query rows, KV head,
// batch), or per (64 keys, column split, KV head, batch) for dk/dv.
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
  using Ti = Tiles<DMAX>;
  dkdv_block<T, DMAX, kCap>(a, (blockIdx.x / Ti::kColSplits) * kKeys,
                            (blockIdx.x % Ti::kColSplits) * Ti::kCols, blockIdx.y, blockIdx.z,
                            smem);
}

// ---- the backward on wgmma (bf16 and fp16, head widths 65..256) ----

constexpr int kWgThreads = 256;  // two warpgroups
constexpr int kWgRows = 128;     // folded query rows of a dq block, 64 a warpgroup
constexpr int kWgKeys = 64;      // keys of a dk/dv block
constexpr int kWgRowStep = 64;   // folded query rows per step of the dk/dv sweep

// keys per K/V tile of the dq sweep
template <int DMAX>
struct WgKeyTile {
  static constexpr int kKeys = DMAX > 128 ? 32 : 64;
};

template <typename T, int DMAX>
constexpr size_t dq_wgmma_smem() {  // Q, dO, two K/V stages; 1 KB to align
  return (size_t)(2 * kWgRows + 4 * WgKeyTile<DMAX>::kKeys) * DMAX * sizeof(T) + 1024;
}

// K, V, two Q/dO stages, P^T (and 1 - t^2) from warpgroup 0, two lse/delta
// stages; 1 KB to align. At D 256 under the softcap: 231,424 bytes
template <typename T, int DMAX, bool kCap>
constexpr size_t dkdv_wgmma_smem() {
  return (size_t)(2 * kWgKeys + 4 * kWgRowStep) * DMAX * sizeof(T) +
         (kCap ? 2 : 1) * (kWgRowStep / 2) * 128 * sizeof(float) +
         4 * kWgRowStep * sizeof(float) + 1024;
}

// the dynamic shared memory from its first 1024-byte boundary (swizzled
// tiles start on one)
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// n / d for 0 <= n < 2^31 by a multiply and a shift, the divisor's magic
// number found once (the folded row f is position f / G, head f % G; a
// division on the CUDA cores is some twenty dependent instructions)
struct FastDiv {
  uint32_t d, m, s;
  __device__ __forceinline__ explicit FastDiv(uint32_t div) : d(div), s(0) {
    while ((1u << s) < div) ++s;
    m = (uint32_t)(((((uint64_t)1 << 32) * (((uint64_t)1 << s) - div)) / div) + 1);
  }
  __device__ __forceinline__ uint32_t operator()(uint32_t n) const {
    return (__umulhi(n, m) + n) >> s;
  }
};

// q_row with the fast division: element row of folded row f of (b, kv)
__device__ __forceinline__ long long q_row_fd(const Args& a, const FastDiv& G, int b, int kv,
                                              int f) {
  const int pos = (int)G(f);
  return ((long long)b * a.S + pos) * a.H + kv * (int)G.d + (f - pos * (int)G.d);
}

// masked_pair without branches: the wgmma bodies test every score of an
// edge tile, and a branch around each score's exp serializes them
__device__ __forceinline__ bool masked_nb(const Args& a, int pos, int key) {
  return (key >= a.S) | ((a.causal != 0) & (key > pos)) |
         ((a.window > 0) & (pos - key >= a.window));
}

// tanh as sign(y) (1 - 2 / (e^2|y| + 1)), the reciprocal refined by one
// Newton step: within 1.5e-7 of the exact value (tanhf: 6e-8; under a cap
// of 50 that moves a score by 7e-6, P by as much relative), and without
// tanhf's branches, which serialized the scores' chains. An odd polynomial
// for small |y| took the error to 1.1e-7 but slowed the softcap passes
// markedly.
__device__ __forceinline__ float tanh_nb(float y) {
  const float d = __expf(2.f * fminf(fabsf(y), 15.f)) + 1.f;  // tanh(15) rounds to 1
  float r = __fdividef(1.f, d);
  r = fmaf(r, fmaf(-d, r, 1.f), r);
  return copysignf(1.f - 2.f * r, y);
}

// capped() for the wgmma bodies: tanh_nb, and x / softcap refined from the
// reciprocal's product by one step (within an ulp of the division)
template <bool kCap>
__device__ __forceinline__ float cap_nb(float qk, float scale, float softcap, float& t) {
  float x = qk * scale;
  t = 0.f;
  if constexpr (kCap) {
    const float inv = __fdividef(1.f, softcap);
    const float y0 = x * inv;
    t = tanh_nb(fmaf(fmaf(-y0, softcap, x), inv, y0));
    x = softcap * t;
  }
  return x;
}

template <bool kCap>
__device__ __forceinline__ float capped_nb(const Args& a, float qk, float& t) {
  return cap_nb<kCap>(qk, a.scale, a.softcap, t);
}

// Start staging R rows of two tensors with the same rows into swizzled tiles
// (wgmma.cuh): row r is src[row(r) * D : +D] where row(r) >= 0, zeros
// otherwise, and the columns D..DMAX are zero. A thread copies one 16-byte
// column chunk of R * DMAX / 8 / 256 rows of each, finding each row once;
// the caller commits and waits.
template <typename T, int DMAX, int R, typename RowFn>
__device__ __forceinline__ void load_pair(T* dst0, const T* src0, T* dst1, const T* src1,
                                          int D, RowFn row) {
  constexpr int kChunks = DMAX / 8, kStride = kWgThreads / kChunks;
  static_assert(R % kStride == 0, "rows a multiple of the threads' row stride");
  const int c = threadIdx.x % kChunks, r0 = threadIdx.x / kChunks;
#pragma unroll
  for (int j = 0; j < R / kStride; ++j) {
    const int r = r0 + j * kStride;
    const long long g = row(r);
    const bool valid = g >= 0 && c * 8 < D;
    const long long off = valid ? g * D + c * 8 : 0;
    const int at = wgmma::swizzled<R>(r, c * 8);
    cp_async<16>(dst0 + at, src0 + off, valid);
    cp_async<16>(dst1 + at, src1 + off, valid);
  }
}

// load_pair for one tensor
template <typename T, int DMAX, int R, typename RowFn>
__device__ __forceinline__ void load_one(T* dst, const T* src, int D, RowFn row) {
  constexpr int kChunks = DMAX / 8, kStride = kWgThreads / kChunks;
  static_assert(R % kStride == 0, "rows a multiple of the threads' row stride");
  const int c = threadIdx.x % kChunks, r0 = threadIdx.x / kChunks;
#pragma unroll
  for (int j = 0; j < R / kStride; ++j) {
    const int r = r0 + j * kStride;
    const long long g = row(r);
    const bool valid = g >= 0 && c * 8 < D;
    cp_async<16>(dst + wgmma::swizzled<R>(r, c * 8), src + (valid ? g * D + c * 8 : 0), valid);
  }
}

// store a warpgroup's [64 x 8 R / 4] fp32 accumulator as T: the rows
// lane / 4 + 8 i of this warp go to element rows rows[i] (none where < 0),
// columns < D
template <typename T, int R>
__device__ __forceinline__ void store_acc(T* out, const float (&d)[R], const long long rows[2],
                                          int D, int lane) {
#pragma unroll
  for (int n = 0; n < R / 4; ++n) {
    const int col = 8 * n + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (rows[i] >= 0 && col < D)  // D % 8 == 0: col + 1 too
        store2(out + rows[i] * D + col, d[4 * n + 2 * i], d[4 * n + 2 * i + 1]);
  }
}

// dq of 128 folded query rows of (batch, KV head): a warpgroup per 64 rows
template <typename T, int DMAX, bool kCap>
__global__ void __launch_bounds__(kWgThreads, 1) dq_wgmma_kernel(Args a) {
  constexpr int KT = WgKeyTile<DMAX>::kKeys, BM = kWgRows;
  constexpr int R = KT / 2;  // score registers a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(align_1024(smem_raw));
  T* Os = Qs + BM * DMAX;    // dO
  T* KVs = Os + BM * DMAX;   // two stages of [K tile, V tile]

  const FastDiv G(a.H / a.KV);
  const int rows = a.S * (int)G.d, D = a.D;
  const int f0 = (int)(gridDim.x - 1 - blockIdx.x) * BM, kv = blockIdx.y, b = blockIdx.z;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const T* k = reinterpret_cast<const T*>(a.k);
  const T* v = reinterpret_cast<const T*>(a.v);
  auto load_kv = [&](int t, int stage) {  // K/V tile t into `stage`
    const int k0 = t * KT;
    T* Kb = KVs + stage * 2 * KT * DMAX;
    load_pair<T, DMAX, KT>(Kb, k, Kb + KT * DMAX, v, D, [&](int r) {
      return k0 + r < a.S ? kv_row(a, b, kv, k0 + r) : -1LL;
    });
  };

  int pos[2];
  long long qr[2];
  float lse[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int f = f0 + 64 * wg + 16 * warp + (lane >> 2) + 8 * i;
    pos[i] = (int)G(f);
    qr[i] = f < rows ? q_row_fd(a, G, b, kv, f) : -1LL;
    lse[i] = qr[i] >= 0 ? a.lse[qr[i]] : kLseMasked;  // masked rows: P = 0
    dl[i] = qr[i] >= 0 ? a.delta[qr[i]] : 0.f;
  }
  int t_begin, t_end;  // the block's key tiles
  key_tiles<KT>(a, (int)G(f0), (int)G(min(f0 + BM, rows) - 1), t_begin, t_end);
  // this warpgroup's positions: a tile that its rows cannot see is an edge
  // tile for it, wholly masked (skipping it would make the products'
  // path divergent, which serializes them)
  const int wf0 = f0 + 64 * wg;
  const int wp_first = (int)G(wf0), wp_last = (int)G(min(wf0 + 64, rows) - 1);

  load_pair<T, DMAX, BM>(Qs, reinterpret_cast<const T*>(a.q), Os,
                         reinterpret_cast<const T*>(a.dout), D, [&](int r) {
                           return f0 + r < rows ? q_row_fd(a, G, b, kv, f0 + r) : -1LL;
                         });
  load_kv(t_begin, 0);
  cp_async_commit();

  const uint32_t qa = smem_addr(Qs), oa = smem_addr(Os);
  float dq[DMAX / 2];
  wgmma::zero(dq);
  for (int t = t_begin, it = 0; t < t_end; ++t, ++it) {
    cp_async_wait<0>();
    wgmma::fence_proxy();
    __syncthreads();  // tile t (and Q, dO) visible to every warp; the other stage free
    const int k0 = t * KT;
    const uint32_t ka = smem_addr(KVs + (it & 1) * 2 * KT * DMAX);
    const uint32_t va = ka + KT * DMAX * sizeof(T);
    // S = Q K^T, in flight during the copy
    float s[R], dp[R];
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk)
      wgmma::mma_ss<T>(s, wgmma::desc_k<BM>(qa, 64 * wg, kk), wgmma::desc_k<KT>(ka, 0, kk),
                       kk > 0);
    wgmma::commit();
    if (t + 1 < t_end) {  // the next tile's copy runs while this one is used
      load_kv(t + 1, (it + 1) & 1);
      cp_async_commit();
    }
    // dP = dO V^T from fresh 16-deep products added in fp32, two in flight
    // at a time (the note)
    wgmma::zero(dp);
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; kk += 2) {
      float t0[R], t1[R];
      wgmma::fence();
      wgmma::mma_ss<T>(t0, wgmma::desc_k<BM>(oa, 64 * wg, kk), wgmma::desc_k<KT>(va, 0, kk),
                       0);
      wgmma::mma_ss<T>(t1, wgmma::desc_k<BM>(oa, 64 * wg, kk + 1),
                       wgmma::desc_k<KT>(va, 0, kk + 1), 0);
      wgmma::commit();
      wgmma::wait<0>();
      wgmma::hold(t0);
      wgmma::hold(t1);
#pragma unroll
      for (int i = 0; i < R; ++i) dp[i] = (dp[i] + t0[i]) + t1[i];
    }
    wgmma::hold(s);
    // dS in place of S; masks on edge tiles only
    auto ds_at = [&](int i, bool masked) {
      const int r = (i >> 1) & 1;
      float tc;
      const float x = capped_nb<kCap>(a, s[i], tc);
      const float p = expf(masked ? -INFINITY : x - lse[r]);
      s[i] = p * (dp[i] - dl[r]) * a.scale * (1.f - tc * tc);
    };
    if (edge_tile<KT>(a, k0, wp_first, wp_last)) {
#pragma unroll
      for (int i = 0; i < R; ++i)
        ds_at(i, masked_nb(a, pos[(i >> 1) & 1], k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1)));
    } else {
#pragma unroll
      for (int i = 0; i < R; ++i) ds_at(i, false);
    }
    uint32_t ds[R / 8][4];
    wgmma::to_a<T>(ds, s);
    wgmma::fence();
#pragma unroll
    for (int j = 0; j < R / 8; ++j)  // dq += dS K
      wgmma::mma_rs<T>(dq, ds[j], wgmma::desc_mn<KT>(ka, j));
    wgmma::commit();
    wgmma::wait<0>();  // K read before its stage is refilled
    wgmma::hold(dq);
    wgmma::hold(ds);
  }
  store_acc<T>(reinterpret_cast<T*>(a.out), dq, qr, D, lane);
}

// dk and dv of 64 keys of (batch, KV head): warpgroup 0 owns dv, 1 owns dk
template <typename T, int DMAX, bool kCap>
__global__ void __launch_bounds__(kWgThreads, 1) dkdv_wgmma_kernel(Args a) {
  constexpr int BN = kWgKeys, BR = kWgRowStep;
  constexpr int R = BR / 2;  // score registers a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(align_1024(smem_raw));
  T* Vs = Ks + BN * DMAX;
  T* QOs = Vs + BN * DMAX;  // two stages of [Q tile, dO tile]
  // P^T from warpgroup 0 to 1, [R / 4][128] float4s (thread t's elements
  // i..i+3 at i / 4 * 128 + t), then under the softcap 1 - t^2 the same way
  float* Px = reinterpret_cast<float*>(QOs + 4 * BR * DMAX);
  float* LDs = Px + (kCap ? 2 : 1) * R * 128;  // two stages of [lse, delta]

  const FastDiv G(a.H / a.KV);
  const int rows = a.S * (int)G.d, D = a.D;
  const int k0 = blockIdx.x * BN, kv = blockIdx.y, b = blockIdx.z;
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const T* q = reinterpret_cast<const T*>(a.q);
  const T* dout = reinterpret_cast<const T*>(a.dout);

  // the row tile at f0 into `stage`: Q, dO, and lse/delta (zeros for rows
  // past the end, which the mask below drops)
  auto load_rows = [&](int f0, int stage) {
    auto q_tile_row = [&](int r) {
      return f0 + r < rows ? q_row_fd(a, G, b, kv, f0 + r) : -1LL;
    };
    T* Qb = QOs + stage * 2 * BR * DMAX;
    load_pair<T, DMAX, BR>(Qb, q, Qb + BR * DMAX, dout, D, q_tile_row);
    if (threadIdx.x < BR) {
      const long long r = q_tile_row(threadIdx.x);
      float* Lb = LDs + stage * 2 * BR;
      cp_async<4>(Lb + threadIdx.x, r >= 0 ? a.lse + r : a.lse, r >= 0);
      cp_async<4>(Lb + BR + threadIdx.x, r >= 0 ? a.delta + r : a.delta, r >= 0);
    }
  };

  int key[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) key[i] = k0 + 16 * warp + (lane >> 2) + 8 * i;
  // under causal, folded rows before position k0 see none of these keys;
  // under a window, rows at or past position k0 + BN - 1 + window see none
  // either
  const int f_begin = a.causal ? (int)((long long)k0 * G.d / BR) * BR : 0;
  const int f_end =
      a.window > 0 ? (int)min((long long)rows, ((long long)k0 + BN - 1 + a.window) * G.d)
                   : rows;

  load_pair<T, DMAX, BN>(Ks, reinterpret_cast<const T*>(a.k), Vs,
                         reinterpret_cast<const T*>(a.v), D, [&](int r) {
                           return k0 + r < a.S ? kv_row(a, b, kv, k0 + r) : -1LL;
                         });
  if (f_begin < f_end) load_rows(f_begin, 0);
  cp_async_commit();

  const uint32_t lhs = smem_addr(wg == 0 ? Ks : Vs);  // S^T = K Q^T; dP^T = V dO^T
  float acc[DMAX / 2];                                 // warpgroup 0: dv; 1: dk
  wgmma::zero(acc);
  for (int f0 = f_begin, it = 0; f0 < f_end; f0 += BR, ++it) {
    cp_async_wait<0>();
    wgmma::fence_proxy();
    __syncthreads();  // this row tile (and K, V) visible to every warp; the other stage free
    const uint32_t qa = smem_addr(QOs + (it & 1) * 2 * BR * DMAX);
    const uint32_t oa = qa + BR * DMAX * sizeof(T);
    const float* Ls = LDs + (it & 1) * 2 * BR;
    const float* Dl = Ls + BR;

    // rows: this warpgroup's 64 keys; columns: the tile's BR folded rows
    float s[R];
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk)
      wgmma::mma_ss<T>(s, wgmma::desc_k<BN>(lhs, 0, kk),
                       wgmma::desc_k<BR>(wg == 0 ? qa : oa, 0, kk), kk > 0);
    wgmma::commit();
    if (f0 + BR < f_end) {  // the next row tile's copy runs meanwhile
      load_rows(f0 + BR, (it + 1) & 1);
      cp_async_commit();
    }
    // this thread's R / 2 columns: 8 (j / 2) + 2 (lane % 4) + j % 2, which
    // holds its elements 4 (j / 2) + j % 2 + {0, 2}
    auto col_of = [&](int j) { return 8 * (j >> 1) + 2 * (lane & 3) + (j & 1); };
    float cv[R / 2];  // warpgroup 0: lse; 1: delta, of each column
#pragma unroll
    for (int j = 0; j < R / 2; ++j) cv[j] = wg == 0 ? Ls[col_of(j)] : Dl[col_of(j)];
    wgmma::wait<0>();
    wgmma::hold(s);
    if (wg == 0) {  // P^T, kept in s and passed on; masks on edge tiles only
      float dc[R];
      auto p_at = [&](int i, bool masked) {
        float tc;
        const float x = capped_nb<kCap>(a, s[i], tc);
        const int j = ((i >> 2) << 1) | (i & 1);
        s[i] = expf(masked ? -INFINITY : x - cv[j]);
        dc[i] = 1.f - tc * tc;
      };
      const int p_last = (int)G(min(f0 + BR, rows) - 1);
      if ((a.causal && k0 + BN - 1 > (int)G(f0)) || k0 + BN > a.S || f0 + BR > rows ||
          (a.window > 0 && p_last - k0 >= a.window)) {
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int f = f0 + col_of(((i >> 2) << 1) | (i & 1));
          p_at(i, (f >= rows) | masked_nb(a, (int)G(f), key[(i >> 1) & 1]));
        }
      } else {
#pragma unroll
        for (int i = 0; i < R; ++i) p_at(i, false);
      }
      float4* P4 = reinterpret_cast<float4*>(Px);
#pragma unroll
      for (int i = 0; i < R; i += 4) {
        P4[(i >> 2) * 128 + t] = make_float4(s[i], s[i + 1], s[i + 2], s[i + 3]);
        if constexpr (kCap)
          P4[(R / 4 + (i >> 2)) * 128 + t] = make_float4(dc[i], dc[i + 1], dc[i + 2], dc[i + 3]);
      }
    }
    __syncthreads();  // P^T visible to warpgroup 1
    if (wg == 1) {  // dS^T in place of dP^T
      const float4* P4 = reinterpret_cast<const float4*>(Px);
#pragma unroll
      for (int i = 0; i < R; i += 4) {
        const float4 p = P4[(i >> 2) * 128 + t];
        float4 dc = make_float4(1.f, 1.f, 1.f, 1.f);
        if constexpr (kCap) dc = P4[(R / 4 + (i >> 2)) * 128 + t];
        const int j = (i >> 2) << 1;  // elements i, i + 1, i + 2, i + 3: columns j, j + 1, j, j + 1
        s[i] = p.x * (s[i] - cv[j]) * a.scale * dc.x;
        s[i + 1] = p.y * (s[i + 1] - cv[j + 1]) * a.scale * dc.y;
        s[i + 2] = p.z * (s[i + 2] - cv[j]) * a.scale * dc.z;
        s[i + 3] = p.w * (s[i + 3] - cv[j + 1]) * a.scale * dc.w;
      }
    }
    uint32_t pa[R / 8][4];
    wgmma::to_a<T>(pa, s);
    wgmma::fence();
#pragma unroll
    for (int j = 0; j < R / 8; ++j)  // dv += P^T dO; dk += dS^T Q
      wgmma::mma_rs<T>(acc, pa[j], wgmma::desc_mn<BR>(wg == 0 ? oa : qa, j));
    wgmma::commit();
    wgmma::wait<0>();  // Q and dO read before their stage is refilled
    wgmma::hold(acc);
    wgmma::hold(pa);
  }
  cp_async_wait<0>();  // K and V, where no row sees the keys

  long long kr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) kr[i] = key[i] < a.S ? kv_row(a, b, kv, key[i]) : -1LL;
  store_acc<T>(reinterpret_cast<T*>(wg == 0 ? a.out2 : a.out), acc, kr, D, lane);
}

// ---- the forward on wgmma: K1 (and K3) here, K4's multi-row tiles in
// paged_attention.cuh, one sweep ----

// bytes of one staging slot of a K4 int8 tile: the codes of K and V
// ([KT][DMAX] bytes each) and, per thread, the scales of the rows it copies
template <int DMAX>
__host__ __device__ constexpr int staged_slot_bytes() {
  constexpr int KT = WgKeyTile<DMAX>::kKeys;
  constexpr int kRowsPerThread = KT * (DMAX / 16) / kWgThreads;  // 2 at 128 and 256
  return 2 * KT * DMAX + 2 * kRowsPerThread * kWgThreads * 4;
}

// Q, two K/V stages, and (kStaged: K4 over an int8 cache) two staging
// slots of int8 codes and scales; 1 KB to align
template <typename T, int DMAX, bool kStaged>
constexpr size_t fwd_wgmma_smem() {
  constexpr int KT = WgKeyTile<DMAX>::kKeys;
  return (size_t)(kWgRows + 4 * KT) * DMAX * sizeof(T) +
         (kStaged ? 2 * staged_slot_bytes<DMAX>() : 0) + 1024;
}

// The forward of the 128 folded query rows f0.. of one block, a warpgroup
// per 64: o (unnormalized), the running max m and sum l of this thread's
// two rows (lane / 4 + 8 i of its warp's 16). Src says where the rows and
// keys are (FlashSrc below: dense K/V; paged_attention.cuh PagedSrc: K/V
// gathered through a block table):
//   q, D, rows, scale, softcap; q_row(f): element row of folded row f of
//   q (-1 past rows); pos(f): its query position; key_tiles<KT>(p_first,
//   p_last, t_begin, t_end): the key tiles the block visits; edge<KT>(k0,
//   p_first, p_last): whether a tile needs masks for those positions;
//   masked(pos, key), branch-free; load<KT, DMAX>(t, K, V, slot): start
//   this thread's copies of key tile t, into the 16-bit K and V tiles or
//   (kStaged) into a staging slot; where kAlibi, slope(f): ALiBi's slope
//   of row f; where kStaged, dequant<KT, DMAX>(slot, K, V): the staged
//   codes this thread copied into the 16-bit tiles (no other thread's, so
//   no barrier between).
// Step t: S = Q K^T (K-major operands), in flight while the next tile's
// copies are issued; the scale, cap, bias and (edge tiles only) masks; the
// online max and sum in registers; o rescaled (the previous step's product
// retired); then o += P V with P rounded to T as the A operand from
// registers (to_a) and V as an MN-major operand. A staged tile t+1 is
// dequantized at the end of step t from codes copied a step earlier. One
// barrier a step: tile t visible, the other stage free.
template <typename T, int DMAX, bool kCap, typename Src>
__device__ __forceinline__ void fwd_sweep(const Src& src, int f0, unsigned char* smem,
                                          float (&o)[DMAX / 2], float (&m)[2], float (&l)[2]) {
  constexpr int KT = WgKeyTile<DMAX>::kKeys, BM = kWgRows;
  constexpr int R = KT / 2;  // score registers a thread
  T* Qs = reinterpret_cast<T*>(smem);
  T* KVs = Qs + BM * DMAX;  // two stages of [K tile, V tile]
  unsigned char* staging = reinterpret_cast<unsigned char*>(KVs + 4 * KT * DMAX);
  auto K_at = [&](int it) { return KVs + (it & 1) * 2 * KT * DMAX; };
  auto slot_at = [&](int it) { return staging + (it & 1) * staged_slot_bytes<DMAX>(); };
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;

  int pos[2];
  float slope[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int f = f0 + 64 * wg + 16 * warp + (lane >> 2) + 8 * i;
    pos[i] = src.pos(f);
    if constexpr (Src::kAlibi) slope[i] = src.slope(f);
  }
  int t_begin, t_end;  // the block's key tiles
  src.template key_tiles<KT>(src.pos(f0), src.pos(min(f0 + BM, src.rows) - 1), t_begin, t_end);
  // this warpgroup's positions: a tile that its rows cannot see is an edge
  // tile for it, wholly masked (as in dq_wgmma_kernel)
  const int wf0 = f0 + 64 * wg;
  const int wp_first = src.pos(wf0), wp_last = src.pos(min(wf0 + 64, src.rows) - 1);

  load_one<T, DMAX, BM>(Qs, src.q, src.D, [&](int r) { return src.q_row(f0 + r); });
  if (t_begin < t_end) src.template load<KT, DMAX>(t_begin, K_at(0), K_at(0) + KT * DMAX,
                                                   slot_at(0));
  cp_async_commit();
  if constexpr (Src::kStaged) {  // tile 0 dequantized, tile 1's codes in flight
    if (t_begin + 1 < t_end) {
      src.template load<KT, DMAX>(t_begin + 1, nullptr, nullptr, slot_at(1));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (t_begin < t_end) src.template dequant<KT, DMAX>(slot_at(0), K_at(0), K_at(0) + KT * DMAX);
  }

  const uint32_t qa = smem_addr(Qs);
  wgmma::zero(o);
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.f;
  for (int t = t_begin, it = 0; t < t_end; ++t, ++it) {
    if constexpr (!Src::kStaged) cp_async_wait<0>();  // tile t (and Q) copied
    wgmma::fence_proxy();
    __syncthreads();  // tile t visible to every warp; the other stage free
    const int k0 = t * KT;
    const uint32_t ka = smem_addr(K_at(it)), va = ka + KT * DMAX * sizeof(T);
    float s[R];
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk)
      wgmma::mma_ss<T>(s, wgmma::desc_k<BM>(qa, 64 * wg, kk), wgmma::desc_k<KT>(ka, 0, kk),
                       kk > 0);
    wgmma::commit();
    // the next copies run while this tile is used: tile t+1 into the other
    // stage, or a staged tile's codes two steps ahead
    if constexpr (Src::kStaged) {
      if (t + 2 < t_end) {
        src.template load<KT, DMAX>(t + 2, nullptr, nullptr, slot_at(it));
        cp_async_commit();
      }
    } else if (t + 1 < t_end) {
      src.template load<KT, DMAX>(t + 1, K_at(it + 1), K_at(it + 1) + KT * DMAX, nullptr);
      cp_async_commit();
    }
    wgmma::wait<0>();
    wgmma::hold(s);
    // scores in place of S: scale, cap, bias; masks on edge tiles only
    float mx[2] = {-INFINITY, -INFINITY};
    auto score = [&](int i, bool masked) {
      const int r = (i >> 1) & 1;
      float tc;
      float x = cap_nb<kCap>(s[i], src.scale, src.softcap, tc);
      if constexpr (Src::kAlibi)  // the plain version's order, each op rounded
        x = __fadd_rn(x, __fmul_rn(slope[r],
                                   (float)(k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1) -
                                           pos[r])));
      s[i] = masked ? -INFINITY : x;
      mx[r] = fmaxf(mx[r], s[i]);
    };
    if (src.template edge<KT>(k0, wp_first, wp_last)) {
#pragma unroll
      for (int i = 0; i < R; ++i)
        score(i, src.masked(pos[(i >> 1) & 1], k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1)));
    } else {
#pragma unroll
      for (int i = 0; i < R; ++i) score(i, false);
    }
    float mu[2], corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], row_max(mx[r]));
      mu[r] = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet
      corr[r] = expf(m[r] - mu[r]);
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      s[i] = expf(s[i] - mu[(i >> 1) & 1]);
      rs[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + row_sum(rs[r]);
    // the previous step's product retired (wait and hold below): o is ours
#pragma unroll
    for (int i = 0; i < DMAX / 2; ++i) o[i] *= corr[(i >> 1) & 1];
    uint32_t pa[R / 8][4];
    wgmma::to_a<T>(pa, s);
    wgmma::fence();
#pragma unroll
    for (int j = 0; j < R / 8; ++j)  // o += P V
      wgmma::mma_rs<T>(o, pa[j], wgmma::desc_mn<KT>(va, j));
    wgmma::commit();
    wgmma::wait<0>();  // K and V read before their stage is refilled
    wgmma::hold(o);
    wgmma::hold(pa);
    if constexpr (Src::kStaged) {  // tile t+1 from the codes this thread copied
      if (t + 1 < t_end) {
        if (t + 2 < t_end) cp_async_wait<1>();
        else cp_async_wait<0>();
        src.template dequant<KT, DMAX>(slot_at(it + 1), K_at(it + 1),
                                       K_at(it + 1) + KT * DMAX);
      }
    }
  }
  cp_async_wait<0>();  // Q, where the block visits no key
}

// K1's keys and rows: dense K/V of (batch b, KV head kv); folded row f is
// position f / G, head kv * G + f % G
template <typename T>
struct FlashSrc {
  static constexpr bool kAlibi = false, kStaged = false;
  const Args& a;
  FastDiv G;
  int b, kv, rows, D;
  const T* q;
  float scale, softcap;
  __device__ __forceinline__ FlashSrc(const Args& args, int b_, int kv_)
      : a(args), G(args.H / args.KV), b(b_), kv(kv_), rows(args.S * (args.H / args.KV)),
        D(args.D), q(reinterpret_cast<const T*>(args.q)), scale(args.scale),
        softcap(args.softcap) {}
  __device__ __forceinline__ long long q_row(int f) const {
    return f < rows ? q_row_fd(a, G, b, kv, f) : -1LL;
  }
  __device__ __forceinline__ int pos(int f) const { return (int)G(f); }
  template <int KT>
  __device__ __forceinline__ void key_tiles(int p_first, int p_last, int& t_begin,
                                            int& t_end) const {
    flash::key_tiles<KT>(a, p_first, p_last, t_begin, t_end);
  }
  template <int KT>
  __device__ __forceinline__ bool edge(int k0, int p_first, int p_last) const {
    return edge_tile<KT>(a, k0, p_first, p_last);
  }
  __device__ __forceinline__ bool masked(int p, int key) const { return masked_nb(a, p, key); }
  template <int KT, int DMAX>
  __device__ __forceinline__ void load(int t, T* Kb, T* Vb, unsigned char*) const {
    const int k0 = t * KT;
    load_pair<T, DMAX, KT>(Kb, reinterpret_cast<const T*>(a.k), Vb,
                           reinterpret_cast<const T*>(a.v), D, [&](int r) {
                             return k0 + r < a.S ? kv_row(a, b, kv, k0 + r) : -1LL;
                           });
  }
};

// o and lse of 128 folded query rows of (batch, KV head): a warpgroup per
// 64 rows; the row tiles run last-first, so under causal the longest
// blocks start first
template <typename T, int DMAX, bool kCap>
__global__ void __launch_bounds__(kWgThreads, 1) fwd_wgmma_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const FlashSrc<T> src(a, blockIdx.z, blockIdx.y);
  const int f0 = (int)(gridDim.x - 1 - blockIdx.x) * kWgRows;
  float o[DMAX / 2], m[2], l[2];
  fwd_sweep<T, DMAX, kCap>(src, f0, align_1024(smem_raw), o, m, l);
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  long long orow[2];
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    orow[i] = src.q_row(f0 + 64 * wg + 16 * warp + (lane >> 2) + 8 * i);
    inv[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;
    if (orow[i] >= 0 && (lane & 3) == 0)
      a.lse_out[orow[i]] = l[i] > 0.f ? m[i] + logf(l[i]) : kLseMasked;
  }
#pragma unroll
  for (int i = 0; i < DMAX / 2; ++i) o[i] *= inv[(i >> 1) & 1];
  store_acc<T>(reinterpret_cast<T*>(a.out), o, orow, a.D, lane);
}

template <Pass P, typename T, int DMAX, bool kCap>
cudaError_t launch_wgmma_cap(const Args& a, cudaStream_t stream) {
  Kernel kern;
  size_t smem;
  dim3 grid;
  if constexpr (P == kFwd) {
    kern = &fwd_wgmma_kernel<T, DMAX, kCap>;
    smem = fwd_wgmma_smem<T, DMAX, false>();
    grid = dim3((a.S * (a.H / a.KV) + kWgRows - 1) / kWgRows, a.KV, a.B);
  } else if constexpr (P == kDq) {
    kern = &dq_wgmma_kernel<T, DMAX, kCap>;
    smem = dq_wgmma_smem<T, DMAX>();
    grid = dim3((a.S * (a.H / a.KV) + kWgRows - 1) / kWgRows, a.KV, a.B);
  } else {
    kern = &dkdv_wgmma_kernel<T, DMAX, kCap>;
    smem = dkdv_wgmma_smem<T, DMAX, kCap>();
    grid = dim3((a.S + kWgKeys - 1) / kWgKeys, a.KV, a.B);
  }
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, kWgThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// one wgmma pass at one head width, by dtype and softcap; each (pass,
// width) is compiled in a source of its own (flash_attention_fwd.cu,
// flash_attention_dq.cu, flash_attention_dkdv.cu, and their _d256 forms),
// so the build runs them in parallel
template <Pass P, int DMAX>
int run_wgmma(const Args& a, int dtype, cudaStream_t s) {
  const bool cap = a.softcap > 0.f;
  switch (dtype) {
    case kBFloat16:
      return (int)(cap ? launch_wgmma_cap<P, __nv_bfloat16, DMAX, true>(a, s)
                       : launch_wgmma_cap<P, __nv_bfloat16, DMAX, false>(a, s));
    case kFloat16:
      return (int)(cap ? launch_wgmma_cap<P, __half, DMAX, true>(a, s)
                       : launch_wgmma_cap<P, __half, DMAX, false>(a, s));
    default: return (int)cudaErrorInvalidValue;
  }
}

int run_fwd_wgmma_128(const Args& a, int dtype, cudaStream_t s);
int run_dq_wgmma_128(const Args& a, int dtype, cudaStream_t s);
int run_dkdv_wgmma_128(const Args& a, int dtype, cudaStream_t s);
int run_fwd_wgmma_256(const Args& a, int dtype, cudaStream_t s);
int run_dq_wgmma_256(const Args& a, int dtype, cudaStream_t s);
int run_dkdv_wgmma_256(const Args& a, int dtype, cudaStream_t s);

// the mma.sync bodies run every pass in fp32 and at head width <= 64
// (fp32 parity runs and small models); bf16 and fp16 at 65..256 are
// wgmma's, and their mma.sync instances are never compiled
template <typename T, int DMAX>
constexpr bool kMmaBody = std::is_same<T, float>::value || DMAX <= 64;

template <typename T, int DMAX, bool kCap>
cudaError_t launch_cap(Pass pass, const Args& a, cudaStream_t stream) {
  if constexpr (!kMmaBody<T, DMAX>) {
    return cudaErrorInvalidValue;  // the wgmma kernels (run)
  } else {
    Kernel kern = &fwd_kernel<T, DMAX, kCap>;
    size_t smem = fwd_smem<T, DMAX>();
    dim3 grid((a.S * (a.H / a.KV) + kRows - 1) / kRows, a.KV, a.B);
    if (pass == kDq) {
      kern = &dq_kernel<T, DMAX, kCap>;
      smem = dq_smem<T, DMAX>();
    } else if (pass == kDkdv) {
      kern = &dkdv_kernel<T, DMAX, kCap>;
      smem = dkdv_smem<T, DMAX>();
      grid = dim3((a.S + kKeys - 1) / kKeys * Tiles<DMAX>::kColSplits, a.KV, a.B);
    }
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
      if (e != cudaSuccess) return e;
    }
    kern<<<grid, kThreads, smem, stream>>>(a);
    return cudaGetLastError();
  }
}

template <typename T, int DMAX>
cudaError_t launch(Pass pass, const Args& a, cudaStream_t stream) {
  return a.softcap > 0.f ? launch_cap<T, DMAX, true>(pass, a, stream)
                         : launch_cap<T, DMAX, false>(pass, a, stream);
}

// the mma.sync instances of one head width DMAX, by dtype
template <int DMAX>
int run_width(Pass pass, const Args& a, int dtype, cudaStream_t s) {
  switch (dtype) {
    case kFloat32: return (int)launch<float, DMAX>(pass, a, s);
    case kBFloat16: return (int)launch<__nv_bfloat16, DMAX>(pass, a, s);
    case kFloat16: return (int)launch<__half, DMAX>(pass, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the head-width-256 mma.sync instances (fp32), compiled in
// flash_attention_d256.cu
int run_d256(Pass pass, const Args& a, int dtype, cudaStream_t stream);

// one pass of either layout (flash_attention.cu): checks the shape, then
// launches a wgmma kernel (bf16, fp16 at head widths 65..256) or a
// mma.sync one
int run(Pass pass, const Args& a, int dtype, void* stream);

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
