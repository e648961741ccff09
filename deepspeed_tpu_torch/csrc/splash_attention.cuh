// K8: splash block-sparse attention, the forward and both backward passes.
// The bodies; splash_attention.cu (forward), splash_attention_bwd_dq.cu
// and splash_attention_bwd_dkdv.cu each instantiate one pass, so the three
// build in parallel.
//
// Replaces the TPU kernels deepspeed_tpu/ops/sparse_attention/splash.py:63
// _splash_kernel (driven by _splash_fwd :117, pallas_call :153), :165
// _splash_dq_kernel (pallas_call :266) and :201 _splash_dkv_kernel
// (pallas_call :289). The same function, on another grid:
//   q, k, v [BH, S, D] (the [B, H, S, D] of the caller), a static layout
//   [Lh, nb, nb] with nb = S / block compacted into a table [Lh, nb, A] of
//   each row's active k-blocks and their counts [Lh, nb] (padding entries
//   point at block 0 and are never read: the loop ends at the count). Row
//   bh reads layout head bh % Lh (jax.lax.rem(bh, nheads_layout), :74).
//   s = (q . k) * scale in fp32 over the active blocks only;
//   forward: o = softmax(s) v in q's dtype and lse [BH, S] fp32; a row
//   with no active block gets o = 0 and lse = +1e30 (-NEG_INF, :104-114), so
//   the backward's exp(s - lse) is exactly 0 there.
//   backward (delta = rowsum(dO * O) [BH, S] fp32 comes from the caller):
//   P = exp(s - lse), dS = P * (dP - delta) * scale with dP = dO v^T;
//   dq = dS k over the forward table; dk = dS^T q and dv = P^T dO over the
//   transposed table (for each k-block, the q-blocks that see it), so no
//   two blocks write one row: no atomics, and dk, dv are deterministic.
//
// Numerics: as K1/K2 (flash_attention.cuh, whose tile products this file
// reuses): bf16 or fp16 operands on mma.sync m16n8k16 with fp32
// accumulation, the softmax and its statistics in fp32; P (forward and
// dk/dv) and dS (dq and dk/dv) rounded to the input dtype before their
// products, as the Pallas kernels do. fp32 runs the same tiles on the CUDA
// cores (the parity runs).
//
// Bound on the H100: at head_dim 64 a 16-key block is reused by the 16
// queries of its q-block only, about 16 flops per byte of K/V staged, so the
// kernels are far below the 295 flops per byte where the tensor cores would
// bind: each input read once (q, k, v, o: 33.5 MB each at B 4, H 16,
// S 4096, D 64 in bf16) is the least time. What the design does:
// - The TPU grid (BH, nb, A) pads every row to the widest one (A = 256 for
//   BigBird's and Longformer's global rows, where other rows have ~5); here
//   one block owns up to 64 rows (one warp per 16) of one q-block of one
//   (batch, head) and loops over exactly its row's count of active blocks,
//   staging each k-block's K and V (in 64-key tiles for block 128) in
//   shared memory, double-buffered with cp.async. Block 128 is two 64-row
//   blocks that read one table row.
// - The tile follows the block size: 16, 32 or 64 rows by 16, 32 or 64 keys,
//   so adjacent q-blocks, whose table rows differ, never share a block.
// - dk/dv: one block per 64 (or block) keys, sweeping the q-blocks of the
//   transposed table in tiles of 32 (or 16) query rows.
// - The wide rows run as long as they are: the load imbalance (BigBird's
//   global row does 256 blocks where others do ~5) is left to a later
//   version, which could split long rows and combine them.
#pragma once

#include "flash_attention.cuh"

namespace dstt {
namespace splash {

using flash::kPad;
using flash::load_tile;  // with the block's thread count NT

constexpr float kLseEmpty = 1e30f;  // splash.py -NEG_INF

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;    // backward: dO
  const float* lse;    // backward: [BH, S]
  const float* delta;  // backward: [BH, S]
  void* out;           // forward: o; dq pass: dq; dk/dv pass: dk
  void* out2;          // dk/dv pass: dv
  float* lse_out;      // forward: [BH, S]
  const int* table;    // [Lh, nb, A]: the layout's (dk/dv: its transpose's)
  const int* counts;   // [Lh, nb]
  int BH, S, D, Lh, A, nb;
  float scale;
};

// The tile of a block size: R rows per thread block (one warp per 16), KT
// keys per staged K/V tile (forward, dq), QT query rows per step (dk/dv)
template <int BLK>
struct Tile {
  static constexpr int R = BLK < 64 ? BLK : 64;
  static constexpr int NT = R / 16 * 32;
  static constexpr int KT = BLK < 64 ? BLK : 64;
  static constexpr int QT = BLK < 32 ? BLK : 32;
};

// the accumulator rows lane/4 and lane/4 + 8 of a warp, as element rows
__device__ __forceinline__ void warp_rows(long long (&rows)[2], long long first, int warp,
                                          int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) rows[i] = first + warp * 16 + (lane >> 2) + 8 * i;
}

template <typename T, int BLK, int DMAX>
__global__ void __launch_bounds__(Tile<BLK>::NT) fwd_kernel(Args a) {
  using G = Tile<BLK>;
  constexpr int R = G::R, KT = G::KT, NT = G::NT, NSUB = BLK / KT;
  constexpr int LD = DMAX + kPad, LP = KT + kPad, N8 = DMAX / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* KVs = Qs + R * LD;        // two buffers of [K tile, V tile]
  T* Ps = KVs + 4 * KT * LD;   // [R][LP], 16 rows per warp

  const int bh = blockIdx.y, r0 = blockIdx.x * R, qb = r0 / BLK, h = bh % a.Lh;
  const int D = a.D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long base = (long long)bh * a.S;
  const int* row = a.table + ((long long)h * a.nb + qb) * a.A;
  const int steps = a.counts[h * a.nb + qb] * NSUB;
  const T* k = reinterpret_cast<const T*>(a.k);
  const T* v = reinterpret_cast<const T*>(a.v);
  auto load_kv = [&](int t) {  // step t's K/V tile into buffer t % 2
    const long long k0 = base + (long long)row[t / NSUB] * BLK + (t % NSUB) * KT;
    T* Kb = KVs + (t & 1) * 2 * KT * LD;
    auto key_row = [&](int r) { return k0 + r; };
    load_tile<T, DMAX, NT>(Kb, KT, k, D, key_row);
    load_tile<T, DMAX, NT>(Kb + KT * LD, KT, v, D, key_row);
  };

  load_tile<T, DMAX, NT>(Qs, R, reinterpret_cast<const T*>(a.q), D,
                         [&](int r) { return base + r0 + r; });
  if (steps > 0) load_kv(0);
  flash::cp_async_commit();

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[N8][4];
  flash::zero(acc);
  const T* Qw = Qs + warp * 16 * LD;
  T* Pw = Ps + warp * 16 * LP;

  for (int t = 0; t < steps; ++t) {
    // the next tile's copy runs while this one is used; the buffer it
    // fills was released by the __syncthreads ending the previous step
    if (t + 1 < steps) {
      load_kv(t + 1);
      flash::cp_async_commit();
      flash::cp_async_wait<1>();
    } else {
      flash::cp_async_wait<0>();
    }
    __syncthreads();
    const T* Ks = KVs + (t & 1) * 2 * KT * LD;
    const T* Vs = Ks + KT * LD;

    float s[KT / 8][4];
    flash::zero(s);
    flash::warp_gemm<T, true, DMAX>(s, Qw, LD, Ks, LD, lane);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < KT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] *= a.scale;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float mu[2], corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], flash::row_max(mx[i]));
      mu[i] = m_new == -INFINITY ? 0.f : m_new;
      corr[i] = expf(m[i] - mu[i]);
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < KT / 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float p0 = expf(s[n][2 * i] - mu[i]), p1 = expf(s[n][2 * i + 1] - mu[i]);
        rs[i] += p0 + p1;
        flash::store2(Pw + ((lane >> 2) + 8 * i) * LP + n * 8 + (lane & 3) * 2, p0, p1);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + flash::row_sum(rs[i]);
#pragma unroll
    for (int n = 0; n < N8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
    __syncwarp();
    flash::warp_gemm<T, false, KT>(acc, Pw, LP, Vs, LD, lane);
    __syncthreads();  // every warp is done with this K/V buffer (and its Pw)
  }
  if (steps == 0) flash::cp_async_wait<0>();  // the Q copy, unused

  long long orow[2];
  warp_rows(orow, base + r0, warp, lane);
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    inv[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;
    if ((lane & 3) == 0) a.lse_out[orow[i]] = l[i] > 0.f ? m[i] + logf(l[i]) : kLseEmpty;
  }
  flash::store_rows<T>(reinterpret_cast<T*>(a.out), acc, orow, inv, D, lane);
}

template <typename T, int BLK, int DMAX>
__global__ void __launch_bounds__(Tile<BLK>::NT) dq_kernel(Args a) {
  using G = Tile<BLK>;
  constexpr int R = G::R, KT = G::KT, NT = G::NT, NSUB = BLK / KT;
  constexpr int LD = DMAX + kPad, LP = KT + kPad, N8 = DMAX / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Os = Qs + R * LD;         // dO
  T* KVs = Os + R * LD;        // two buffers of [K tile, V tile]
  T* Ps = KVs + 4 * KT * LD;   // dS, [R][LP]

  const int bh = blockIdx.y, r0 = blockIdx.x * R, qb = r0 / BLK, h = bh % a.Lh;
  const int D = a.D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long base = (long long)bh * a.S;
  const int* row = a.table + ((long long)h * a.nb + qb) * a.A;
  const int steps = a.counts[h * a.nb + qb] * NSUB;
  const T* k = reinterpret_cast<const T*>(a.k);
  const T* v = reinterpret_cast<const T*>(a.v);
  auto load_kv = [&](int t) {
    const long long k0 = base + (long long)row[t / NSUB] * BLK + (t % NSUB) * KT;
    T* Kb = KVs + (t & 1) * 2 * KT * LD;
    auto key_row = [&](int r) { return k0 + r; };
    load_tile<T, DMAX, NT>(Kb, KT, k, D, key_row);
    load_tile<T, DMAX, NT>(Kb + KT * LD, KT, v, D, key_row);
  };

  long long qr[2];
  warp_rows(qr, base + r0, warp, lane);
  float lse[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse[i] = a.lse[qr[i]];
    dl[i] = a.delta[qr[i]];
  }
  auto q_row = [&](int r) { return base + r0 + r; };
  load_tile<T, DMAX, NT>(Qs, R, reinterpret_cast<const T*>(a.q), D, q_row);
  load_tile<T, DMAX, NT>(Os, R, reinterpret_cast<const T*>(a.dout), D, q_row);
  if (steps > 0) load_kv(0);
  flash::cp_async_commit();

  float dq[N8][4];
  flash::zero(dq);
  const T* Qw = Qs + warp * 16 * LD;
  const T* Ow = Os + warp * 16 * LD;
  T* Pw = Ps + warp * 16 * LP;

  for (int t = 0; t < steps; ++t) {
    if (t + 1 < steps) {  // as in fwd_kernel
      load_kv(t + 1);
      flash::cp_async_commit();
      flash::cp_async_wait<1>();
    } else {
      flash::cp_async_wait<0>();
    }
    __syncthreads();
    const T* Ks = KVs + (t & 1) * 2 * KT * LD;
    const T* Vs = Ks + KT * LD;

    float s[KT / 8][4], dp[KT / 8][4];
    flash::zero(s);
    flash::zero(dp);
    flash::warp_gemm<T, true, DMAX>(s, Qw, LD, Ks, LD, lane);
    flash::warp_gemm<T, true, DMAX>(dp, Ow, LD, Vs, LD, lane);
#pragma unroll
    for (int n = 0; n < KT / 8; ++n) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float p = expf(s[n][e] * a.scale - lse[i]);
        ds[e] = p * (dp[n][e] - dl[i]) * a.scale;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
        flash::store2(Pw + ((lane >> 2) + 8 * i) * LP + n * 8 + (lane & 3) * 2, ds[2 * i],
                      ds[2 * i + 1]);
    }
    __syncwarp();
    flash::warp_gemm<T, false, KT>(dq, Pw, LP, Ks, LD, lane);
    __syncthreads();
  }
  if (steps == 0) flash::cp_async_wait<0>();
  const float one[2] = {1.f, 1.f};
  flash::store_rows<T>(reinterpret_cast<T*>(a.out), dq, qr, one, D, lane);
}

template <typename T, int BLK, int DMAX>
__global__ void __launch_bounds__(Tile<BLK>::NT) dkdv_kernel(Args a) {
  using G = Tile<BLK>;
  constexpr int R = G::R, QT = G::QT, NT = G::NT, NSUB = BLK / QT;
  constexpr int LD = DMAX + kPad, LP = QT + kPad, N8 = DMAX / 8, C8 = QT / 8;
  static_assert(NT >= QT, "one thread stages each row's lse and delta");
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + R * LD;
  T* QOs = Vs + R * LD;         // two buffers of [Q tile, dO tile]
  T* Ps = QOs + 4 * QT * LD;    // P^T, then dS^T: [R][LP], 16 key rows per warp
  // two buffers of [lse, delta] of the row tile
  float* LDs = reinterpret_cast<float*>(Ps + R * LP);

  const int bh = blockIdx.y, k0 = blockIdx.x * R, kb = k0 / BLK, h = bh % a.Lh;
  const int D = a.D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long base = (long long)bh * a.S;
  const int* row = a.table + ((long long)h * a.nb + kb) * a.A;  // the transposed table
  const int steps = a.counts[h * a.nb + kb] * NSUB;
  const T* q = reinterpret_cast<const T*>(a.q);
  const T* dout = reinterpret_cast<const T*>(a.dout);

  // step t's row tile into buffer `buf`: Q, dO, lse and delta
  auto load_rows = [&](int t, int buf) {
    const long long f0 = base + (long long)row[t / NSUB] * BLK + (t % NSUB) * QT;
    auto q_row = [&](int r) { return f0 + r; };
    T* Qb = QOs + buf * 2 * QT * LD;
    load_tile<T, DMAX, NT>(Qb, QT, q, D, q_row);
    load_tile<T, DMAX, NT>(Qb + QT * LD, QT, dout, D, q_row);
    if (threadIdx.x < QT) {
      float* Lb = LDs + buf * 2 * QT;
      flash::cp_async<4>(Lb + threadIdx.x, a.lse + f0 + threadIdx.x, true);
      flash::cp_async<4>(Lb + QT + threadIdx.x, a.delta + f0 + threadIdx.x, true);
    }
  };

  auto key_row = [&](int r) { return base + k0 + r; };
  load_tile<T, DMAX, NT>(Ks, R, reinterpret_cast<const T*>(a.k), D, key_row);
  load_tile<T, DMAX, NT>(Vs, R, reinterpret_cast<const T*>(a.v), D, key_row);
  if (steps > 0) load_rows(0, 0);
  flash::cp_async_commit();

  float dk[N8][4], dv[N8][4];
  flash::zero(dk);
  flash::zero(dv);
  const T* Kw = Ks + warp * 16 * LD;
  const T* Vw = Vs + warp * 16 * LD;
  T* Pw = Ps + warp * 16 * LP;

  for (int t = 0; t < steps; ++t) {
    const int buf = t & 1;
    if (t + 1 < steps) {  // the next row tile's copy runs meanwhile
      load_rows(t + 1, buf ^ 1);
      flash::cp_async_commit();
      flash::cp_async_wait<1>();
    } else {
      flash::cp_async_wait<0>();
    }
    __syncthreads();  // this row tile (and K, V) visible to every warp
    const T* Qs = QOs + buf * 2 * QT * LD;
    const T* Os = Qs + QT * LD;  // dO
    const float* Ls = LDs + buf * 2 * QT;
    const float* Dl = Ls + QT;

    // S^T = K Q^T: rows are this warp's 16 keys, columns the tile's rows
    float s[C8][4], dp[C8][4];
    flash::zero(s);
    flash::zero(dp);
    flash::warp_gemm<T, true, DMAX>(s, Kw, LD, Qs, LD, lane);
#pragma unroll
    for (int n = 0; n < C8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + (lane & 3) * 2 + (e & 1);
        s[n][e] = expf(s[n][e] * a.scale - Ls[col]);
      }
#pragma unroll
    for (int n = 0; n < C8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        flash::store2(Pw + ((lane >> 2) + 8 * i) * LP + n * 8 + (lane & 3) * 2, s[n][2 * i],
                      s[n][2 * i + 1]);
    __syncwarp();
    flash::warp_gemm<T, false, QT>(dv, Pw, LP, Os, LD, lane);  // dv += P^T dO
    flash::warp_gemm<T, true, DMAX>(dp, Vw, LD, Os, LD, lane); // dP^T = V dO^T
    __syncwarp();  // every lane has read P^T before dS^T overwrites it
#pragma unroll
    for (int n = 0; n < C8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = n * 8 + (lane & 3) * 2;
        flash::store2(Pw + ((lane >> 2) + 8 * i) * LP + col,
                      s[n][2 * i] * (dp[n][2 * i] - Dl[col]) * a.scale,
                      s[n][2 * i + 1] * (dp[n][2 * i + 1] - Dl[col + 1]) * a.scale);
      }
    __syncwarp();
    flash::warp_gemm<T, false, QT>(dk, Pw, LP, Qs, LD, lane);  // dk += dS^T Q
    __syncthreads();  // every warp is done with this row-tile buffer
  }
  if (steps == 0) flash::cp_async_wait<0>();

  long long kr[2];
  warp_rows(kr, base + k0, warp, lane);
  const float one[2] = {1.f, 1.f};
  flash::store_rows<T>(reinterpret_cast<T*>(a.out), dk, kr, one, D, lane);
  flash::store_rows<T>(reinterpret_cast<T*>(a.out2), dv, kr, one, D, lane);
}

enum Pass { kFwd, kDq, kDkdv };

template <Pass P, typename T, int BLK, int DMAX>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using G = Tile<BLK>;
  constexpr size_t LD = DMAX + kPad;
  void (*kern)(Args);
  size_t smem;
  if constexpr (P == kFwd) {  // Q, two K/V buffers, P
    kern = &fwd_kernel<T, BLK, DMAX>;
    smem = ((G::R + 4 * G::KT) * LD + G::R * (G::KT + kPad)) * sizeof(T);
  } else if constexpr (P == kDq) {  // Q, dO, two K/V buffers, dS
    kern = &dq_kernel<T, BLK, DMAX>;
    smem = ((2 * G::R + 4 * G::KT) * LD + G::R * (G::KT + kPad)) * sizeof(T);
  } else {  // K, V, two Q/dO buffers, P^T/dS^T, two lse/delta buffers
    kern = &dkdv_kernel<T, BLK, DMAX>;
    smem = ((2 * G::R + 4 * G::QT) * LD + G::R * (G::QT + kPad)) * sizeof(T) +
           4 * G::QT * sizeof(float);
  }
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(a.S / G::R, a.BH), G::NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <Pass P, typename T, int DMAX>
cudaError_t launch_block(const Args& a, int block, cudaStream_t s) {
  switch (block) {
    case 16: return launch<P, T, 16, DMAX>(a, s);
    case 32: return launch<P, T, 32, DMAX>(a, s);
    case 64: return launch<P, T, 64, DMAX>(a, s);
    case 128: return launch<P, T, 128, DMAX>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <Pass P, typename T>
cudaError_t launch_dtype(const Args& a, int block, cudaStream_t s) {
  return a.D <= 64 ? launch_block<P, T, 64>(a, block, s)
                   : launch_block<P, T, 128>(a, block, s);
}

// check the shape, then launch pass P's kernel for the block size and dtype
template <Pass P>
int run(Args a, int block, int dtype, void* stream) {
  const bool ok = a.BH > 0 && a.BH <= 65535 && block > 0 && a.S > 0 && a.S % block == 0 &&
                  a.D > 0 && a.D <= 128 && a.D % 8 == 0 && a.Lh > 0 && a.A > 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  a.nb = a.S / block;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kFloat32: return (int)launch_dtype<P, float>(a, block, s);
    case kBFloat16: return (int)launch_dtype<P, __nv_bfloat16>(a, block, s);
    case kFloat16: return (int)launch_dtype<P, __half>(a, block, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace splash
}  // namespace dstt
