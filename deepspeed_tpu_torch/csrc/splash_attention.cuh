// K8: splash block-sparse attention. This header holds what the three
// passes share and the dq pass's body (built in splash_attention_bwd_dq.cu);
// the forward and the dk/dv pass sweep row groups of a host plan
// (splash_grouped.cuh, built in splash_attention{,_f16,_f32}.cu and
// splash_attention_bwd_dkdv{,_f16,_f32}.cu).
//
// Replaces the TPU kernels deepspeed_tpu/ops/sparse_attention/splash.py:63
// _splash_kernel (driven by _splash_fwd :117, pallas_call :153), :165
// _splash_dq_kernel (pallas_call :266) and :201 _splash_dkv_kernel
// (pallas_call :289). The same function, on another grid:
//   q, k, v [BH, S, D] (the [B, H, S, D] of the caller), a static layout
//   [Lh, nb, nb] with nb = S / block. Row bh reads layout head bh % Lh
//   (jax.lax.rem(bh, nheads_layout), :74).
//   s = (q . k) * scale in fp32 over the active blocks only;
//   forward: o = softmax(s) v in q's dtype and lse [BH, S] fp32; a row
//   with no active block gets o = 0 and lse = +1e30 (-NEG_INF, :104-114), so
//   the backward's exp(s - lse) is exactly 0 there.
//   backward (delta = rowsum(dO * O) [BH, S] fp32 comes from the caller):
//   P = exp(s - lse), dS = P * (dP - delta) * scale with dP = dO v^T;
//   dq = dS k over the layout's table (each row's active k-blocks and their
//   count; padding entries are never read); dk = dS^T q and dv = P^T dO over
//   the transposed layout (for each k-block, the q-blocks that see it). No
//   float atomics anywhere: every output is deterministic.
//
// Numerics: as K1/K2 (flash_attention.cuh, whose tile products these
// kernels reuse): bf16 or fp16 operands on mma.sync m16n8k16 with fp32
// accumulation, the softmax and its statistics in fp32; P (forward and
// dk/dv) and dS (dq and dk/dv) rounded to the input dtype before their
// products, as the Pallas kernels do. fp32 runs the same fragments on the
// CUDA cores (the parity runs).
//
// Bound on the H100: at head_dim 64 each input read once (q, k, v, o: 33.5
// MB each at B 4, H 16, S 4096, D 64 in bf16) is the least time; the
// products of a 16-key block reused by 16 queries are far below the 295
// flops per byte where the tensor cores would bind. What held the first
// kernels (one thread block per q-block or k-block) back, and what the
// grouped forward and dk/dv do about it (splash_grouped.cuh):
// - one warp per 16 rows at block 16, each step a 2 KB tile, a 16 x 16 x 64
//   and a 16 x 64 x 16 product behind a cp.async wait and a barrier in a
//   two-deep ring: nearly a memory round trip a step. Now 4 warps share
//   each stage of 64 keys (or query rows) in a 3-deep ring.
// - blocks that several rows share staged once per row (fixed's four rows
//   of a local window are identical). Now a group of 64 rows stages the
//   union of its members' blocks once: rows grouped in order or widest
//   first, whichever sweeps fewer stages (the nested transposed global
//   columns of fixed), so fixed's forward stages a quarter of the blocks.
// - the global rows (BigBird's and Longformer's row 0 and column 0 see all
//   256 blocks) ran 256 steps in one warp while the rest of the grid had
//   ~5. Now a union past the plan's limit is cut into segments, each its own
//   thread block, merged or summed in order by a second pass, and the
//   longest items launch first.
// - the dq pass keeps the first design: one block per (up to) 64 rows of a
//   q-block, looping over the row's active k-blocks, double-buffered.
#pragma once

#include "flash_attention.cuh"

namespace dstt {
namespace splash {

using flash::kPad;
using flash::load_tile;  // with the block's thread count NT

constexpr float kLseEmpty = 1e30f;  // splash.py -NEG_INF

// the dq pass's arguments
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;    // dO
  const float* lse;    // [BH, S]
  const float* delta;  // [BH, S]
  void* out;           // dq
  const int* table;    // [Lh, nb, A]: the layout's active k-blocks of each row
  const int* counts;   // [Lh, nb]
  int BH, S, D, Lh, A, nb;
  float scale;
};

// The dq pass's tile of a block size: R rows per thread block (one warp per
// 16), KT keys per staged K/V tile
template <int BLK>
struct Tile {
  static constexpr int R = BLK < 64 ? BLK : 64;
  static constexpr int NT = R / 16 * 32;
  static constexpr int KT = BLK < 64 ? BLK : 64;
};

// the accumulator rows lane/4 and lane/4 + 8 of a warp, as element rows
__device__ __forceinline__ void warp_rows(long long (&rows)[2], long long first, int warp,
                                          int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) rows[i] = first + warp * 16 + (lane >> 2) + 8 * i;
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
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  using G = Tile<BLK>;
  constexpr size_t LD = DMAX + kPad;
  void (*kern)(Args) = &dq_kernel<T, BLK, DMAX>;
  // Q, dO, two K/V buffers, dS
  constexpr size_t smem = ((2 * G::R + 4 * G::KT) * LD + G::R * (G::KT + kPad)) * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(a.S / G::R, a.BH), G::NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int DMAX>
cudaError_t launch_dq_block(const Args& a, int block, cudaStream_t s) {
  switch (block) {
    case 16: return launch_dq<T, 16, DMAX>(a, s);
    case 32: return launch_dq<T, 32, DMAX>(a, s);
    case 64: return launch_dq<T, 64, DMAX>(a, s);
    case 128: return launch_dq<T, 128, DMAX>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_dq_dtype(const Args& a, int block, cudaStream_t s) {
  return a.D <= 64 ? launch_dq_block<T, 64>(a, block, s)
                   : launch_dq_block<T, 128>(a, block, s);
}

// check the shape, then launch the dq kernel for the block size and dtype
inline int run_dq(Args a, int block, int dtype, void* stream) {
  const bool ok = a.BH > 0 && a.BH <= 65535 && block > 0 && a.S > 0 && a.S % block == 0 &&
                  a.D > 0 && a.D <= 128 && a.D % 8 == 0 && a.Lh > 0 && a.A > 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  a.nb = a.S / block;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kFloat32: return (int)launch_dq_dtype<float>(a, block, s);
    case kBFloat16: return (int)launch_dq_dtype<__nv_bfloat16>(a, block, s);
    case kFloat16: return (int)launch_dq_dtype<__half>(a, block, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace splash
}  // namespace dstt
