// Row norms over the last dim, one design for K5 and K5b:
//   RMSNorm    y = x * rsqrt(mean(x^2) + eps) * w
//   LayerNorm  y = (x - mean) * rsqrt(mean((x - mean)^2) + eps) * w + b
// Statistics in fp32, w and b cast to fp32, the output in x's dtype. x is
// bf16 or fp32; w (and b) share x's dtype, or w is fp32 beside a bf16 x
// (Gemma's 1 + w, whose ~1e-3 deltas round away in bf16 against 1.0).
// LayerNorm takes the mean first, then the mean of the centred squares,
// both from the same values: never E[x^2] - E[x]^2, which cancels for
// rows with a large mean. rms_norm.cu and layer_norm.cu build the
// instances and hold the C entry points.
//
// Bound on the H100: bytes. Each element is read once and written once
// with a few flops between, two orders of magnitude under the card's ridge
// point. At a decode step's 8 rows the bytes take ~0.04 us and the
// kernel's time is latency: the launch (an empty kernel takes ~1.1 us
// under a CUDA graph), one trip to memory for the row, the reductions, the
// scaled write. The design:
// - one read of the row: a lane keeps kNV 16-byte vectors of it in
//   registers from the statistic to the scaled write (the row's vectors
//   dealt round-robin to the lanes of its warps, neighbouring lanes on
//   neighbouring addresses);
// - w (and b) as 16-byte vectors (an fp32 w two float4 per bf16 vector of
//   x), loaded before the statistic (kEarly: their latency under the
//   row's) or after it (fewer registers a lane, so more blocks an SM);
// - bf16 converted where used (element()): the row stays packed in
//   registers across the reductions;
// - a row on one block, as many warps (up to 8) as its fewest vectors a
//   lane fill (4096 bf16: 8 warps of 2 vectors; 3584: 7 of 2; 4608: 6 of
//   3), each warp's sum through shared memory once a statistic. A row on
//   one warp needs shuffles alone, but a lane then converts, sums and
//   scales several times the elements in one dependent chain: measured
//   against a block's warps (and several rows a block) at 1-768 rows of
//   each serving width, it never won by more than a few per cent and lost
//   by up to 1.8x, so only the block's mapping is built;
// - launch_row_norm plans each launch from rows, d, the dtypes and the
//   pointers: kNV, the warps, and the weights early or late (late for bf16
//   rows from kLateWeightsMinRows rows on, where the late loads' fewer
//   registers a lane fit more blocks an SM once the rows fill the card).
// Rows whose width is not a whole number of vectors, unaligned pointers
// and rows wider than kRowNormMaxNV vectors a lane take
// row_norm_scalar_kernel: a block a row, each pass reading memory, scalar
// loads.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace dstt {

constexpr int kRowNormThreads = 256;  // a block's most threads: 8 warps
constexpr int kRowNormMaxNV = 4;       // the most 16-byte vectors of x a lane keeps
constexpr long long kLateWeightsMinRows = 256;

// Element j of a 16-byte vector of x in fp32, converted where it is used.
// A bf16 element is an opaque shift or mask (volatile asm), which the
// compiler neither hoists nor reuses: it keeps the row packed in registers
// across the reductions instead of every converted value (77 registers a
// lane for LayerNorm's 3 bf16 vectors otherwise), so more blocks fit an SM.
template <typename T>
__device__ __forceinline__ float element(const uint4& v, int j);
template <>
__device__ __forceinline__ float element<float>(const uint4& v, int j) {
  return __uint_as_float((&v.x)[j]);
}
template <>
__device__ __forceinline__ float element<__nv_bfloat16>(const uint4& v, int j) {
  const uint32_t word = (&v.x)[j >> 1];
  uint32_t bits;
  if (j & 1)
    asm volatile("and.b32 %0, %1, 0xffff0000;" : "=r"(bits) : "r"(word));
  else
    asm volatile("shl.b32 %0, %1, 16;" : "=r"(bits) : "r"(word));
  return __uint_as_float(bits);
}

// Sum of v over the block's row: shuffles, then (warps > 1) the warps'
// sums through `partial` in one fixed order, so every lane holds the same
// value. Every thread of the block must call it.
__device__ __forceinline__ float row_sum(float v, float* partial, int warps) {
  v = warp_sum(v);
  if (warps == 1) return v;
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  for (int k = 0; k < warps; ++k) t += partial[k];
  return t;
}

// A block a row, blockDim.x / 32 warps; kNV: the vectors of x each lane
// keeps.
// kEarly: w (and b) loaded before the statistic, held in registers across
// it (their latency hidden under the row's); else after it, which leaves
// fewer registers a lane, so more blocks an SM at prefill row counts.
// ptxas fits the late LayerNorm instances of 3 and 4 bf16 vectors to 48
// and 64 registers with 12-28 B of spill; __launch_bounds__(256, 1)
// removes the spill at 60 registers, but 768 rows of 4608 then take two
// waves (5 blocks of 6 warps an SM, not 7) and ran 3.8% slower.
template <bool kLN, typename T, typename W, int kNV, bool kEarly>
__global__ void __launch_bounds__(kRowNormThreads)
row_norm_kernel(const T* __restrict__ x, const W* __restrict__ w, const W* __restrict__ b,
                T* __restrict__ out, int d, float eps) {
  constexpr int V = 16 / sizeof(T);           // x elements per vector
  constexpr int WV = sizeof(W) / sizeof(T);   // w (b) vectors per x vector
  constexpr int NB = kLN ? kNV : 1;
  __shared__ float partial[2][kRowNormThreads / 32];
  const int warps = blockDim.x >> 5, first = threadIdx.x, stride = blockDim.x;
  const int nvec = d / V;
  const uint4* xv = reinterpret_cast<const uint4*>(x + (long long)blockIdx.x * d);
  const uint4* wv = reinterpret_cast<const uint4*>(w);
  const uint4* bv = reinterpret_cast<const uint4*>(b);

  uint4 xr[kNV], wr[kNV][WV], br[NB][WV];
#pragma unroll
  for (int k = 0; k < kNV; ++k) {
    const int i = first + k * stride;
    if (i < nvec) xr[k] = __ldg(xv + i);
  }
  // w (and b) as 16-byte vectors, an fp32 w two per bf16 vector of x
  auto load_weights = [&]() {
#pragma unroll
    for (int k = 0; k < kNV; ++k) {
      const int i = first + k * stride;
      if (i < nvec) {
#pragma unroll
        for (int j = 0; j < WV; ++j) {
          wr[k][j] = __ldg(wv + i * WV + j);
          if (kLN) br[kLN ? k : 0][j] = __ldg(bv + i * WV + j);
        }
      }
    }
  };
  if (kEarly) load_weights();

  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kNV; ++k) {
    const int i = first + k * stride;
    if (i < nvec) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = element<T>(xr[k], j);
        s += kLN ? f : f * f;
      }
    }
  }
  s = row_sum(s, partial[0], warps);
  float mean = 0.f, r;
  if (kLN) {
    mean = s / (float)d;
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < kNV; ++k) {
      const int i = first + k * stride;
      if (i < nvec) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float c = element<T>(xr[k], j) - mean;
          ss += c * c;
        }
      }
    }
    r = rsqrtf(row_sum(ss, partial[1], warps) / (float)d + eps);
  } else {
    r = rsqrtf(s / (float)d + eps);
  }
  if (!kEarly) load_weights();

  uint4* ov = reinterpret_cast<uint4*>(out + (long long)blockIdx.x * d);
#pragma unroll
  for (int k = 0; k < kNV; ++k) {
    const int i = first + k * stride;
    if (i < nvec) {
      const T* e = reinterpret_cast<const T*>(&xr[k]);
      const W* we = reinterpret_cast<const W*>(&wr[k][0]);
      const W* be = reinterpret_cast<const W*>(&br[kLN ? k : 0][0]);
      uint4 res;
      T* o = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (kLN)
          o[j] = from_float<T>((to_float(e[j]) - mean) * r * to_float(we[j]) + to_float(be[j]));
        else
          o[j] = from_float<T>(to_float(e[j]) * r * to_float(we[j]));
      }
      ov[i] = res;
    }
  }
}

// Sum of v over the block, returned to every thread. The leading barrier
// lets a second call reuse `partial`.
__device__ __forceinline__ float block_sum(float v, float* partial) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  return warp_sum(lane < (int)(blockDim.x >> 5) ? partial[lane] : 0.f);
}

// Any width and alignment: a block of kRowNormThreads a row, scalar
// loads, each pass reading the row from memory (the later reads from
// L1/L2)
template <bool kLN, typename T, typename W>
__global__ void __launch_bounds__(kRowNormThreads)
row_norm_scalar_kernel(const T* __restrict__ x, const W* __restrict__ w,
                       const W* __restrict__ b, T* __restrict__ out, int d, float eps) {
  __shared__ float partial[32];
  const T* xr = x + (long long)blockIdx.x * d;
  T* outr = out + (long long)blockIdx.x * d;
  float s = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float f = to_float(xr[i]);
    s += kLN ? f : f * f;
  }
  s = block_sum(s, partial);
  float mean = 0.f, r;
  if (kLN) {
    mean = s / (float)d;
    float ss = 0.f;
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float c = to_float(xr[i]) - mean;
      ss += c * c;
    }
    r = rsqrtf(block_sum(ss, partial) / (float)d + eps);
  } else {
    r = rsqrtf(s / (float)d + eps);
  }
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    if (kLN)
      outr[i] = from_float<T>((to_float(xr[i]) - mean) * r * to_float(w[i]) + to_float(b[i]));
    else
      outr[i] = from_float<T>(to_float(xr[i]) * r * to_float(w[i]));
  }
}

// Plans and launches one row norm: the register kernel where the width is
// a whole number of 16-byte vectors, every pointer 16-byte aligned and the
// row at most kRowNormMaxNV vectors a lane, else the scalar kernel. `late`:
// -1 the plan's weight loads (late for bf16 rows from kLateWeightsMinRows
// rows on), 0 early, 1 late (the register kernel only; the crossover's
// measurement forces it).
template <bool kLN, typename T, typename W>
int launch_row_norm(const void* x, const void* w, const void* b, void* out, long long rows,
                    int d, float eps, int late, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (late < -1 || late > 1) return (int)cudaErrorInvalidValue;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(out) |
                         (kLN ? reinterpret_cast<uintptr_t>(b) : 0);
  const int nvec = d / V;
  const int nv = (nvec + kRowNormThreads - 1) / kRowNormThreads;
  if (d % V != 0 || addr % 16 != 0 || nv > kRowNormMaxNV) {
    row_norm_scalar_kernel<kLN, T, W><<<(unsigned)rows, kRowNormThreads, 0, stream>>>(
        (const T*)x, (const W*)w, (const W*)b, (T*)out, d, eps);
    return (int)cudaGetLastError();
  }
  const int threads = 32 * ((nvec + 32 * nv - 1) / (32 * nv));
  if (late < 0) late = std::is_same<T, __nv_bfloat16>::value && rows >= kLateWeightsMinRows;
  switch (nv * 2 + late) {
#define DSTT_ROW_NORM_CASE(N, L)                                                            \
    case N * 2 + L:                                                                         \
      row_norm_kernel<kLN, T, W, N, !L><<<(unsigned)rows, threads, 0, stream>>>(            \
          (const T*)x, (const W*)w, (const W*)b, (T*)out, d, eps);                          \
      break;
    DSTT_ROW_NORM_CASE(1, 0) DSTT_ROW_NORM_CASE(1, 1) DSTT_ROW_NORM_CASE(2, 0)
    DSTT_ROW_NORM_CASE(2, 1) DSTT_ROW_NORM_CASE(3, 0) DSTT_ROW_NORM_CASE(3, 1)
    DSTT_ROW_NORM_CASE(4, 0) DSTT_ROW_NORM_CASE(4, 1)
#undef DSTT_ROW_NORM_CASE
  }
  return (int)cudaGetLastError();
}

}  // namespace dstt
