// LayerNorm over the last dim: y = (x - mean) * rsqrt(var + eps) * w + b,
// with var the mean of the centred squares (x - mean)^2.
//
// Replaces the TPU kernel deepspeed_tpu/ops/normalization.py:32 _ln_kernel
// (driven by _row_call :41 via layer_norm :76). Same contract: statistics in
// fp32 (two passes: the mean, then the centred variance, never
// E[x^2] - E[x]^2, which cancels for rows with a large mean), the weight and
// bias cast to fp32, output in x's dtype, any row width d. x, w and b share
// one dtype, bf16 (the serving path) or fp32.
//
// Bound on the H100: bytes. Each element is read once and written once with
// about 8 flops between, far under the card's ridge point. So the design is
// about the memory stream:
// - one thread block per row, so both statistics are block reductions
//   (warp shuffles, then one value per warp through shared memory);
// - the row is read from device memory once, in 16-byte vectors (8 bf16 or
//   4 fp32 per access, neighbouring threads on neighbouring addresses), and
//   kept in registers: up to kLnMaxVec vectors per thread, so rows of up to
//   8192 bf16 (4096 fp32) values; StarCoder2-7B's 4608 take three vectors
//   per thread on a 256-thread block. The centred pass and the scaled write
//   read the registers, not memory;
// - the same kernel takes any other row (a width that is not a multiple of
//   the vector, an unaligned pointer, a wider row) through a scalar tail
//   that each of the three passes reads from memory, the second and third
//   reads hitting L1/L2.
#include <algorithm>

#include "common.cuh"

namespace dstt {

constexpr int kLnThreads = 256;
constexpr int kLnMaxVec = 4;  // 16-byte vectors a thread keeps in registers

// Sum of v over the block, returned to every thread. `partial` holds one
// value per warp; the leading barrier lets a second call reuse it.
__device__ __forceinline__ float block_sum(float v, float* partial) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  return warp_sum(lane < (int)(blockDim.x >> 5) ? partial[lane] : 0.f);
}

// nv: the leading 16-byte vectors of the row that stay in registers (0
// when a pointer is not 16-byte aligned); the elements from nv*V on are the
// scalar tail, read from memory in each pass
template <typename T>
__global__ void __launch_bounds__(kLnThreads)
layer_norm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const T* __restrict__ b, T* __restrict__ out, int d, int nv,
                  float eps) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float partial[32];
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  T* outr = out + row * d;
  const uint4* xv = reinterpret_cast<const uint4*>(xr);
  uint4* ov = reinterpret_cast<uint4*>(outr);
  const uint4* wv = reinterpret_cast<const uint4*>(w);
  const uint4* bv = reinterpret_cast<const uint4*>(b);
  const int tail = nv * V;

  uint4 reg[kLnMaxVec];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kLnMaxVec; ++k) {
    const int i = threadIdx.x + k * kLnThreads;
    if (i < nv) {
      reg[k] = xv[i];
      const T* e = reinterpret_cast<const T*>(&reg[k]);
#pragma unroll
      for (int j = 0; j < V; ++j) s += to_float(e[j]);
    }
  }
  for (int i = tail + threadIdx.x; i < d; i += kLnThreads) s += to_float(xr[i]);
  const float mean = block_sum(s, partial) / (float)d;

  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < kLnMaxVec; ++k) {
    const int i = threadIdx.x + k * kLnThreads;
    if (i < nv) {
      const T* e = reinterpret_cast<const T*>(&reg[k]);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float c = to_float(e[j]) - mean;
        ss += c * c;
      }
    }
  }
  for (int i = tail + threadIdx.x; i < d; i += kLnThreads) {
    const float c = to_float(xr[i]) - mean;
    ss += c * c;
  }
  const float rstd = rsqrtf(block_sum(ss, partial) / (float)d + eps);

#pragma unroll
  for (int k = 0; k < kLnMaxVec; ++k) {
    const int i = threadIdx.x + k * kLnThreads;
    if (i < nv) {
      const uint4 wr = wv[i], br = bv[i];
      const T* e = reinterpret_cast<const T*>(&reg[k]);
      const T* we = reinterpret_cast<const T*>(&wr);
      const T* be = reinterpret_cast<const T*>(&br);
      uint4 res;
      T* o = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int j = 0; j < V; ++j)
        o[j] = from_float<T>((to_float(e[j]) - mean) * rstd * to_float(we[j]) +
                             to_float(be[j]));
      ov[i] = res;
    }
  }
  for (int i = tail + threadIdx.x; i < d; i += kLnThreads)
    outr[i] = from_float<T>((to_float(xr[i]) - mean) * rstd * to_float(w[i]) +
                            to_float(b[i]));
}

template <typename T>
void launch_layer_norm(const void* x, const void* w, const void* b, void* out,
                       long long rows, int d, float eps, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(b) | reinterpret_cast<uintptr_t>(out);
  // every row starts 16-byte aligned only if d is a whole number of vectors
  const int nv = (d % V == 0 && addr % 16 == 0) ? std::min(d / V, kLnMaxVec * kLnThreads) : 0;
  layer_norm_kernel<T><<<dim3((unsigned)rows), kLnThreads, 0, stream>>>(
      (const T*)x, (const T*)w, (const T*)b, (T*)out, d, nv, eps);
}

}  // namespace dstt

extern "C" int dstt_layer_norm(const void* x, const void* w, const void* b,
                               void* out, long long rows, int d, float eps,
                               int dtype, void* stream) {
  using namespace dstt;
  if (rows <= 0 || rows > 0x7fffffffLL || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kFloat32: launch_layer_norm<float>(x, w, b, out, rows, d, eps, s); break;
    case kBFloat16: launch_layer_norm<__nv_bfloat16>(x, w, b, out, rows, d, eps, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
