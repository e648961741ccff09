// RMSNorm over the last dim: y = x * rsqrt(mean(x^2) + eps) * w.
//
// Replaces the TPU kernel deepspeed_tpu/ops/normalization.py:26 _rms_kernel
// (driven by _row_call :41 via rms_norm :65). Same contract: statistics in
// fp32, the weight cast to fp32, output in x's dtype, any row width d. x and
// the weight share one dtype, bf16 (the serving path) or fp32; or x is bf16
// and the weight fp32 (Gemma's 1 + w, which must stay fp32: in bf16 its
// ~1e-3 deltas round away against 1.0).
//
// Bound on the H100: bytes. Each element is read, squared and added once,
// then scaled and written once: about 3 flops per 4 bytes moved in bf16,
// two orders of magnitude under the card's ridge point. So the design is
// about the memory stream alone:
// - one thread block per row, so a row's sum of squares is one block
//   reduction (warp shuffles, then one value per warp through shared
//   memory) with no second pass over device memory between blocks;
// - 16-byte vector loads and stores (8 bf16 or 4 fp32 per access,
//   neighbouring threads on neighbouring addresses) whenever the row width
//   and the pointers allow, else a scalar loop for any d;
// - the second read of the row for the scaled write hits L1/L2 (a row of
//   the main path is 8 KiB), so device memory sees x once.
#include "common.cuh"

namespace dstt {

constexpr int kNormThreads = 256;

// T: x's and the output's type; W: the weight's (T, or fp32)
template <typename T, typename W, bool kVec>
__global__ void __launch_bounds__(kNormThreads)
rms_norm_kernel(const T* __restrict__ x, const W* __restrict__ w,
                T* __restrict__ out, int d, float eps) {
  constexpr int V = 16 / sizeof(T);
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  T* outr = out + row * d;

  float ss = 0.f;
  if (kVec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = threadIdx.x; i < d / V; i += blockDim.x) {
      uint4 raw = xv[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        float f = to_float(e[k]);
        ss += f * f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      float f = to_float(xr[i]);
      ss += f * f;
    }
  }

  __shared__ float partial[32];
  __shared__ float inv_rms;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  ss = warp_sum(ss);
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < (int)(blockDim.x >> 5) ? partial[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) inv_rms = rsqrtf(v / (float)d + eps);
  }
  __syncthreads();
  const float r = inv_rms;

  if (kVec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    uint4* ov = reinterpret_cast<uint4*>(outr);
    for (int i = threadIdx.x; i < d / V; i += blockDim.x) {
      uint4 raw = xv[i];
      const T* e = reinterpret_cast<const T*>(&raw);
      uint4 res;
      T* o = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int k = 0; k < V; ++k)
        o[k] = from_float<T>(to_float(e[k]) * r * to_float(w[i * V + k]));
      ov[i] = res;
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x)
      outr[i] = from_float<T>(to_float(xr[i]) * r * to_float(w[i]));
  }
}

template <typename T, typename W>
void launch_rms_norm(const void* x, const void* w, void* out, long long rows,
                     int d, float eps, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = d % V == 0 &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  const dim3 grid((unsigned)rows);
  if (vec)
    rms_norm_kernel<T, W, true><<<grid, kNormThreads, 0, stream>>>(
        (const T*)x, (const W*)w, (T*)out, d, eps);
  else
    rms_norm_kernel<T, W, false><<<grid, kNormThreads, 0, stream>>>(
        (const T*)x, (const W*)w, (T*)out, d, eps);
}

}  // namespace dstt

// dtype: x's and the output's; w_dtype: the weight's, dtype or (for a bf16
// x) fp32
extern "C" int dstt_rms_norm(const void* x, const void* w, void* out,
                             long long rows, int d, float eps, int dtype,
                             int w_dtype, void* stream) {
  using namespace dstt;
  if (rows <= 0 || rows > 0x7fffffffLL || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kFloat32 && w_dtype == kFloat32)
    launch_rms_norm<float, float>(x, w, out, rows, d, eps, s);
  else if (dtype == kBFloat16 && w_dtype == kBFloat16)
    launch_rms_norm<__nv_bfloat16, __nv_bfloat16>(x, w, out, rows, d, eps, s);
  else if (dtype == kBFloat16 && w_dtype == kFloat32)
    launch_rms_norm<__nv_bfloat16, float>(x, w, out, rows, d, eps, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
