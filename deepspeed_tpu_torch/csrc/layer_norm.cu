// LayerNorm over the last dim: y = (x - mean) * rsqrt(var + eps) * w + b,
// with var the mean of the centred squares (x - mean)^2 (K5b).
//
// Replaces the TPU kernel deepspeed_tpu/ops/normalization.py:32 _ln_kernel
// (driven by _row_call :41 via layer_norm :76). Same contract: statistics in
// fp32 (two passes over the same values: the mean, then the centred
// variance, never E[x^2] - E[x]^2, which cancels for rows with a large
// mean), the weight and bias cast to fp32, output in x's dtype, any row
// width d. x, w and b share one dtype, bf16 (the serving path) or fp32.
//
// The kernels are row_norm.cuh's (the bound and the design are noted
// there), shared with RMSNorm (rms_norm.cu); this file builds the
// LayerNorm instances and holds the entry point.
#include "row_norm.cuh"

// late: -1 the plan's weight loads, 0 early, 1 late (row_norm.cuh
// launch_row_norm)
extern "C" int dstt_layer_norm(const void* x, const void* w, const void* b, void* out,
                               long long rows, int d, float eps, int dtype, int late,
                               void* stream) {
  using namespace dstt;
  if (rows <= 0 || rows > 0x7fffffffLL || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kFloat32:
      return launch_row_norm<true, float, float>(x, w, b, out, rows, d, eps, late, s);
    case kBFloat16:
      return launch_row_norm<true, __nv_bfloat16, __nv_bfloat16>(x, w, b, out, rows, d, eps,
                                                                 late, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
