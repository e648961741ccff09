// RMSNorm over the last dim: y = x * rsqrt(mean(x^2) + eps) * w (K5).
//
// Replaces the TPU kernel deepspeed_tpu/ops/normalization.py:26 _rms_kernel
// (driven by _row_call :41 via rms_norm :65). Same contract: statistics in
// fp32, the weight cast to fp32, output in x's dtype, any row width d. x and
// the weight share one dtype, bf16 (the serving path) or fp32; or x is bf16
// and the weight fp32 (Gemma's 1 + w, which must stay fp32: in bf16 its
// ~1e-3 deltas round away against 1.0).
//
// The kernels are row_norm.cuh's (the bound and the design are noted
// there), shared with LayerNorm (layer_norm.cu); this file builds the
// RMSNorm instances and holds the entry point. dstt_empty_launch launches
// an empty kernel: the card's floor for one launch, timed beside the
// decode-row norms.
#include "row_norm.cuh"

namespace dstt {

__global__ void empty_kernel() {}

}  // namespace dstt

// dtype: x's and the output's; w_dtype: the weight's, dtype or (for a bf16
// x) fp32; late: -1 the plan's weight loads, 0 early, 1 late
// (row_norm.cuh launch_row_norm)
extern "C" int dstt_rms_norm(const void* x, const void* w, void* out, long long rows, int d,
                             float eps, int dtype, int w_dtype, int late, void* stream) {
  using namespace dstt;
  if (rows <= 0 || rows > 0x7fffffffLL || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kFloat32 && w_dtype == kFloat32)
    return launch_row_norm<false, float, float>(x, w, nullptr, out, rows, d, eps, late, s);
  if (dtype == kBFloat16 && w_dtype == kBFloat16)
    return launch_row_norm<false, __nv_bfloat16, __nv_bfloat16>(x, w, nullptr, out, rows, d,
                                                                eps, late, s);
  if (dtype == kBFloat16 && w_dtype == kFloat32)
    return launch_row_norm<false, __nv_bfloat16, float>(x, w, nullptr, out, rows, d, eps,
                                                        late, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int dstt_empty_launch(void* stream) {
  dstt::empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
