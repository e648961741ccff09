// Fused optimizer steps over flat buffers (K7): Adam/AdamW, Lion and LAMB's
// first pass, each one pass over memory.
//
// Replaces the TPU kernels deepspeed_tpu/ops/fused_optimizer.py:67
// _adam_kernel (fused_adam_step :86), :115 _lion_kernel (fused_lion_step
// :126) and :152 _lamb_update_kernel (fused_lamb_step :165), all launched
// by _launch_flat :32. Per element, with m and v fp32, p and g any float
// type widened to fp32:
//   adam:  [L2 mode: g += wd*p]  m = b1*m + (1-b1)*g,  v = b2*v + (1-b2)*g*g,
//          u = (m / bc1) / (sqrt(v / bc2) + eps)  [decoupled: u += wd*p],
//          p = p - lr*u,  bc = 1 - exp(step * log b)  (the Pallas body's form)
//   lion:  u = sign(b1*m + (1-b1)*g) [+ wd*p],  p = p - lr*u,
//          m = b2*m + (1-b2)*g
//   lamb:  m, v as adam; u = (m / bc1) / (sqrt(v / bc2) + eps) written out
//          (the per-tensor trust ratio and the write of p are outside, in
//          ops/fused_optimizer.py, as :199-219 keeps them outside Pallas).
// The L2 mode is the engine's `adam` with weight decay (optax's
// add_decayed_weights before scale_by_adam): one pass in place of two.
//
// Numerics: every product, sum and quotient is rounded on its own (the _rn
// intrinsics keep nvcc from contracting a*b + c into one fma), division and
// sqrt are IEEE (the build adds no fast math), in the order the plain
// version writes them, so the kernel equals its plain version on the card
// up to the last bit of expf. log b and 1 - b come from the host, computed
// in double and rounded to fp32, as the Python constants of the Pallas body.
//
// The per-step scalars live in device memory, as the Pallas body reads
// lr_ref[0] and step_ref[0]: a one-element fp32 learning rate, a
// one-element fp32 update count (1 for the first update) and a one-byte
// skip flag (null: never skip). Each thread loads them once, at its start
// (one broadcast load a warp). A set flag means "this step overflowed":
// every thread returns before it reads or writes a buffer, so p, m, v and
// LAMB's u stay bit for bit as they were (a zero learning rate would not:
// 0 * inf is NaN, and the moments would still move). So K steps can be
// enqueued with no host read between them: the engine computes the flag,
// the learning rate and the count on the device.
// sign(NaN) is 0, as torch.sign (jnp.sign gives NaN; only an overflowed
// step, which the engine skips, carries one).
//
// Bound on the H100: bytes (~1 flop per byte against ~295 at the ridge):
// adam reads p, g, m, v and writes p, m, v (28 B per fp32 element), lion 20
// B, the lamb pass 24 B. The design: one launch over the whole flat buffer
// (the engine keeps masters, gradients and moments each as one buffer), a
// grid-stride loop over 16-byte vectors (four fp32 elements, or four 2-byte
// values in 8 bytes) so neighbouring threads read neighbouring addresses;
// a scalar loop takes the n % 4 tail, and the whole buffer when a pointer
// is not aligned to its vector. In place: p, m and v (and u over g) are read
// and written at one index by one thread, so outputs may alias inputs.
#include <math.h>

#include <algorithm>

#include "common.cuh"

namespace dstt {
namespace optim {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 65535;

enum AdamMode : int { kNoDecay = 0, kDecoupled = 1, kL2 = 2 };

struct Hyper {
  float b1, omb1, log_b1, b2, omb2, log_b2, eps, wd;
  float lr, bc1, bc2;  // filled on the device from the scalars
  int mode;
};

// the scalars one launch reads from device memory
struct Scalars {
  const float* lr;
  const float* step;
  const unsigned char* skip;
};

__device__ __forceinline__ bool skipped(const Scalars& s) {
  return s.skip != nullptr && *s.skip != 0;
}

__device__ __forceinline__ float bias_correction(float step, float log_b) {
  return __fsub_rn(1.f, expf(__fmul_rn(step, log_b)));
}

__device__ __forceinline__ float sign_of(float x) {
  return (float)((0.f < x) - (x < 0.f));
}

// four consecutive elements of T as fp32 (16 bytes of fp32, 8 of a 2-byte type)
template <typename T>
__device__ __forceinline__ void load4(const T* p, long long i4, float (&x)[4]);

template <>
__device__ __forceinline__ void load4<float>(const float* p, long long i4, float (&x)[4]) {
  const float4 f = reinterpret_cast<const float4*>(p)[i4];
  x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
}

template <typename H2, typename T>
__device__ __forceinline__ void load4_half(const T* p, long long i4, float (&x)[4]) {
  const uint2 w = reinterpret_cast<const uint2*>(p)[i4];
  const H2 a = *reinterpret_cast<const H2*>(&w.x), b = *reinterpret_cast<const H2*>(&w.y);
  x[0] = to_float(a.x); x[1] = to_float(a.y); x[2] = to_float(b.x); x[3] = to_float(b.y);
}

template <>
__device__ __forceinline__ void load4<__nv_bfloat16>(const __nv_bfloat16* p, long long i4,
                                                     float (&x)[4]) {
  load4_half<__nv_bfloat162>(p, i4, x);
}

template <>
__device__ __forceinline__ void load4<__half>(const __half* p, long long i4, float (&x)[4]) {
  load4_half<__half2>(p, i4, x);
}

template <typename T>
__device__ __forceinline__ void store4(T* p, long long i4, const float (&x)[4]);

template <>
__device__ __forceinline__ void store4<float>(float* p, long long i4, const float (&x)[4]) {
  reinterpret_cast<float4*>(p)[i4] = make_float4(x[0], x[1], x[2], x[3]);
}

template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p, long long i4,
                                                      const float (&x)[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x[0], x[1]), b = __floats2bfloat162_rn(x[2], x[3]);
  reinterpret_cast<uint2*>(p)[i4] =
      make_uint2(*reinterpret_cast<uint32_t*>(&a), *reinterpret_cast<uint32_t*>(&b));
}

template <>
__device__ __forceinline__ void store4<__half>(__half* p, long long i4, const float (&x)[4]) {
  __half2 a = __floats2half2_rn(x[0], x[1]), b = __floats2half2_rn(x[2], x[3]);
  reinterpret_cast<uint2*>(p)[i4] =
      make_uint2(*reinterpret_cast<uint32_t*>(&a), *reinterpret_cast<uint32_t*>(&b));
}

// ---- the three bodies, one element each ----

// adam: updates p, m, v
__device__ __forceinline__ void adam_elem(const Hyper& h, float& p, float g, float& m,
                                          float& v) {
  if (h.mode == kL2) g = __fadd_rn(g, __fmul_rn(h.wd, p));
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, g), g));
  float u = __fdiv_rn(__fdiv_rn(m, h.bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.bc2)), h.eps));
  if (h.mode == kDecoupled) u = __fadd_rn(u, __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(h.lr, u));
}

// lion: updates p, m
__device__ __forceinline__ void lion_elem(const Hyper& h, float& p, float g, float& m) {
  float u = sign_of(__fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g)));
  if (h.mode == kDecoupled) u = __fadd_rn(u, __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(h.lr, u));
  m = __fadd_rn(__fmul_rn(h.b2, m), __fmul_rn(h.omb2, g));
}

// lamb's first pass: updates m, v; returns u
__device__ __forceinline__ float lamb_elem(const Hyper& h, float g, float& m, float& v) {
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, g), g));
  return __fdiv_rn(__fdiv_rn(m, h.bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.bc2)), h.eps));
}

// ---- the kernels: vectors of four (when `vec`), then the scalar tail ----

template <typename TP, typename TG>
__global__ void __launch_bounds__(kThreads)
adam_kernel(TP* p, const TG* g, float* m, float* v, long long n, Hyper h, Scalars sc,
            bool vec) {
  if (skipped(sc)) return;
  h.lr = *sc.lr;
  const float step = *sc.step;
  h.bc1 = bias_correction(step, h.log_b1);
  h.bc2 = bias_correction(step, h.log_b2);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n4 = vec ? n / 4 : 0;
  for (long long c = t; c < n4; c += stride) {
    float pp[4], gg[4], mm[4], vv[4];
    load4(p, c, pp); load4(g, c, gg); load4(m, c, mm); load4(v, c, vv);
#pragma unroll
    for (int k = 0; k < 4; ++k) adam_elem(h, pp[k], gg[k], mm[k], vv[k]);
    store4(p, c, pp); store4(m, c, mm); store4(v, c, vv);
  }
  for (long long i = n4 * 4 + t; i < n; i += stride) {
    float pp = to_float(p[i]), mm = m[i], vv = v[i];
    adam_elem(h, pp, to_float(g[i]), mm, vv);
    p[i] = from_float<TP>(pp);
    m[i] = mm;
    v[i] = vv;
  }
}

template <typename TP, typename TG>
__global__ void __launch_bounds__(kThreads)
lion_kernel(TP* p, const TG* g, float* m, long long n, Hyper h, Scalars sc, bool vec) {
  if (skipped(sc)) return;
  h.lr = *sc.lr;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n4 = vec ? n / 4 : 0;
  for (long long c = t; c < n4; c += stride) {
    float pp[4], gg[4], mm[4];
    load4(p, c, pp); load4(g, c, gg); load4(m, c, mm);
#pragma unroll
    for (int k = 0; k < 4; ++k) lion_elem(h, pp[k], gg[k], mm[k]);
    store4(p, c, pp); store4(m, c, mm);
  }
  for (long long i = n4 * 4 + t; i < n; i += stride) {
    float pp = to_float(p[i]), mm = m[i];
    lion_elem(h, pp, to_float(g[i]), mm);
    p[i] = from_float<TP>(pp);
    m[i] = mm;
  }
}

// u may be g (in place): each element is read before it is written
template <typename TG>
__global__ void __launch_bounds__(kThreads)
lamb_kernel(const TG* g, float* m, float* v, float* u, long long n, Hyper h, Scalars sc,
            bool vec) {
  if (skipped(sc)) return;
  const float step = *sc.step;
  h.bc1 = bias_correction(step, h.log_b1);
  h.bc2 = bias_correction(step, h.log_b2);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n4 = vec ? n / 4 : 0;
  for (long long c = t; c < n4; c += stride) {
    float gg[4], mm[4], vv[4], uu[4];
    load4(g, c, gg); load4(m, c, mm); load4(v, c, vv);
#pragma unroll
    for (int k = 0; k < 4; ++k) uu[k] = lamb_elem(h, gg[k], mm[k], vv[k]);
    store4(u, c, uu); store4(m, c, mm); store4(v, c, vv);
  }
  for (long long i = n4 * 4 + t; i < n; i += stride) {
    float mm = m[i], vv = v[i];
    const float uu = lamb_elem(h, to_float(g[i]), mm, vv);
    u[i] = uu;
    m[i] = mm;
    v[i] = vv;
  }
}

template <typename T>
inline bool vec_aligned(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % (4 * sizeof(T)) == 0;
}

inline unsigned grid_for(long long n, bool vec) {
  const long long work = vec ? std::max(n / 4, 1LL) : n;
  return (unsigned)std::min((work + kThreads - 1) / kThreads, kMaxBlocks);
}

template <typename TP, typename TG>
cudaError_t launch_adam(void* p, const void* g, void* m, void* v, long long n, const Hyper& h,
                        const Scalars& sc, cudaStream_t s) {
  const bool vec = vec_aligned<TP>(p) && vec_aligned<TG>(g) && vec_aligned<float>(m) &&
                   vec_aligned<float>(v);
  adam_kernel<TP, TG><<<grid_for(n, vec), kThreads, 0, s>>>(
      (TP*)p, (const TG*)g, (float*)m, (float*)v, n, h, sc, vec);
  return cudaGetLastError();
}

template <typename TP, typename TG>
cudaError_t launch_lion(void* p, const void* g, void* m, long long n, const Hyper& h,
                        const Scalars& sc, cudaStream_t s) {
  const bool vec = vec_aligned<TP>(p) && vec_aligned<TG>(g) && vec_aligned<float>(m);
  lion_kernel<TP, TG><<<grid_for(n, vec), kThreads, 0, s>>>((TP*)p, (const TG*)g, (float*)m,
                                                            n, h, sc, vec);
  return cudaGetLastError();
}

template <typename TG>
cudaError_t launch_lamb(const void* g, void* m, void* v, void* u, long long n, const Hyper& h,
                        const Scalars& sc, cudaStream_t s) {
  const bool vec = vec_aligned<TG>(g) && vec_aligned<float>(m) && vec_aligned<float>(v) &&
                   vec_aligned<float>(u);
  lamb_kernel<TG><<<grid_for(n, vec), kThreads, 0, s>>>((const TG*)g, (float*)m, (float*)v,
                                                        (float*)u, n, h, sc, vec);
  return cudaGetLastError();
}

// the statements with T the C type of a float dtype code; an invalid-value
// error for any other code
#define DSTT_DISPATCH_FLOAT(code, T, ...)                 \
  switch (code) {                                         \
    case kFloat32: { using T = float; __VA_ARGS__; }      \
    case kBFloat16: { using T = __nv_bfloat16; __VA_ARGS__; } \
    case kFloat16: { using T = __half; __VA_ARGS__; }     \
    default: return (int)cudaErrorInvalidValue;           \
  }

}  // namespace optim
}  // namespace dstt

// In place over n elements: p (p_dtype), g (g_dtype) read only, m and v fp32.
// lr, step: one fp32 each in device memory; skip: one byte (or null).
// mode: 0 no weight decay, 1 decoupled (AdamW), 2 L2 into the gradient.
extern "C" int dstt_adam_step(void* p, const void* g, void* m, void* v, long long n,
                              const void* lr, const void* step, const void* skip, float b1,
                              float omb1, float log_b1, float b2, float omb2, float log_b2,
                              float eps, float wd, int mode, int p_dtype, int g_dtype,
                              void* stream) {
  using namespace dstt;
  using namespace dstt::optim;
  if (n <= 0 || mode < kNoDecay || mode > kL2 || !lr || !step) return (int)cudaErrorInvalidValue;
  const Hyper h{b1, omb1, log_b1, b2, omb2, log_b2, eps, wd, 0.f, 0.f, 0.f, mode};
  const Scalars sc{(const float*)lr, (const float*)step, (const unsigned char*)skip};
  cudaStream_t s = (cudaStream_t)stream;
  DSTT_DISPATCH_FLOAT(p_dtype, TP, DSTT_DISPATCH_FLOAT(g_dtype, TG,
      return (int)launch_adam<TP, TG>(p, g, m, v, n, h, sc, s)))
  return (int)cudaErrorInvalidValue;
}

// In place: p, m updated; lr and skip as dstt_adam_step's; mode 0 or 1
// (decoupled weight decay).
extern "C" int dstt_lion_step(void* p, const void* g, void* m, long long n, const void* lr,
                              const void* skip, float b1, float omb1, float b2, float omb2,
                              float wd, int mode, int p_dtype, int g_dtype, void* stream) {
  using namespace dstt;
  using namespace dstt::optim;
  if (n <= 0 || (mode != kNoDecay && mode != kDecoupled) || !lr) return (int)cudaErrorInvalidValue;
  const Hyper h{b1, omb1, 0.f, b2, omb2, 0.f, 0.f, wd, 0.f, 0.f, 0.f, mode};
  const Scalars sc{(const float*)lr, nullptr, (const unsigned char*)skip};
  cudaStream_t s = (cudaStream_t)stream;
  DSTT_DISPATCH_FLOAT(p_dtype, TP, DSTT_DISPATCH_FLOAT(g_dtype, TG,
      return (int)launch_lion<TP, TG>(p, g, m, n, h, sc, s)))
  return (int)cudaErrorInvalidValue;
}

// m, v in place; u (fp32, may be g when g is fp32) written; step and skip as
// dstt_adam_step's.
extern "C" int dstt_lamb_update(const void* g, void* m, void* v, void* u, long long n,
                                const void* step, const void* skip, float b1, float omb1,
                                float log_b1, float b2, float omb2, float log_b2, float eps,
                                int g_dtype, void* stream) {
  using namespace dstt;
  using namespace dstt::optim;
  if (n <= 0 || !step) return (int)cudaErrorInvalidValue;
  const Hyper h{b1, omb1, log_b1, b2, omb2, log_b2, eps, 0.f, 0.f, 0.f, 0.f, kNoDecay};
  const Scalars sc{nullptr, (const float*)step, (const unsigned char*)skip};
  cudaStream_t s = (cudaStream_t)stream;
  DSTT_DISPATCH_FLOAT(g_dtype, TG, return (int)launch_lamb<TG>(g, m, v, u, n, h, sc, s))
  return (int)cudaErrorInvalidValue;
}
