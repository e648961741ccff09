// K1 and K2: the per-head flash kernels, one block per (64 folded query
// rows or 64 keys, KV head, batch). What they replace, their numerics and
// their bound are in flash_attention.cuh, which holds the bodies they share
// with K3 (flash_attention_folded.cu).
#include "flash_attention.cuh"

namespace dstt {
namespace flash {

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
  dkdv_block<T, DMAX, kCap>(a, blockIdx.x * kKeys, blockIdx.y, blockIdx.z, smem);
}

struct PerHead {
  template <typename T, int DMAX, bool kCap>
  static Kernel kernel(Pass pass) {
    if (pass == kFwd) return &fwd_kernel<T, DMAX, kCap>;
    if (pass == kDq) return &dq_kernel<T, DMAX, kCap>;
    return &dkdv_kernel<T, DMAX, kCap>;
  }
  static dim3 grid(Pass pass, const Args& a) {
    if (pass == kDkdv) return dim3((a.S + kKeys - 1) / kKeys, a.KV, a.B);
    return dim3((a.S * (a.H / a.KV) + kRows - 1) / kRows, a.KV, a.B);
  }
};

}  // namespace flash
}  // namespace dstt

// o, lse = attention(q, k, v); lse [B, S, H] fp32
extern "C" int dstt_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              int B, int S, int H, int KV, int D, float scale, int causal,
                              int window, float softcap, int dtype, void* stream) {
  using namespace dstt::flash;
  return run<PerHead>(kFwd,
                      make_args(q, k, v, nullptr, nullptr, nullptr, o, nullptr, lse, B, S, H,
                                KV, D, scale, causal, window, softcap),
                      dtype, stream);
}

extern "C" int dstt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq, int B, int S,
                                 int H, int KV, int D, float scale, int causal, int window,
                                 float softcap, int dtype, void* stream) {
  using namespace dstt::flash;
  return run<PerHead>(kDq,
                      make_args(q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, S, H, KV,
                                D, scale, causal, window, softcap),
                      dtype, stream);
}

extern "C" int dstt_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   void* dk, void* dv, int B, int S, int H, int KV, int D,
                                   float scale, int causal, int window, float softcap,
                                   int dtype, void* stream) {
  using namespace dstt::flash;
  return run<PerHead>(kDkdv,
                      make_args(q, k, v, dout, lse, delta, dk, dv, nullptr, B, S, H, KV, D,
                                scale, causal, window, softcap),
                      dtype, stream);
}
