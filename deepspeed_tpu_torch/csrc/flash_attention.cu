// K1 and K2: the entry points of the per-head flash kernels and the
// dispatch both layouts share (run). What they replace, their numerics,
// bound and design are in flash_attention.cuh, which holds the bodies; the
// instances are built in this source (the mma.sync bodies: every pass in
// fp32 at head widths <= 128, and in every dtype at <= 64),
// flash_attention_d256.cu (fp32 at 256), and the wgmma kernels' six sources
// flash_attention_fwd.cu, flash_attention_dq.cu, flash_attention_dkdv.cu
// and their _d256 forms.
#include "flash_attention.cuh"

namespace dstt {
namespace flash {

int run(Pass pass, const Args& a, int dtype, void* stream) {
  const bool shape_ok = a.B > 0 && a.B <= 65535 && a.S > 0 && a.KV > 0 && a.KV <= 65535 &&
                        a.H % a.KV == 0 && a.D > 0 && a.D <= 256 && a.D % 8 == 0 &&
                        (long long)a.S * (a.H / a.KV) < (1LL << 31) && a.window >= 0 &&
                        a.softcap >= 0.f;
  if (!shape_ok) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (a.D <= 64) return run_width<64>(pass, a, dtype, s);
  if (dtype != kFloat32) {
    if (a.D <= 128)
      return pass == kFwd  ? run_fwd_wgmma_128(a, dtype, s)
             : pass == kDq ? run_dq_wgmma_128(a, dtype, s)
                           : run_dkdv_wgmma_128(a, dtype, s);
    return pass == kFwd  ? run_fwd_wgmma_256(a, dtype, s)
           : pass == kDq ? run_dq_wgmma_256(a, dtype, s)
                         : run_dkdv_wgmma_256(a, dtype, s);
  }
  if (a.D <= 128) return run_width<128>(pass, a, dtype, s);
  return run_d256(pass, a, dtype, s);
}

}  // namespace flash
}  // namespace dstt

// o, lse = attention(q, k, v); lse [B, S, H] fp32
extern "C" int dstt_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              int B, int S, int H, int KV, int D, float scale, int causal,
                              int window, float softcap, int dtype, void* stream) {
  using namespace dstt::flash;
  return run(kFwd,
             make_args(q, k, v, nullptr, nullptr, nullptr, o, nullptr, lse, B, S, H, KV, D,
                       scale, causal, window, softcap),
             dtype, stream);
}

extern "C" int dstt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq, int B, int S,
                                 int H, int KV, int D, float scale, int causal, int window,
                                 float softcap, int dtype, void* stream) {
  using namespace dstt::flash;
  return run(kDq,
             make_args(q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, S, H, KV, D, scale,
                       causal, window, softcap),
             dtype, stream);
}

extern "C" int dstt_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   void* dk, void* dv, int B, int S, int H, int KV, int D,
                                   float scale, int causal, int window, float softcap,
                                   int dtype, void* stream) {
  using namespace dstt::flash;
  return run(kDkdv,
             make_args(q, k, v, dout, lse, delta, dk, dv, nullptr, B, S, H, KV, D, scale,
                       causal, window, softcap),
             dtype, stream);
}

// bytes of dynamic shared memory of a wgmma instance (pass 0: forward, 1:
// dq, 2: dk/dv; head width 128 or 256; the same in bf16 and fp16), for the
// build report; -1 for no such instance
extern "C" int dstt_flash_wgmma_smem(int pass, int dmax, int softcap) {
  using namespace dstt::flash;
  using T = __nv_bfloat16;
  size_t bytes = 0;
  if (pass == kFwd && dmax == 128) bytes = fwd_wgmma_smem<T, 128, false>();
  if (pass == kFwd && dmax == 256) bytes = fwd_wgmma_smem<T, 256, false>();
  if (pass == kDq && dmax == 128) bytes = dq_wgmma_smem<T, 128>();
  if (pass == kDq && dmax == 256) bytes = dq_wgmma_smem<T, 256>();
  if (pass == kDkdv && dmax == 128)
    bytes = softcap ? dkdv_wgmma_smem<T, 128, true>() : dkdv_wgmma_smem<T, 128, false>();
  if (pass == kDkdv && dmax == 256)
    bytes = softcap ? dkdv_wgmma_smem<T, 256, true>() : dkdv_wgmma_smem<T, 256, false>();
  return bytes ? (int)bytes : -1;
}
