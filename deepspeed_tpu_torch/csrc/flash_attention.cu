// K1 and K2: the entry points of the per-head flash kernels, one block per
// (64 folded query rows or 64 keys, KV head, batch). What they replace,
// their numerics and their bound are in flash_attention.cuh, which holds
// the bodies and kernels they share with K3 (flash_attention_folded.cu);
// head width 256 is built in flash_attention_d256.cu.
#include "flash_attention.cuh"

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
