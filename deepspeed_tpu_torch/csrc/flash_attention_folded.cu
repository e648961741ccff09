// K3: the folded flash kernels' entry points (deepspeed_tpu/ops/
// attention_folded.py :69 _fwd_kernel, :146 _dq_kernel, :215 _dkdv_kernel).
// q/o/dO stay [B, S, H, D] and k/v are read as the folded [B, S, KV*D], the
// same memory as [B, S, KV, D]; lse is [B, S, H] fp32 with K1's +1e30 marker
// for a row that sees no key. They launch K1/K2's kernels on K1/K2's grid,
// with the KV head on blockIdx.y. The Pallas kernel folds every KV head
// into one grid step (its grid (B, num_q, num_kv) walks query and key
// blocks; attention_folded.py's docstring) to spread a TPU grid step's
// fixed cost, which dominated its per-head kernels there. The H100 has no
// such cost: a block that walked every KV head of its tile only left KV
// times fewer blocks than SMs (64 dk/dv blocks at B 2, S 2048 for 132
// SMs, ~4x K2's time), so here the fold has nothing to do and K3 computes
// with K2's kernels, bit for bit.
// Bodies, bound and numerics: flash_attention.cuh.
#include "flash_attention.cuh"

// o, lse = attention(q, k, v) with k/v folded [B, S, KV*D]; lse [B, S, H] fp32
extern "C" int dstt_flash_folded_fwd(const void* q, const void* k, const void* v, void* o,
                                     void* lse, int B, int S, int H, int KV, int D, float scale,
                                     int causal, int window, float softcap, int dtype,
                                     void* stream) {
  using namespace dstt::flash;
  return run(kFwd,
             make_args(q, k, v, nullptr, nullptr, nullptr, o, nullptr, lse, B, S, H, KV, D,
                       scale, causal, window, softcap),
             dtype, stream);
}

extern "C" int dstt_flash_folded_bwd_dq(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse, const void* delta,
                                        void* dq, int B, int S, int H, int KV, int D,
                                        float scale, int causal, int window, float softcap,
                                        int dtype, void* stream) {
  using namespace dstt::flash;
  return run(kDq,
             make_args(q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, S, H, KV, D, scale,
                       causal, window, softcap),
             dtype, stream);
}

extern "C" int dstt_flash_folded_bwd_dkdv(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse,
                                          const void* delta, void* dk, void* dv, int B, int S,
                                          int H, int KV, int D, float scale, int causal,
                                          int window, float softcap, int dtype, void* stream) {
  using namespace dstt::flash;
  return run(kDkdv,
             make_args(q, k, v, dout, lse, delta, dk, dv, nullptr, B, S, H, KV, D, scale,
                       causal, window, softcap),
             dtype, stream);
}
