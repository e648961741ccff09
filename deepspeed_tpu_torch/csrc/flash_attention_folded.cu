// K3: the folded flash kernels (deepspeed_tpu/ops/attention_folded.py :69
// _fwd_kernel, :146 _dq_kernel, :215 _dkdv_kernel). One block per (64
// folded query rows, batch), or (64 keys, batch) for dk/dv, covers every KV
// head of its tile, as the folded Pallas grid (B, num_q, num_kv) does: a
// folded [64, KV*D] K tile and its V tile exceed shared memory at Llama
// width (256 KB in bf16 at KV 8, D 128), so the block streams the KV heads
// through the buffers of the per-head body (flash_attention.cuh), one head
// after the other. q/o/dO stay [B, S, H, D] and k/v are read as the folded
// [B, S, KV*D] (the same memory as [B, S, KV, D]); lse is [B, S, H] fp32
// with K1's +1e30 marker for a row that sees no key. Bound and numerics:
// flash_attention.cuh. The fold answers the TPU's fixed cost per grid step,
// which the H100 does not have: here it leaves KV times fewer blocks than
// K1/K2 (64 dk/dv blocks at B 2, S 2048 for 132 SMs), and dk/dv takes ~4x
// K2's time there (PERF.md). The kernels are in flash_attention.cuh; head
// width 256 is built in flash_attention_folded_d256.cu.
#include "flash_attention.cuh"

// o, lse = attention(q, k, v) with k/v folded [B, S, KV*D]; lse [B, S, H] fp32
extern "C" int dstt_flash_folded_fwd(const void* q, const void* k, const void* v, void* o,
                                     void* lse, int B, int S, int H, int KV, int D, float scale,
                                     int causal, int window, float softcap, int dtype,
                                     void* stream) {
  using namespace dstt::flash;
  return run<Folded>(kFwd,
                     make_args(q, k, v, nullptr, nullptr, nullptr, o, nullptr, lse, B, S, H,
                               KV, D, scale, causal, window, softcap),
                     dtype, stream);
}

extern "C" int dstt_flash_folded_bwd_dq(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse, const void* delta,
                                        void* dq, int B, int S, int H, int KV, int D,
                                        float scale, int causal, int window, float softcap,
                                        int dtype, void* stream) {
  using namespace dstt::flash;
  return run<Folded>(kDq,
                     make_args(q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, S, H, KV, D,
                               scale, causal, window, softcap),
                     dtype, stream);
}

extern "C" int dstt_flash_folded_bwd_dkdv(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse,
                                          const void* delta, void* dk, void* dv, int B, int S,
                                          int H, int KV, int D, float scale, int causal,
                                          int window, float softcap, int dtype, void* stream) {
  using namespace dstt::flash;
  return run<Folded>(kDkdv,
                     make_args(q, k, v, dout, lse, delta, dk, dv, nullptr, B, S, H, KV, D,
                               scale, causal, window, softcap),
                     dtype, stream);
}
