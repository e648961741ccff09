// K8's dk/dv pass (splash.py:201 _splash_dkv_kernel), over the transposed
// block table; the bodies are in splash_attention.cuh.
#include "splash_attention.cuh"

// dk, dv over the transposed (table, counts)
extern "C" int dstt_splash_bwd_dkdv(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dk, void* dv, const void* table, const void* counts,
                                    int BH, int S, int D, int Lh, int A, int block, float scale,
                                    int dtype, void* stream) {
  using namespace dstt::splash;
  Args a{q, k, v, dout, (const float*)lse, (const float*)delta, dk, dv, nullptr,
         (const int*)table, (const int*)counts, BH, S, D, Lh, A, 0, scale};
  return run<kDkdv>(a, block, dtype, stream);
}
