// K8's dq pass (splash.py:165 _splash_dq_kernel), over the forward's block
// table; the bodies are in splash_attention.cuh.
#include "splash_attention.cuh"

// dq over the forward (table, counts)
extern "C" int dstt_splash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dq, const void* table,
                                  const void* counts, int BH, int S, int D, int Lh, int A,
                                  int block, float scale, int dtype, void* stream) {
  using namespace dstt::splash;
  Args a{q, k, v, dout, (const float*)lse, (const float*)delta, dq, (const int*)table,
         (const int*)counts, BH, S, D, Lh, A, 0, scale};
  return run_dq(a, block, dtype, stream);
}
