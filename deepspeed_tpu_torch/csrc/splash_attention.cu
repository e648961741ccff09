// K8's forward (splash.py:63 _splash_kernel): one block per (up to 64 rows
// of one q-block, batch*head), looping over the row's active k-blocks. What
// K8 replaces, its numerics and its bound are in splash_attention.cuh,
// which holds the bodies of all three passes.
#include "splash_attention.cuh"

// o, lse = splash(q, k, v) over (table, counts); lse [BH, S] fp32
extern "C" int dstt_splash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                               const void* table, const void* counts, int BH, int S, int D,
                               int Lh, int A, int block, float scale, int dtype, void* stream) {
  using namespace dstt::splash;
  Args a{q, k, v, nullptr, nullptr, nullptr, o, nullptr, (float*)lse, (const int*)table,
         (const int*)counts, BH, S, D, Lh, A, 0, scale};
  return run<kFwd>(a, block, dtype, stream);
}
