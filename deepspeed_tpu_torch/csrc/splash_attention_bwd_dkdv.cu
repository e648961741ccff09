// K8's dk/dv pass (splash.py:201 _splash_dkv_kernel) in bf16: the grouped
// sweep over the transposed layout's plan, and the sum of split keys in
// every type; fp16 and fp32 build in splash_attention_bwd_dkdv_{f16,f32}.cu.
// Bodies in splash_grouped.cuh.
#include "splash_grouped.cuh"

// dk, dv over the transposed layout's plan (items, entries; cap the most
// entries of an item); a split group's segments write fp32 partials of dk
// to ws and of dv to ws2 for dstt_splash_dkdv_sum
extern "C" int dstt_splash_bwd_dkdv(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dk, void* dv, const void* items, const void* entries,
                                    int n_items, int cap, int BH, int S, int D, int Lh,
                                    int block, float scale, int dtype, void* ws, void* ws2,
                                    int n_parts, void* stream) {
  using namespace dstt::splash;
  GArgs a{q, k, v, dout, (const float*)lse, (const float*)delta, dk, dv, nullptr,
          (const int*)items, (const int*)entries, (float*)ws, (float*)ws2,
          n_items, n_parts, 0, BH, S, D, Lh, cap, scale};
  return run_grouped<kPassDkdv>(a, block, dtype, stream);
}

// the split keys' dk and dv: their segments' partials summed in order
extern "C" int dstt_splash_dkdv_sum(void* dk, void* dv, const void* merges, int n_merges,
                                    int BH, int S, int D, int Lh, int dtype, void* ws,
                                    void* ws2, int n_parts, void* stream) {
  using namespace dstt::splash;
  GArgs a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, dk, dv, nullptr,
          (const int*)merges, nullptr, (float*)ws, (float*)ws2,
          n_merges, n_parts, 0, BH, S, D, Lh, 0, 0.f};
  return run_second_pass<kPassDkdv>(a, dtype, stream);
}
