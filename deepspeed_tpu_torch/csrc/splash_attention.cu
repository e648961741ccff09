// K8's forward (splash.py:63 _splash_kernel) in bf16: the grouped sweep
// over the layout's plan, and the merge of split rows in every type; fp16
// and fp32 build in splash_attention_{f16,f32}.cu. The bodies and the design
// are in splash_grouped.cuh, what K8 replaces and its numerics in
// splash_attention.cuh.
#include "splash_grouped.cuh"

// o, lse = splash(q, k, v) over the plan (items, entries; cap the most
// entries of an item); lse [BH, S] fp32; a split group's segments write
// their partials to ws (accumulators) and ws2 (max, sum) for
// dstt_splash_fwd_merge
extern "C" int dstt_splash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                               const void* items, const void* entries, int n_items, int cap,
                               int BH, int S, int D, int Lh, int block, float scale, int dtype,
                               void* ws, void* ws2, int n_parts, void* stream) {
  using namespace dstt::splash;
  GArgs a{q, k, v, nullptr, nullptr, nullptr, o, nullptr, (float*)lse,
          (const int*)items, (const int*)entries, (float*)ws, (float*)ws2,
          n_items, n_parts, 0, BH, S, D, Lh, cap, scale};
  return run_grouped<true>(a, block, dtype, stream);
}

// the split rows of o and lse from their segments' partials, in order
extern "C" int dstt_splash_fwd_merge(void* o, void* lse, const void* merges, int n_merges,
                                     int BH, int S, int D, int Lh, int dtype, void* ws,
                                     void* ws2, int n_parts, void* stream) {
  using namespace dstt::splash;
  GArgs a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, o, nullptr, (float*)lse,
          (const int*)merges, nullptr, (float*)ws, (float*)ws2,
          n_merges, n_parts, 0, BH, S, D, Lh, 0, 0.f};
  return run_second_pass<true>(a, dtype, stream);
}
