// K8's dq pass (splash.py:165 _splash_dq_kernel) in bf16: the grouped sweep
// over the forward's plan, and the sum of split rows in every type; fp16 and
// fp32 build in splash_attention_bwd_dq_{f16,f32}.cu. Bodies in
// splash_grouped.cuh.
#include "splash_grouped.cuh"

// dq over the forward's plan (items, entries; cap the most entries of an
// item); a split group's segments write fp32 partials of dq to ws for
// dstt_splash_dq_sum
extern "C" int dstt_splash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dq,
                                  const void* items, const void* entries, int n_items, int cap,
                                  int BH, int S, int D, int Lh, int block, float scale,
                                  int dtype, void* ws, int n_parts, void* stream) {
  using namespace dstt::splash;
  GArgs a{q, k, v, dout, (const float*)lse, (const float*)delta, dq, nullptr, nullptr,
          (const int*)items, (const int*)entries, (float*)ws, nullptr,
          n_items, n_parts, 0, BH, S, D, Lh, cap, scale};
  return run_grouped<kPassDq>(a, block, dtype, stream);
}

// the split rows' dq: their segments' partials summed in order
extern "C" int dstt_splash_dq_sum(void* dq, const void* merges, int n_merges, int BH, int S,
                                  int D, int Lh, int dtype, void* ws, int n_parts,
                                  void* stream) {
  using namespace dstt::splash;
  GArgs a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, dq, nullptr, nullptr,
          (const int*)merges, nullptr, (float*)ws, nullptr,
          n_merges, n_parts, 0, BH, S, D, Lh, 0, 0.f};
  return run_second_pass<kPassDq>(a, dtype, stream);
}
