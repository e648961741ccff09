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
  return run_grouped<kPassFwd>(a, block, dtype, stream);
}

// the split rows of o and lse from their segments' partials, in order
extern "C" int dstt_splash_fwd_merge(void* o, void* lse, const void* merges, int n_merges,
                                     int BH, int S, int D, int Lh, int dtype, void* ws,
                                     void* ws2, int n_parts, void* stream) {
  using namespace dstt::splash;
  GArgs a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, o, nullptr, (float*)lse,
          (const int*)merges, nullptr, (float*)ws, (float*)ws2,
          n_merges, n_parts, 0, BH, S, D, Lh, 0, 0.f};
  return run_second_pass<kPassFwd>(a, dtype, stream);
}

// the dynamic shared memory of a grouped sweep's instance (pass 0 forward,
// 1 dq, 2 dk/dv; head width 64 or 128) before its item's entries, or -1
template <int P>
static int splash_smem(int dtype, int dmax) {
  using namespace dstt::splash;
  const bool narrow = dmax == 64;
  if (!narrow && dmax != 128) return -1;
  switch (dtype) {
    case dstt::kFloat32:
      return (int)(narrow ? group_smem<float, 64, P>() : group_smem<float, 128, P>());
    case dstt::kBFloat16:
    case dstt::kFloat16:
      return (int)(narrow ? group_smem<__half, 64, P>() : group_smem<__half, 128, P>());
    default: return -1;
  }
}

extern "C" int dstt_splash_smem(int pass, int dtype, int dmax) {
  using namespace dstt::splash;
  switch (pass) {
    case kPassFwd: return splash_smem<kPassFwd>(dtype, dmax);
    case kPassDq: return splash_smem<kPassDq>(dtype, dmax);
    case kPassDkdv: return splash_smem<kPassDkdv>(dtype, dmax);
    default: return -1;
  }
}
