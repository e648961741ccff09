// K4 paged attention: the entry points (the grid plan, its workspace, the
// dispatch on dtypes). What the kernel replaces, computes and is bound by
// is in paged_attention.cuh, which holds it; each (query, cache) type
// pair's instances are compiled in their own source
// (paged_attention_{f32,bf16,int8_f32,int8_bf16}.cu).
#include "paged_attention.cuh"

namespace dstt {

// SM count of the current device, read once per device
inline int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && cached[dev] > 0) return cached[dev];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  if (dev < 64) cached[dev] = n;
  return n;
}

// The grid: query rows per warp, and the split of each sequence's pages.
// Few rows (decode: G rows per sequence and head) take one row per warp;
// prefill tiles take four rows per warp, sharing each staged page. The
// span of pages a sequence can read (all B without a window; with window
// W, at most ceil((W + N - 1) / page_size) + 1 from its first live page) is
// split over enough blocks that the grid holds about 16 blocks per SM
// (splits past a sequence's last page exit at once); 1 split when the
// query rows alone fill the card.
struct Plan {
  int rpw, splits, pages_per_split;
};

inline Plan plan(int S, int N, int H, int KV, int B, int page_size, int window,
                 int sms) {
  const int rows = N * (H / KV);
  Plan p;
  p.rpw = rows <= kAttnWarps ? 1 : 4;
  const long long tiles = (rows + kAttnWarps * p.rpw - 1) / (kAttnWarps * p.rpw);
  const long long blocks = tiles * KV * S;
  const long long want = (16LL * sms + blocks - 1) / blocks;
  const int span = window > 0
      ? (int)std::min<long long>(B, ((long long)window + N - 1 + page_size - 1) / page_size + 1)
      : B;
  const int splits = (int)std::min<long long>(span, std::max<long long>(1, want));
  p.pages_per_split = (span + splits - 1) / splits;
  p.splits = (span + p.pages_per_split - 1) / p.pages_per_split;
  return p;
}

// fp32 words of workspace a split plan needs: accumulator and (max, sum)
inline size_t workspace_floats(const Plan& p, int S, int N, int H, int D) {
  return p.splits > 1 ? (size_t)S * N * H * p.splits * (D + 2) : 0;
}

inline bool valid_shape(int S, int N, int H, int D, int KV, int B) {
  return S > 0 && N > 0 && KV > 0 && H % KV == 0 && D > 0 && D <= kMaxHeadDim &&
         B > 0 && S <= 65535 && KV <= 65535;
}

}  // namespace dstt

// Workspace (fp32 words) that dstt_paged_attention needs for this shape on
// the current device; 0 when the pages are not split.
extern "C" int dstt_paged_attention_workspace(int S, int N, int H, int D, int KV,
                                              int B, int page_size, int window,
                                              long long* floats) {
  using namespace dstt;
  if (!valid_shape(S, N, H, D, KV, B) || page_size <= 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  *floats = (long long)workspace_floats(plan(S, N, H, KV, B, page_size, window, sms),
                                        S, N, H, D);
  return (int)cudaSuccess;
}

// dtype: the query's and output's; cache_dtype: the same, or kInt8 with
// cache_scales; slopes: the [KV, G] fp32 ALiBi slopes, or null for none;
// window: the sliding window in keys, 0 for none; softcap: the score cap,
// 0 for none
extern "C" int dstt_paged_attention(const void* q, const void* cache,
                                    const void* cache_scales, const void* slopes, void* out,
                                    const void* block_table, const void* seen,
                                    const void* lens, int S, int N, int H, int D,
                                    int KV, int B, long long slots, int layer,
                                    int page_size, int window, float scale, float softcap,
                                    int dtype,
                                    int cache_dtype, void* workspace,
                                    long long workspace_len, void* stream) {
  using namespace dstt;
  const int cache_bytes = cache_dtype == kFloat32 ? 4 : cache_dtype == kBFloat16 ? 2 : 1;
  if (!valid_shape(S, N, H, D, KV, B) || page_size <= 0 || page_size > kMaxPage ||
      window < 0 || !(softcap >= 0.f) || slots % page_size != 0 ||
      (D * cache_bytes) % 4 != 0 ||
      (cache_dtype == kInt8) != (cache_scales != nullptr))
    return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const Plan p = plan(S, N, H, KV, B, page_size, window, sms);
  const size_t need = workspace_floats(p, S, N, H, D);
  if (need > 0 && (workspace == nullptr || (size_t)workspace_len < need))
    return (int)cudaErrorInvalidValue;
  float* ws = need > 0 ? (float*)workspace : nullptr;
  const size_t parts = (size_t)S * N * H * p.splits;
  PagedArgs a{q, cache, (const float*)cache_scales, (const float*)slopes, out,
              (const int*)block_table,
              (const int*)seen,
              (const int*)lens, S, N, H, D, KV, B, slots, layer, page_size, window, scale,
              softcap, p.splits, p.pages_per_split, ws, ws ? ws + parts * D : nullptr};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (dtype == kFloat32 && cache_dtype == kFloat32)
    e = launch_cache<float, float>(a, p.rpw, s);
  else if (dtype == kBFloat16 && cache_dtype == kBFloat16)
    e = launch_cache<__nv_bfloat16, __nv_bfloat16>(a, p.rpw, s);
  else if (dtype == kFloat32 && cache_dtype == kInt8)
    e = launch_cache<float, int8_t>(a, p.rpw, s);
  else if (dtype == kBFloat16 && cache_dtype == kInt8)
    e = launch_cache<__nv_bfloat16, int8_t>(a, p.rpw, s);
  else
    return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
