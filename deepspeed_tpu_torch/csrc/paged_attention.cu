// K4 paged attention: the entry points (the grid plan, its workspace, the
// dispatch on dtypes and on the five kernels). What the kernels replace,
// compute and are bound by is in paged_attention.cuh, paged_decode.cuh and
// paged_f32.cuh, which hold them; each (query, cache) type pair's CUDA-core
// instances are compiled in their own source (paged_attention_{f32,bf16,
// int8_f32,int8_bf16}.cu), the wgmma instances by cache type and head width
// (paged_attention_wgmma_{bf16,int8}{,_d256}.cu), and the decode kernel's
// (paged_decode_{bf16,int8}{,_d256}.cu) and the fp32-query kernels'
// (paged_f32_{f32,int8}{,_d256}.cu) likewise.
#include "paged_f32.cuh"

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

// The grid, and the rule that picks the kernel. A bf16 query over a bf16
// or int8 cache at head widths 65..256 (D % 8 == 0; an int8 cache D % 16 ==
// 0) with at least wgmma_min_rows(D) folded rows per (sequence, KV head)
// takes the wgmma tiles, 128 rows a block; below that, a bf16 query over
// either cache at D % 16 == 0 takes the bf16 decode kernel, 16 rows a
// block. An fp32 query over an fp32 or int8 cache at D % 4 == 0 takes the
// fp32 chunk kernel from f32::kChunkMinRows folded rows (64 rows a block),
// the fp32 decode kernel below (f32::dec_rows(D, rows) rows a block). The
// CUDA-core kernel keeps the rest: bf16 queries at widths that are not a
// multiple of 16 (an int8 cache: not a multiple of 16 past 64), fp32
// queries at widths that are not a multiple of 4; its few rows take one
// row per warp and its chunks four rows per warp. The span of pages a
// sequence can read (all B without a window; with window W, at most
// ceil((W + N - 1) / page_size) + 1 from its first live page) is split over
// blocks: the CUDA-core grid to about 16 blocks per SM; the wgmma grid to
// two waves, 1 split when the query rows alone fill the card; the fp32
// chunk grid (one block an SM) to the fewest splits that fill its waves
// best (wave_splits); the bf16 decode grid to about two blocks per SM and
// the fp32 decode grid to at most two (one wave), both with at least four
// key tiles a split (enough for their copy rings to run ahead). Splits past
// a sequence's last page exit at once.
enum Kernel : int { kCudaCores = 0, kTiles = 1, kDecode = 2, kF32Chunk = 3, kF32Decode = 4 };

struct Plan {
  int kernel, rpw, splits, pages_per_split;
};

inline bool tiles_take(int D, int dtype, int cache_dtype) {
  return dtype == kBFloat16 && D > 64 && D <= 256 && D % 8 == 0 &&
         (cache_dtype == kBFloat16 || (cache_dtype == kInt8 && D % 16 == 0));
}

inline bool decode_takes(int D, int dtype, int cache_dtype) {
  return dtype == kBFloat16 && D % 16 == 0 && D <= 256 &&
         (cache_dtype == kBFloat16 || cache_dtype == kInt8);
}

inline bool f32_takes(int D, int dtype, int cache_dtype) {
  return dtype == kFloat32 && D % 4 == 0 && D <= 256 &&
         (cache_dtype == kFloat32 || cache_dtype == kInt8);
}

inline bool cuda_cores_take(int dtype, int cache_dtype) {
  return (dtype == kFloat32 || dtype == kBFloat16) &&
         (cache_dtype == dtype || cache_dtype == kInt8);
}

// the plan's kernel; `kernel` >= 0 asks for that one (-1 if it does not
// take these dtypes and widths)
inline int choose(int rows, int D, int dtype, int cache_dtype, int kernel) {
  if (kernel == kTiles) return tiles_take(D, dtype, cache_dtype) ? kTiles : -1;
  if (kernel == kDecode) return decode_takes(D, dtype, cache_dtype) ? kDecode : -1;
  if (kernel == kF32Chunk || kernel == kF32Decode)
    return f32_takes(D, dtype, cache_dtype) ? kernel : -1;
  if (kernel == kCudaCores) return cuda_cores_take(dtype, cache_dtype) ? kCudaCores : -1;
  if (kernel >= 0) return -1;
  if (tiles_take(D, dtype, cache_dtype) && rows >= wgmma_min_rows(D)) return kTiles;
  if (decode_takes(D, dtype, cache_dtype)) return kDecode;
  if (f32_takes(D, dtype, cache_dtype))
    return rows >= f32::kChunkMinRows ? kF32Chunk : kF32Decode;
  return cuda_cores_take(dtype, cache_dtype) ? kCudaCores : -1;
}

// keys a row's running max steps over where the output is fp32 and P is
// rounded to bf16 (the JAX kernel's own step is a page): the fp32 kernels'
// key tile; the CUDA-core kernel's page (the bf16-query kernels round
// their outputs to bf16 and report their page as well)
inline int tile_keys(int kernel, int D, int page_size, int cache_dtype) {
  if (kernel == kF32Chunk) return f32::chunk_keys(cache_dtype == kInt8);
  if (kernel == kF32Decode) return f32::dec_keys(D);
  return page_size;
}

// the splits of a chunk grid of `blocks` blocks, `cap` resident at once:
// the fewest that fill the card's waves best, a split more only where it
// fills them by 5 points more (each split's partials go through the combine)
inline long long wave_splits(long long blocks, long long cap, long long most) {
  auto fill = [&](long long s) {
    const long long waves = (blocks * s + cap - 1) / cap;
    return (double)(blocks * s) / (double)(waves * cap);
  };
  long long best = 1;
  for (long long s = 2; s <= most; ++s)
    if (fill(s) > fill(best) + 0.05) best = s;
  return best;
}

inline Plan plan(int S, int N, int H, int D, int KV, int B, int page_size, int window,
                 int dtype, int cache_dtype, int kernel, int sms) {
  const int rows = N * (H / KV);
  Plan p;
  p.kernel = choose(rows, D, dtype, cache_dtype, kernel);
  p.rpw = rows <= kAttnWarps ? 1 : 4;
  const int row_tile = p.kernel == kTiles      ? flash::kWgRows
                       : p.kernel == kDecode   ? decode::kRows
                       : p.kernel == kF32Chunk ? f32::kChunkRows
                       : p.kernel == kF32Decode ? f32::dec_rows(D > 128 ? 256 : 128, rows)
                                               : kAttnWarps * p.rpw;
  const long long blocks = (long long)(rows + row_tile - 1) / row_tile * KV * S;
  const int span = window > 0
      ? (int)std::min<long long>(B, ((long long)window + N - 1 + page_size - 1) / page_size + 1)
      : B;
  long long want;
  if (p.kernel == kF32Chunk)  // one block an SM
    want = wave_splits(blocks, sms, std::max<long long>(4, (sms + blocks - 1) / blocks));
  else if (p.kernel == kF32Decode)
    want = ((long long)f32::kDecBlocksPerSM * sms + blocks - 1) / blocks;
  else if (p.kernel == kTiles && blocks >= sms)
    want = 1;
  else
    want = ((p.kernel == kCudaCores ? 16LL : 2LL) * sms + blocks - 1) / blocks;
  const int splits = (int)std::min<long long>(span, std::max<long long>(1, want));
  p.pages_per_split = (span + splits - 1) / splits;
  // at least four key tiles a decode split, two a chunk split
  const int min_keys = p.kernel == kDecode      ? 4 * decode::keys(D)
                       : p.kernel == kF32Decode ? 4 * f32::dec_keys(D)
                       : p.kernel == kF32Chunk  ? 2 * f32::chunk_keys(cache_dtype == kInt8)
                                                : 0;
  p.pages_per_split = std::max(p.pages_per_split, (min_keys + page_size - 1) / page_size);
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

// The plan of dstt_paged_attention for this shape and these dtypes on the
// current device (`kernel` -1: the plan's choice; else that kernel, which
// must take the dtypes and widths): the fp32 words of workspace it needs
// (0 when the pages are not split), the kernel it launches (0 the
// CUDA-core kernel, 1 the wgmma tiles, 2 the bf16 decode kernel, 3 the fp32
// chunk kernel, 4 the fp32 decode kernel), the pages of each split, counted
// from each sequence's first live page (the whole span when there is one
// split), and the keys each step of a row's running max covers (the
// kernel's key tile, from multiples of it; the CUDA-core kernel's page).
extern "C" int dstt_paged_attention_plan(int S, int N, int H, int D, int KV, int B,
                                         int page_size, int window, int dtype,
                                         int cache_dtype, int kernel, long long* floats,
                                         int* chosen, int* pages_per_split,
                                         int* tile_keys) {
  using namespace dstt;
  if (!valid_shape(S, N, H, D, KV, B) || page_size <= 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const Plan p = plan(S, N, H, D, KV, B, page_size, window, dtype, cache_dtype, kernel, sms);
  if (p.kernel < 0) return (int)cudaErrorInvalidValue;
  *floats = (long long)workspace_floats(p, S, N, H, D);
  *chosen = p.kernel;
  *pages_per_split = p.pages_per_split;
  *tile_keys = dstt::tile_keys(p.kernel, D, page_size, cache_dtype);
  return (int)cudaSuccess;
}

// the folded rows N * G per (sequence, KV head) from which the plan takes
// the wgmma tiles at head width D (wgmma_min_rows)
extern "C" int dstt_paged_wgmma_min_rows(int D) { return dstt::wgmma_min_rows(D); }

// bytes of dynamic shared memory of a wgmma instance (head width 128 or
// 256; a bf16 cache 0, an int8 cache 1), for the build report; -1 for no
// such instance
extern "C" int dstt_paged_wgmma_smem(int dmax, int int8_cache) {
  using namespace dstt;
  size_t bytes = 0;
  if (dmax == 128) bytes = int8_cache ? paged_wgmma_smem<int8_t, 128>()
                                      : paged_wgmma_smem<__nv_bfloat16, 128>();
  if (dmax == 256) bytes = int8_cache ? paged_wgmma_smem<int8_t, 256>()
                                      : paged_wgmma_smem<__nv_bfloat16, 256>();
  return bytes ? (int)bytes : -1;
}

// the folded rows from which the plan takes the fp32 chunk kernel
extern "C" int dstt_paged_f32_chunk_min_rows() { return dstt::f32::kChunkMinRows; }

// bytes of dynamic shared memory of an fp32-query instance (head width 128
// or 256; an fp32 cache 0, an int8 cache 1; the chunk kernel 1, else the
// decode kernel with rows_per_block rows), for the build report; -1 for no
// such instance
extern "C" int dstt_paged_f32_smem(int dmax, int int8_cache, int chunk, int rows_per_block) {
  using namespace dstt::f32;
  size_t bytes = 0;
  if (dmax == 128 && chunk)
    bytes = int8_cache ? chunk_smem<true, 128>() : chunk_smem<false, 128>();
  if (dmax == 256 && chunk)
    bytes = int8_cache ? chunk_smem<true, 256>() : chunk_smem<false, 256>();
  if (dmax == 128 && !chunk && rows_per_block == dec_rows_small(128))
    bytes = int8_cache ? decode_smem<true, 128, dec_rows_small(128)>()
                       : decode_smem<false, 128, dec_rows_small(128)>();
  if (dmax == 128 && !chunk && rows_per_block == dec_rows_large(128))
    bytes = int8_cache ? decode_smem<true, 128, dec_rows_large(128)>()
                       : decode_smem<false, 128, dec_rows_large(128)>();
  if (dmax == 256 && !chunk && rows_per_block == dec_rows_small(256))
    bytes = int8_cache ? decode_smem<true, 256, dec_rows_small(256)>()
                       : decode_smem<false, 256, dec_rows_small(256)>();
  if (dmax == 256 && !chunk && rows_per_block == dec_rows_large(256))
    bytes = int8_cache ? decode_smem<true, 256, dec_rows_large(256)>()
                       : decode_smem<false, 256, dec_rows_large(256)>();
  return bytes ? (int)bytes : -1;
}

// bytes of dynamic shared memory of a decode instance (head width 64, 128
// or 256; a bf16 cache 0, an int8 cache 1), for the build report; -1 for no
// such instance
extern "C" int dstt_paged_decode_smem(int dmax, int int8_cache) {
  using namespace dstt;
  size_t bytes = 0;
  if (dmax == 64) bytes = int8_cache ? paged_decode_smem<int8_t, 64>()
                                     : paged_decode_smem<__nv_bfloat16, 64>();
  if (dmax == 128) bytes = int8_cache ? paged_decode_smem<int8_t, 128>()
                                      : paged_decode_smem<__nv_bfloat16, 128>();
  if (dmax == 256) bytes = int8_cache ? paged_decode_smem<int8_t, 256>()
                                      : paged_decode_smem<__nv_bfloat16, 256>();
  return bytes ? (int)bytes : -1;
}

// dtype: the query's and output's; cache_dtype: the same, or kInt8 with
// cache_scales; slopes: the [KV, G] fp32 ALiBi slopes, or null for none;
// window: the sliding window in keys, 0 for none; softcap: the score cap,
// 0 for none; kernel: -1 for the plan's choice, else the one to launch (as
// dstt_paged_attention_plan)
extern "C" int dstt_paged_attention(const void* q, const void* cache,
                                    const void* cache_scales, const void* slopes, void* out,
                                    const void* block_table, const void* seen,
                                    const void* lens, int S, int N, int H, int D,
                                    int KV, int B, long long slots, int layer,
                                    int page_size, int window, float scale, float softcap,
                                    int dtype, int cache_dtype, int kernel, void* workspace,
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
  const Plan p = plan(S, N, H, D, KV, B, page_size, window, dtype, cache_dtype, kernel, sms);
  if (p.kernel < 0) return (int)cudaErrorInvalidValue;
  // every kernel but the CUDA-core one copies 16 bytes at a time
  if (p.kernel != kCudaCores &&
      (((uintptr_t)q | (uintptr_t)cache | (uintptr_t)out) % 16) != 0)
    return (int)cudaErrorMisalignedAddress;
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
  const bool int8 = cache_dtype == kInt8;
  cudaError_t e;
  if (p.kernel == kTiles)
    e = int8 ? (D <= 128 ? launch_paged_wgmma<int8_t, 128>(a, s)
                         : launch_paged_wgmma<int8_t, 256>(a, s))
             : (D <= 128 ? launch_paged_wgmma<__nv_bfloat16, 128>(a, s)
                         : launch_paged_wgmma<__nv_bfloat16, 256>(a, s));
  else if (p.kernel == kDecode)
    e = int8 ? (D <= 64    ? launch_paged_decode<int8_t, 64>(a, s)
                : D <= 128 ? launch_paged_decode<int8_t, 128>(a, s)
                           : launch_paged_decode<int8_t, 256>(a, s))
             : (D <= 64    ? launch_paged_decode<__nv_bfloat16, 64>(a, s)
                : D <= 128 ? launch_paged_decode<__nv_bfloat16, 128>(a, s)
                           : launch_paged_decode<__nv_bfloat16, 256>(a, s));
  else if (p.kernel == kF32Chunk || p.kernel == kF32Decode) {
    const bool chunk = p.kernel == kF32Chunk;
    e = int8 ? (D <= 128 ? launch_paged_f32<int8_t, 128>(a, chunk, s)
                         : launch_paged_f32<int8_t, 256>(a, chunk, s))
             : (D <= 128 ? launch_paged_f32<float, 128>(a, chunk, s)
                         : launch_paged_f32<float, 256>(a, chunk, s));
  } else if (dtype == kFloat32 && cache_dtype == kFloat32)
    e = launch_cache<float, float>(a, p.rpw, s);
  else if (dtype == kBFloat16 && cache_dtype == kBFloat16)
    e = launch_cache<__nv_bfloat16, __nv_bfloat16>(a, p.rpw, s);
  else if (dtype == kFloat32 && cache_dtype == kInt8)
    e = launch_cache<float, int8_t>(a, p.rpw, s);
  else
    e = launch_cache<__nv_bfloat16, int8_t>(a, p.rpw, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
