// K4's instances for fp32 queries over an fp32 cache (every head width, rows per
// warp, ALiBi and softcap flag); the kernel is in paged_attention.cuh.
#include "paged_attention.cuh"

namespace dstt {
template cudaError_t launch_cache<float, float>(const PagedArgs&, int, cudaStream_t);
}  // namespace dstt
