// K4's instances for fp32 queries over an int8 cache (every head width, rows per
// warp, ALiBi and softcap flag); the kernel is in paged_attention.cuh.
#include "paged_attention.cuh"

namespace dstt {
template cudaError_t launch_cache<float, int8_t>(const PagedArgs&, int, cudaStream_t);
}  // namespace dstt
