// K4's multi-row tiles on wgmma for bf16 queries over a bf16 cache at
// head widths 129..256 (ALiBi and the softcap as template flags); the kernel
// and its design are in paged_attention.cuh, the sweep it shares with K1's
// forward in flash_attention.cuh.
#include "paged_attention.cuh"

namespace dstt {
template cudaError_t launch_paged_wgmma<__nv_bfloat16, 256>(const PagedArgs&, cudaStream_t);
}  // namespace dstt
