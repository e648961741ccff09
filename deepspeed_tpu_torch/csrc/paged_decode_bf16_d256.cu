// K4's decode kernel for bf16 queries over a bf16 cache at head widths
// 129..256 (ALiBi and the softcap as template flags); the kernel and its
// design are in paged_decode.cuh.
#include "paged_decode.cuh"

namespace dstt {
template cudaError_t launch_paged_decode<__nv_bfloat16, 256>(const PagedArgs&, cudaStream_t);
}  // namespace dstt
