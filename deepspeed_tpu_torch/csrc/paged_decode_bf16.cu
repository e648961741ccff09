// K4's decode kernel for bf16 queries over a bf16 cache at head widths up
// to 64 and up to 128 (ALiBi and the softcap as template flags); the kernel
// and its design are in paged_decode.cuh.
#include "paged_decode.cuh"

namespace dstt {
template cudaError_t launch_paged_decode<__nv_bfloat16, 64>(const PagedArgs&, cudaStream_t);
template cudaError_t launch_paged_decode<__nv_bfloat16, 128>(const PagedArgs&, cudaStream_t);
}  // namespace dstt
