// K4's decode kernel for bf16 queries over an int8 cache at head widths up
// to 64 and up to 128 (ALiBi and the softcap as template flags); the kernel
// and its design are in paged_decode.cuh.
#include "paged_decode.cuh"

namespace dstt {
template cudaError_t launch_paged_decode<int8_t, 64>(const PagedArgs&, cudaStream_t);
template cudaError_t launch_paged_decode<int8_t, 128>(const PagedArgs&, cudaStream_t);
}  // namespace dstt
