// K4's fp32-query kernels (chunk and decode) over an int8 cache at
// head widths 129..256 (ALiBi and the softcap as template flags); the kernels
// and their design are in paged_f32.cuh.
#include "paged_f32.cuh"

namespace dstt {
template cudaError_t launch_paged_f32<int8_t, 256>(const PagedArgs&, bool, cudaStream_t);
}  // namespace dstt
