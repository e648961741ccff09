// K8's forward in fp16: the grouped sweep's fp16 instances, launched by
// dstt_splash_fwd (splash_attention.cu). Bodies in splash_grouped.cuh.
#include "splash_grouped.cuh"

namespace dstt {
namespace splash {

cudaError_t launch_fwd_f16(const GArgs& a, int block, cudaStream_t s) {
  return launch_grouped_type<kPassFwd, __half>(a, block, s);
}

}  // namespace splash
}  // namespace dstt
