// K8's forward in fp32 (the parity runs): the grouped sweep's fp32
// instances, launched by dstt_splash_fwd (splash_attention.cu). Bodies in
// splash_grouped.cuh.
#include "splash_grouped.cuh"

namespace dstt {
namespace splash {

cudaError_t launch_fwd_f32(const GArgs& a, int block, cudaStream_t s) {
  return launch_grouped_type<kPassFwd, float>(a, block, s);
}

}  // namespace splash
}  // namespace dstt
