// K8's dk/dv pass in fp32 (the parity runs): the grouped sweep's fp32
// instances, launched by dstt_splash_bwd_dkdv (splash_attention_bwd_dkdv.cu).
// Bodies in splash_grouped.cuh.
#include "splash_grouped.cuh"

namespace dstt {
namespace splash {

cudaError_t launch_dkdv_f32(const GArgs& a, int block, cudaStream_t s) {
  return launch_grouped_type<kPassDkdv, float>(a, block, s);
}

}  // namespace splash
}  // namespace dstt
