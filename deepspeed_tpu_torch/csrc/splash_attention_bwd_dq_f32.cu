// K8's dq pass in fp32 (the parity runs): the grouped sweep's fp32
// instances, launched by dstt_splash_bwd_dq (splash_attention_bwd_dq.cu).
// Bodies in splash_grouped.cuh.
#include "splash_grouped.cuh"

namespace dstt {
namespace splash {

cudaError_t launch_dq_f32(const GArgs& a, int block, cudaStream_t s) {
  return launch_grouped_type<kPassDq, float>(a, block, s);
}

}  // namespace splash
}  // namespace dstt
