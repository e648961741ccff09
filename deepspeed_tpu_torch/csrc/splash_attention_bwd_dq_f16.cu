// K8's dq pass in fp16: the grouped sweep's fp16 instances, launched by
// dstt_splash_bwd_dq (splash_attention_bwd_dq.cu). Bodies in
// splash_grouped.cuh.
#include "splash_grouped.cuh"

namespace dstt {
namespace splash {

cudaError_t launch_dq_f16(const GArgs& a, int block, cudaStream_t s) {
  return launch_grouped_type<kPassDq, __half>(a, block, s);
}

}  // namespace splash
}  // namespace dstt
