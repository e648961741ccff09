// K8's dk/dv pass in fp16: the grouped sweep's fp16 instances, launched by
// dstt_splash_bwd_dkdv (splash_attention_bwd_dkdv.cu). Bodies in
// splash_grouped.cuh.
#include "splash_grouped.cuh"

namespace dstt {
namespace splash {

cudaError_t launch_dkdv_f16(const GArgs& a, int block, cudaStream_t s) {
  return launch_grouped_type<kPassDkdv, __half>(a, block, s);
}

}  // namespace splash
}  // namespace dstt
