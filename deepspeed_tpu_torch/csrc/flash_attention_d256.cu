// K1/K2 at head width 256 (Gemma-2): the mma.sync instances of
// flash_attention.cuh with DMAX 256 (the forward in bf16, fp16 and fp32;
// the fp32 backward; with and without the softcap), in a source of their
// own so the build compiles them beside the narrower ones. Their tiles:
// flash_attention.cuh, Tiles. The bf16/fp16 backward at 256 is wgmma's
// (flash_attention_dq_d256.cu, flash_attention_dkdv_d256.cu).
#include "flash_attention.cuh"

namespace dstt {
namespace flash {

int run_d256(Pass pass, const Args& a, int dtype, cudaStream_t stream) {
  return run_width<256>(pass, a, dtype, stream);
}

}  // namespace flash
}  // namespace dstt
