// K1/K2 at head width 256 (Gemma-2) in fp32: the mma.sync instances of
// flash_attention.cuh with DMAX 256 (every pass, with and without the
// softcap), in a source of their own so the build compiles them beside the
// narrower ones. Their tiles: flash_attention.cuh, Tiles. bf16 and fp16 at
// 256 are wgmma's (flash_attention_fwd_d256.cu, flash_attention_dq_d256.cu,
// flash_attention_dkdv_d256.cu).
#include "flash_attention.cuh"

namespace dstt {
namespace flash {

int run_d256(Pass pass, const Args& a, int dtype, cudaStream_t stream) {
  return run_width<256>(pass, a, dtype, stream);
}

}  // namespace flash
}  // namespace dstt
