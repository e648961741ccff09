// K3 at head width 256 (Gemma-2): the folded instances of
// flash_attention.cuh with DMAX 256 (bf16, fp16, fp32; with and without the
// softcap), in a source of their own so the build compiles them beside the
// narrower ones. Their tiles: flash_attention.cuh, Tiles.
#include "flash_attention.cuh"

namespace dstt {
namespace flash {

int Folded::run_d256(Pass pass, const Args& a, int dtype, cudaStream_t stream) {
  return run_width<Folded, 256>(pass, a, dtype, stream);
}

}  // namespace flash
}  // namespace dstt
