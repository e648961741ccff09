// K1's forward (fwd_wgmma_kernel, which K3's entry points launch too) on
// wgmma at head widths 65..128, bf16 and fp16, with and without the
// softcap: the instances of flash_attention.cuh in a source of their own,
// so the build compiles them beside the other flash sources. Design, bound
// and numerics: flash_attention.cuh.
#include "flash_attention.cuh"

namespace dstt {
namespace flash {

int run_fwd_wgmma_128(const Args& a, int dtype, cudaStream_t s) {
  return run_wgmma<kFwd, 128>(a, dtype, s);
}

}  // namespace flash
}  // namespace dstt
