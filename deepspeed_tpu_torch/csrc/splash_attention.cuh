// K8: splash block-sparse attention. This header holds the note on the
// function, its numerics and its design, and what the three passes share;
// all three sweep row groups of a host plan (splash_grouped.cuh, built in
// splash_attention{,_f16,_f32}.cu, splash_attention_bwd_dq{,_f16,_f32}.cu
// and splash_attention_bwd_dkdv{,_f16,_f32}.cu).
//
// Replaces the TPU kernels deepspeed_tpu/ops/sparse_attention/splash.py:63
// _splash_kernel (driven by _splash_fwd :117, pallas_call :153), :165
// _splash_dq_kernel (pallas_call :266) and :201 _splash_dkv_kernel
// (pallas_call :289). The same function, on another grid:
//   q, k, v [BH, S, D] (the [B, H, S, D] of the caller), a static layout
//   [Lh, nb, nb] with nb = S / block. Row bh reads layout head bh % Lh
//   (jax.lax.rem(bh, nheads_layout), :74).
//   s = (q . k) * scale in fp32 over the active blocks only;
//   forward: o = softmax(s) v in q's dtype and lse [BH, S] fp32; a row
//   with no active block gets o = 0 and lse = +1e30 (-NEG_INF, :104-114), so
//   the backward's exp(s - lse) is exactly 0 there.
//   backward (delta = rowsum(dO * O) [BH, S] fp32 comes from the caller):
//   P = exp(s - lse), dS = P * (dP - delta) * scale with dP = dO v^T;
//   dq = dS k over the layout (each q-block's active k-blocks); dk = dS^T q
//   and dv = P^T dO over the transposed layout (for each k-block, the
//   q-blocks that see it). No float atomics anywhere: every output is
//   deterministic.
//
// Numerics: as K1/K2 (flash_attention.cuh, whose tile products these
// kernels reuse): bf16 or fp16 operands on mma.sync m16n8k16 with fp32
// accumulation, the softmax and its statistics in fp32; P (forward and
// dk/dv) and dS (dq and dk/dv) rounded to the input dtype before their
// products, as the Pallas kernels do. fp32 runs the same fragments on the
// CUDA cores (the parity runs).
//
// Bound on the H100: at head_dim 64 each input read once (q, k, v, o: 33.5
// MB each at B 4, H 16, S 4096, D 64 in bf16) is the least time; the
// products of a 16-key block reused by 16 queries are far below the 295
// flops per byte where the tensor cores would bind. What held the first
// kernels (one thread block per q-block or k-block) back, and what the
// grouped passes do about it (splash_grouped.cuh):
// - one warp per 16 rows at block 16, each step a 2 KB tile, a 16 x 16 x 64
//   and a 16 x 64 x 16 product behind a cp.async wait and a barrier in a
//   two-deep ring: nearly a memory round trip a step. Now 4 warps share
//   each stage of 64 keys (or query rows) in a 3-deep ring.
// - blocks that several rows share staged once per row (fixed's four rows
//   of a local window are identical). Now a group of 64 rows stages the
//   union of its members' blocks once: rows grouped in order or widest
//   first, whichever sweeps fewer stages (the nested transposed global
//   columns of fixed), so fixed's forward stages a quarter of the blocks.
// - the global rows (BigBird's and Longformer's row 0 and column 0 see all
//   256 blocks) ran 256 steps in one warp while the rest of the grid had
//   ~5. Now a union past the plan's limit is cut into segments, each its own
//   thread block, merged or summed in order by a second pass, and the
//   longest items launch first.
// - dS written to shared memory and read back for dq += dS k, and the warp's
//   Q and dO reloaded from shared memory every step. Now dS is the A operand
//   of dq's product as it lies in registers, and Q and dO are held as A
//   fragments at head width <= 64.
#pragma once

#include "flash_attention.cuh"

namespace dstt {
namespace splash {

using flash::kPad;

constexpr float kLseEmpty = 1e30f;  // splash.py -NEG_INF

}  // namespace splash
}  // namespace dstt
