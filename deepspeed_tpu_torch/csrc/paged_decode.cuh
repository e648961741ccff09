// K4's decode kernel on Hopper: bf16 queries over a bf16 or int8 paged
// cache, fewer than wgmma_min_rows(D) folded rows N * G per (sequence, KV
// head), head widths D % 16 == 0 up to 256.
//
// Replaces the TPU kernel deepspeed_tpu/ops/paged_attention.py:60
// _paged_attn_kernel (driven by paged_attention :166) on decode steps and
// small chunks: it computes that kernel's function (inputs, masks, window
// and its page skip, ALiBi, softcap, int8 staging, P rounded to bf16 before
// P V, :147), not its grid. paged_attention.cuh holds the arguments and the
// two other K4 kernels; paged_attention.cu's plan() picks among the three.
//
// Bound on the H100: bytes. A decode row meets each history key once: two
// products of D per key against 2 * D bytes of K and V (int8: D + 4), some
// 1 operation per byte, far under the card's ~295. So the design is about
// keeping copies in flight and moving nothing twice, and about keeping
// each tile's own instructions under its copy time. What held the
// CUDA-core kernel (paged_attention_kernel) back, and what this one does:
// 1. One lane per key: each score a serial D-long dot product of fp32 q in
//    shared memory against the K row, P V one lane per output dim over the
//    page's keys; no tensor core. Here both products run on the tensor
//    cores (mma.sync.m16n8k16, bf16 in, fp32 sums): S = Q K^T with the
//    block's 16 folded rows (zero-padded) as the A operand, K by ldmatrix
//    from rows padded by 16 bytes (no bank conflict); O += P V with P taken
//    from the S accumulators repacked to bf16 registers (the C -> A
//    identity of m16n8k16), which is the JAX kernel's rounding of P, and V
//    by ldmatrix.trans. Rows go on the M side: keys there (S^T = K Q^T)
//    would waste less of the tile at G <= 8, but need a transpose of P in
//    registers, and the tensor cores' idle rows cost nothing measurable.
// 2. Warps owned query rows (BLOOM's G 1 left 3 of 4 warps idle). Here the
//    4 warps split every key tile, each with its own running max, sum and
//    fp32 accumulator for all 16 rows; the block merges the four through
//    shared memory once, at the end.
// 3. Each page was staged by plain loads between two barriers, so every
//    page paid the full memory latency. Here key tiles (64 keys, 16 a warp;
//    32 at head width 256, where 64 would leave one block on an SM) go
//    through a ring in shared memory filled by 16-byte cp.async two tiles
//    ahead of the compute (3 stages), one barrier a tile. A tile's rows are
//    gathered through the block table (key j is slot block_table[s, j /
//    page_size] * page_size + j % page_size; any page size up to 128): each
//    lane loads one table entry a tile ahead and the rows take theirs by a
//    shuffle. An int8 cache copies its codes and scales (2 code stages);
//    after the barrier that lands a tile each thread dequantizes the codes
//    it copied into one of two bf16 tiles, a tile ahead of the compute, with
//    the TPU kernel's numerics (the scale rounded to bf16, each product
//    rounded to bf16), the codes made floats by an exponent trick and the
//    products by bf16 pair multiplies.
// 4. The split plan aimed at 16 blocks per SM: StarCoder2's decode became
//    65 one-page splits (2,080 blocks) whose fp32 partials were ~a sixth of
//    the K/V bytes, merged by a loop with a shuffle per split. Here one
//    block per (16 folded rows, KV head, sequence, split), the splits
//    sized so that the grid is about two blocks per SM (paged_attention.cu
//    plan(); 4 and more per SM measured slower) and each walks at least
//    four tiles; the partials are a few percent of the K/V bytes, and
//    combine_kernel reads a row's splits with independent loads.
// What clock64 probes and the SASS showed on the H100 (PERF.md, section 6):
// a tile's products and softmax first took 3,000-6,800 cycles a warp, since
// a branch on the head width sat between each ldmatrix and its product and
// each masked exp was a branch of its own; with every column computed (the
// tiles hold zeros past D), the exp taken before the mask's select and the
// accumulator rescaled only where a row's max moved (a warp vote) they take
// 1,000-1,350, and the int8 dequantize's conversion instructions (a quarter
// of the ALU rate) gave way to the exponent trick.
// The block's keys are [kmin, kmax]: from its first row's window (the
// entries the engine freed below it are never read) or its split's first
// page, to the last key its last row sees (causal, < lens); keys outside
// are never copied and always masked. A padding sequence (lens 0) reads
// nothing and writes zeros. Scores are q.k * scale, then the softcap
// c * tanh(s / c) (flash::cap_nb, as the wgmma tiles), then the ALiBi bias
// in the plain version's order (product, then sum, no fma), then the masks.
// No allocation and no host synchronisation: a launch can be captured in a
// CUDA graph.
#pragma once

#include "paged_attention.cuh"

namespace dstt {
namespace decode {

constexpr int kRows = 16;    // folded query rows of a block: one m16 tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 8;      // elements of padding per shared-memory row
// keys of a K/V tile, a quarter a warp: 64, and 32 at head width 256, where
// 64 would take the block's shared memory past half an SM's and leave one
// block (4 warps) on it (0.20 against 0.17 ms on Gemma-2's decode)
__host__ __device__ constexpr int keys(int dmax) { return dmax > 128 ? 32 : 64; }
// tiles in the ring: bf16 tiles; an int8 cache's code tiles (beside its two
// bf16 tiles, so a tile's codes land two tiles ahead of its compute)
template <bool kInt8>
__host__ __device__ constexpr int stages() { return kInt8 ? 2 : 3; }

// one bf16 K and V tile
template <int DMAX>
__host__ __device__ constexpr size_t tile_bytes() {
  return (size_t)2 * keys(DMAX) * (DMAX + kPad) * sizeof(__nv_bfloat16);
}

// one int8 K and V tile and its 2 * keys scales
template <int DMAX>
__host__ __device__ constexpr size_t code_bytes() {
  return (size_t)2 * keys(DMAX) * DMAX + 2 * keys(DMAX) * sizeof(float);
}

template <bool kInt8, int DMAX>
__host__ __device__ constexpr size_t ring_bytes() {
  return kInt8 ? stages<true>() * code_bytes<DMAX>() + 2 * tile_bytes<DMAX>()
               : stages<false>() * tile_bytes<DMAX>();
}

// the merge at the end reuses the ring: each warp's scaled accumulator,
// each warp's (max, sum) per row, the block's (max, sum) per row
template <int DMAX>
__host__ __device__ constexpr size_t merge_bytes() {
  return ((size_t)kWarps * kRows * DMAX + kWarps * kRows * 2 + kRows * 2) * sizeof(float);
}

template <bool kInt8, int DMAX>
constexpr size_t smem_bytes() {
  const size_t q = (size_t)kRows * (DMAX + kPad) * sizeof(__nv_bfloat16);
  return q + (ring_bytes<kInt8, DMAX>() > merge_bytes<DMAX>() ? ring_bytes<kInt8, DMAX>()
                                                                : merge_bytes<DMAX>());
}

// one block's view of its sequence, KV head and keys
template <typename C>
struct Block {
  const int* bt;      // this sequence's block-table row
  const C* kc;        // cache row 2 * layer at KV head h (the K plane)
  const C* vc;        // row 2 * layer + 1 (the V plane)
  const float* ksc;   // int8: the scales of K's plane at KV head h
  const float* vsc;   // of V's
  long long kvd;      // elements (int8: bytes) per slot of a plane
  int D, KV, ps, kmin, kmax;
  flash::FastDiv PS;

  __device__ __forceinline__ Block(const PagedArgs& a, int s, int h)
      : bt(a.block_table + (long long)s * a.B), kvd((long long)a.KV * a.D), D(a.D), KV(a.KV),
        ps(a.page_size), PS(a.page_size) {
    kc = reinterpret_cast<const C*>(a.cache) + 2LL * a.layer * a.slots * kvd + (long long)h * D;
    vc = kc + a.slots * kvd;
    ksc = a.cache_scales ? a.cache_scales + 2LL * a.layer * a.slots * a.KV + h : nullptr;
    vsc = ksc ? ksc + a.slots * a.KV : nullptr;
  }
  // the block-table entries of the pages of the tile at key k0, lane l
  // holding page PS(k0) + l's where that page holds keys of [kmin, kmax]
  // (one load a lane, issued a tile ahead of the copies that use it); with
  // pages under 4 keys a tile spans more pages than lanes, and slot() reads
  // the table itself
  __device__ __forceinline__ int pages(int k0, int lane) const {
    const int page = (int)PS(k0) + lane;
    return ps >= 4 && page >= (int)PS(kmin) && page <= (int)PS(kmax) ? bt[page] : 0;
  }
  // the slot of key `key` of the tile at k0 whose pages() are `ids`, -1
  // outside [kmin, kmax] (never copied); every lane calls it together
  __device__ __forceinline__ long long slot(int key, int k0, int ids) const {
    const bool valid = key >= kmin && key <= kmax;
    const int page = (int)PS(key);
    const int id = ps >= 4 ? __shfl_sync(0xffffffffu, ids, page - (int)PS(k0))
                           : (valid ? bt[page] : 0);
    return valid ? (long long)id * ps + (key - page * ps) : -1LL;
  }
};

// start copying the bf16 K and V rows of keys k0.. into a tile (row stride
// DMAX + kPad); rows outside [kmin, kmax] and columns past D are zeros
template <int DMAX>
__device__ __forceinline__ void copy_bf16(const Block<__nv_bfloat16>& b, __nv_bfloat16* Kt,
                                          int k0, int ids) {
  constexpr int DS = DMAX + kPad, CH = DMAX / 8, RP = kThreads / CH, KT = keys(DMAX);
  static_assert(KT % RP == 0, "the threads' row stride divides the tile");
  __nv_bfloat16* Vt = Kt + KT * DS;
  const int c = (threadIdx.x % CH) * 8, r0 = threadIdx.x / CH;
#pragma unroll
  for (int j = 0; j < KT / RP; ++j) {
    const int r = r0 + j * RP;
    const long long slot = b.slot(k0 + r, k0, ids);
    const bool valid = slot >= 0 && c < b.D;
    const long long off = valid ? slot * b.kvd + c : 0;
    flash::cp_async<16>(Kt + r * DS + c, b.kc + off, valid);
    flash::cp_async<16>(Vt + r * DS + c, b.vc + off, valid);
  }
}

// start copying the int8 codes of keys k0.. ([2][KT][DMAX] bytes, K then
// V) and, by the thread that copies a row's first chunk, the row's two
// scales ([2][KT] fp32 after the codes)
template <int DMAX>
__device__ __forceinline__ void copy_int8(const Block<int8_t>& b, unsigned char* codes, int k0,
                                          int ids) {
  constexpr int CH = DMAX / 16, RP = kThreads / CH, KT = keys(DMAX);
  static_assert(KT % RP == 0, "the threads' row stride divides the tile");
  float* sc = reinterpret_cast<float*>(codes + 2 * KT * DMAX);
  const int c = (threadIdx.x % CH) * 16, r0 = threadIdx.x / CH;
#pragma unroll
  for (int j = 0; j < KT / RP; ++j) {
    const int r = r0 + j * RP;
    const long long slot = b.slot(k0 + r, k0, ids);
    const bool valid = slot >= 0 && c < b.D;
    const long long off = valid ? slot * b.kvd + c : 0;
    flash::cp_async<16>(codes + r * DMAX + c, b.kc + off, valid);
    flash::cp_async<16>(codes + (KT + r) * DMAX + c, b.vc + off, valid);
    if (c == 0) {
      const long long si = slot >= 0 ? slot * b.KV : 0;
      flash::cp_async<4>(sc + r, b.ksc + si, slot >= 0);
      flash::cp_async<4>(sc + KT + r, b.vsc + si, slot >= 0);
    }
  }
}

// four int8 codes (one 32-bit word) times a bf16 scale pair, each product
// rounded to bf16 (bf16 multiplies: the exact product, rounded once, as
// dequant4's fp32 product and rounding): two words of bf16 pairs. The codes
// become floats without a conversion instruction (those run at a quarter
// of the ALU rate and held the int8 tiles back): byte u = code + 128 under
// the exponent of 2^23 is the float 2^23 + u, less 2^23 + 128 the code,
// whose upper half is its bf16 (a small integer, exact).
__device__ __forceinline__ uint2 dequant4_bf16x2(uint32_t w, __nv_bfloat162 scale) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    f[k] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + k)) - 8388736.f;
  uint32_t h[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const uint32_t pair =
        __byte_perm(__float_as_uint(f[2 * k]), __float_as_uint(f[2 * k + 1]), 0x7632);
    const __nv_bfloat162 v = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&pair), scale);
    h[k] = *reinterpret_cast<const uint32_t*>(&v);
  }
  return make_uint2(h[0], h[1]);
}

// the codes this thread copied, dequantized into the bf16 K and V tile:
// bf16(code) * bf16(scale), rounded to bf16; rows never copied are zero
// codes and scales
template <int DMAX>
__device__ __forceinline__ void dequant(const unsigned char* codes, __nv_bfloat16* Kt) {
  constexpr int DS = DMAX + kPad, CH = DMAX / 16, RP = kThreads / CH, KT = keys(DMAX);
  const float* sc = reinterpret_cast<const float*>(codes + 2 * KT * DMAX);
  const int c = (threadIdx.x % CH) * 16, r0 = threadIdx.x / CH;
#pragma unroll
  for (int j = 0; j < KT / RP; ++j) {
    const int r = r0 + j * RP;
#pragma unroll
    for (int kv = 0; kv < 2; ++kv) {
      const uint4 w = *reinterpret_cast<const uint4*>(codes + (kv * KT + r) * DMAX + c);
      const __nv_bfloat162 scale = __bfloat162bfloat162(__float2bfloat16(sc[kv * KT + r]));
      const uint2 a0 = dequant4_bf16x2(w.x, scale), a1 = dequant4_bf16x2(w.y, scale);
      const uint2 a2 = dequant4_bf16x2(w.z, scale), a3 = dequant4_bf16x2(w.w, scale);
      __nv_bfloat16* dst = Kt + (kv * KT + r) * DS + c;
      *reinterpret_cast<uint4*>(dst) = make_uint4(a0.x, a0.y, a1.x, a1.y);
      *reinterpret_cast<uint4*>(dst + 8) = make_uint4(a2.x, a2.y, a3.x, a3.y);
    }
  }
}

// two 8x8 b16 matrices (lanes 0-7 and 8-15 give the row addresses), each
// lane's two elements of each, transposed with kTrans (as ldmatrix_x4)
template <bool kTrans>
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  if (kTrans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(flash::smem_addr(p)));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(flash::smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// one warp's rows (lane/4 and lane/4 + 8 of the block's 16): position,
// whether the row exists, ALiBi slope; running max, this lane's share of
// the running sum, fp32 accumulator (m16n8 layout: n-tile t holds columns
// 8t + 2 (lane % 4) and +1 of both rows)
template <int DMAX>
struct Rows {
  int pos[2];
  bool real[2];
  float slope[2], m[2], l[2];
  float o[DMAX / 8][4];
};

// the scores, online softmax and P V of this warp's WK keys (16, or 8 at
// head width 256) of the tile at k0 (K rows at Kt, V rows KT rows after).
// With 8 keys the products take one 8-key n-tile for S (its 16-deep sums in
// two chains, even and odd steps) and the upper half of P V's 16-deep A
// operand is zero (its B rows never read: x2 loads). Every column to DMAX
// is computed (past D the tiles hold zeros): no branch between the loads
// and the products. The accumulator is rescaled only where a row's max
// moved (a warp vote), which most tiles of a long history skip.
template <int DMAX, bool kAlibi, bool kCap>
__device__ __forceinline__ void tile_step(const PagedArgs& a, Rows<DMAX>& R,
                                          const __nv_bfloat16* Qs, const __nv_bfloat16* Kt,
                                          int k0, int kmin, int kmax, int lane, int warp) {
  using T = __nv_bfloat16;
  constexpr int DS = DMAX + kPad, KT = keys(DMAX), WK = KT / kWarps, NT = WK / 8;
  const int r8 = lane & 7, hi = (lane >> 4) * 8, mid = ((lane >> 3) & 1) * 8;
  const T* Kw = Kt + warp * WK * DS;
  const T* Vw = Kt + (KT + warp * WK) * DS;
  float c[2][4];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DMAX; kk += 16) {
    uint32_t qa[4];
    flash::ldmatrix_x4<false>(qa, Qs + (lane & 15) * DS + kk + hi);
    if constexpr (NT == 2) {
      uint32_t kb[4];
      flash::ldmatrix_x4<false>(kb, Kw + (r8 + hi) * DS + kk + mid);
      flash::mma_16bit<T>(c[0], qa, kb[0], kb[1]);
      flash::mma_16bit<T>(c[1], qa, kb[2], kb[3]);
    } else {
      uint32_t kb[2];
      ldmatrix_x2<false>(kb, Kw + r8 * DS + kk + mid);
      flash::mma_16bit<T>(c[(kk >> 4) & 1], qa, kb[0], kb[1]);
    }
  }
  if constexpr (NT == 1) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[0][e] += c[1][e];
  }
  // scores: key WK warp + 8 n + 2 (lane % 4) + (e & 1) of row (lane / 4) + 8 (e >> 1)
  const int key0 = k0 + warp * WK + 2 * (lane & 3);
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1, key = key0 + 8 * n + (e & 1);
      float t;
      float v = flash::cap_nb<kCap>(c[n][e], a.scale, a.softcap, t);
      if constexpr (kAlibi) v = __fadd_rn(v, __fmul_rn(R.slope[i], (float)(key - R.pos[i])));
      const bool vis = R.real[i] & (key >= kmin) & (key <= kmax) & (key <= R.pos[i]) &
                       ((a.window <= 0) | (key > R.pos[i] - a.window));
      c[n][e] = vis ? v : kNegInf;
      mx[i] = fmaxf(mx[i], c[n][e]);
    }
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m_new = fmaxf(R.m[i], flash::row_max(mx[i]));
    alpha[i] = expf(R.m[i] - m_new);
    R.m[i] = m_new;
  }
  // a masked score is kNegInf, and exp(kNegInf - m) is 0 for any m the
  // row holds (kNegInf itself only where every key so far is masked: then
  // the score is not kept, below)
  float p[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = expf(c[n][e] - R.m[e >> 1]);
      p[n][e] = c[n][e] > kNegInf ? x : 0.f;
    }
  // the sum takes P unrounded (the JAX kernel's l_new); the product P
  // rounded to bf16 (its p.astype(v.dtype))
#pragma unroll
  for (int i = 0; i < 2; ++i)
    R.l[i] = alpha[i] * R.l[i] + ((p[0][2 * i] + p[0][2 * i + 1]) + (p[1][2 * i] + p[1][2 * i + 1]));
  const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                          pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
  if (__any_sync(0xffffffffu, (alpha[0] != 1.f) | (alpha[1] != 1.f))) {
#pragma unroll
    for (int t = 0; t < DMAX / 8; ++t) {
      R.o[t][0] *= alpha[0];
      R.o[t][1] *= alpha[0];
      R.o[t][2] *= alpha[1];
      R.o[t][3] *= alpha[1];
    }
  }
#pragma unroll
  for (int t = 0; t < DMAX / 8; t += 2) {
    if constexpr (NT == 2) {
      uint32_t vb[4];
      flash::ldmatrix_x4<true>(vb, Vw + (r8 + mid) * DS + t * 8 + hi);
      flash::mma_16bit<T>(R.o[t], pa, vb[0], vb[1]);
      flash::mma_16bit<T>(R.o[t + 1], pa, vb[2], vb[3]);
    } else {
      uint32_t vb[2];
      ldmatrix_x2<true>(vb, Vw + r8 * DS + t * 8 + mid);
      flash::mma_16bit<T>(R.o[t], pa, vb[0], 0u);
      flash::mma_16bit<T>(R.o[t + 1], pa, vb[1], 0u);
    }
  }
}

}  // namespace decode

// 16 folded query rows (n * G + g) of one (sequence, KV head) over one split
// of the sequence's pages; with splits > 1 the block writes its rows'
// (max, sum, fp32 accumulator) to the workspace for combine_kernel, as the
// other K4 kernels do
template <typename C, int DMAX, bool kAlibi, bool kCap>
__global__ void __launch_bounds__(decode::kThreads)
paged_decode_kernel(PagedArgs a) {
  using namespace decode;
  using T = __nv_bfloat16;
  constexpr bool kInt8 = std::is_same<C, int8_t>::value;
  constexpr int DS = DMAX + kPad, NS = stages<kInt8>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  unsigned char* ring = smem + (size_t)kRows * DS * sizeof(T);

  const int G = a.H / a.KV, rows = a.N * G, D = a.D, ps = a.page_size;
  const int tile = blockIdx.x / a.splits, split = blockIdx.x % a.splits;
  const int h = blockIdx.y, s = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = tile * kRows;
  const int seen = a.seen[s], hist = a.lens[s];

  // the block's query rows -> shared memory, zeros past the rows and past D
  {
    const T* q = reinterpret_cast<const T*>(a.q);
    constexpr int CH = DMAX / 8;
    for (int i = threadIdx.x; i < kRows * CH; i += kThreads) {
      const int rl = i / CH, c = (i % CH) * 8, r = row0 + rl;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows && c < D) {
        const int n = r / G, head = h * G + r % G;
        v = *reinterpret_cast<const uint4*>(q + ((long long)(s * a.N + n) * a.H + head) * D + c);
      }
      *reinterpret_cast<uint4*>(Qs + rl * DS + c) = v;
    }
  }

  // the block's keys: its rows' window (or the split's first page) to the
  // last key its last row sees
  Block<C> b(a, s, h);
  {
    const int n_first = row0 / G, n_last = (min(row0 + kRows, rows) - 1) / G;
    const int seq_first = a.window > 0 ? max(0, seen - a.window + 1) / ps : 0;
    const int kmin = a.window > 0 ? max(0, seen + n_first - a.window + 1) : 0;
    b.kmin = max(kmin, (seq_first + split * a.pages_per_split) * ps);
    b.kmax = min(min(hist - 1, seen + n_last),
                 min(a.B, seq_first + (split + 1) * a.pages_per_split) * ps - 1);
  }
  constexpr int KT = keys(DMAX);
  const int t_begin = b.kmin / KT;
  const int n_tiles = b.kmin <= b.kmax ? b.kmax / KT + 1 - t_begin : 0;

  Rows<DMAX> R;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + (lane >> 2) + 8 * i;
    R.real[i] = r < rows;
    R.pos[i] = seen + (R.real[i] ? r / G : 0);
    R.slope[i] = kAlibi && R.real[i] ? a.slopes[h * G + r % G] : 0.f;
    R.m[i] = kNegInf;
    R.l[i] = 0.f;
  }
#pragma unroll
  for (int t = 0; t < DMAX / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) R.o[t][e] = 0.f;

  if constexpr (!kInt8) {
    auto stage = [&](int i) { return reinterpret_cast<T*>(ring + (i % NS) * tile_bytes<DMAX>()); };
    // ids: the page ids of the next tile to copy, loaded a tile ahead
    int ids = n_tiles > 0 ? b.pages(t_begin * KT, lane) : 0;
#pragma unroll
    for (int i = 0; i < NS - 1; ++i) {
      const int next = i + 1 < n_tiles ? b.pages((t_begin + i + 1) * KT, lane) : 0;
      if (i < n_tiles) copy_bf16<DMAX>(b, stage(i), (t_begin + i) * KT, ids);
      flash::cp_async_commit();
      ids = next;
    }
    for (int i = 0; i < n_tiles; ++i) {
      flash::cp_async_wait<NS - 2>();  // this thread's copies of tile i
      __syncthreads();                 // everyone's; tile i - 1 consumed
      const int j = i + NS - 1;
      const int next = j + 1 < n_tiles ? b.pages((t_begin + j + 1) * KT, lane) : 0;
      if (j < n_tiles) copy_bf16<DMAX>(b, stage(j), (t_begin + j) * KT, ids);
      flash::cp_async_commit();
      ids = next;
      tile_step<DMAX, kAlibi, kCap>(a, R, Qs, stage(i), (t_begin + i) * KT, b.kmin, b.kmax,
                                    lane, warp);
    }
  } else {
    auto codes = [&](int i) { return ring + (i % NS) * code_bytes<DMAX>(); };
    auto bf16 = [&](int i) {
      return reinterpret_cast<T*>(ring + NS * code_bytes<DMAX>() + (i % 2) * tile_bytes<DMAX>());
    };
    int ids = n_tiles > 0 ? b.pages(t_begin * KT, lane) : 0;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int next = i + 1 < n_tiles ? b.pages((t_begin + i + 1) * KT, lane) : 0;
      if (i < n_tiles) copy_int8<DMAX>(b, codes(i), (t_begin + i) * KT, ids);
      flash::cp_async_commit();
      ids = next;
    }
    flash::cp_async_wait<NS - 1>();
    __syncthreads();  // tile 0's codes and scales, everyone's
    if (n_tiles > 0) dequant<DMAX>(codes(0), bf16(0));
    for (int i = 0; i < n_tiles; ++i) {
      flash::cp_async_wait<NS - 2>();  // tile i + 1's codes
      __syncthreads();  // ... everyone's; tile i's bf16 written; tile i - 1 consumed
      if (i + 1 < n_tiles) dequant<DMAX>(codes(i + 1), bf16(i + 1));
      const int j = i + NS;
      const int next = j + 1 < n_tiles ? b.pages((t_begin + j + 1) * KT, lane) : 0;
      if (j < n_tiles) copy_int8<DMAX>(b, codes(j), (t_begin + j) * KT, ids);
      flash::cp_async_commit();
      ids = next;
      tile_step<DMAX, kAlibi, kCap>(a, R, Qs, bf16(i), (t_begin + i) * KT, b.kmin, b.kmax,
                                    lane, warp);
    }
  }
  flash::cp_async_wait<0>();
  __syncthreads();  // every warp done with the ring: it becomes the merge area

  // merge the four warps' rows: the common max, each accumulator scaled to
  // it, summed in warp order
  float* red = reinterpret_cast<float*>(ring);  // [kWarps][kRows][DMAX]
  float* wml = red + kWarps * kRows * DMAX;     // [kWarps][kRows] (max, sum)
  float* bml = wml + kWarps * kRows * 2;        // [kRows] (max, sum)
  const int g = lane >> 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lsum = flash::row_sum(R.l[i]);
    if ((lane & 3) == 0) {
      wml[(warp * kRows + g + 8 * i) * 2] = R.m[i];
      wml[(warp * kRows + g + 8 * i) * 2 + 1] = lsum;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = g + 8 * i;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wml[(w * kRows + row) * 2]);
    const float f = expf(R.m[i] - M);
    float* dst = red + (warp * kRows + row) * DMAX + 2 * (lane & 3);
#pragma unroll
    for (int t = 0; t < DMAX / 8; ++t)
      *reinterpret_cast<float2*>(dst + 8 * t) = make_float2(R.o[t][2 * i] * f, R.o[t][2 * i + 1] * f);
  }
  if (threadIdx.x < kRows) {
    const int row = threadIdx.x;
    float M = kNegInf, L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wml[(w * kRows + row) * 2]);
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      L += wml[(w * kRows + row) * 2 + 1] * expf(wml[(w * kRows + row) * 2] - M);
    bml[2 * row] = M;
    bml[2 * row + 1] = L;
  }
  __syncthreads();
  const int n_rows = min(kRows, rows - row0);
  for (int idx = threadIdx.x; idx < n_rows * DMAX; idx += kThreads) {
    const int rl = idx / DMAX, d = idx % DMAX, r = row0 + rl;
    if (d >= D) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red[(w * kRows + rl) * DMAX + d];
    const float L = bml[2 * rl + 1];
    if (a.splits > 1) {
      const size_t part = (((size_t)s * a.KV + h) * rows + r) * a.splits + split;
      if (L > 0.f) a.ws_acc[part * D + d] = sum;  // combine_kernel reads no empty split
      if (d == 0) {
        a.ws_ml[2 * part] = bml[2 * rl];
        a.ws_ml[2 * part + 1] = L;
      }
    } else {
      const int n = r / G, head = h * G + r % G;
      reinterpret_cast<T*>(a.out)[((long long)(s * a.N + n) * a.H + head) * D + d] =
          __float2bfloat16(L > 0.f ? sum / L : 0.f);
    }
  }
}

template <typename C, int DMAX>
constexpr size_t paged_decode_smem() {
  return decode::smem_bytes<std::is_same<C, int8_t>::value, DMAX>();
}

template <typename C, int DMAX, bool kAlibi, bool kCap>
cudaError_t launch_paged_decode_inst(const PagedArgs& a, cudaStream_t stream) {
  auto kern = paged_decode_kernel<C, DMAX, kAlibi, kCap>;
  constexpr size_t smem = paged_decode_smem<C, DMAX>();
  static_assert(smem <= 232448, "one block's shared memory on the H100");
  static bool ready[64] = {};
  cudaError_t e = allow_smem(kern, smem, ready);
  if (e != cudaSuccess) return e;
  const int rows = a.N * (a.H / a.KV);
  const dim3 grid((rows + decode::kRows - 1) / decode::kRows * a.splits, a.KV, a.S);
  kern<<<grid, decode::kThreads, smem, stream>>>(a);
  if (a.splits > 1)
    combine_kernel<__nv_bfloat16><<<dim3(rows, a.KV, a.S), kAttnThreads, 0, stream>>>(a);
  return cudaSuccess;
}

// The decode instances over one cache type at one head width (ALiBi and the
// softcap as template flags), each (cache, widths) compiled in a source of
// its own (paged_decode_{bf16,int8}{,_d256}.cu)
template <typename C, int DMAX>
cudaError_t launch_paged_decode(const PagedArgs& a, cudaStream_t stream) {
  const bool cap = a.softcap > 0.f;
  if (a.slopes)
    return cap ? launch_paged_decode_inst<C, DMAX, true, true>(a, stream)
               : launch_paged_decode_inst<C, DMAX, true, false>(a, stream);
  return cap ? launch_paged_decode_inst<C, DMAX, false, true>(a, stream)
             : launch_paged_decode_inst<C, DMAX, false, false>(a, stream);
}

extern template cudaError_t launch_paged_decode<__nv_bfloat16, 64>(const PagedArgs&,
                                                                   cudaStream_t);
extern template cudaError_t launch_paged_decode<__nv_bfloat16, 128>(const PagedArgs&,
                                                                    cudaStream_t);
extern template cudaError_t launch_paged_decode<__nv_bfloat16, 256>(const PagedArgs&,
                                                                    cudaStream_t);
extern template cudaError_t launch_paged_decode<int8_t, 64>(const PagedArgs&, cudaStream_t);
extern template cudaError_t launch_paged_decode<int8_t, 128>(const PagedArgs&, cudaStream_t);
extern template cudaError_t launch_paged_decode<int8_t, 256>(const PagedArgs&, cudaStream_t);

}  // namespace dstt
