// K4's fp32-query kernels on Hopper: fp32 queries over an fp32 or int8
// paged cache, head widths D % 4 == 0 up to 256, any page size up to 128.
//
// Replace the TPU kernel deepspeed_tpu/ops/paged_attention.py:60
// _paged_attn_kernel (driven by paged_attention :166) for fp32 queries: they
// compute that kernel's function (inputs, causal and lens masks, the window
// and its page skip :87-90 / :105-106, the softcap before the bias and the
// masks :122-124, ALiBi :125-131, the int8 branch :111-117, a row that sees
// no key gives 0), not its grid. paged_attention.cuh holds the arguments and
// the kernels for bf16 queries; paged_attention.cu's plan() picks among all
// of them.
//
// Numerics. fp32 over an fp32 cache stays fp32 on the CUDA cores (FFMA):
// P stays fp32, as the JAX kernel's p.astype(v.dtype) keeps it; TF32 on the
// tensor cores would round the operands to 10 mantissa bits. Over an int8
// cache the K/V values are staged as the TPU kernel feeds its dots (the
// scale rounded to bf16, each product bf16(code) * bf16(scale) rounded to
// bf16), held here as fp32; P is rounded to bf16 before P V against the
// running max, and its unrounded value goes into the row's sum. The running
// max of a row steps once per key tile (the max over the tile's keys),
// where the JAX kernel steps once per page: paged_attention_reference(...,
// round_p=True, split_pages=..., tile_keys=...) follows the kernels' steps
// (kernel_plan names them).
//
// What held the CUDA-core kernel (paged_attention_kernel) back on these
// shapes, and what the two kernels here do about it:
// 1. A chunk took 16 folded rows a block, so every K/V page was staged again
//    for every 16 rows (96 blocks per KV head on Gemma-2's 768-token chunk),
//    and a decode step with G 2 left two of four warps idle.
// 2. About one shared-memory load per FMA: one lane per key with a serial
//    D-long dot product, one lane per output dim for P V.
// 3. Each page was staged by plain loads between two barriers, so every
//    page paid the full memory latency.
// 4. Splits sized to ~16 blocks per SM made the fp32 partials heavy.
//
// The chunk kernel (paged_f32_chunk_kernel), from f32::kChunkMinRows (33)
// folded rows: bound by operations on the CUDA cores (67 TFLOP/s fp32; Gemma-2's
// 768-row chunk at ~3700 deep does ~5e10 flops, 0.77 ms). One block of 256
// threads per (64 folded rows, KV head, sequence, split), the Q tile in
// shared memory (rows padded by 16 bytes). Over an fp32 cache, 64-key tiles
// through one K and one V buffer (sweep_staggered): V(i) is copied under
// S = Q K(i)^T, K(i + 1) under P V(i), two barriers a tile, 16-byte
// cp.async rows gathered through the block table (each key's slot found
// once a tile, from page ids loaded a tile ahead); over an int8 cache
// 32-key tiles, their codes through a 2-stage ring and dequantized into one
// fp32 tile. The products are register-blocked as in an SGEMM, each warp
// owning 8 rows: for S each lane holds a 4-row x 4-key micro-tile (2 x 2
// over int8) and reads float4s of Q and K, 64 FMAs per 8 loads
// (kRowGroups); for P V each
// lane owns the warp's 8 rows x 8 dims of the accumulator (64 registers at
// head width 256) and reads P (through the warp's own slice of shared
// memory, no block barrier) and V as float4s, 64 FMAs per 4 loads. A row's
// running max and sum are shared by the 16 lanes that hold it through
// shuffles; the accumulator is rescaled only where a row's max moved. The
// keys run over [kmin, kmax]: from the window of the block's first row
// (pages the engine freed below it are never read) or its split's first
// page, to the last key its last row sees; masks are applied by select.
// Shared memory at head width 256: the Q tile (66.5 KB), a 64-key K and V
// (129 KB) and the warps' P (16 KB): one block an SM, so plan() splits the
// pages where that fills the card's waves better (wave_splits).
//
// The decode kernel (paged_f32_decode_kernel), under kChunkMinRows rows:
// bound by bytes (a decode row meets each key once: 2 flops per 4 bytes of
// K or V). paged_decode.cuh's structure in fp32: one block of 4 warps per
// (RB folded rows, KV head, sequence, split), RB an instance's own (2 at
// head width 256 and 4 below, a decode step of G 2 or 4; else 8 and 16),
// every row loop unrolled and unguarded (rows past the real ones are zero
// queries, masked; 16-row blocks whose loops skipped the unreal rows took
// Llama's fp32 decode over int8 0.0591 ms, these 0.0281, PERF.md section
// 6); the 4 warps split every key tile (16 keys at width
// 256, 32 below), a warp's lanes splitting its keys' dot products by dims
// (partials added by shuffles) and its P V by dims; a 3-stage cp.async ring
// (int8: 3 code stages, each tile dequantized a tile ahead into one of two
// fp32 tiles, one barrier a tile); over an fp32 cache each warp keeps its
// own running max and the block merges them at the end, over an int8 cache
// the warps take the block's max of each tile through shared memory (a
// second barrier a tile), so that P rounds as the chunk kernel rounds it;
// splits sized to about kDecBlocksPerSM blocks per SM with at least four
// tiles each (plan()), merged by combine_kernel.
//
// Both: a padding sequence (lens 0) reads nothing and writes zeros. No
// allocation and no host synchronisation: a launch can be captured in a
// CUDA graph.
#pragma once

#include "paged_decode.cuh"

namespace dstt {
namespace f32 {

constexpr int kKPad = 4;  // floats of padding per K row in shared memory

constexpr int kChunkWarps = 8;
constexpr int kChunkThreads = 32 * kChunkWarps;
constexpr int kChunkRowsPerWarp = 8;
constexpr int kChunkRows = kChunkWarps * kChunkRowsPerWarp;  // folded rows of a block
// the warps' score layout: lane (ty, tx) holds rows ty + kRowGroups i of
// its warp's 8 and keys tx + (32 / kRowGroups) j of the tile (1 row
// group, an 8 x 2 micro-tile, measured 7% slower: the loads a lane issues
// per FMA set the pace, not the bytes they share)
constexpr int kRowGroups = 2;
// keys of a chunk K/V tile: 64 over an fp32 cache (single K and V buffers,
// each copied under the other's products), 32 over an int8 cache (a ring
// of code tiles beside one fp32 tile)
__host__ __device__ constexpr int chunk_keys(bool int8) { return int8 ? 32 : 64; }

constexpr int kDecWarps = 4;
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kDecStages = 3;
// the fp32 decode grid's target: blocks per SM over all splits
constexpr int kDecBlocksPerSM = 2;
// keys of a decode tile: 16 at head width 256, 32 below
__host__ __device__ constexpr int dec_keys(int dmax) { return dmax > 128 ? 16 : 32; }
// folded rows of a decode block, an instance's own (every row loop is
// unrolled and unguarded): 2 at head width 256 and 4 below (a decode step
// of G 2 or 4), else 8 and 16 (64 accumulator registers a lane)
__host__ __device__ constexpr int dec_rows_small(int dmax) { return dmax > 128 ? 2 : 4; }
__host__ __device__ constexpr int dec_rows_large(int dmax) { return dmax > 128 ? 8 : 16; }
__host__ __device__ constexpr int dec_rows(int dmax, int rows) {
  return rows <= dec_rows_small(dmax) ? dec_rows_small(dmax) : dec_rows_large(dmax);
}

// folded rows N * G per (sequence, KV head) from which plan() takes the
// chunk kernel, below which the decode kernel, which reads every K/V tile
// once per dec_rows(D, rows) rows: measured on the H100 (chip_smoke.py's
// fp32 crossover sweep, PERF.md section 6), the decode kernel wins up to
// 32 rows at G 2 (D 256: 4 blocks of 8 rows, 0.54 against 0.67 ms) and G 4
// (D 128: 2 blocks of 16, 0.069 against 0.089), the chunk kernel from 40
// and 48 (5 and 3 decode blocks)
constexpr int kChunkMinRows = 33;

// one fp32 K tile of KT keys (rows padded by kKPad floats) and its V tile
template <int DMAX, int KT>
__host__ __device__ constexpr size_t tile_bytes() {
  return (size_t)KT * (2 * DMAX + kKPad) * sizeof(float);
}

// one int8 tile: [2][KT][DMAX] codes (K, then V) and [2][KT] fp32 scales
template <int DMAX, int KT>
__host__ __device__ constexpr size_t code_bytes() {
  return (size_t)2 * KT * DMAX + 2 * KT * sizeof(float);
}

// start copying one plane (K or V) of a tile's rows into a tile of row
// stride RS floats, row r from slot slots[r] (-1: zeros, as are the columns
// past D)
template <int DMAX, int KT, int NT, int RS>
__device__ __forceinline__ void copy_rows(const decode::Block<float>& b, float* dst,
                                          const float* plane, const long long* slots) {
  constexpr int CH = DMAX / 4, RP = NT / CH;
  static_assert(KT % RP == 0, "the threads' row stride divides the tile");
  const int c = (threadIdx.x % CH) * 4, r0 = threadIdx.x / CH;
#pragma unroll
  for (int j = 0; j < KT / RP; ++j) {
    const int r = r0 + j * RP;
    const long long slot = slots[r];
    const bool valid = slot >= 0 && c < b.D;
    flash::cp_async<16>(dst + r * RS + c, plane + (valid ? slot * b.kvd + c : 0), valid);
  }
}

// start copying the fp32 K and V rows of keys k0.. into a tile (K rows
// DMAX + kKPad apart, V rows DMAX, after the K tile), each row's slot found
// once for both
template <int DMAX, int KT, int NT>
__device__ __forceinline__ void copy_f32(const decode::Block<float>& b, float* Kt, int k0,
                                         int ids) {
  constexpr int KS = DMAX + kKPad, CH = DMAX / 4, RP = NT / CH;
  static_assert(KT % RP == 0, "the threads' row stride divides the tile");
  float* Vt = Kt + KT * KS;
  const int c = (threadIdx.x % CH) * 4, r0 = threadIdx.x / CH;
#pragma unroll
  for (int j = 0; j < KT / RP; ++j) {
    const int r = r0 + j * RP;
    const long long slot = b.slot(k0 + r, k0, ids);
    const bool valid = slot >= 0 && c < b.D;
    const long long off = valid ? slot * b.kvd + c : 0;
    flash::cp_async<16>(Kt + r * KS + c, b.kc + off, valid);
    flash::cp_async<16>(Vt + r * DMAX + c, b.vc + off, valid);
  }
}

// start copying the int8 codes of keys k0.. ([2][KT][DMAX] bytes) and each
// row's two scales ([2][KT] fp32 after the codes), CB bytes a copy
template <int DMAX, int KT, int NT, int CB>
__device__ __forceinline__ void copy_codes_by(const decode::Block<int8_t>& b,
                                              unsigned char* codes, int k0, int ids) {
  constexpr int CH = DMAX / CB, RP = NT / CH;
  static_assert(KT % RP == 0, "the threads' row stride divides the tile");
  float* sc = reinterpret_cast<float*>(codes + 2 * KT * DMAX);
  const int c = (threadIdx.x % CH) * CB, r0 = threadIdx.x / CH;
#pragma unroll
  for (int j = 0; j < KT / RP; ++j) {
    const int r = r0 + j * RP;
    const long long slot = b.slot(k0 + r, k0, ids);
    const bool valid = slot >= 0 && c < b.D;
    const long long off = valid ? slot * b.kvd + c : 0;
    flash::cp_async<CB>(codes + r * DMAX + c, b.kc + off, valid);
    flash::cp_async<CB>(codes + (KT + r) * DMAX + c, b.vc + off, valid);
    if (c == 0) {
      const long long si = slot >= 0 ? slot * b.KV : 0;
      flash::cp_async<4>(sc + r, b.ksc + si, slot >= 0);
      flash::cp_async<4>(sc + KT + r, b.vsc + si, slot >= 0);
    }
  }
}

template <int DMAX, int KT, int NT>
__device__ __forceinline__ void copy_codes(const decode::Block<int8_t>& b,
                                           unsigned char* codes, int k0, int ids) {
  if (b.D % 16 == 0)
    copy_codes_by<DMAX, KT, NT, 16>(b, codes, k0, ids);
  else
    copy_codes_by<DMAX, KT, NT, 4>(b, codes, k0, ids);
}

// a tile's codes dequantized into the fp32 K and V tiles with the TPU
// kernel's numerics (the scale rounded to bf16, each product rounded to
// bf16: decode::dequant4_bf16x2, the codes made floats without a
// conversion instruction); rows never copied are zero codes and scales
template <int DMAX, int KT, int NT>
__device__ __forceinline__ void dequant_f32(const unsigned char* codes, float* Kt) {
  constexpr int KS = DMAX + kKPad, W = DMAX / 4;
  const float* sc = reinterpret_cast<const float*>(codes + 2 * KT * DMAX);
  float* Vt = Kt + KT * KS;
#pragma unroll 4
  for (int i = threadIdx.x; i < 2 * KT * W; i += NT) {
    const int row = i / W, w = i - row * W;  // row: K rows, then V rows
    const uint32_t word = *reinterpret_cast<const uint32_t*>(codes + row * DMAX + 4 * w);
    const uint2 d =
        decode::dequant4_bf16x2(word, __bfloat162bfloat162(__float2bfloat16(sc[row])));
    const float4 f = make_float4(__uint_as_float(d.x << 16), __uint_as_float(d.x & 0xffff0000u),
                                 __uint_as_float(d.y << 16), __uint_as_float(d.y & 0xffff0000u));
    float* dst = row < KT ? Kt + row * KS : Vt + (row - KT) * DMAX;
    *reinterpret_cast<float4*>(dst + 4 * w) = f;
  }
}

// The tiles [t_begin, t_begin + n) of a block's keys through a ring, each
// handed to step(K tile, V tile, first key) once it has landed (the V tile
// KT rows of DMAX + kKPad floats after the K tile).
// An fp32 cache: NS fp32 stages, copies NS - 1 tiles ahead, one barrier a
// tile. An int8 cache: NS code stages, codes NS - 1 tiles ahead; with NF 2
// fp32 tiles each tile's codes are dequantized a tile ahead, after the
// barrier that lands them, one barrier a tile; with NF 1, after the barrier
// that lands them and before a second one.
template <typename C, int DMAX, int KT, int NT, int NS, int NF, typename Step>
__device__ __forceinline__ void sweep_ring(const decode::Block<C>& b, unsigned char* ring,
                                           int t_begin, int n, Step&& step) {
  constexpr int KS = DMAX + kKPad;
  const int lane = threadIdx.x & 31;
  int ids = n > 0 ? b.pages(t_begin * KT, lane) : 0;
  if constexpr (!std::is_same<C, int8_t>::value) {
    auto stage = [&](int i) {
      return reinterpret_cast<float*>(ring + (i % NS) * tile_bytes<DMAX, KT>());
    };
    auto copy = [&](int i) { copy_f32<DMAX, KT, NT>(b, stage(i), (t_begin + i) * KT, ids); };
#pragma unroll
    for (int i = 0; i < NS - 1; ++i) {
      const int next = i + 1 < n ? b.pages((t_begin + i + 1) * KT, lane) : 0;
      if (i < n) copy(i);
      flash::cp_async_commit();
      ids = next;
    }
    for (int i = 0; i < n; ++i) {
      flash::cp_async_wait<NS - 2>();  // this thread's copies of tile i
      __syncthreads();                 // everyone's; tile i - 1 consumed
      const int j = i + NS - 1;
      const int next = j + 1 < n ? b.pages((t_begin + j + 1) * KT, lane) : 0;
      if (j < n) copy(j);
      flash::cp_async_commit();
      ids = next;
      const float* Kt = stage(i);
      step(Kt, Kt + KT * KS, (t_begin + i) * KT);
    }
  } else if constexpr (NF == 2) {
    auto codes = [&](int i) { return ring + (i % NS) * code_bytes<DMAX, KT>(); };
    auto tile = [&](int i) {
      return reinterpret_cast<float*>(ring + NS * code_bytes<DMAX, KT>() +
                                      (i % 2) * tile_bytes<DMAX, KT>());
    };
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int next = i + 1 < n ? b.pages((t_begin + i + 1) * KT, lane) : 0;
      if (i < n) copy_codes<DMAX, KT, NT>(b, codes(i), (t_begin + i) * KT, ids);
      flash::cp_async_commit();
      ids = next;
    }
    flash::cp_async_wait<NS - 1>();
    __syncthreads();  // tile 0's codes and scales, everyone's
    if (n > 0) dequant_f32<DMAX, KT, NT>(codes(0), tile(0));
    for (int i = 0; i < n; ++i) {
      flash::cp_async_wait<NS - 2>();  // tile i + 1's codes
      __syncthreads();  // ... everyone's; tile i dequantized; tile i - 1 consumed
      if (i + 1 < n) dequant_f32<DMAX, KT, NT>(codes(i + 1), tile(i + 1));
      const int j = i + NS;
      const int next = j + 1 < n ? b.pages((t_begin + j + 1) * KT, lane) : 0;
      if (j < n) copy_codes<DMAX, KT, NT>(b, codes(j), (t_begin + j) * KT, ids);
      flash::cp_async_commit();
      ids = next;
      const float* Kt = tile(i);
      step(Kt, Kt + KT * KS, (t_begin + i) * KT);
    }
  } else {
    auto codes = [&](int i) { return ring + (i % NS) * code_bytes<DMAX, KT>(); };
    float* tile = reinterpret_cast<float*>(ring + NS * code_bytes<DMAX, KT>());
#pragma unroll
    for (int i = 0; i < NS - 1; ++i) {
      const int next = i + 1 < n ? b.pages((t_begin + i + 1) * KT, lane) : 0;
      if (i < n) copy_codes<DMAX, KT, NT>(b, codes(i), (t_begin + i) * KT, ids);
      flash::cp_async_commit();
      ids = next;
    }
    for (int i = 0; i < n; ++i) {
      // the stage of tile i - 1's codes, dequantized before the last barrier
      const int j = i + NS - 1;
      const int next = j + 1 < n ? b.pages((t_begin + j + 1) * KT, lane) : 0;
      if (j < n) copy_codes<DMAX, KT, NT>(b, codes(j), (t_begin + j) * KT, ids);
      flash::cp_async_commit();
      ids = next;
      flash::cp_async_wait<NS - 1>();  // this thread's copies of tile i
      __syncthreads();                 // everyone's; the fp32 tile consumed
      dequant_f32<DMAX, KT, NT>(codes(i), tile);
      __syncthreads();
      step(tile, tile + KT * KS, (t_begin + i) * KT);
    }
  }
  flash::cp_async_wait<0>();
}

// The tiles [t_begin, t_begin + n) of an fp32 cache through one K and one
// V buffer, each copied under the other's products: V(i) lands while
// qk(K buffer, first key) runs on K(i), K(i + 1) while pv(V buffer) runs
// on V(i); two barriers a tile. The slots of a tile's keys ([2][KT], by
// tile parity) are found once, one a thread, their page ids loaded a tile
// ahead, and read by every copy of both planes.
template <int DMAX, int KT, int NT, typename QK, typename PV>
__device__ __forceinline__ void sweep_staggered(const decode::Block<float>& b, float* Kb,
                                                float* Vb, long long* slots, int t_begin,
                                                int n, QK&& qk, PV&& pv) {
  static_assert(KT <= NT, "a thread per key of a tile");
  constexpr int KS = DMAX + kKPad;
  const int t = threadIdx.x;
  // this thread's key of the tile at k0: its page id, and its slot from it
  auto page_id = [&](int k0) {
    const int key = k0 + t;
    return t < KT && key >= b.kmin && key <= b.kmax ? b.bt[(int)b.PS(key)] : 0;
  };
  auto put_slot = [&](long long* tab, int k0, int id) {
    const int key = k0 + t;
    if (t < KT)
      tab[t] = key >= b.kmin && key <= b.kmax
                   ? (long long)id * b.ps + (key - (int)b.PS(key) * b.ps) : -1LL;
  };
  if (n > 0) put_slot(slots, t_begin * KT, page_id(t_begin * KT));
  __syncthreads();
  if (n > 0) copy_rows<DMAX, KT, NT, KS>(b, Kb, b.kc, slots);
  flash::cp_async_commit();
  for (int i = 0; i < n; ++i) {
    const int k0 = (t_begin + i) * KT;
    const int next = i + 1 < n ? page_id(k0 + KT) : 0;
    flash::cp_async_wait<0>();  // this thread's copies of K(i)
    __syncthreads();            // everyone's; V(i - 1) consumed
    copy_rows<DMAX, KT, NT, DMAX>(b, Vb, b.vc, slots + (i & 1) * KT);
    flash::cp_async_commit();
    qk(static_cast<const float*>(Kb), k0);
    if (i + 1 < n) put_slot(slots + ((i + 1) & 1) * KT, k0 + KT, next);
    flash::cp_async_wait<0>();  // this thread's copies of V(i)
    __syncthreads();            // everyone's; K(i) consumed; the next slots
    if (i + 1 < n) copy_rows<DMAX, KT, NT, KS>(b, Kb, b.kc, slots + ((i + 1) & 1) * KT);
    flash::cp_async_commit();
    pv(static_cast<const float*>(Vb));
  }
  flash::cp_async_wait<0>();
}

// a score of key `key` for the row at position `pos`: q.k * scale, the
// softcap (flash::cap_nb), the ALiBi bias in the plain version's order
// (product, then sum, no fma), then the masks by select
template <bool kAlibi, bool kCap>
__device__ __forceinline__ float score(const PagedArgs& a, float qk, float slope, int pos,
                                       int key, int kmin, int kmax, bool real) {
  float t;
  float v = flash::cap_nb<kCap>(qk, a.scale, a.softcap, t);
  if constexpr (kAlibi) v = __fadd_rn(v, __fmul_rn(slope, (float)(key - pos)));
  const bool vis = real & (key >= kmin) & (key <= kmax) & (key <= pos) &
                   ((a.window <= 0) | (key > pos - a.window));
  return vis ? v : kNegInf;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// the block's keys: from its first row's window (or its split's first
// page) to the last key its last row sees (or its split's last page)
template <typename C>
__device__ __forceinline__ void key_range(const PagedArgs& a, decode::Block<C>& b, int seen,
                                          int hist, int n_first, int n_last, int split) {
  const int ps = a.page_size;
  const int seq_first = a.window > 0 ? max(0, seen - a.window + 1) / ps : 0;
  const int kmin = a.window > 0 ? max(0, seen + n_first - a.window + 1) : 0;
  b.kmin = max(kmin, (seq_first + split * a.pages_per_split) * ps);
  b.kmax = min(min(hist - 1, seen + n_last),
               min(a.B, seq_first + (split + 1) * a.pages_per_split) * ps - 1);
}

// `rows` query rows of (sequence s, KV head h) from folded row row0 into a
// [rows][QS] fp32 tile, zeros past the rows and past D
template <int DMAX, int QS, int NT>
__device__ __forceinline__ void load_q(const PagedArgs& a, float* Qs, int rows, int s, int h,
                                       int row0) {
  const int G = a.H / a.KV, all = a.N * G, D = a.D;
  const float* q = reinterpret_cast<const float*>(a.q);
  constexpr int CH = DMAX / 4;
  for (int i = threadIdx.x; i < rows * CH; i += NT) {
    const int rl = i / CH, c = (i - rl * CH) * 4, f = row0 + rl;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (f < all && c < D) {
      const int n = f / G, head = h * G + f - n * G;
      v = *reinterpret_cast<const float4*>(q + ((long long)(s * a.N + n) * a.H + head) * D + c);
    }
    *reinterpret_cast<float4*>(Qs + rl * QS + c) = v;
  }
}

// one row's result: with splits, its (max, sum) and, where it saw a key,
// its fp32 accumulator columns c.. (float4) into the workspace; else the
// accumulator over the sum (0 where it saw none) into the output
__device__ __forceinline__ void store_row(const PagedArgs& a, int s, int h, int f, int split,
                                          int c, float4 acc, float M, float L, bool ml) {
  const int G = a.H / a.KV, rows = a.N * G, D = a.D;
  if (c >= D) return;
  if (a.splits > 1) {
    const size_t part = (((size_t)s * a.KV + h) * rows + f) * a.splits + split;
    if (L > 0.f) *reinterpret_cast<float4*>(a.ws_acc + part * D + c) = acc;
    if (ml) {
      a.ws_ml[2 * part] = L > 0.f ? M : kNegInf;
      a.ws_ml[2 * part + 1] = L;
    }
    return;
  }
  const int n = f / G, head = h * G + f - n * G;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  if (L > 0.f) o = make_float4(acc.x / L, acc.y / L, acc.z / L, acc.w / L);
  *reinterpret_cast<float4*>(reinterpret_cast<float*>(a.out) +
                             ((long long)(s * a.N + n) * a.H + head) * D + c) = o;
}

template <bool kInt8, int DMAX>
__host__ __device__ constexpr size_t chunk_smem() {
  constexpr int KT = chunk_keys(kInt8);
  return (size_t)kChunkRows * (DMAX + kKPad) * sizeof(float)       // Q tile
         + (size_t)kChunkWarps * KT * kChunkRowsPerWarp * 4       // P, per warp
         + (size_t)kChunkWarps * 2 * kChunkRowsPerWarp * 4        // alpha / (m, l)
         + (kInt8 ? 2 * code_bytes<DMAX, KT>() + tile_bytes<DMAX, KT>()
                  : tile_bytes<DMAX, KT>() + 2 * KT * sizeof(long long));
}

template <bool kInt8, int DMAX, int RB>
__host__ __device__ constexpr size_t decode_smem() {
  constexpr int KT = dec_keys(DMAX), NS = kDecStages;
  constexpr size_t ring = kInt8 ? NS * code_bytes<DMAX, KT>() + 2 * tile_bytes<DMAX, KT>()
                                : NS * tile_bytes<DMAX, KT>();
  constexpr size_t merge = ((size_t)kDecWarps * RB * DMAX + 2 * kDecWarps * RB) * 4;
  return (size_t)RB * DMAX * 4 + 2 * kDecWarps * RB * 4 + (ring > merge ? ring : merge);
}

}  // namespace f32

// 64 folded query rows (n * G + g) of one (sequence, KV head) over one
// split of the sequence's pages (f32 namespace note); the row tiles run
// last-first (later rows see more keys)
template <typename C, int DMAX, bool kAlibi, bool kCap>
__global__ void __launch_bounds__(f32::kChunkThreads, 1)
paged_f32_chunk_kernel(PagedArgs a) {
  using namespace f32;
  constexpr bool kInt8 = std::is_same<C, int8_t>::value;
  constexpr int RW = kChunkRowsPerWarp, BM = kChunkRows, KT = chunk_keys(kInt8);
  constexpr int QS = DMAX + kKPad, KS = DMAX + kKPad;
  // scores: lane (ty, tx) holds rows ty + RG i of its warp's RW and keys
  // tx + KG j of the tile
  constexpr int RG = kRowGroups, KG = 32 / RG;
  constexpr int SR = RW / RG, SK = KT / KG, NU = DMAX / 128;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);         // [BM][QS]
  float* Pall = Qs + BM * QS;                         // [warps][KT][RW]
  float* Rall = Pall + kChunkWarps * KT * RW;         // [warps][2][RW]
  unsigned char* tiles = reinterpret_cast<unsigned char*>(Rall + kChunkWarps * 2 * RW);

  const int G = a.H / a.KV, rows = a.N * G;
  const int n_row_tiles = (int)gridDim.x / a.splits;
  const int tile = n_row_tiles - 1 - (int)blockIdx.x / a.splits;
  const int split = (int)blockIdx.x % a.splits;
  const int h = blockIdx.y, s = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ty = lane / KG, tx = lane % KG;
  const int row0 = tile * BM;
  const int seen = a.seen[s], hist = a.lens[s];

  load_q<DMAX, QS, kChunkThreads>(a, Qs, BM, s, h, row0);
  decode::Block<C> b(a, s, h);
  key_range(a, b, seen, hist, row0 / G, (min(row0 + BM, rows) - 1) / G, split);
  const int t_begin = b.kmin / KT;
  const int n_tiles = b.kmin <= b.kmax ? b.kmax / KT + 1 - t_begin : 0;

  int pos[SR];
  bool real[SR];
  float slope[SR], m[SR], l[SR];
#pragma unroll
  for (int i = 0; i < SR; ++i) {
    const int f = row0 + warp * RW + ty + RG * i;
    real[i] = f < rows;
    pos[i] = seen + (real[i] ? f / G : 0);
    slope[i] = kAlibi && real[i] ? a.slopes[h * G + f % G] : 0.f;
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  // the P V accumulator: the warp's RW rows, this lane's float4 columns
  // lane + 32 u
  float4 acc[RW][NU];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int u = 0; u < NU; ++u) acc[r][u] = make_float4(0.f, 0.f, 0.f, 0.f);
  float* Pw = Pall + warp * KT * RW;  // [KT][RW]
  float* Rw = Rall + warp * 2 * RW;
  const float* Qw = Qs + (warp * RW + ty) * QS;

  // S = Q K^T, the scores and the online softmax; P (rounded to bf16 over
  // an int8 cache: the JAX kernel's p.astype(v.dtype)) and each row's
  // rescale into the warp's shared memory
  auto qk = [&](const float* Kt, int k0) {
    float sc[SR][SK];
#pragma unroll
    for (int i = 0; i < SR; ++i)
#pragma unroll
      for (int j = 0; j < SK; ++j) sc[i][j] = 0.f;
    const float* Kl = Kt + tx * KS;
#pragma unroll 4
    for (int c = 0; c < DMAX; c += 4) {
      float4 qv[SR], kv[SK];
#pragma unroll
      for (int i = 0; i < SR; ++i) qv[i] = *reinterpret_cast<const float4*>(Qw + RG * i * QS + c);
#pragma unroll
      for (int j = 0; j < SK; ++j) kv[j] = *reinterpret_cast<const float4*>(Kl + KG * j * KS + c);
#pragma unroll
      for (int i = 0; i < SR; ++i)
#pragma unroll
        for (int j = 0; j < SK; ++j) {
          float x = fmaf(qv[i].x, kv[j].x, sc[i][j]);
          x = fmaf(qv[i].y, kv[j].y, x);
          x = fmaf(qv[i].z, kv[j].z, x);
          sc[i][j] = fmaf(qv[i].w, kv[j].w, x);
        }
    }
    float alpha[SR], ps[SR];
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < SK; ++j) {
        sc[i][j] = score<kAlibi, kCap>(a, sc[i][j], slope[i], pos[i], k0 + tx + KG * j, b.kmin,
                                       b.kmax, real[i]);
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int o = 1; o < KG; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
      ps[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < SR; ++i)
#pragma unroll
      for (int j = 0; j < SK; ++j) {
        const float x = expf(sc[i][j] - m[i]);
        const float p = sc[i][j] > kNegInf ? x : 0.f;
        ps[i] += p;
        Pw[(tx + KG * j) * RW + ty + RG * i] = kInt8 ? round_bf16(p) : p;
      }
#pragma unroll
    for (int i = 0; i < SR; ++i) {
#pragma unroll
      for (int o = 1; o < KG; o <<= 1) ps[i] += __shfl_xor_sync(0xffffffffu, ps[i], o);
      l[i] = alpha[i] * l[i] + ps[i];
      if (tx == 0) Rw[ty + RG * i] = alpha[i];
    }
    __syncwarp();
  };
  // O += P V: the warp's rows, rescaled only where a row's max moved
  auto pv = [&](const float* Vt) {
    float al[RW];
#pragma unroll
    for (int r = 0; r < RW; r += 4) {
      const float4 v = *reinterpret_cast<const float4*>(Rw + r);
      al[r] = v.x;
      al[r + 1] = v.y;
      al[r + 2] = v.z;
      al[r + 3] = v.w;
    }
#pragma unroll
    for (int r = 0; r < RW; ++r)
      if (al[r] != 1.f) {
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          acc[r][u].x *= al[r];
          acc[r][u].y *= al[r];
          acc[r][u].z *= al[r];
          acc[r][u].w *= al[r];
        }
      }
    const float* Vl = Vt + lane * 4;
#pragma unroll 4
    for (int k = 0; k < KT; ++k) {
      float p[RW];
#pragma unroll
      for (int r = 0; r < RW; r += 4) {
        const float4 v = *reinterpret_cast<const float4*>(Pw + k * RW + r);
        p[r] = v.x;
        p[r + 1] = v.y;
        p[r + 2] = v.z;
        p[r + 3] = v.w;
      }
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const float4 v = *reinterpret_cast<const float4*>(Vl + k * DMAX + 128 * u);
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          acc[r][u].x = fmaf(p[r], v.x, acc[r][u].x);
          acc[r][u].y = fmaf(p[r], v.y, acc[r][u].y);
          acc[r][u].z = fmaf(p[r], v.z, acc[r][u].z);
          acc[r][u].w = fmaf(p[r], v.w, acc[r][u].w);
        }
      }
    }
    __syncwarp();  // Pw and Rw are rewritten by the next tile
  };
  if constexpr (kInt8) {
    sweep_ring<C, DMAX, KT, kChunkThreads, 2, 1>(
        b, tiles, t_begin, n_tiles, [&](const float* Kt, const float* Vt, int k0) {
          qk(Kt, k0);
          pv(Vt);
        });
  } else {
    float* Kb = reinterpret_cast<float*>(tiles);
    long long* slots = reinterpret_cast<long long*>(tiles + tile_bytes<DMAX, KT>());
    sweep_staggered<DMAX, KT, kChunkThreads>(b, Kb, Kb + KT * KS, slots, t_begin, n_tiles, qk,
                                             pv);
  }

  // each row's (max, sum) to the lanes that hold its accumulator
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      Rw[ty + RG * i] = m[i];
      Rw[RW + ty + RG * i] = l[i];
    }
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int f = row0 + warp * RW + r;
    if (f >= rows) continue;  // warp-uniform
    const float M = Rw[r], L = Rw[RW + r];
#pragma unroll
    for (int u = 0; u < NU; ++u)
      store_row(a, s, h, f, split, (lane + 32 * u) * 4, acc[r][u], M, L, lane == 0 && u == 0);
  }
}

// up to RB folded query rows (n * G + g) of one (sequence, KV head) over
// one split of the sequence's pages (f32 namespace note)
template <typename C, int DMAX, int RB, bool kAlibi, bool kCap>
__global__ void __launch_bounds__(f32::kDecThreads)
paged_f32_decode_kernel(PagedArgs a) {
  using namespace f32;
  constexpr bool kInt8 = std::is_same<C, int8_t>::value;
  constexpr int KT = dec_keys(DMAX), KW = KT / kDecWarps, DP = 32 / KW;
  constexpr int NC = DMAX / 4 / DP;  // float4 columns of a lane's dims part
  constexpr int NU = DMAX / 128, KS = DMAX + kKPad;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [RB][DMAX]
  float* MX = Qs + RB * DMAX;                  // int8: [2][warps][RB], each warp's tile max
  unsigned char* ring = reinterpret_cast<unsigned char*>(MX + 2 * kDecWarps * RB);

  const int G = a.H / a.KV, rows = a.N * G;
  const int tile = blockIdx.x / a.splits, split = blockIdx.x % a.splits;
  const int h = blockIdx.y, s = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kl = lane % KW, part = lane / KW;
  const int row0 = tile * RB, nr = min(RB, rows - row0);
  const int seen = a.seen[s], hist = a.lens[s];

  load_q<DMAX, DMAX, kDecThreads>(a, Qs, RB, s, h, row0);
  decode::Block<C> b(a, s, h);
  key_range(a, b, seen, hist, row0 / G, (row0 + nr - 1) / G, split);
  const int t_begin = b.kmin / KT;
  const int n_tiles = b.kmin <= b.kmax ? b.kmax / KT + 1 - t_begin : 0;

  // each warp's running max, sum and accumulator of every row over its
  // keys; over an int8 cache the warps share the block's max (every P is
  // rounded against the running max of its tile, as the chunk kernel
  // rounds it), over an fp32 cache each keeps its own. Rows past the
  // block's real ones (zero queries) are computed and masked.
  int pos[RB];
  bool real[RB];
  float slope[RB], m[RB], l[RB];
  float4 acc[RB][NU];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int f = row0 + r;
    real[r] = r < nr;
    pos[r] = seen + (real[r] ? f / G : 0);
    slope[r] = kAlibi && real[r] ? a.slopes[h * G + f % G] : 0.f;
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int u = 0; u < NU; ++u) acc[r][u] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  int parity = 0;

  auto step = [&](const float* Kt, const float* Vt, int k0) {
    // this warp's KW keys; lane (kl, part) sums its key's dims part
    // (float4 columns part + DP t), the parts then added by shuffles
    const float* kr = Kt + (warp * KW + kl) * KS + part * 4;
    float4 kf[NC];
#pragma unroll
    for (int t = 0; t < NC; ++t) kf[t] = *reinterpret_cast<const float4*>(kr + DP * 4 * t);
    const int key = k0 + warp * KW + kl;
    float sc[RB], tm[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const float* qr = Qs + r * DMAX + part * 4;
      float x0 = 0.f, x1 = 0.f;
#pragma unroll
      for (int t = 0; t < NC; t += 2) {
        const float4 q0 = *reinterpret_cast<const float4*>(qr + DP * 4 * t);
        const float4 q1 = *reinterpret_cast<const float4*>(qr + DP * 4 * (t + 1));
        x0 = fmaf(q0.x, kf[t].x, x0);
        x0 = fmaf(q0.y, kf[t].y, x0);
        x0 = fmaf(q0.z, kf[t].z, x0);
        x0 = fmaf(q0.w, kf[t].w, x0);
        x1 = fmaf(q1.x, kf[t + 1].x, x1);
        x1 = fmaf(q1.y, kf[t + 1].y, x1);
        x1 = fmaf(q1.z, kf[t + 1].z, x1);
        x1 = fmaf(q1.w, kf[t + 1].w, x1);
      }
      sc[r] = x0 + x1;
    }
#pragma unroll
    for (int o = KW; o < 32; o <<= 1)
#pragma unroll
      for (int r = 0; r < RB; ++r) sc[r] += __shfl_xor_sync(0xffffffffu, sc[r], o);
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      sc[r] = score<kAlibi, kCap>(a, sc[r], slope[r], pos[r], key, b.kmin, b.kmax, real[r]);
      tm[r] = sc[r];
    }
#pragma unroll
    for (int o = 1; o < KW; o <<= 1)
#pragma unroll
      for (int r = 0; r < RB; ++r) tm[r] = fmaxf(tm[r], __shfl_xor_sync(0xffffffffu, tm[r], o));
    if constexpr (kInt8) {
      // the block's max of each row over the tile, through shared memory
      float* mx = MX + parity * kDecWarps * RB;
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < RB; ++r) mx[warp * RB + r] = tm[r];
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        tm[r] = mx[r];
#pragma unroll
        for (int w = 1; w < kDecWarps; ++w) tm[r] = fmaxf(tm[r], mx[w * RB + r]);
      }
      parity ^= 1;
    }
    float p[RB], pv[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const float m_new = fmaxf(m[r], tm[r]);
      const float alpha = expf(m[r] - m_new);
      m[r] = m_new;
      const float x = expf(sc[r] - m_new);
      p[r] = sc[r] > kNegInf ? x : 0.f;
      // P V takes P rounded to bf16 over bf16-staged K/V; the sum unrounded
      pv[r] = kInt8 ? round_bf16(p[r]) : p[r];
      l[r] *= alpha;
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        acc[r][u].x *= alpha;
        acc[r][u].y *= alpha;
        acc[r][u].z *= alpha;
        acc[r][u].w *= alpha;
      }
    }
#pragma unroll
    for (int o = 1; o < KW; o <<= 1)
#pragma unroll
      for (int r = 0; r < RB; ++r) p[r] += __shfl_xor_sync(0xffffffffu, p[r], o);
#pragma unroll
    for (int r = 0; r < RB; ++r) l[r] += p[r];
    // O += P V over this warp's keys: lane kk holds key kk's P
#pragma unroll
    for (int kk = 0; kk < KW; ++kk) {
      float4 v[NU];
#pragma unroll
      for (int u = 0; u < NU; ++u)
        v[u] = *reinterpret_cast<const float4*>(Vt + (warp * KW + kk) * DMAX + (lane + 32 * u) * 4);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float pk = __shfl_sync(0xffffffffu, pv[r], kk);
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          acc[r][u].x = fmaf(pk, v[u].x, acc[r][u].x);
          acc[r][u].y = fmaf(pk, v[u].y, acc[r][u].y);
          acc[r][u].z = fmaf(pk, v[u].z, acc[r][u].z);
          acc[r][u].w = fmaf(pk, v[u].w, acc[r][u].w);
        }
      }
    }
  };
  sweep_ring<C, DMAX, KT, kDecThreads, kDecStages, 2>(b, ring, t_begin, n_tiles, step);
  __syncthreads();  // every warp done with the ring: it becomes the merge area

  // merge the warps: each accumulator and sum scaled to the rows' common
  // max (a factor of 1 over an int8 cache, whose warps share it), added
  float* red = reinterpret_cast<float*>(ring);   // [warps][RB][DMAX]
  float* ml = red + kDecWarps * RB * DMAX;       // [warps][RB] (max, sum)
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      ml[2 * (warp * RB + r)] = m[r];
      ml[2 * (warp * RB + r) + 1] = l[r];
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    float M = ml[2 * r];
#pragma unroll
    for (int w = 1; w < kDecWarps; ++w) M = fmaxf(M, ml[2 * (w * RB + r)]);
    const float f = expf(m[r] - M);
#pragma unroll
    for (int u = 0; u < NU; ++u)
      *reinterpret_cast<float4*>(red + (warp * RB + r) * DMAX + (lane + 32 * u) * 4) =
          make_float4(acc[r][u].x * f, acc[r][u].y * f, acc[r][u].z * f, acc[r][u].w * f);
  }
  __syncthreads();
  constexpr int CH = DMAX / 4;
  for (int idx = threadIdx.x; idx < nr * CH; idx += kDecThreads) {
    const int r = idx / CH, c = (idx - r * CH) * 4;
    float M = ml[2 * r];
#pragma unroll
    for (int w = 1; w < kDecWarps; ++w) M = fmaxf(M, ml[2 * (w * RB + r)]);
    float4 sum = *reinterpret_cast<const float4*>(red + r * DMAX + c);
    float L = ml[2 * r + 1] * expf(ml[2 * r] - M);
#pragma unroll
    for (int w = 1; w < kDecWarps; ++w) {
      const float4 v = *reinterpret_cast<const float4*>(red + (w * RB + r) * DMAX + c);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
      L += ml[2 * (w * RB + r) + 1] * expf(ml[2 * (w * RB + r)] - M);
    }
    store_row(a, s, h, row0 + r, split, c, sum, M, L, c == 0);
  }
}

template <typename C, int DMAX, int RB, bool kAlibi, bool kCap>
cudaError_t launch_f32_decode(const PagedArgs& a, cudaStream_t stream) {
  auto kern = paged_f32_decode_kernel<C, DMAX, RB, kAlibi, kCap>;
  constexpr size_t smem = f32::decode_smem<std::is_same<C, int8_t>::value, DMAX, RB>();
  static_assert(smem <= 232448, "one block's shared memory on the H100");
  static bool ready[64] = {};
  cudaError_t e = allow_smem(kern, smem, ready);
  if (e != cudaSuccess) return e;
  const int rows = a.N * (a.H / a.KV);
  const dim3 grid((rows + RB - 1) / RB * a.splits, a.KV, a.S);
  kern<<<grid, f32::kDecThreads, smem, stream>>>(a);
  return cudaSuccess;
}

template <typename C, int DMAX, bool kAlibi, bool kCap>
cudaError_t launch_paged_f32_inst(const PagedArgs& a, bool chunk, cudaStream_t stream) {
  constexpr bool kInt8 = std::is_same<C, int8_t>::value;
  const int rows = a.N * (a.H / a.KV);
  if (chunk) {
    auto kern = paged_f32_chunk_kernel<C, DMAX, kAlibi, kCap>;
    constexpr size_t smem = f32::chunk_smem<kInt8, DMAX>();
    static_assert(smem <= 232448, "one block's shared memory on the H100");
    static bool ready[64] = {};
    cudaError_t e = allow_smem(kern, smem, ready);
    if (e != cudaSuccess) return e;
    const dim3 grid((rows + f32::kChunkRows - 1) / f32::kChunkRows * a.splits, a.KV, a.S);
    kern<<<grid, f32::kChunkThreads, smem, stream>>>(a);
  } else if (rows <= f32::dec_rows_small(DMAX)) {
    cudaError_t e = launch_f32_decode<C, DMAX, f32::dec_rows_small(DMAX), kAlibi, kCap>(a, stream);
    if (e != cudaSuccess) return e;
  } else {
    cudaError_t e = launch_f32_decode<C, DMAX, f32::dec_rows_large(DMAX), kAlibi, kCap>(a, stream);
    if (e != cudaSuccess) return e;
  }
  if (a.splits > 1) combine_kernel<float><<<dim3(rows, a.KV, a.S), kAttnThreads, 0, stream>>>(a);
  return cudaSuccess;
}

// The fp32-query instances over one cache type at one head width (the chunk
// and the decode kernel; ALiBi and the softcap as template flags), each
// (cache, width) compiled in a source of its own
// (paged_f32_{f32,int8}{,_d256}.cu)
template <typename C, int DMAX>
cudaError_t launch_paged_f32(const PagedArgs& a, bool chunk, cudaStream_t stream) {
  const bool cap = a.softcap > 0.f;
  if (a.slopes)
    return cap ? launch_paged_f32_inst<C, DMAX, true, true>(a, chunk, stream)
               : launch_paged_f32_inst<C, DMAX, true, false>(a, chunk, stream);
  return cap ? launch_paged_f32_inst<C, DMAX, false, true>(a, chunk, stream)
             : launch_paged_f32_inst<C, DMAX, false, false>(a, chunk, stream);
}

extern template cudaError_t launch_paged_f32<float, 128>(const PagedArgs&, bool, cudaStream_t);
extern template cudaError_t launch_paged_f32<float, 256>(const PagedArgs&, bool, cudaStream_t);
extern template cudaError_t launch_paged_f32<int8_t, 128>(const PagedArgs&, bool, cudaStream_t);
extern template cudaError_t launch_paged_f32<int8_t, 256>(const PagedArgs&, bool, cudaStream_t);

}  // namespace dstt
