// K8's three passes over a host plan of row groups, and their second
// passes: the forward's merge of split rows, the sums of split rows of dq
// and of split keys of dk/dv. splash_attention.cu, _f16.cu and _f32.cu
// instantiate the forward in bf16, fp16 and fp32,
// splash_attention_bwd_dq{,_f16,_f32}.cu dq and
// splash_attention_bwd_dkdv{,_f16,_f32}.cu dk/dv, so the nine build in
// parallel. The function, its numerics and the TPU kernels it replaces are
// in splash_attention.cuh's note; the plan is splash.py plan_splash (the
// forward and dq sweep the layout's, dk/dv its transpose's).
//
// The plan (int32, on the device with the tables):
// - an item is one thread block of 4 warps over 64 rows (kGroupRows):
//   queries in the forward and dq, keys in dk/dv. Its row of kItemInts:
//   layout head h, its entries [e0, e1), a partial slot (-1: it writes the
//   outputs), and each warp's first row (-1: the warp has no rows). A group
//   is 4 block rows at block 16 (a warp each), 2 at 32 (two warps each), 1
//   at 64, and half of one at 128;
// - an entry is a block of the group's union, block | mask << 23, bit m of
//   the mask set where member m holds it: a warp skips, by a warp-uniform
//   branch, the 16-row chunks whose block its member lacks;
// - a merge row: h, the first partial slot, the segment count, 0, and the
//   warps' rows of a split group.
// Grid: item x replica, replica fastest, so the plan's order (longest
// first) is the launch order; row bh = replica * heads + h.
//
// A stage is 64 keys (forward, dq) or query rows (dk/dv): 64 / block
// entries (half an entry at block 128), staged once for the group's 4 warps
// in a cp.async ring of ring_stages() (2 where 3 would pass the shared
// memory: fp32 at head width 128), one __syncthreads a stage; the item's
// entries sit in shared memory, so no copy waits on a global load to find
// its row, and one row lookup serves both tensors of a stage. Products are
// mma.sync.m16n8k16 with fp32 accumulation on 16-row chunks (fp32: the same
// fragments summed on the CUDA cores): a score chunk's accumulator is the
// next product's A operand as it lies in registers, rounded to the input
// type (P, dS, P^T, dS^T). A warp's own rows (Q in the forward; Q and dO in
// dq; K and V in dk/dv) are A fragments held in registers at head width <=
// 64 (the forward's Q and dq's Q and dO then staged in the ring's last
// buffer, so that four blocks fit an SM) and read from shared memory at
// 128. Exponentials are one FFMA and one ex2 in the base-2 domain (the
// scale times log2 e). Where a warp's member holds every chunk of a stage
// (the stage functions with kAll, in bf16 and fp16) no branch separates the
// chunks' products.
// - Forward: each warp keeps its rows' running max, sum and fp32
//   accumulator over the chunks its member holds. A split row writes its
//   segment's (max, sum, accumulator) to the workspace; fwd_merge_kernel
//   merges the segments in order, as K4's decode merges its page splits.
// - dq: each warp owns its 16 query rows' dq and their lse and delta in
//   registers; a chunk of 16 keys is S = Q K^T, dP = dO V^T, P = exp2(S
//   scale log2 e - lse log2 e), dS = P (dP - delta) scale, dq += dS K (K read
//   transposed by ldmatrix, as the forward reads V); no running max, so one
//   chunk's scores are live at a time.
// - dk/dv: each warp owns its 16 keys' dk and dv: S^T = K Q^T, P^T =
//   exp(S^T scale - lse), dv += P^T dO, dP^T = V dO^T, dS^T = P^T (dP^T -
//   delta) scale, dk += dS^T Q.
// A split group's dq or dk/dv segments write fp32 partials; sum_kernel sums
// them in segment order and rounds once. No float atomics: two launches
// give the same bits.
#pragma once

#include "splash_attention.cuh"

namespace dstt {
namespace splash {

constexpr int kWarpRows = 16;
constexpr int kGroupRows = 64;  // rows of an item, a warp's 16 each
constexpr int kGroupWarps = kGroupRows / kWarpRows;
constexpr int kGroupThreads = 32 * kGroupWarps;
constexpr int kStageRows = 64;  // keys or query rows of a stage
constexpr int kItemInts = 4 + kGroupWarps;
constexpr int kMaskShift = 23;  // entry: block | members' mask << kMaskShift
constexpr int kBlockMask = (1 << kMaskShift) - 1;
constexpr int kMaxItemEntries = 4096;  // an item's entries in shared memory: 16 KB at most
constexpr int kSecondThreads = 128;    // a thread block of the merge or the sum
constexpr float kLog2e = 1.4426950408889634f;
// the passes, a template argument of what they share
constexpr int kPassFwd = 0;
constexpr int kPassDq = 1;
constexpr int kPassDkdv = 2;

struct GArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;    // dq, dk/dv: dO
  const float* lse;    // dq, dk/dv: [BH, S]
  const float* delta;  // dq, dk/dv: [BH, S]
  void* out;           // forward: o; dq: dq; dk/dv: dk
  void* out2;          // dk/dv: dv
  float* lse_out;      // forward: [BH, S]
  const int* items;    // [n_items, kItemInts], or the merges of a second pass
  const int* entries;
  float* ws;           // partials: forward accumulators; dq; dk/dv dk
  float* ws2;          // forward (max, sum); dk/dv dv
  int n_items, n_parts, reps, BH, S, D, Lh;
  int cap;             // the most entries an item sweeps (the plan's widest segment)
  float scale;
};

template <typename T, int DMAX>
__host__ __device__ constexpr int ring_stages() {
  return sizeof(T) * DMAX > 256 ? 2 : 3;
}

// the A operand of a warp's rows held in registers (16-bit types at head
// width <= 64), so that its shared memory is free once they are read
template <typename T, int DMAX>
__host__ __device__ constexpr bool rows_held() {
  return !std::is_same<T, float>::value && DMAX <= 64;
}

// blocks an SM holds of an instance, the bound its registers are fitted to:
// at head width 64 the forward's and dq's (4 at 64-row groups) and dk/dv's
// (3); one at 128
template <int P, int DMAX>
__host__ __device__ constexpr int group_blocks() {
  return DMAX > 64 ? 1 : P == kPassDkdv ? 3 * 64 / kGroupRows : 4 * 64 / kGroupRows;
}

// the warps' own rows (the forward's Q, dq's Q and dO) staged in the ring's
// last buffer, which the first stages leave free: where their fragments are
// held in registers and they fit one stage
template <typename T, int DMAX, int P>
__host__ __device__ constexpr bool own_rows_in_ring() {
  return rows_held<T, DMAX>() && (P == kPassDq ? 2 : 1) * kGroupRows <= 2 * kStageRows;
}

// the shared memory of an instance: the ring of stages ([K, V] in the
// forward and dq, [Q, dO] and [lse, delta] in dk/dv), the forward's Q and
// dq's Q and dO where they are not in the ring, dk/dv's K and V; then the
// item's entries
template <typename T, int DMAX, int P>
__host__ __device__ constexpr size_t group_smem() {
  constexpr size_t LD = DMAX + kPad, NS = ring_stages<T, DMAX>();
  constexpr size_t stage = 2 * kStageRows * LD * sizeof(T);
  constexpr size_t own = (P == kPassDq ? 2 : 1) * kGroupRows * LD * sizeof(T);
  return P == kPassDkdv ? NS * (stage + 2 * kStageRows * sizeof(float)) +
                              2 * kGroupRows * LD * sizeof(T)
                        : NS * stage + (own_rows_in_ring<T, DMAX, P>() ? 0 : own);
}
static_assert(kGroupRows <= 2 * kStageRows, "the forward's Q fits a stage buffer");

// an item's entries, copied into shared memory at its start so that no
// stage waits on a global load to find its rows (every thread's copy is
// visible after the caller's barrier)
__device__ __forceinline__ int* stage_entries(unsigned char* at, const GArgs& a, int e0,
                                              int e1) {
  int* Es = reinterpret_cast<int*>(at);
  for (int i = threadIdx.x; i < e1 - e0; i += blockDim.x) Es[i] = a.entries[e0 + i];
  return Es;
}

// Start copying n rows of two tensors (K and V, or Q and dO) into Ab and
// Bb (row stride DMAX + kPad): row rr is source row row(rr), zeros where it
// is < 0 and past D; one lookup per row serves both tensors. The caller
// commits and waits.
template <typename T, int DMAX, int NT, typename RowFn>
__device__ __forceinline__ void load_pair(T* Ab, T* Bb, int n, const T* A, const T* B, int D,
                                          RowFn row) {
  constexpr int V = 16 / sizeof(T), CH = DMAX / V;  // 16-byte copies a row
  static_assert(NT % CH == 0, "a thread copies one column of rows");
  const int c = (threadIdx.x % CH) * V;
  for (int r = threadIdx.x / CH; r < n; r += NT / CH) {
    const long long g = row(r);
    const bool valid = g >= 0 && c < D;
    const long long off = valid ? g * D + c : 0;
    flash::cp_async<16>(Ab + r * (DMAX + kPad) + c, A + off, valid);
    flash::cp_async<16>(Bb + r * (DMAX + kPad) + c, B + off, valid);
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi, __nv_bfloat16*) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi, __half*) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A warp's 16 rows x DMAX in shared memory (row stride LD) as the A operand
// of its products: held in registers (16-bit types at DMAX <= 64) or loaded
// where used; fp32 reads the rows themselves
template <typename T, int DMAX, int LD>
struct RowsA {
  static constexpr bool kHeld = rows_held<T, DMAX>();
  const T* p;
  uint32_t r[kHeld ? DMAX / 16 : 1][4];

  __device__ __forceinline__ void init(const T* rows, int lane) {
    p = rows;
    if constexpr (kHeld) {
#pragma unroll
      for (int k = 0; k < DMAX / 16; ++k)
        flash::ldmatrix_x4<false>(r[k], p + (lane & 15) * LD + k * 16 + (lane >> 4) * 8);
    }
  }

  __device__ __forceinline__ void frag(uint32_t (&a)[4], int k, int lane) const {
    if constexpr (kHeld) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = r[k][i];
    } else {
      flash::ldmatrix_x4<false>(a, p + (lane & 15) * LD + k * 16 + (lane >> 4) * 8);
    }
  }
};

// c (16 x 16, the m16n8 accumulator layout of two 8-column tiles) = A B^T
// over DMAX, B the 16 rows of a chunk in shared memory (row stride LD)
template <typename T, int DMAX, int LD>
__device__ __forceinline__ void nt16(float (&c)[2][4], const RowsA<T, DMAX, LD>& a, const T* B,
                                     int lane) {
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
  if constexpr (std::is_same<T, float>::value) {
    const int g = lane >> 2, q2 = (lane & 3) * 2;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* ar = a.p + (g + (e >> 1) * 8) * LD;
        const float* br = B + (n * 8 + q2 + (e & 1)) * LD;
        float s = 0.f;
#pragma unroll 8
        for (int d = 0; d < DMAX; ++d) s += ar[d] * br[d];
        c[n][e] = s;
      }
  } else {
    const int r8 = lane & 7, hi = (lane >> 4) * 8, mid = ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int k = 0; k < DMAX / 16; ++k) {
      uint32_t af[4], b[4];
      a.frag(af, k, lane);
      flash::ldmatrix_x4<false>(b, B + (r8 + hi) * LD + k * 16 + mid);
      flash::mma_16bit<T>(c[0], af, b[0], b[1]);
      flash::mma_16bit<T>(c[1], af, b[2], b[3]);
    }
  }
}

// c (16 x DMAX) += P B: P the 16 x 16 accumulator of nt16 (rounded to T for
// the tensor cores), B the chunk's 16 rows x DMAX in shared memory
template <typename T, int DMAX, int LD>
__device__ __forceinline__ void pn16(float (&c)[DMAX / 8][4], const float (&p)[2][4],
                                     const T* B, int lane) {
  constexpr int N8 = DMAX / 8;
  if constexpr (std::is_same<T, float>::value) {
    // P's row lane/4 (and +8), column kk, is held by lane (lane & ~3) | (kk % 8) / 2
    const int src = lane & ~3, q2 = (lane & 3) * 2;
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      const int t = kk >> 3, j = kk & 7;
      const float lo = __shfl_sync(0xffffffffu, p[t][j & 1], src | (j >> 1));
      const float hi = __shfl_sync(0xffffffffu, p[t][2 + (j & 1)], src | (j >> 1));
      const float* b = B + kk * LD + q2;
#pragma unroll
      for (int n = 0; n < N8; ++n) {
        c[n][0] += lo * b[n * 8];
        c[n][1] += lo * b[n * 8 + 1];
        c[n][2] += hi * b[n * 8];
        c[n][3] += hi * b[n * 8 + 1];
      }
    }
  } else {
    const uint32_t a[4] = {pack2(p[0][0], p[0][1], (T*)nullptr),
                           pack2(p[0][2], p[0][3], (T*)nullptr),
                           pack2(p[1][0], p[1][1], (T*)nullptr),
                           pack2(p[1][2], p[1][3], (T*)nullptr)};
    const int r8 = lane & 7, hi = (lane >> 4) * 8, mid = ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int n = 0; n < N8; n += 2) {
      uint32_t b[4];
      flash::ldmatrix_x4<true>(b, B + (r8 + mid) * LD + n * 8 + hi);
      flash::mma_16bit<T>(c[n], a, b[0], b[1]);
      flash::mma_16bit<T>(c[n + 1], a, b[2], b[3]);
    }
  }
}

// The sweep of one item, common to both passes: the entry and the row
// within its block of stage row rr (a 16-row chunk c is rows 16c..16c+15)
template <int BLK>
struct Sweep {
  static constexpr int EPS = BLK < kStageRows ? kStageRows / BLK : 1;  // entries a stage
  static constexpr int SPE = BLK > kStageRows ? BLK / kStageRows : 1;  // stages an entry
  static constexpr int M = BLK < kGroupRows ? kGroupRows / BLK : 1;     // members a group

  __device__ static int stages(int n) { return (n + EPS - 1) / EPS * SPE; }
  // the item's entry (from its first) of stage row rr
  __device__ static int entry(int t, int rr) {
    return BLK <= kStageRows ? t * EPS + rr / BLK : t / SPE;
  }
  __device__ static int offset(int t, int rr) {
    return BLK <= kStageRows ? rr % BLK : (t % SPE) * kStageRows + rr;
  }
  // the chunks of stage t that warp's member holds, a bit each, from the
  // item's n entries Es
  __device__ static unsigned active(const int* Es, int n, int t, int warp) {
    const int bit = kMaskShift + warp * M / kGroupWarps;
    unsigned act = 0;
#pragma unroll
    for (int c = 0; c < kStageRows / kWarpRows; ++c) {
      const int e = entry(t, c * kWarpRows);
      if (e < n && ((Es[e] >> bit) & 1)) act |= 1u << c;
    }
    return act;
  }
};

// the branch-free stage where a member holds every chunk, for the
// tensor-core types (fp32, the parity runs, keeps one stage body and builds
// faster)
template <typename T>
__host__ __device__ constexpr bool full_stage_path() {
  return !std::is_same<T, float>::value;
}

// 2^x on the SFU, subnormal results flushed to 0 (a probability below
// 2^-126 adds nothing a bf16 or fp32 sum can hold)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One stage of the forward for a warp over the chunks of act, or over every
// chunk with kAll: then no branch stands between the chunks' products, which
// the compiler interleaves (a member that holds the whole stage, as fixed's
// windows do). The running max m is in the base-2 domain of scale2.
template <bool kAll, typename T, int DMAX, int LD>
__device__ __forceinline__ void fwd_stage(float (&acc)[DMAX / 8][4], float (&m)[2],
                                          float (&l)[2], const RowsA<T, DMAX, LD>& qa,
                                          const T* Ks, const T* Vs, unsigned act, float scale2,
                                          int lane) {
  constexpr int NC = kStageRows / kWarpRows, N8 = DMAX / 8;
  auto on = [&](int c) { return kAll || ((act >> c) & 1); };
  float s[NC][2][4];
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (!on(c)) continue;
    nt16<T, DMAX, LD>(s[c], qa, Ks + c * kWarpRows * LD, lane);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[c][j][e] * scale2);
  }
  float mu[2], corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m_new = fmaxf(m[i], flash::row_max(mx[i]));
    mu[i] = m_new == -INFINITY ? 0.f : m_new;
    corr[i] = exp2f(m[i] - mu[i]);
    m[i] = m_new;
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (!on(c)) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[c][j][e] = exp2_ftz(fmaf(s[c][j][e], scale2, -mu[e >> 1]));
        rs[e >> 1] += s[c][j][e];
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + flash::row_sum(rs[i]);
#pragma unroll
  for (int j = 0; j < N8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e >> 1];
#pragma unroll
  for (int c = 0; c < NC; ++c)
    if (on(c)) pn16<T, DMAX, LD>(acc, s[c], Vs + c * kWarpRows * LD, lane);
}

template <typename T, int BLK, int DMAX>
__global__ void __launch_bounds__(kGroupThreads, group_blocks<kPassFwd, DMAX>())
    fwd_grouped_kernel(GArgs a) {
  using W = Sweep<BLK>;
  using QA = RowsA<T, DMAX, DMAX + kPad>;
  constexpr int LD = DMAX + kPad, N8 = DMAX / 8, NS = ring_stages<T, DMAX>();
  constexpr int NC = kStageRows / kWarpRows, STAGE = 2 * kStageRows * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);  // NS x [K 64 rows, V 64 rows]
  // Q: in the ring's last buffer where its fragments are held in registers
  T* Qs = QA::kHeld ? ring + (NS - 1) * STAGE : ring + NS * STAGE;
  unsigned char* after = reinterpret_cast<unsigned char*>(
      ring + NS * STAGE + (QA::kHeld ? 0 : kGroupRows * LD));

  const int* it = a.items + (long long)(blockIdx.x / a.reps) * kItemInts;
  const int rep = blockIdx.x % a.reps;
  const int h = it[0], e0 = it[1], e1 = it[2], part = it[3];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wrow = it[4 + warp];
  const int D = a.D, ne = e1 - e0, nst = W::stages(ne);
  const long long base = (long long)(rep * a.Lh + h) * a.S;
  const T* k = reinterpret_cast<const T*>(a.k);
  const T* v = reinterpret_cast<const T*>(a.v);
  const T* q = reinterpret_cast<const T*>(a.q);
  const int* Es = stage_entries(after, a, e0, e1);
  // scores in the base-2 domain: exp(x - m) = exp2(x log2 e - m log2 e)
  const float scale2 = a.scale * kLog2e;
  __syncthreads();

  auto load_stage = [&](int t) {
    if (t >= nst) return;
    T* Kb = ring + (t % NS) * STAGE;
    load_pair<T, DMAX, kGroupThreads>(Kb, Kb + kStageRows * LD, kStageRows, k, v, D,
                                      [&](int rr) -> long long {
      const int e = W::entry(t, rr);
      return e < ne ? base + (long long)(Es[e] & kBlockMask) * BLK + W::offset(t, rr) : -1LL;
    });
  };

  flash::load_tile<T, DMAX, kGroupThreads>(Qs, kGroupRows, q, D, [&](int rr) -> long long {
    const int w = it[4 + rr / kWarpRows];
    return w < 0 ? -1LL : base + w + rr % kWarpRows;
  });
#pragma unroll
  for (int t = 0; t < NS - 1; ++t) {  // Q rides in the first group
    load_stage(t);
    flash::cp_async_commit();
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // m in the base-2 domain
  float acc[N8][4];
  flash::zero(acc);
  QA qa;

  for (int t = 0; t < nst; ++t) {
    flash::cp_async_wait<NS - 2>();  // stage t (and Q) landed for this thread
    __syncthreads();  // ... for every thread; stage t - 1's buffer is free
    if (t == 0) {
      qa.init(Qs + warp * kWarpRows * LD, lane);
      if (QA::kHeld) __syncthreads();  // every warp holds Q: its buffer is the ring's
    }
    load_stage(t + NS - 1);
    flash::cp_async_commit();
    const unsigned act = W::active(Es, ne, t, warp);
    if (act == 0 || wrow < 0) continue;
    const T* Ks = ring + (t % NS) * STAGE;
    const T* Vs = Ks + kStageRows * LD;
    if constexpr (full_stage_path<T>()) {
      if (act == (1u << NC) - 1) {
        fwd_stage<true>(acc, m, l, qa, Ks, Vs, act, scale2, lane);
        continue;
      }
    }
    fwd_stage<false>(acc, m, l, qa, Ks, Vs, act, scale2, lane);
  }
  flash::cp_async_wait<0>();
  if (wrow < 0) return;

  // back from the base-2 domain: the natural max is m ln 2
  const int r0 = (lane >> 2);
  if (part < 0) {
    long long orow[2];
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      orow[i] = base + wrow + r0 + 8 * i;
      inv[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;
      if ((lane & 3) == 0)
        a.lse_out[orow[i]] = l[i] > 0.f ? (m[i] + log2f(l[i])) / kLog2e : kLseEmpty;
    }
    flash::store_rows<T>(reinterpret_cast<T*>(a.out), acc, orow, inv, D, lane);
  } else {  // this segment's (max, sum, accumulator) of each row, the max natural
    const long long slot0 = ((long long)rep * a.n_parts + part) * kGroupRows + warp * kWarpRows;
    long long srow[2];
    const float one[2] = {1.f, 1.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      srow[i] = slot0 + r0 + 8 * i;
      if ((lane & 3) == 0) {
        a.ws2[2 * srow[i]] = m[i] / kLog2e;
        a.ws2[2 * srow[i] + 1] = l[i];
      }
    }
    flash::store_rows<float>(a.ws, acc, srow, one, D, lane);
  }
}

// The second passes: a thread block for each 16-row slice (a warp's rows)
// of each split group in each replica, a thread for 4 columns of a row at
// a time. Each split row of the forward from its segments in order: o =
// sum_s acc_s e^(m_s - M) / L with M the largest max and L = sum_s l_s
// e^(m_s - M), lse = M + log L; a row no segment saw gets o = 0 and lse =
// +1e30
template <typename T>
__global__ void __launch_bounds__(kSecondThreads) fwd_merge_kernel(GArgs a) {
  constexpr int kSlices = kGroupWarps;
  const int slice = blockIdx.x % kSlices, mr = blockIdx.x / kSlices;
  const int* mg = a.items + (long long)(mr / a.reps) * kItemInts;
  const int rep = mr % a.reps, w = mg[4 + slice];
  if (w < 0) return;
  const int h = mg[0], p0 = mg[1], ns = mg[2], D = a.D, C4 = D / 4;
  const long long base = (long long)(rep * a.Lh + h) * a.S + w;
  const long long slot0 = ((long long)rep * a.n_parts + p0) * kGroupRows + slice * kWarpRows;
  for (int i = threadIdx.x; i < kWarpRows * C4; i += kSecondThreads) {
    const int rr = i / C4, c = (i % C4) * 4;
    float M = -INFINITY;
    for (int s = 0; s < ns; ++s) {
      const long long sl = slot0 + (long long)s * kGroupRows + rr;
      if (a.ws2[2 * sl + 1] > 0.f) M = fmaxf(M, a.ws2[2 * sl]);
    }
    float L = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < ns; ++s) {
      const long long sl = slot0 + (long long)s * kGroupRows + rr;
      const float ls = a.ws2[2 * sl + 1];
      if (ls > 0.f) {
        const float f = expf(a.ws2[2 * sl] - M);
        const float4 x = *reinterpret_cast<const float4*>(a.ws + sl * D + c);
        L += ls * f;
        o.x += x.x * f;
        o.y += x.y * f;
        o.z += x.z * f;
        o.w += x.w * f;
      }
    }
    const float inv = L > 0.f ? 1.f / L : 0.f;
    T* out = reinterpret_cast<T*>(a.out) + (base + rr) * D + c;
    flash::store2(out, o.x * inv, o.y * inv);
    flash::store2(out + 2, o.z * inv, o.w * inv);
    if (c == 0) a.lse_out[base + rr] = L > 0.f ? M + logf(L) : kLseEmpty;
  }
}

// One stage of dq for a warp's 16 query rows over the chunks of keys of
// act (every chunk with kAll, as fwd_stage): lse2 the rows' lse times log2
// e, dl their delta
template <bool kAll, typename T, int DMAX, int LD>
__device__ __forceinline__ void dq_stage(float (&dq)[DMAX / 8][4], const RowsA<T, DMAX, LD>& qa,
                                         const RowsA<T, DMAX, LD>& oa, const T* Ks, const T* Vs,
                                         unsigned act, const float (&lse2)[2],
                                         const float (&dl)[2], float scale, int lane) {
  constexpr int NC = kStageRows / kWarpRows;
  const float scale2 = scale * kLog2e;  // P = exp2(S scale log2 e - lse log2 e)
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (!kAll && !((act >> c) & 1)) continue;
    const T* Kc = Ks + c * kWarpRows * LD;
    float s[2][4], dp[2][4];
    nt16<T, DMAX, LD>(s, qa, Kc, lane);                         // S = Q K^T
    nt16<T, DMAX, LD>(dp, oa, Vs + c * kWarpRows * LD, lane);   // dP = dO V^T
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        s[j][e] = exp2_ftz(fmaf(s[j][e], scale2, -lse2[i])) * (dp[j][e] - dl[i]) * scale;
      }
    pn16<T, DMAX, LD>(dq, s, Kc, lane);  // dq += dS K
  }
}

template <typename T, int BLK, int DMAX>
__global__ void __launch_bounds__(kGroupThreads, group_blocks<kPassDq, DMAX>())
    dq_grouped_kernel(GArgs a) {
  using W = Sweep<BLK>;
  using RA = RowsA<T, DMAX, DMAX + kPad>;
  constexpr int LD = DMAX + kPad, N8 = DMAX / 8, NS = ring_stages<T, DMAX>();
  constexpr int NC = kStageRows / kWarpRows, STAGE = 2 * kStageRows * LD;
  constexpr bool kInRing = own_rows_in_ring<T, DMAX, kPassDq>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);  // NS x [K 64 rows, V 64 rows]
  // Q and dO: in the ring's last buffer where their fragments are held
  T* Qs = kInRing ? ring + (NS - 1) * STAGE : ring + NS * STAGE;
  T* Os = Qs + kGroupRows * LD;
  unsigned char* after = reinterpret_cast<unsigned char*>(
      ring + NS * STAGE + (kInRing ? 0 : 2 * kGroupRows * LD));

  const int* it = a.items + (long long)(blockIdx.x / a.reps) * kItemInts;
  const int rep = blockIdx.x % a.reps;
  const int h = it[0], e0 = it[1], e1 = it[2], part = it[3];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wrow = it[4 + warp];
  const int D = a.D, ne = e1 - e0, nst = W::stages(ne);
  const long long base = (long long)(rep * a.Lh + h) * a.S;
  const T* k = reinterpret_cast<const T*>(a.k);
  const T* v = reinterpret_cast<const T*>(a.v);
  const int* Es = stage_entries(after, a, e0, e1);
  // this lane's rows lane/4 and lane/4 + 8: lse in the base-2 domain (an
  // empty row's 1e30 makes every P exactly 0), delta
  float lse2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
  if (wrow >= 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long r = base + wrow + (lane >> 2) + 8 * i;
      lse2[i] = a.lse[r] * kLog2e;
      dl[i] = a.delta[r];
    }
  }
  __syncthreads();

  auto load_stage = [&](int t) {
    if (t >= nst) return;
    T* Kb = ring + (t % NS) * STAGE;
    load_pair<T, DMAX, kGroupThreads>(Kb, Kb + kStageRows * LD, kStageRows, k, v, D,
                                      [&](int rr) -> long long {
      const int e = W::entry(t, rr);
      return e < ne ? base + (long long)(Es[e] & kBlockMask) * BLK + W::offset(t, rr) : -1LL;
    });
  };

  load_pair<T, DMAX, kGroupThreads>(Qs, Os, kGroupRows, reinterpret_cast<const T*>(a.q),
                                    reinterpret_cast<const T*>(a.dout), D,
                                    [&](int rr) -> long long {
    const int w = it[4 + rr / kWarpRows];
    return w < 0 ? -1LL : base + w + rr % kWarpRows;
  });
#pragma unroll
  for (int t = 0; t < NS - 1; ++t) {  // Q and dO ride in the first group
    load_stage(t);
    flash::cp_async_commit();
  }

  float dq[N8][4];
  flash::zero(dq);
  RA qa, oa;

  for (int t = 0; t < nst; ++t) {
    flash::cp_async_wait<NS - 2>();  // stage t (and Q, dO) landed for this thread
    __syncthreads();  // ... for every thread; stage t - 1's buffer is free
    if (t == 0) {
      qa.init(Qs + warp * kWarpRows * LD, lane);
      oa.init(Os + warp * kWarpRows * LD, lane);
      if (kInRing) __syncthreads();  // every warp holds Q and dO: their buffer is the ring's
    }
    load_stage(t + NS - 1);
    flash::cp_async_commit();
    const unsigned act = W::active(Es, ne, t, warp);
    if (act == 0 || wrow < 0) continue;
    const T* Ks = ring + (t % NS) * STAGE;
    const T* Vs = Ks + kStageRows * LD;
    if constexpr (full_stage_path<T>()) {
      if (act == (1u << NC) - 1) {
        dq_stage<true>(dq, qa, oa, Ks, Vs, act, lse2, dl, a.scale, lane);
        continue;
      }
    }
    dq_stage<false>(dq, qa, oa, Ks, Vs, act, lse2, dl, a.scale, lane);
  }
  flash::cp_async_wait<0>();
  if (wrow < 0) return;

  // every query row is in one group of the plan: a row no key reached
  // writes dq = 0
  long long rows[2];
  const float one[2] = {1.f, 1.f};
  if (part < 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) rows[i] = base + wrow + (lane >> 2) + 8 * i;
    flash::store_rows<T>(reinterpret_cast<T*>(a.out), dq, rows, one, D, lane);
  } else {
    const long long slot0 = ((long long)rep * a.n_parts + part) * kGroupRows + warp * kWarpRows;
#pragma unroll
    for (int i = 0; i < 2; ++i) rows[i] = slot0 + (lane >> 2) + 8 * i;
    flash::store_rows<float>(a.ws, dq, rows, one, D, lane);
  }
}

// One stage of dk/dv for a warp's 16 keys over the chunks of query rows of
// act (every chunk with kAll, as fwd_stage): Qs, Os the stage's Q and dO,
// Ls, Dl its lse and delta
template <bool kAll, typename T, int DMAX, int LD>
__device__ __forceinline__ void dkdv_stage(float (&dk)[DMAX / 8][4], float (&dv)[DMAX / 8][4],
                                           const RowsA<T, DMAX, LD>& ka,
                                           const RowsA<T, DMAX, LD>& va, const T* Qs,
                                           const T* Os, const float* Ls, const float* Dl,
                                           unsigned act, float scale, int lane) {
  constexpr int NC = kStageRows / kWarpRows;
  const float scale2 = scale * kLog2e;  // P^T = exp2(S^T scale log2 e - lse log2 e)
  const int q2 = (lane & 3) * 2;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (!kAll && !((act >> c) & 1)) continue;
    const T* Qc = Qs + c * kWarpRows * LD;
    const T* Oc = Os + c * kWarpRows * LD;
    float p[2][4], dp[2][4];
    nt16<T, DMAX, LD>(p, ka, Qc, lane);  // S^T: this warp's keys x the chunk's rows
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[j][e] = exp2_ftz(fmaf(p[j][e], scale2,
                                -Ls[c * kWarpRows + j * 8 + q2 + (e & 1)] * kLog2e));
    pn16<T, DMAX, LD>(dv, p, Oc, lane);   // dv += P^T dO
    nt16<T, DMAX, LD>(dp, va, Oc, lane);  // dP^T = V dO^T
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[j][e] = p[j][e] * (dp[j][e] - Dl[c * kWarpRows + j * 8 + q2 + (e & 1)]) * scale;
    pn16<T, DMAX, LD>(dk, dp, Qc, lane);  // dk += dS^T Q
  }
}

template <typename T, int BLK, int DMAX>
__global__ void __launch_bounds__(kGroupThreads, group_blocks<kPassDkdv, DMAX>())
    dkdv_grouped_kernel(GArgs a) {
  using W = Sweep<BLK>;
  constexpr int LD = DMAX + kPad, N8 = DMAX / 8, NS = ring_stages<T, DMAX>();
  constexpr int NC = kStageRows / kWarpRows, STAGE = 2 * kStageRows * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);  // NS x [Q 64 rows, dO 64 rows]
  T* Ks = ring + NS * STAGE;
  T* Vs = Ks + kGroupRows * LD;
  float* LDs = reinterpret_cast<float*>(Vs + kGroupRows * LD);  // NS x [lse, delta]

  const int* it = a.items + (long long)(blockIdx.x / a.reps) * kItemInts;
  const int rep = blockIdx.x % a.reps;
  const int h = it[0], e0 = it[1], e1 = it[2], part = it[3];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wrow = it[4 + warp];
  const int D = a.D, ne = e1 - e0, nst = W::stages(ne);
  const long long base = (long long)(rep * a.Lh + h) * a.S;
  const T* q = reinterpret_cast<const T*>(a.q);
  const T* dout = reinterpret_cast<const T*>(a.dout);
  const int* Es = stage_entries(reinterpret_cast<unsigned char*>(LDs + NS * 2 * kStageRows),
                                a, e0, e1);
  __syncthreads();

  auto q_row = [&](int t, int rr) -> long long {
    const int e = W::entry(t, rr);
    return e < ne ? base + (long long)(Es[e] & kBlockMask) * BLK + W::offset(t, rr) : -1LL;
  };
  auto load_stage = [&](int t) {
    if (t >= nst) return;
    T* Qb = ring + (t % NS) * STAGE;
    load_pair<T, DMAX, kGroupThreads>(Qb, Qb + kStageRows * LD, kStageRows, q, dout, D,
                                      [&](int rr) { return q_row(t, rr); });
    // lse and delta of the stage's rows
    for (int i = threadIdx.x; i < 2 * kStageRows; i += kGroupThreads) {
      const int rr = i % kStageRows;
      const long long g = q_row(t, rr);
      const float* src = i < kStageRows ? a.lse : a.delta;
      flash::cp_async<4>(LDs + ((t % NS) * 2 + i / kStageRows) * kStageRows + rr,
                         g >= 0 ? src + g : src, g >= 0);
    }
  };

  load_pair<T, DMAX, kGroupThreads>(Ks, Vs, kGroupRows, reinterpret_cast<const T*>(a.k),
                                    reinterpret_cast<const T*>(a.v), D,
                                    [&](int rr) -> long long {
    const int w = it[4 + rr / kWarpRows];
    return w < 0 ? -1LL : base + w + rr % kWarpRows;
  });
#pragma unroll
  for (int t = 0; t < NS - 1; ++t) {  // K and V ride in the first group
    load_stage(t);
    flash::cp_async_commit();
  }

  float dk[N8][4], dv[N8][4];
  flash::zero(dk);
  flash::zero(dv);
  RowsA<T, DMAX, LD> ka, va;

  for (int t = 0; t < nst; ++t) {
    flash::cp_async_wait<NS - 2>();
    __syncthreads();
    if (t == 0) {
      ka.init(Ks + warp * kWarpRows * LD, lane);
      va.init(Vs + warp * kWarpRows * LD, lane);
    }
    load_stage(t + NS - 1);
    flash::cp_async_commit();
    const unsigned act = W::active(Es, ne, t, warp);
    if (act == 0 || wrow < 0) continue;
    const T* Qs = ring + (t % NS) * STAGE;
    const T* Os = Qs + kStageRows * LD;
    const float* Ls = LDs + (t % NS) * 2 * kStageRows;
    const float* Dl = Ls + kStageRows;
    if constexpr (full_stage_path<T>()) {
      if (act == (1u << NC) - 1) {
        dkdv_stage<true>(dk, dv, ka, va, Qs, Os, Ls, Dl, act, a.scale, lane);
        continue;
      }
    }
    dkdv_stage<false>(dk, dv, ka, va, Qs, Os, Ls, Dl, act, a.scale, lane);
  }
  flash::cp_async_wait<0>();
  if (wrow < 0) return;

  long long rows[2];
  const float one[2] = {1.f, 1.f};
  if (part < 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) rows[i] = base + wrow + (lane >> 2) + 8 * i;
    flash::store_rows<T>(reinterpret_cast<T*>(a.out), dk, rows, one, D, lane);
    flash::store_rows<T>(reinterpret_cast<T*>(a.out2), dv, rows, one, D, lane);
  } else {
    const long long slot0 = ((long long)rep * a.n_parts + part) * kGroupRows + warp * kWarpRows;
#pragma unroll
    for (int i = 0; i < 2; ++i) rows[i] = slot0 + (lane >> 2) + 8 * i;
    flash::store_rows<float>(a.ws, dk, rows, one, D, lane);
    flash::store_rows<float>(a.ws2, dv, rows, one, D, lane);
  }
}

// each split row of dq (kTensors 1) or key row of dk and dv (2): its
// segments' fp32 partials (ws, ws2) summed in segment order, rounded once
// (the grid of fwd_merge_kernel)
template <typename T, int kTensors>
__global__ void __launch_bounds__(kSecondThreads) sum_kernel(GArgs a) {
  constexpr int kSlices = kGroupWarps;
  const int slice = blockIdx.x % kSlices, mr = blockIdx.x / kSlices;
  const int* mg = a.items + (long long)(mr / a.reps) * kItemInts;
  const int rep = mr % a.reps, w = mg[4 + slice];
  if (w < 0) return;
  const int h = mg[0], p0 = mg[1], ns = mg[2], D = a.D, C4 = D / 4;
  const long long base = (long long)(rep * a.Lh + h) * a.S + w;
  const long long slot0 = ((long long)rep * a.n_parts + p0) * kGroupRows + slice * kWarpRows;
  const float* ws[2] = {a.ws, a.ws2};
  T* out[2] = {reinterpret_cast<T*>(a.out), reinterpret_cast<T*>(a.out2)};
  for (int i = threadIdx.x; i < kWarpRows * C4; i += kSecondThreads) {
    const int rr = i / C4, c = (i % C4) * 4;
    float4 sum[kTensors];
#pragma unroll
    for (int j = 0; j < kTensors; ++j) sum[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < ns; ++s) {
      const long long at = (slot0 + (long long)s * kGroupRows + rr) * D + c;
#pragma unroll
      for (int j = 0; j < kTensors; ++j) {
        const float4 x = *reinterpret_cast<const float4*>(ws[j] + at);
        sum[j].x += x.x;
        sum[j].y += x.y;
        sum[j].z += x.z;
        sum[j].w += x.w;
      }
    }
    const long long at = (base + rr) * D + c;
#pragma unroll
    for (int j = 0; j < kTensors; ++j) {
      flash::store2(out[j] + at, sum[j].x, sum[j].y);
      flash::store2(out[j] + at + 2, sum[j].z, sum[j].w);
    }
  }
}

template <int P, typename T, int BLK, int DMAX>
cudaError_t launch_grouped(const GArgs& a, cudaStream_t stream) {
  void (*kern)(GArgs);
  if constexpr (P == kPassFwd)
    kern = &fwd_grouped_kernel<T, BLK, DMAX>;
  else if constexpr (P == kPassDq)
    kern = &dq_grouped_kernel<T, BLK, DMAX>;
  else
    kern = &dkdv_grouped_kernel<T, BLK, DMAX>;
  const size_t smem = group_smem<T, DMAX, P>() + ((size_t)a.cap * sizeof(int) + 15) / 16 * 16;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<(unsigned)((long long)a.n_items * a.reps), kGroupThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// the grouped sweep of one type, by block size and head width
template <int P, typename T>
cudaError_t launch_grouped_type(const GArgs& a, int block, cudaStream_t s) {
  const bool narrow = a.D <= 64;
  switch (block) {
    case 16: return narrow ? launch_grouped<P, T, 16, 64>(a, s)
                           : launch_grouped<P, T, 16, 128>(a, s);
    case 32: return narrow ? launch_grouped<P, T, 32, 64>(a, s)
                           : launch_grouped<P, T, 32, 128>(a, s);
    case 64: return narrow ? launch_grouped<P, T, 64, 64>(a, s)
                           : launch_grouped<P, T, 64, 128>(a, s);
    case 128: return narrow ? launch_grouped<P, T, 128, 64>(a, s)
                            : launch_grouped<P, T, 128, 128>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// the fp16 and fp32 instances, each built in a source of its own
// (splash_attention{,_bwd_dq,_bwd_dkdv}_{f16,f32}.cu) so that the build's
// parallel nvcc runs them side by side
cudaError_t launch_fwd_f16(const GArgs& a, int block, cudaStream_t s);
cudaError_t launch_fwd_f32(const GArgs& a, int block, cudaStream_t s);
cudaError_t launch_dq_f16(const GArgs& a, int block, cudaStream_t s);
cudaError_t launch_dq_f32(const GArgs& a, int block, cudaStream_t s);
cudaError_t launch_dkdv_f16(const GArgs& a, int block, cudaStream_t s);
cudaError_t launch_dkdv_f32(const GArgs& a, int block, cudaStream_t s);

// the checks every grouped entry point of pass P makes, and the replicas
// BH / heads
inline bool grouped_ok(GArgs& a, int P) {
  const bool ok = a.BH > 0 && a.Lh > 0 && a.BH % a.Lh == 0 && a.n_items > 0 && a.S > 0 &&
                  a.cap >= 0 && a.cap <= kMaxItemEntries &&
                  a.D > 0 && a.D <= 128 && a.D % 8 == 0 && a.n_parts >= 0 &&
                  (a.n_parts == 0 || (a.ws && (P == kPassDq || a.ws2)));
  a.reps = ok ? a.BH / a.Lh : 0;
  // grids of n_items * replicas blocks (4 times that for a second pass)
  return ok && (long long)a.n_items * a.reps < (1LL << 29);
}

// launch the grouped sweep of pass P for the dtype
template <int P>
int run_grouped(GArgs a, int block, int dtype, void* stream) {
  if (!grouped_ok(a, P) || block <= 0 || a.S % block) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kFloat32:
      if constexpr (P == kPassFwd) return (int)launch_fwd_f32(a, block, s);
      else if constexpr (P == kPassDq) return (int)launch_dq_f32(a, block, s);
      else return (int)launch_dkdv_f32(a, block, s);
    case kBFloat16: return (int)launch_grouped_type<P, __nv_bfloat16>(a, block, s);
    case kFloat16:
      if constexpr (P == kPassFwd) return (int)launch_fwd_f16(a, block, s);
      else if constexpr (P == kPassDq) return (int)launch_dq_f16(a, block, s);
      else return (int)launch_dkdv_f16(a, block, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int P, typename T>
void launch_second_pass(const GArgs& a, cudaStream_t s) {
  const unsigned grid = (unsigned)((long long)a.n_items * a.reps * kGroupWarps);
  if constexpr (P == kPassFwd)
    fwd_merge_kernel<T><<<grid, kSecondThreads, 0, s>>>(a);
  else
    sum_kernel<T, P == kPassDq ? 1 : 2><<<grid, kSecondThreads, 0, s>>>(a);
}

// launch the forward's merge, or dq's or dk/dv's sum, over the merge rows
// (a.items)
template <int P>
int run_second_pass(GArgs a, int dtype, void* stream) {
  if (!grouped_ok(a, P) || a.n_parts == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case kFloat32: launch_second_pass<P, float>(a, s); break;
    case kBFloat16: launch_second_pass<P, __nv_bfloat16>(a, s); break;
    case kFloat16: launch_second_pass<P, __half>(a, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace splash
}  // namespace dstt
