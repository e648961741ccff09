// Blockwise symmetric int8 quantization (K6) and its inverse.
//
// Replaces the TPU kernel deepspeed_tpu/ops/quantizer.py:29 _quant_kernel
// (driven by quantize_int8_blockwise :45). The input x (n elements, fp32 or
// bf16, row-major) is cut into blocks of `block` elements, the last one
// padded with zeros:
//   scale[r]  = absmax(block r) == 0 ? 1 : absmax / 127
//   values[i] = int8(clip(rint(x[i] / scale[r]), -127, 127))   (0 past n)
// IEEE division (no fast math, no multiply by 1/scale) and rintf (round
// half to even, as jnp.round and torch.round) make the result equal the
// plain version bit for bit; the max is order-independent.
//
// Bound on the H100: bytes (2 B read and 1 B written per bf16 element, 4 B
// per block). quantize_vec_kernel gives each block to one warp and keeps
// it in registers: a lane owns 16 consecutive elements of every 512-wide
// stretch of the block (two 16-byte loads of bf16, four of fp32, so eight
// and sixteen at the JAX default block of 2048), the absmax is a warp
// reduction by shuffles alone, and the lane's 16 codes of a stretch leave
// in one 16-byte store. The block is read from device memory once. It
// takes blocks of 512 and 2048 elements over a 16-byte aligned x; in the
// last block the vector across n loads element by element, zeros past n
// (the padding). Other block sizes and unaligned inputs take
// quantize_kernel: a lane an element, the block read twice (the second
// time from L1/L2), 1-byte stores. It runs only at engine build.
//
// dequantize_kernel is the inverse, out[i] = T(float(values[i]) * scale),
// the same order as the JAX package's astype(f32) * s then astype(dtype).
// It is no port of a Pallas kernel: XLA fuses that expression into the
// matmul that consumes it, while eager PyTorch would make three passes (int8
// -> fp32, multiply, -> bf16). One pass, 8 elements per thread: an 8-byte
// load of codes and one 16-byte (bf16) or two 16-byte (fp32) stores.
// Bound: bytes, 1 B read and 2 B (bf16) written per element.
#include <algorithm>

#include "common.cuh"

namespace dstt {

constexpr int kQuantWarps = 8;
constexpr int kDequantThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kQuantWarps * 32)
quantize_kernel(const T* __restrict__ x, long long n, int block, long long rows,
                int8_t* __restrict__ values, float* __restrict__ scales) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * kQuantWarps + warp;
  if (r >= rows) return;  // warp-uniform
  const long long base = r * block;
  const long long end = min(n, base + block);  // past n: the zero padding
  float amax = 0.f;
  for (long long i = base + lane; i < end; i += 32)
    amax = fmaxf(amax, fabsf(to_float(x[i])));
  amax = warp_max(amax);
  const float scale = amax == 0.f ? 1.f : __fdiv_rn(amax, 127.f);
  for (long long i = base + lane; i < base + block; i += 32) {
    float q = 0.f;
    if (i < end) q = fminf(fmaxf(rintf(__fdiv_rn(to_float(x[i]), scale)), -127.f), 127.f);
    values[i] = (int8_t)q;
  }
  if (lane == 0) scales[r] = scale;
}

// the 16 elements a lane owns in one 512-wide stretch of a block; their
// codes are one 16-byte store
constexpr int kQuantLaneElems = 16;
constexpr int kQuantStretch = 32 * kQuantLaneElems;

// One warp a block of kC * 512 elements, held in registers (see above)
template <typename T, int kC>
__global__ void __launch_bounds__(kQuantWarps * 32)
quantize_vec_kernel(const T* __restrict__ x, long long n, long long rows,
                    int8_t* __restrict__ values, float* __restrict__ scales) {
  constexpr int E = 16 / sizeof(T);                  // elements per 16-byte vector
  constexpr int VL = kQuantLaneElems / E;            // vectors a lane loads a stretch
  constexpr long long kBlock = (long long)kC * kQuantStretch;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * kQuantWarps + warp;
  if (r >= rows) return;  // warp-uniform
  const long long base = r * kBlock;
  uint4 raw[kC][VL];
  const bool whole = base + kBlock <= n;  // warp-uniform: all but the last block
#pragma unroll
  for (int c = 0; c < kC; ++c)
#pragma unroll
    for (int v = 0; v < VL; ++v) {
      const long long i0 = base + c * kQuantStretch + lane * kQuantLaneElems + v * E;
      if (whole || i0 + E <= n) {
        raw[c][v] = __ldg(reinterpret_cast<const uint4*>(x + i0));
      } else {  // the vector across n: zeros past it
        T* e = reinterpret_cast<T*>(&raw[c][v]);
#pragma unroll
        for (int j = 0; j < E; ++j) e[j] = i0 + j < n ? x[i0 + j] : from_float<T>(0.f);
      }
    }
  float amax = 0.f;
#pragma unroll
  for (int c = 0; c < kC; ++c)
#pragma unroll
    for (int v = 0; v < VL; ++v) {
      const T* e = reinterpret_cast<const T*>(&raw[c][v]);
#pragma unroll
      for (int j = 0; j < E; ++j) amax = fmaxf(amax, fabsf(to_float(e[j])));
    }
  amax = warp_max(amax);
  const float scale = amax == 0.f ? 1.f : __fdiv_rn(amax, 127.f);
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    uint4 codes;
    int8_t* q = reinterpret_cast<int8_t*>(&codes);
#pragma unroll
    for (int v = 0; v < VL; ++v) {
      const T* e = reinterpret_cast<const T*>(&raw[c][v]);
#pragma unroll
      for (int j = 0; j < E; ++j)
        q[v * E + j] = (int8_t)fminf(fmaxf(rintf(__fdiv_rn(to_float(e[j]), scale)), -127.f),
                                     127.f);
    }
    *reinterpret_cast<uint4*>(values + base + c * kQuantStretch + lane * kQuantLaneElems) =
        codes;
  }
  if (lane == 0) scales[r] = scale;
}

template <typename T>
void launch_quantize(const T* x, long long n, int block, long long rows, int8_t* values,
                     float* scales, cudaStream_t stream) {
  const unsigned grid = (unsigned)((rows + kQuantWarps - 1) / kQuantWarps);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(values) % 16 == 0;
  if (aligned && block == kQuantStretch)
    quantize_vec_kernel<T, 1><<<grid, kQuantWarps * 32, 0, stream>>>(x, n, rows, values,
                                                                      scales);
  else if (aligned && block == 4 * kQuantStretch)
    quantize_vec_kernel<T, 4><<<grid, kQuantWarps * 32, 0, stream>>>(x, n, rows, values,
                                                                      scales);
  else
    quantize_kernel<T><<<grid, kQuantWarps * 32, 0, stream>>>(x, n, block, rows, values,
                                                              scales);
}

template <typename T>
__device__ __forceinline__ void store8(T* out, const float (&v)[8]);

template <>
__device__ __forceinline__ void store8<float>(float* out, const float (&v)[8]) {
  reinterpret_cast<float4*>(out)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(out)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

template <>
__device__ __forceinline__ void store8<__nv_bfloat16>(__nv_bfloat16* out,
                                                      const float (&v)[8]) {
  uint4 w;
  uint32_t* p = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    __nv_bfloat162 h = __halves2bfloat162(__float2bfloat16(v[2 * k]),
                                          __float2bfloat16(v[2 * k + 1]));
    p[k] = *reinterpret_cast<uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(out) = w;
}

// 8 consecutive elements per thread; needs n % 8 == 0, block % 8 == 0 (the
// 8 share one scale) and aligned pointers
template <typename T>
__global__ void __launch_bounds__(kDequantThreads)
dequantize8_kernel(const int8_t* __restrict__ values, const float* __restrict__ scales,
                   long long n, int block, T* __restrict__ out) {
  const long long n8 = n / 8;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x; c < n8;
       c += (long long)gridDim.x * blockDim.x) {
    const uint2 w = reinterpret_cast<const uint2*>(values)[c];
    const float s = scales[c * 8 / block];
    float v[8];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = (float)(int8_t)((w.x >> (8 * k)) & 0xff) * s;
      v[4 + k] = (float)(int8_t)((w.y >> (8 * k)) & 0xff) * s;
    }
    store8<T>(out + c * 8, v);
  }
}

template <typename T>
__global__ void __launch_bounds__(kDequantThreads)
dequantize_kernel(const int8_t* __restrict__ values, const float* __restrict__ scales,
                  long long n, int block, T* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = from_float<T>((float)values[i] * scales[i / block]);
}

template <typename T>
cudaError_t launch_dequantize(const int8_t* values, const float* scales, long long n,
                              int block, T* out, cudaStream_t stream) {
  const bool vec = n % 8 == 0 && block % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(values) % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long work = vec ? n / 8 : n;
  // a grid-stride loop over at most 64K blocks of 256 threads
  const long long blocks = std::min<long long>((work + kDequantThreads - 1) / kDequantThreads,
                                               65535LL);
  if (vec)
    dequantize8_kernel<T><<<(unsigned)blocks, kDequantThreads, 0, stream>>>(
        values, scales, n, block, out);
  else
    dequantize_kernel<T><<<(unsigned)blocks, kDequantThreads, 0, stream>>>(
        values, scales, n, block, out);
  return cudaSuccess;
}

}  // namespace dstt

// values: int8 [rows * block], scales: fp32 [rows], rows = ceil(n / block)
extern "C" int dstt_quantize_int8(const void* x, long long n, int block, int dtype,
                                  void* values, void* scales, void* stream) {
  using namespace dstt;
  if (n <= 0 || block <= 0) return (int)cudaErrorInvalidValue;
  const long long rows = (n + block - 1) / block;
  const long long grid = (rows + kQuantWarps - 1) / kQuantWarps;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int8_t* v = (int8_t*)values;
  float* sc = (float*)scales;
  switch (dtype) {
    case kFloat32: launch_quantize<float>((const float*)x, n, block, rows, v, sc, s); break;
    case kBFloat16:
      launch_quantize<__nv_bfloat16>((const __nv_bfloat16*)x, n, block, rows, v, sc, s);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// out: the first n elements of the dequantized blocks, in `dtype`
extern "C" int dstt_dequantize_int8(const void* values, const void* scales, long long n,
                                    int block, void* out, int dtype, void* stream) {
  using namespace dstt;
  if (n <= 0 || block <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int8_t* v = (const int8_t*)values;
  const float* sc = (const float*)scales;
  cudaError_t e;
  switch (dtype) {
    case kFloat32: e = launch_dequantize<float>(v, sc, n, block, (float*)out, s); break;
    case kBFloat16:
      e = launch_dequantize<__nv_bfloat16>(v, sc, n, block, (__nv_bfloat16*)out, s);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
