// Hopper's warpgroup matrix products (wgmma) for the flash backward
// (flash_attention.cuh): shared-memory tiles in the 128-byte swizzle, their
// matrix descriptors, and the product instructions the backward issues. Only
// for sm_90a (the build's target): wgmma does not exist on plain sm_90.
//
// A tile of R rows (R a multiple of 8) and DMAX columns of a 16-bit type is
// held as DMAX / 64 column blocks of [R][64], block after block; in each,
// row r takes 128 bytes and its 16-byte chunk c sits at chunk c ^ (r % 8)
// (the 128-byte swizzle, so the eight rows of a group meet all 32 banks).
// The same bytes serve as a K-major operand (the product's depth along the
// columns: Q K^T reads Q and K so) and as an MN-major one (the depth along
// the rows: dS K reads K so), which is what lets the backward keep Q, dO, K
// and V as they come, [rows][D], for every product that reads them.
// Tiles start on 1024-byte boundaries (one swizzle pattern).
//
// Register fragments (PTX ISA, wgmma .m64nNk16): thread t of the warpgroup
// (warp w = t / 32, lane l = t % 32) holds accumulator element d[i] at row
// 16 w + l / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (l % 4) + i % 2; the
// A fragment of a k16 step (four 32-bit registers, two 16-bit values each)
// holds the same rows at columns 2 (l % 4) + {0, 1} and 8 + 2 (l % 4) + {0,
// 1}. So the accumulator's columns 16 j .. 16 j + 15 are the A fragment of
// step j once rounded to 16 bits (to_a): a product's result feeds the next
// product from registers, with no trip through shared memory.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace dstt {
namespace wgmma {

// element offset of (r, c) in a swizzled tile of R rows
template <int R>
__device__ __forceinline__ int swizzled(int r, int c) {
  return (c >> 6) * R * 64 + r * 64 + ((((c >> 3) & 7) ^ (r & 7)) << 3) + (c & 7);
}

__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);  // layout 1: 128-byte swizzle
}

// k16 step k of a K-major operand: rows r0 .. of a swizzled tile of R rows
// at shared address `tile` (8-row groups 1024 bytes apart; the leading
// offset is unused in this layout)
template <int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int r0, int k) {
  return descriptor(tile + 2 * ((k >> 2) * R * 64 + r0 * 64 + (k & 3) * 16), 16, 1024);
}

// k16 step k of an MN-major operand: rows 16 k .. 16 k + 15 of a swizzled
// tile of R rows, every column (64-column blocks R * 128 bytes apart, 8-row
// groups 1024 bytes apart)
template <int R>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int k) {
  return descriptor(tile + k * 16 * 64 * 2, R * 128, 1024);
}

// wgmma.fence: orders this warpgroup's register writes before the products
// that read them (accumulators, A fragments)
__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most kPending committed groups of products are in flight
template <int kPending>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// generic-proxy writes to shared memory (cp.async, st.shared) made visible
// to the products, which read through the async proxy
__device__ __forceinline__ void fence_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The compiler sees a product's registers as read and written when it is
// issued; these empty statements pin them until after wait(), so nothing
// reads an accumulator, or reuses an A fragment's registers, early.
template <int R>
__device__ __forceinline__ void hold(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int J>
__device__ __forceinline__ void hold(uint32_t (&a)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][e])::"memory");
}

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

__device__ __forceinline__ uint32_t pack(float x, float y, __nv_bfloat16) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack(float x, float y, __half) {
  __half2 v = __floats2half2_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&v);
}

// an fp32 accumulator [64 x 8 R / 4] rounded to T, as the A fragments of its
// R / 8 k16 steps
template <typename T, int R>
__device__ __forceinline__ void to_a(uint32_t (&a)[R / 8][4], const float (&d)[R]) {
#pragma unroll
  for (int j = 0; j < R / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[j][e] = pack(d[8 * j + 2 * e], d[8 * j + 2 * e + 1], T());
}

#define DSTT_WG_D8(d, i)                                                             \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define DSTT_WG_D16_AT(d, i) DSTT_WG_D8(d, i), DSTT_WG_D8(d, i + 8)
#define DSTT_WG_D32_AT(d, i) DSTT_WG_D16_AT(d, i), DSTT_WG_D16_AT(d, i + 16)
#define DSTT_WG_D64_AT(d, i) DSTT_WG_D32_AT(d, i), DSTT_WG_D32_AT(d, i + 32)
#define DSTT_WG_D16(d) DSTT_WG_D16_AT(d, 0)
#define DSTT_WG_D32(d) DSTT_WG_D32_AT(d, 0)
#define DSTT_WG_D64(d) DSTT_WG_D64_AT(d, 0)
#define DSTT_WG_D128(d) DSTT_WG_D64_AT(d, 0), DSTT_WG_D64_AT(d, 64)

// d (+)= a b, m64n32k16: a [64 x 16] and b [16 x 32] in shared memory
// (descriptors of K-major tiles); scale_d 0 starts the sum afresh
template <typename T>
__device__ __forceinline__ void mma_ss_n32(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (std::is_same<T, __half>::value)
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : DSTT_WG_D16(d)
        : "l"(a), "l"(b), "r"(scale_d));
  else
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : DSTT_WG_D16(d)
        : "l"(a), "l"(b), "r"(scale_d));
}

// d (+)= a b, m64n64k16: a [64 x 16] and b [16 x 64] in shared memory
// (descriptors of K-major tiles); scale_d 0 starts the sum afresh
template <typename T>
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (std::is_same<T, __half>::value)
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : DSTT_WG_D32(d)
        : "l"(a), "l"(b), "r"(scale_d));
  else
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : DSTT_WG_D32(d)
        : "l"(a), "l"(b), "r"(scale_d));
}

// d += a b, m64n128k16: a [64 x 16] in registers (the fragments of
// to_a), b [16 x 128] in shared memory (descriptor of an MN-major tile)
template <typename T>
__device__ __forceinline__ void mma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (std::is_same<T, __half>::value)
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : DSTT_WG_D64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  else
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : DSTT_WG_D64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += a b, m64n256k16: a [64 x 16] in registers (the fragments of
// to_a), b [16 x 256] in shared memory (descriptor of an MN-major tile)
template <typename T>
__device__ __forceinline__ void mma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (std::is_same<T, __half>::value)
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : DSTT_WG_D128(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  else
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : DSTT_WG_D128(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (+)= a b with b [16 x N] from a K-major tile (N = 8 R / 4)
template <typename T, int R>
__device__ __forceinline__ void mma_ss(float (&d)[R], uint64_t a, uint64_t b, int scale_d) {
  static_assert(R == 16 || R == 32, "N 32 or 64");
  if constexpr (R == 16) mma_ss_n32<T>(d, a, b, scale_d);
  else mma_ss_n64<T>(d, a, b, scale_d);
}

// d += a b with a from registers and b [16 x N] from an MN-major tile
template <typename T, int R>
__device__ __forceinline__ void mma_rs(float (&d)[R], const uint32_t (&a)[4], uint64_t b) {
  static_assert(R == 64 || R == 128, "N 128 or 256");
  if constexpr (R == 64) mma_rs_n128<T>(d, a, b);
  else mma_rs_n256<T>(d, a, b);
}

#undef DSTT_WG_D8
#undef DSTT_WG_D16_AT
#undef DSTT_WG_D32_AT
#undef DSTT_WG_D64_AT
#undef DSTT_WG_D16
#undef DSTT_WG_D32
#undef DSTT_WG_D64
#undef DSTT_WG_D128

}  // namespace wgmma
}  // namespace dstt
