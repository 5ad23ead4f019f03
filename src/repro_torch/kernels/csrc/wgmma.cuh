// wgmma.mma_async wrappers for flash_attention.cu: m64nNk16 with float32
// accumulators, bfloat16 or float16 operands. Each thread of the
// warpgroup holds N / 2 accumulators d[], in the layout of mma.sync's C
// fragment: for each 8 columns j, d[4j], d[4j + 1] in row lane / 4 and
// d[4j + 2], d[4j + 3] in row lane / 4 + 8 of the warp's 16 rows, columns
// 8j + 2 (lane % 4) + {0, 1}.
//   ss: D = (scale_d ? D : 0) + A B^T, A [64, 16] and B [N, 16] both
//       K-major in shared memory (128-byte swizzle descriptors);
//   rs: D += A B, A [64, 16] in registers (mma.sync's A fragment: a0 to
//       a3, two values each), B [16, N] MN-major
//       (transposed) in shared memory.
// The operand lists are written out because inline PTX names every
// register.
#pragma once
#include <stdint.h>

namespace wgmma {

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps registers that an asynchronous wgmma reads or writes where they
// are: the compiler may not move their uses across this point
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define WGMMA_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
    "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WGMMA_D32 WGMMA_D8(0), WGMMA_D8(8), WGMMA_D8(16), WGMMA_D8(24)
#define WGMMA_D64 WGMMA_D8(0), WGMMA_D8(8), WGMMA_D8(16), WGMMA_D8(24), WGMMA_D8(32), WGMMA_D8(40), WGMMA_D8(48), WGMMA_D8(56)
#define WGMMA_D96 WGMMA_D8(0), WGMMA_D8(8), WGMMA_D8(16), WGMMA_D8(24), WGMMA_D8(32), WGMMA_D8(40), WGMMA_D8(48), WGMMA_D8(56), WGMMA_D8(64), WGMMA_D8(72), WGMMA_D8(80), WGMMA_D8(88)
#define WGMMA_D128 WGMMA_D8(0), WGMMA_D8(8), WGMMA_D8(16), WGMMA_D8(24), WGMMA_D8(32), WGMMA_D8(40), WGMMA_D8(48), WGMMA_D8(56), WGMMA_D8(64), WGMMA_D8(72), WGMMA_D8(80), WGMMA_D8(88), WGMMA_D8(96), WGMMA_D8(104), WGMMA_D8(112), WGMMA_D8(120)
#define WGMMA_R32 \
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define WGMMA_R64 \
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
    "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
    "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define WGMMA_R96 \
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
    "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
    "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
    "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
    "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
#define WGMMA_R128 \
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
    "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
    "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
    "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
    "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
    "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
    "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"

__device__ __forceinline__ void ss_n64_bf16(float (&d)[32], uint64_t a, uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WGMMA_R32 "}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_D32
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void ss_n128_bf16(float (&d)[64], uint64_t a, uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WGMMA_R64 "}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_D64
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void rs_n64_bf16(float (&d)[32], uint32_t a0, uint32_t a1,
                                          uint32_t a2, uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WGMMA_R32 "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WGMMA_D32
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

__device__ __forceinline__ void rs_n128_bf16(float (&d)[64], uint32_t a0, uint32_t a1,
                                          uint32_t a2, uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WGMMA_R64 "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WGMMA_D64
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

__device__ __forceinline__ void rs_n192_bf16(float (&d)[96], uint32_t a0, uint32_t a1,
                                          uint32_t a2, uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {" WGMMA_R96 "}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : WGMMA_D96
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

__device__ __forceinline__ void rs_n256_bf16(float (&d)[128], uint32_t a0, uint32_t a1,
                                          uint32_t a2, uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" WGMMA_R128 "}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : WGMMA_D128
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

__device__ __forceinline__ void ss_n64_f16(float (&d)[32], uint64_t a, uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {" WGMMA_R32 "}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_D32
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void ss_n128_f16(float (&d)[64], uint64_t a, uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {" WGMMA_R64 "}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_D64
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void rs_n64_f16(float (&d)[32], uint32_t a0, uint32_t a1,
                                          uint32_t a2, uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {" WGMMA_R32 "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WGMMA_D32
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

__device__ __forceinline__ void rs_n128_f16(float (&d)[64], uint32_t a0, uint32_t a1,
                                          uint32_t a2, uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {" WGMMA_R64 "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WGMMA_D64
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

__device__ __forceinline__ void rs_n192_f16(float (&d)[96], uint32_t a0, uint32_t a1,
                                          uint32_t a2, uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.f16.f16 {" WGMMA_R96 "}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : WGMMA_D96
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

__device__ __forceinline__ void rs_n256_f16(float (&d)[128], uint32_t a0, uint32_t a1,
                                          uint32_t a2, uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 {" WGMMA_R128 "}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : WGMMA_D128
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// D [64, N] from shared-memory A and B: ss_n<N>_<type>
template <int N, bool BF16>
__device__ __forceinline__ void ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d) {
  static_assert(N == 64 || N == 128, "ss: N is 64 or 128");
  if constexpr (N == 64) {
    if constexpr (BF16) ss_n64_bf16(d, a, b, scale_d); else ss_n64_f16(d, a, b, scale_d);
  } else {
    if constexpr (BF16) ss_n128_bf16(d, a, b, scale_d); else ss_n128_f16(d, a, b, scale_d);
  }
}

// D [64, N] += A (registers) B (shared memory, MN-major): rs_n<N>_<type>
template <int N, bool BF16>
__device__ __forceinline__ void rs(float (&d)[N / 2], uint32_t a0, uint32_t a1, uint32_t a2,
                                   uint32_t a3, uint64_t b) {
  static_assert(N == 64 || N == 128 || N == 192 || N == 256, "rs: N is 64 to 256");
  if constexpr (N == 64) {
    if constexpr (BF16) rs_n64_bf16(d, a0, a1, a2, a3, b); else rs_n64_f16(d, a0, a1, a2, a3, b);
  } else if constexpr (N == 128) {
    if constexpr (BF16) rs_n128_bf16(d, a0, a1, a2, a3, b); else rs_n128_f16(d, a0, a1, a2, a3, b);
  } else if constexpr (N == 192) {
    if constexpr (BF16) rs_n192_bf16(d, a0, a1, a2, a3, b); else rs_n192_f16(d, a0, a1, a2, a3, b);
  } else {
    if constexpr (BF16) rs_n256_bf16(d, a0, a1, a2, a3, b); else rs_n256_f16(d, a0, a1, a2, a3, b);
  }
}

#undef WGMMA_D8
#undef WGMMA_D32
#undef WGMMA_D64
#undef WGMMA_D96
#undef WGMMA_D128
#undef WGMMA_R32
#undef WGMMA_R64
#undef WGMMA_R96
#undef WGMMA_R128

}  // namespace wgmma
