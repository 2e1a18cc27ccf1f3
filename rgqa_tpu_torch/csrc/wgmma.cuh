// Hopper's warpgroup matrix multiply (wgmma.mma_async, sm_90a) by inline
// PTX: the descriptors of bf16 tiles in shared memory, the fences, and one
// instruction wrapper per shape a kernel of the port runs: headfold.cu
// (the head-fold experiment's bf16 body), fused_attention_long.cu (the
// long-stream forward's bf16 body) and epilogue.cu (the attention
// epilogue's bf16 body).
//
// A warpgroup (4 warps, 128 threads) issues each instruction together: a
// 64-row A (shared memory or registers) times a 16-deep B (shared memory),
// summed into f32 accumulators that the 128 threads hold in registers,
// warp w rows 16 w .. 16 w + 15 in mma.sync's m16n8 C layout per 8
// columns: element 4 n + e of a thread's array is row 16 w + lane / 4 + 8
// (e / 2), column 8 n + 2 (lane % 4) + e % 2.  The A fragment of a
// register operand is mma.sync's m16n8k16 A fragment per warp, so a
// 16-column slice of accumulators packs into it pair by pair.
//
// The shared-memory tiles here have 128-byte rows (64 bf16 values) in the
// 128-byte swizzle (16-byte chunk c of row r stored at chunk c ^ (r % 8))
// and start on 1024-byte boundaries, the swizzle's period.  Two
// descriptor forms read them:
// - wgmma_desc_sw128, one swizzle atom wide: a K-major operand (rows
//   along M or N, the 64 values along K: Q, K, the epilogue's context)
//   and an MN-major one of N = 64 (rows along K, the values along N: V in
//   P V, with the transpose bit).  Groups of 8 rows lie 1024 bytes apart
//   (the stride byte offset); the leading byte offset is unused (K spans
//   one row; N = 64 is one atom).  K advances by 16 values within a row by
//   adding 32 bytes to the start address.
// - wgmma_desc_sw128_mn, an MN-major operand several atoms wide (the
//   epilogue's W slices, N = 192): atom a (values 64 a .. 64 a + 63 of N)
//   holds the slice's K rows at start + a * lbo, 128 bytes a row, so the
//   leading byte offset is the step from one 64-value atom of N to the
//   next and the stride byte offset (1024) the step from one group of 8
//   K rows to the next, as a TMA box of 64 values x K rows in the 128-byte
//   swizzle lays them out.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The descriptor of a swizzled tile at p (shared memory, 1024-byte aligned
// or 32 bytes a K step past it): start address >> 4 in bits 0-13, leading
// byte offset 16 bytes (unused), stride byte offset 1024 bytes, layout 1
// (128-byte swizzle) in bits 62-63.  + 2 steps K by 16 values; + (rows * 8)
// moves an MN-major operand down by `rows` rows (multiples of 8).
__device__ __forceinline__ uint64_t wgmma_desc_sw128(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((1024ull >> 4) << 32) | (1ull << 62);
}

// The descriptor of an MN-major operand of several swizzle atoms along N
// at p (1024-byte aligned): atom a at p + a * lbo (lbo a multiple of 16
// bytes, below 256 KB), groups of 8 K rows 1024 bytes apart within an
// atom, the 128-byte swizzle.
__device__ __forceinline__ uint64_t wgmma_desc_sw128_mn(const void* p, uint32_t lbo) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         ((1024ull >> 4) << 32) | (1ull << 62);
}

// Writes to shared memory by ordinary stores or cp.async are made visible
// to wgmma's reads (the async proxy); each writer fences, then a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Orders the warpgroup's register and shared-memory accesses before the
// wgmma instructions that follow.
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int n>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(n) : "memory");
}

// Keeps the compiler from moving uses of an accumulator (or a register
// operand) across the wait that completes the instruction.
template <int n>
__device__ __forceinline__ void fence_operands(float (&x)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

template <int n, int m>
__device__ __forceinline__ void fence_operands(uint32_t (&x)[n][m]) {
#pragma unroll
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int j = 0; j < m; ++j) asm volatile("" : "+r"(x[i][j])::"memory");
  }
}

#define RGQA_D8(i)                                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x N, f32) = (acc ? d : 0) + A B: A (64 x 16) K-major at descriptor
// da, B (16 x N) K-major at db (its N rows hold the 16 values: K^T read
// from key rows), both bf16.  One specialization per N in 16 .. 256, step
// 16; they differ only in N and the number of operands, which inline PTX
// names one by one.
template <int N>
struct WgmmaSS;

template <>
struct WgmmaSS<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : RGQA_D8(0)
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct WgmmaSS<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : RGQA_D8(0), RGQA_D8(8)
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct WgmmaSS<48> {
  static __device__ __forceinline__ void mma(float (&d)[24], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
        : RGQA_D8(0), RGQA_D8(8), RGQA_D8(16)
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct WgmmaSS<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : RGQA_D8(0), RGQA_D8(8), RGQA_D8(16), RGQA_D8(24)
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct WgmmaSS<80> {
  static __device__ __forceinline__ void mma(float (&d)[40], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39"
        "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
        : RGQA_D8(0), RGQA_D8(8), RGQA_D8(16), RGQA_D8(24), RGQA_D8(32)
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct WgmmaSS<96> {
  static __device__ __forceinline__ void mma(float (&d)[48], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
        : RGQA_D8(0), RGQA_D8(8), RGQA_D8(16), RGQA_D8(24), RGQA_D8(32), RGQA_D8(40)
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct WgmmaSS<112> {
  static __device__ __forceinline__ void mma(float (&d)[56], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55"
        "}, %56, %57, p, 1, 1, 0, 0;\n}\n"
        : RGQA_D8(0), RGQA_D8(8), RGQA_D8(16), RGQA_D8(24), RGQA_D8(32), RGQA_D8(40),
          RGQA_D8(48)
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct WgmmaSS<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : RGQA_D8(0), RGQA_D8(8), RGQA_D8(16), RGQA_D8(24), RGQA_D8(32), RGQA_D8(40),
          RGQA_D8(48), RGQA_D8(56)
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct WgmmaSS<144> {
  static __device__ __forceinline__ void mma(float (&d)[72], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71"
        "}, %72, %73, p, 1, 1, 0, 0;\n}\n"
        : RGQA_D8(0), RGQA_D8(8), RGQA_D8(16), RGQA_D8(24), RGQA_D8(32), RGQA_D8(40),
          RGQA_D8(48), RGQA_D8(56), RGQA_D8(64)
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct WgmmaSS<160> {
  static __device__ __forceinline__ void mma(float (&d)[80], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
        "}, %80, %81, p, 1, 1, 0, 0;\n}\n"
        : RGQA_D8(0), RGQA_D8(8), RGQA_D8(16), RGQA_D8(24), RGQA_D8(32), RGQA_D8(40),
          RGQA_D8(48), RGQA_D8(56), RGQA_D8(64), RGQA_D8(72)
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct WgmmaSS<176> {
  static __device__ __forceinline__ void mma(float (&d)[88], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %90, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n176k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87"
        "}, %88, %89, p, 1, 1, 0, 0;\n}\n"
        : RGQA_D8(0), RGQA_D8(8), RGQA_D8(16), RGQA_D8(24), RGQA_D8(32), RGQA_D8(40),
          RGQA_D8(48), RGQA_D8(56), RGQA_D8(64), RGQA_D8(72), RGQA_D8(80)
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct WgmmaSS<192> {
  static __device__ __forceinline__ void mma(float (&d)[96], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
        : RGQA_D8(0), RGQA_D8(8), RGQA_D8(16), RGQA_D8(24), RGQA_D8(32), RGQA_D8(40),
          RGQA_D8(48), RGQA_D8(56), RGQA_D8(64), RGQA_D8(72), RGQA_D8(80), RGQA_D8(88)
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct WgmmaSS<208> {
  static __device__ __forceinline__ void mma(float (&d)[104], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %106, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n208k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103"
        "}, %104, %105, p, 1, 1, 0, 0;\n}\n"
        : RGQA_D8(0), RGQA_D8(8), RGQA_D8(16), RGQA_D8(24), RGQA_D8(32), RGQA_D8(40),
          RGQA_D8(48), RGQA_D8(56), RGQA_D8(64), RGQA_D8(72), RGQA_D8(80), RGQA_D8(88),
          RGQA_D8(96)
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct WgmmaSS<224> {
  static __device__ __forceinline__ void mma(float (&d)[112], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %114, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111"
        "}, %112, %113, p, 1, 1, 0, 0;\n}\n"
        : RGQA_D8(0), RGQA_D8(8), RGQA_D8(16), RGQA_D8(24), RGQA_D8(32), RGQA_D8(40),
          RGQA_D8(48), RGQA_D8(56), RGQA_D8(64), RGQA_D8(72), RGQA_D8(80), RGQA_D8(88),
          RGQA_D8(96), RGQA_D8(104)
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct WgmmaSS<240> {
  static __device__ __forceinline__ void mma(float (&d)[120], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %122, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n240k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119"
        "}, %120, %121, p, 1, 1, 0, 0;\n}\n"
        : RGQA_D8(0), RGQA_D8(8), RGQA_D8(16), RGQA_D8(24), RGQA_D8(32), RGQA_D8(40),
          RGQA_D8(48), RGQA_D8(56), RGQA_D8(64), RGQA_D8(72), RGQA_D8(80), RGQA_D8(88),
          RGQA_D8(96), RGQA_D8(104), RGQA_D8(112)
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct WgmmaSS<256> {
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
        : RGQA_D8(0), RGQA_D8(8), RGQA_D8(16), RGQA_D8(24), RGQA_D8(32), RGQA_D8(40),
          RGQA_D8(48), RGQA_D8(56), RGQA_D8(64), RGQA_D8(72), RGQA_D8(80), RGQA_D8(88),
          RGQA_D8(96), RGQA_D8(104), RGQA_D8(112), RGQA_D8(120)
        : "l"(da), "l"(db), "r"(acc));
  }
};

// d (64 x 64, f32) = (acc ? d : 0) + A B: A (64 x 16) in registers (a, the
// warp's m16n8k16 A fragment), B (16 x 64) MN-major at db (16 rows of 64
// values: V read from key rows), bf16.
struct WgmmaRS64 {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                             int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : RGQA_D8(0), RGQA_D8(8), RGQA_D8(16), RGQA_D8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  }
};

// d (64 x 192, f32) = (acc ? d : 0) + A B: A (64 x 16) K-major at
// descriptor da, B (16 x 192) MN-major at db (wgmma_desc_sw128_mn: K rows
// of N values, the transpose bit), both bf16: the epilogue's projection,
// a warpgroup's 192 output columns of ctx W.
struct WgmmaSST192 {
  static __device__ __forceinline__ void mma(float (&d)[96], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, %96, %97, p, 1, 1, 0, 1;\n}\n"
        : RGQA_D8(0), RGQA_D8(8), RGQA_D8(16), RGQA_D8(24), RGQA_D8(32), RGQA_D8(40),
          RGQA_D8(48), RGQA_D8(56), RGQA_D8(64), RGQA_D8(72), RGQA_D8(80), RGQA_D8(88)
        : "l"(da), "l"(db), "r"(acc));
  }
};

#undef RGQA_D8

}  // namespace
