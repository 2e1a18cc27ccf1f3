// The 64-row bf16 tiles that the long-stream bodies on wgmma stream into
// shared memory: fused_attention_long.cu (#2 / 4L) and
// fused_attention_long_bwd.cu (#3L / 5L).  A tile holds 64 rows of 64 bf16
// values (one 128-byte row each) in the 128-byte swizzle that wgmma reads
// (wgmma.cuh): 16-byte chunk c of row r at chunk c ^ (r % 8), the tile on
// a 1024-byte boundary, the swizzle's period.  Include after
// attention_common.cuh (cp_async16, kTileQ) and wgmma.cuh (smem_u32).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kRow = 64;                   // bf16 values in one 128-byte swizzled row
constexpr unsigned kSwizzlePeriod = 1024;  // bytes: 8 swizzled rows
constexpr size_t kTileBytes = sizeof(__nv_bfloat16) * kRow * kTileQ;  // a 64-row tile, 8 KB

// `rows` rows (< kTileQ: the rest zero) of d values of a strided bf16
// source, row stride rs, into a 64-row tile at dst in the 128-byte
// swizzle: 16-byte chunk c of row r at chunk c ^ (r % 8), zero past d.
// cp.async where the source allows 16-byte copies; the caller commits,
// waits, fences (fence_proxy_async) and syncs before wgmma reads it.  At
// d = 64, the block's kThreads threads (a multiple of 64) each copy one
// column c = tid % 8 of rows tid / 8 + k kThreads / 8, whose swizzled
// place is one offset from a fixed start: no index arithmetic a chunk.
template <int kThreads>
__device__ __forceinline__ void load_swizzled(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                              long long rs, int d, int rows, int tid) {
  static_assert(kThreads % 64 == 0, "a thread's chunks share their row's swizzle phase");
  const bool vec = d % 8 == 0 && rs % 8 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0;
  if (vec && d == kRow) {
    constexpr int kStep = kThreads / 8;  // rows a pass of the block
    const int r0 = tid >> 3, c = tid & 7;
    __nv_bfloat16* chunk = dst + r0 * kRow + ((c ^ (r0 & 7)) << 3);
    const __nv_bfloat16* s = src + r0 * rs + c * 8;
#pragma unroll
    for (int k = 0; k < kTileQ / kStep; ++k) {
      if (r0 + k * kStep < rows) {
        cp_async16(chunk + k * kStep * kRow, s);
      } else {
        *reinterpret_cast<uint4*>(chunk + k * kStep * kRow) = make_uint4(0u, 0u, 0u, 0u);
      }
      s += kStep * rs;
    }
    return;
  }
  for (int i = tid; i < kTileQ * 8; i += kThreads) {
    const int r = i >> 3, c = i & 7;
    __nv_bfloat16* chunk = dst + r * kRow + ((c ^ (r & 7)) << 3);
    if (r < rows && c * 8 < d) {
      const __nv_bfloat16* s = src + r * rs + c * 8;
      if (vec) {
        cp_async16(chunk, s);
      } else {
        for (int e = 0; e < 8; ++e) chunk[e] = c * 8 + e < d ? s[e] : __float2bfloat16(0.f);
      }
    } else {
      *reinterpret_cast<uint4*>(chunk) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// The smem pointer p rounded up to the swizzle's period (the launch adds
// one period of dynamic shared memory for it).
__device__ __forceinline__ unsigned char* align_to_period(unsigned char* p) {
  return p + ((kSwizzlePeriod - smem_u32(p) % kSwizzlePeriod) % kSwizzlePeriod);
}

}  // namespace
