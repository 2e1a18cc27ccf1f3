// Fused multi-head attention forward for long streams, on the natural
// (B, S, H*D) layout.
//
// Replaces the Pallas TPU kernel rgqa_tpu/ops/attention.py:_fused_kernel
// on the query-tiled grid (launched by _fused_qblocked_raw) and, at 266-277
// tokens, on the full-sequence grid (_fused_pallas_raw), which serve
// ViLT's single stream: 20 or 40 text tokens + (image / patch)^2 patches +
// CLS, so 165 or 185 tokens for ViLT-B/32 at 384 px, 277 at 512 px and 597
// with 16 px patches; 12 heads of 64.  Per (batch row, head) it computes
//
//     out[b, :, h*D:(h+1)*D] = softmax(q_h k_h^T / sqrt(D) + bias[b]) v_h
//
// with products of input-dtype operands and f32 accumulation, scores and
// softmax in f32, P rounded to the input dtype before the PV product.
// When the caller passes lse (training: the backward's row statistics),
// each query row also gets (m, log(sum)), its scores' max and the log of
// its softmax sum, in a (B, H, Sq, 2) f32 tensor: their sum is the row's
// log-sum-exp, kept in two parts because a fully masked row's scores lie
// near -1e4, where one f32 holds the sum only to 2^-10, and exp(s - lse)
// would then scale the whole row's P by up to 5e-4; exp((s - m) -
// log(sum)) is exact to a few ulp.  Without lse the output is unchanged.
//
// What bounds it on an H100 (bf16, 12 heads of 64; chip_smoke.py's
// _bound_ms): at 165-185 tokens, batch 256, a call moves 260-291 MB (q,
// k, v read once, the output written once) against 21-27 GFLOP, so bytes
// bound it, 78-87 us at 3.35 TB/s; at 277 tokens 436 MB, 130 us (61 us of
// products); at 597 tokens, batch 64, 235 MB (70.1 us) against 70 GFLOP
// (70.9 us): the products.
//
// bf16 (fused_attention_long_wgmma<kWG>), one body for every length, on
// Hopper's warpgroup products (wgmma.cuh).  One block per (batch row,
// head, group of kWG = 2 query tiles of kTileQ = 64 rows; 1 when Sq <=
// 64): warpgroup w owns query tile w of the group, 64 rows, wgmma's
// native M.  The block walks the row's keys in tiles of kKvTile = 64
// with an online softmax (a running max m and sum l per row, O rescaled
// by exp(m_old - m_new) when the max moves, O / l once at the end), and
// - K, V and the bias stream through a ring of kRingStages = 3 stages
//   that every thread of the block fills by cp.async, straight from the
//   strided q, k, v of the fused QKV product into the 128-byte swizzle
//   that wgmma reads (no copies in device memory): the loads of tiles
//   kt + 1 and kt + 2 are in flight while tile kt is computed, one
//   barrier per tile; the group's two query tiles share each K / V load;
// - S = Q K^T as wgmma m64n64k16 from shared memory, in registers (32 f32
//   a thread, the m16n8 C layout); the row max and sum by quad shuffles,
//   exp as ex2.approx (__expf), whose f32 errors are far below the bf16
//   rounding of P; P = exp(S - m) rounded to bf16 straight into the
//   register A fragments of O += P V, wgmma m64n64k16 with V MN-major
//   from the stage; O (32 f32 a thread) in registers, written once.
// S and P never touch shared memory.  Ragged tiles: the key tiles past
// skv are zero with a -inf bias (P = 0), query rows past sq are zero and
// not written, and a warpgroup whose tile lies past sq only loads and
// syncs.  The body holds 118 registers and 67 KB of shared memory, so
// two blocks share an SM: 4 warpgroups, which hide each other's softmax
// and loads.
// Tried on the H100 in A/B builds of this file and dropped (PERF.md §6):
// 3 warpgroups a block (every query tile of a 165-185-token row in one
// block, K and V read once per row and head, but 153 registers and one
// block an SM), 9-21% slower; 1 a block (3 blocks an SM, by shared
// memory), 2-22% slower; a ring of 2 or 4 stages instead of 3, -0.5% to
// +3.0%; a persistent grid (as many blocks as the card holds, each
// streaming its work items' key tiles through one ring), 2-13% slower.
// A build that loaded no key tile past the ring's first fill (wrong
// output; the body's time without its K / V stream) was 8-9% faster at
// 165-185 tokens and 15-19% at 277-597, where 3-5 blocks read each row's
// K and V.  A deeper ring does not buy that back, so TMA, which makes the
// same copies from one thread, is not used (cp.async writes the same
// swizzled layout, without a tensor map or libcuda); one load multicast
// to a row's blocks (a cluster) would cut the re-reads.
// The bf16 bodies this one replaced (mma.sync m16n8k16, 463-473 us at
// 165-185 tokens): a whole-row body up to 256 keys, one block of 4 warps
// per (row, head, query tile) that loaded the row's whole K and V and
// waited for every load before its first product (each query tile
// re-read K and V), and a key-tiled body beyond, 64-key tiles through a
// double-buffered ring with ldmatrix fragments (36 bytes spilled).
//
// f32, on the CUDA cores: up to kLongWholeKv = 256 keys the whole-row
// body (attention_common.cuh, fused_attention_f32, one thread per output)
// with query tiles, kLongPerLane = 8 keys per lane in the softmax and
// kLongF32Threads = 1024 threads, exact to the plain version's order;
// beyond, fused_attention_long_tiled_f32, the online softmax over key
// tiles (scores in shared memory by tile, expf, fmaf in key order).
//
// Limits: any Sq and Skv, D <= 64 (the wrapper raises beyond that); f32
// and bf16 inputs; the bias is a (B, Skv) f32 additive mask.  A fully
// masked row (bias -10000 everywhere) has a finite max, hence a finite
// lse and output.

#include "attention_common.cuh"
#include "wgmma.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16: wgmma over a ring of key tiles.
// ---------------------------------------------------------------------------

constexpr int kRingStages = 3;            // key tiles the ring holds
static_assert(kRingStages >= 2, "the ring needs a stage in flight beside the one computed");
constexpr int kRow = 64;                   // bf16 values in one 128-byte swizzled row
constexpr unsigned kSwizzlePeriod = 1024;  // bytes: 8 swizzled rows
constexpr size_t kTileBytes = sizeof(__nv_bfloat16) * kRow * kTileQ;  // a 64-row tile, 8 KB

// Shared memory of a block of `wg` warpgroups: their Q tiles, then the
// ring's K and V stages (each tile on a 1024-byte boundary, the
// swizzle's period), then the ring's bias stages (kKvTile f32 each, -inf
// past skv).  The launch adds one period so that the kernel can align
// the tiles itself.
struct RingLayout {
  size_t k_off, v_off, b_off, bytes;
};

__host__ __device__ inline RingLayout ring_layout(int wg) {
  RingLayout L;
  L.k_off = kTileBytes * wg;
  L.v_off = L.k_off + kTileBytes * kRingStages;
  L.b_off = L.v_off + kTileBytes * kRingStages;
  L.bytes = L.b_off + sizeof(float) * kKvTile * kRingStages;
  return L;
}

size_t ring_smem_bytes(int wg) { return ring_layout(wg).bytes + kSwizzlePeriod; }

// `rows` rows (< kTileQ: the rest zero) of d values of a strided bf16
// source, row stride rs, into a 64-row tile at dst in the 128-byte
// swizzle: 16-byte chunk c of row r at chunk c ^ (r % 8), zero past d.
// cp.async where the source allows 16-byte copies; the caller commits,
// waits, fences (fence_proxy_async) and syncs before wgmma reads it.
__device__ __forceinline__ void load_swizzled(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                              long long rs, int d, int rows, int tid,
                                              int nthreads) {
  const bool vec = d % 8 == 0 && rs % 8 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0;
  for (int i = tid; i < kTileQ * 8; i += nthreads) {
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

// Key tile kt (keys kt * kKvTile ..) of a (batch row, head) into ring
// stage kt % kRingStages: K, V and the bias; one cp.async group, an empty
// one when kt is past the last tile.
__device__ __forceinline__ void stage_ring(const Args& a, int b, int h, int kt,
                                           unsigned char* smem, const RingLayout& L, int tid,
                                           int nthreads) {
  const int k0 = kt * kKvTile;
  if (k0 < a.skv) {
    const int st = kt % kRingStages, nk = min(a.skv - k0, kKvTile), d = a.dim;
    load_swizzled(reinterpret_cast<__nv_bfloat16*>(smem + L.k_off + st * kTileBytes),
                  static_cast<const __nv_bfloat16*>(a.k) + b * a.k_bs + k0 * a.k_rs + h * d,
                  a.k_rs, d, nk, tid, nthreads);
    load_swizzled(reinterpret_cast<__nv_bfloat16*>(smem + L.v_off + st * kTileBytes),
                  static_cast<const __nv_bfloat16*>(a.v) + b * a.v_bs + k0 * a.v_rs + h * d,
                  a.v_rs, d, nk, tid, nthreads);
    float* bs = reinterpret_cast<float*>(smem + L.b_off) + st * kKvTile;
    for (int j = tid; j < kKvTile; j += nthreads) {
      if (j < nk) {
        cp_async4(bs + j, a.bias + static_cast<long long>(b) * a.skv + k0 + j);
      } else {
        bs[j] = -CUDART_INF_F;
      }
    }
  }
  cp_async_commit();
}

// Blocks of kWG warpgroups an SM should hold (__launch_bounds__): 4
// warpgroups of at most 128 registers a thread.
constexpr int ring_min_blocks(int wg) { return 4 / wg; }

// One block per (batch row, head, group of kWG query tiles): warpgroup w
// owns query tile group * kWG + w (rows past sq: it only loads and
// syncs), and the block's threads stream the row's key tiles through the
// ring together, so K and V are read once per group.
template <int kWG>
__global__ void __launch_bounds__(kWG * kMmaThreads, ring_min_blocks(kWG))
    fused_attention_long_wgmma(Args a) {
  static_assert(kWG == 1 || kWG == 2, "1 or 2 warpgroups a block");
  constexpr int kThreads = kWG * kMmaThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];  // aligned to the swizzle's period below
  unsigned char* smem =
      smem_raw + ((kSwizzlePeriod - smem_u32(smem_raw) % kSwizzlePeriod) % kSwizzlePeriod);
  const RingLayout L = ring_layout(kWG);
  const int groups = ((a.sq + kTileQ - 1) / kTileQ + kWG - 1) / kWG;
  const int bh = blockIdx.x / groups, b = bh / a.heads, h = bh % a.heads;
  const int first = blockIdx.x % groups * kWG;  // the group's first query tile
  const int d = a.dim, tid = threadIdx.x, wg = tid / kMmaThreads;
  const int ktiles = (a.skv + kKvTile - 1) / kKvTile;

#pragma unroll
  for (int w = 0; w < kWG; ++w) {
    const int t0 = (first + w) * kTileQ;
    load_swizzled(reinterpret_cast<__nv_bfloat16*>(smem + w * kTileBytes),
                  static_cast<const __nv_bfloat16*>(a.q) + b * a.q_bs + t0 * a.q_rs + h * d,
                  a.q_rs, d, max(0, min(kTileQ, a.sq - t0)), tid, kThreads);
  }
#pragma unroll
  for (int kt = 0; kt < kRingStages - 1; ++kt) {
    stage_ring(a, b, h, kt, smem, L, tid, kThreads);  // the Q tiles ride in tile 0's group
  }

  // A thread holds rows i0 = 16 warp + g and i0 + 8 of its warpgroup's
  // tile, columns 8 n + tq + (e & 1) in element 4 n + e of s (keys) and
  // o (head dims); e >= 2 is row i0 + 8 (wgmma.cuh).
  const int q0 = (first + wg) * kTileQ;
  const bool active = q0 < a.sq;
  const int lane = tid & 31, warp = (tid >> 5) & 3, g = lane >> 2, tq = (lane & 3) * 2;
  const uint64_t dq = wgmma_desc_sw128(smem + wg * kTileBytes);
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;

  for (int kt = 0; kt < ktiles; ++kt) {
    // Tile kt has landed (this thread's copies), is visible to wgmma
    // (the fence) and everyone's (the barrier), and every warpgroup is
    // done with tile kt - 1, whose stage the next load takes.
    cp_async_wait_group<kRingStages - 2>();
    fence_proxy_async();
    __syncthreads();
    stage_ring(a, b, h, kt + kRingStages - 1, smem, L, tid, kThreads);
    if (!active) continue;
    const int st = kt % kRingStages;

    // S = Q K^T (wgmma m64n64k16, both from shared memory), 4 steps of 16.
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    const uint64_t dk = wgmma_desc_sw128(smem + L.k_off + st * kTileBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kMaxDim / 16; ++kk) WgmmaSS<64>::mma(s, dq + 2 * kk, dk + 2 * kk, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(s);

    // Scale and bias (-inf past skv), the tile's row max by quad shuffles.
    // Every tile holds a key below skv, whose score is finite: so is the
    // new max, and the first tile's rescale is exp(-inf) = 0.
    const float* bs = reinterpret_cast<const float*>(smem + L.b_off) + st * kKvTile;
    float t0 = -CUDART_INF_F, t1 = -CUDART_INF_F;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[4 * n + e] * a.scale + bs[8 * n + tq + (e & 1)];
        s[4 * n + e] = x;
        if (e < 2) t0 = fmaxf(t0, x); else t1 = fmaxf(t1, x);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, off));
      t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, off));
    }
    const float n0 = fmaxf(m0, t0), n1 = fmaxf(m1, t1);
    const float c0 = __expf(m0 - n0), c1 = __expf(m1 - n1);
    m0 = n0;
    m1 = n1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= (i & 2) ? c1 : c0;

    // P = exp(S - m), unnormalised, its row sums in f32, P rounded to bf16
    // into the A fragments of P V: keys 16 c .. 16 c + 15 are the
    // accumulators of column tiles 2 c and 2 c + 1.
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = __expf(s[i] - ((i & 2) ? m1 : m0));
      s[i] = p;
      if (i & 2) l1 += p; else l0 += p;
    }
    uint32_t pa[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      pa[c][0] = pack_f32_pair(s[8 * c], s[8 * c + 1]);
      pa[c][1] = pack_f32_pair(s[8 * c + 2], s[8 * c + 3]);
      pa[c][2] = pack_f32_pair(s[8 * c + 4], s[8 * c + 5]);
      pa[c][3] = pack_f32_pair(s[8 * c + 6], s[8 * c + 7]);
    }

    // O += P V: wgmma m64n64k16, P from registers, V (MN-major: key rows
    // of 64 values, the transpose bit) from the stage, 16 key rows a step.
    const uint64_t dv = wgmma_desc_sw128(smem + L.v_off + st * kTileBytes);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < 4; ++c) WgmmaRS64::mma(o, pa[c], dv + c * 16 * 8, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(o);
    fence_operands(pa);
  }
  if (!active) return;

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;  // a row's max term is 1: sum >= 1
  const int i0 = warp * 16 + g;
  const long long out_rs = static_cast<long long>(a.heads) * d;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out) +
                       (static_cast<long long>(b) * a.sq + q0) * out_rs + h * d;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = i0 + 8 * half;
    if (q0 + i >= a.sq) continue;
    const float inv = half ? inv1 : inv0;
    __nv_bfloat16* row = out + i * out_rs;
#pragma unroll
    for (int n = 0; n < kMaxDim / 8; ++n) {
      const int c = n * 8 + tq;
      if (c >= d) continue;
      const float x0 = o[4 * n + 2 * half] * inv, x1 = o[4 * n + 2 * half + 1] * inv;
      if ((d & 1) == 0) {
        *reinterpret_cast<uint32_t*>(row + c) = pack_f32_pair(x0, x1);
      } else {
        row[c] = __float2bfloat16(x0);
        if (c + 1 < d) row[c + 1] = __float2bfloat16(x1);
      }
    }
  }
  if (a.lse != nullptr && (lane & 3) == 0) {
    float* lse = a.lse + 2 * ((static_cast<long long>(b) * a.heads + h) * a.sq + q0 + i0);
    if (q0 + i0 < a.sq) {
      lse[0] = m0;
      lse[1] = logf(l0);
    }
    if (q0 + i0 + 8 < a.sq) {
      lse[16] = m1;
      lse[17] = logf(l1);
    }
  }
}

// f32, CUDA cores.  Shared memory, f32, ld = dim + 1: Q (kTileQ x ld), K,
// V (kKvTile x ld), the tile's scores / probabilities (kTileQ x (kKvTile +
// 1)), bias (kKvTile), and per row the running max, sum and rescale
// (kTileQ each).  Each thread keeps kTiledF32Elems (row, column) elements
// of O in registers.
constexpr int kTiledF32Threads = 256;
constexpr int kTiledF32Elems = kTileQ * kMaxDim / kTiledF32Threads;

size_t tiled_f32_smem_bytes(int d) {
  const size_t ld = d + 1;
  return sizeof(float) * (kTileQ * ld + 2 * kKvTile * ld + kTileQ * (kKvTile + 1) + kKvTile +
                          3 * kTileQ);
}

__global__ void __launch_bounds__(kTiledF32Threads) fused_attention_long_tiled_f32(Args a) {
  extern __shared__ float smem[];
  const FwdTile f = fwd_tile(a, sizeof(float));
  const int b = f.b, h = f.h, q0 = f.q0;
  const int sq = f.t.sq, skv = a.skv, d = a.dim, ld = d + 1, ldp = kKvTile + 1;
  float* qs = smem;
  float* ks = qs + kTileQ * ld;
  float* vs = ks + kKvTile * ld;
  float* ps = vs + kKvTile * ld;
  float* bs = ps + kTileQ * ldp;
  float* rm = bs + kKvTile;  // running max, sum and this tile's rescale per row
  float* rl = rm + kTileQ;
  float* rc = rl + kTileQ;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  constexpr int kThreads = kTiledF32Threads, kWarps = kThreads / 32;

  load_rows_f32(qs, ld, static_cast<const float*>(f.t.q) + b * a.q_bs + h * d, a.q_rs, sq, d, tid,
                kThreads);
  for (int i = tid; i < kTileQ; i += kThreads) {
    rm[i] = -CUDART_INF_F;
    rl[i] = 0.f;
  }
  float o[kTiledF32Elems];
#pragma unroll
  for (int e = 0; e < kTiledF32Elems; ++e) o[e] = 0.f;

  for (int k0 = 0; k0 < skv; k0 += kKvTile) {
    const int nk = min(skv - k0, kKvTile);
    __syncthreads();  // the previous tile is done with K, V, P
    load_rows_f32(ks, ld, static_cast<const float*>(a.k) + b * a.k_bs + k0 * a.k_rs + h * d,
                  a.k_rs, nk, d, tid, kThreads);
    load_rows_f32(vs, ld, static_cast<const float*>(a.v) + b * a.v_bs + k0 * a.v_rs + h * d,
                  a.v_rs, nk, d, tid, kThreads);
    for (int j = tid; j < nk; j += kThreads) bs[j] = a.bias[b * skv + k0 + j];
    __syncthreads();

    // Scores as scores_f32 computes them: the same order of products.
    for (int idx = tid; idx < sq * nk; idx += kThreads) {
      const int i = idx / nk, j = idx % nk;
      const float* qi = qs + i * ld;
      const float* kj = ks + j * ld;
      float acc = 0.f;
#pragma unroll 8
      for (int c = 0; c < d; ++c) acc = fmaf(qi[c], kj[c], acc);
      ps[i * ldp + j] = acc * a.scale + bs[j];
    }
    __syncthreads();

    // Online softmax, one warp per row, keys lane and lane + 32.
    for (int i = warp; i < sq; i += kWarps) {
      float* pi = ps + i * ldp;
      const float x0 = lane < nk ? pi[lane] : -CUDART_INF_F;
      const float x1 = lane + 32 < nk ? pi[lane + 32] : -CUDART_INF_F;
      float mt = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float mn = fmaxf(rm[i], mt);
      const float p0 = lane < nk ? expf(x0 - mn) : 0.f;
      const float p1 = lane + 32 < nk ? expf(x1 - mn) : 0.f;
      if (lane < nk) pi[lane] = p0;
      if (lane + 32 < nk) pi[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float c = expf(rm[i] - mn);
        rc[i] = c;
        rl[i] = rl[i] * c + sum;
        rm[i] = mn;
      }
    }
    __syncthreads();

#pragma unroll
    for (int e = 0; e < kTiledF32Elems; ++e) {
      const int idx = tid + e * kThreads;
      if (idx < sq * d) {
        const int i = idx / d, c = idx % d;
        const float* pi = ps + i * ldp;
        float acc = o[e] * rc[i];
#pragma unroll 4
        for (int j = 0; j < nk; ++j) acc = fmaf(pi[j], vs[j * ld + c], acc);
        o[e] = acc;
      }
    }
  }

  const long long out_rs = static_cast<long long>(a.heads) * d;
  float* out = static_cast<float*>(a.out) + static_cast<long long>(b) * a.sq * out_rs +
               q0 * out_rs + h * d;
#pragma unroll
  for (int e = 0; e < kTiledF32Elems; ++e) {
    const int idx = tid + e * kThreads;
    if (idx < sq * d) {
      const int i = idx / d, c = idx % d;
      out[i * out_rs + c] = o[e] / rl[i];
    }
  }
  if (a.lse != nullptr) {
    float* lse = a.lse + 2 * ((static_cast<long long>(b) * a.heads + h) * a.sq + q0);
    for (int i = tid; i < sq; i += kThreads) {
      lse[2 * i] = rm[i];
      lse[2 * i + 1] = logf(rl[i]);
    }
  }
}

template <int kWG>
int launch_ring(const Args& a, int batch, cudaStream_t s) {
  const auto kernel = fused_attention_long_wgmma<kWG>;
  const size_t smem = ring_smem_bytes(kWG);
  if (const int err = allow_smem(kernel, smem)) return err;
  const int groups = ((a.sq + kTileQ - 1) / kTileQ + kWG - 1) / kWG;
  const unsigned blocks = static_cast<unsigned>(batch) * a.heads * static_cast<unsigned>(groups);
  kernel<<<blocks, kWG * kMmaThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Two warpgroups a block (one when there is one query tile): at 118
// registers two blocks share an SM, 4 warpgroups.
int launch_long_bf16(const Args& a, int batch, cudaStream_t s) {
  return a.sq <= kTileQ ? launch_ring<1>(a, batch, s) : launch_ring<2>(a, batch, s);
}

}  // namespace

extern "C" {

// The argument list of rgqa_fused_attention_fwd (fused_attention.cu)
// with lse after out: dtype 0 = float32, 1 = bfloat16; strides in
// elements, the last dimension of q, k and v contiguous; the output is a
// contiguous (batch, sq, heads * dim) tensor of the input dtype; lse, when
// not null, a contiguous (batch, heads, sq, 2) f32 tensor that receives
// each row's (m, log(sum)).  Returns the cudaError_t of the launch (0 on
// success); -1 for arguments outside the kernel's limits.
int rgqa_fused_attention_long_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* out, void* lse,
    int dtype, int batch, int sq, int skv, int heads, int dim,
    long long q_bs, long long q_rs, long long k_bs, long long k_rs,
    long long v_bs, long long v_rs, float scale, void* stream) {
  if (!within_long_limits(batch, sq, skv, heads, dim)) return -1;
  Args a = make_args(q, k, v, bias, sq, skv, heads, dim, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs,
                     scale);
  a.out = out;
  a.lse = static_cast<float*>(lse);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_long_bf16(a, batch, s);
  if (dtype != 0) return -1;
  const int tiles = (a.sq + kTileQ - 1) / kTileQ;
  if (a.skv > kLongWholeKv) {
    return launch(fused_attention_long_tiled_f32, a, batch, kTiledF32Threads,
                  tiled_f32_smem_bytes(a.dim), s, tiles);
  }
  return launch(fused_attention_f32<kLongPerLane, kLongF32Threads>, a, batch,
                kLongF32Threads, fwd_f32_smem_bytes(tile_rows(a.sq), a.skv, a.dim), s, tiles);
}

}  // extern "C"

RGQA_CUDA_ERROR_STRING
