// Fused multi-head attention backward for long streams, on the natural
// (B, S, H*D) layout.
//
// Replaces the Pallas TPU kernel rgqa_tpu/ops/attention.py:_fused_bwd_kernel
// where it runs at ViLT's streams (launched by _fused_bwd_pallas_raw under
// the raised VMEM tiers of _fit_bwd_block; from 246 tokens on the JAX
// package differentiates its XLA path instead, which computes the same
// function): the backward of every ViLT training step, 12 calls per step.
// Per (batch row, head), for the output gradient g and the forward's row
// statistics (m, log(sum)) (fused_attention_long.cu), it computes what the
// short backward (fused_attention_bwd.cu) does:
//
//     P = exp((s - m) - log(sum)),  s = q k^T / sqrt(D) + bias  (recomputed, f32)
//     dP = g V^T,  dV = P^T g
//     dS = P (dP - D),  D = rowsum(dP P)
//     dQ = (dS/sqrt(D)) K,  dK = (dS/sqrt(D))^T Q     (dS in the input dtype)
//     dbias[b, j] = sum over heads h and query rows i of dS[h, i, j]
//
// dq, dk, dv in the input dtype, dbias in f32.  The plain version is
// rgqa_tpu_torch.ops.attention.attention_bwd_ref.  q, k and v may be
// strided column views (the fused QKV product, row stride 3E); g is
// contiguous.
//
// The TPU held a (Bt, Sq, Skv) block in VMEM; on Hopper the work is tiled,
// and three sums cross any tiling: dK and dV sum over every query row, dQ
// and D over every key, dbias over heads and query rows.  The design
// splits the work where the sums allow and never adds floats from two
// blocks into one place, so two runs give identical bits (float atomics
// for dQ would not):
//
// - the dQ pass, one block per (batch row, head, query tile of 64), the
//   tile fastest: it keeps its Q and g tiles and each row's statistics, and walks
//   the key tiles twice.  The first sweep takes D_i = sum_j P_ij dP_ij in
//   f32 (S and dP: two products per score) and leaves it in a (B, H, Sq)
//   f32 scratch; the second computes dS = P (dP - D) and accumulates dQ +=
//   round(dS scale) K in registers (three products), written once.
// - the dK/dV pass, one block per (batch row, head, key tile of 64), on
//   the same stream after it: it keeps its keys' K and V and walks the
//   query tiles with their statistics and D, computing S^T, P^T, dP^T and dS^T,
//   and accumulates dV += P^T g, dK += round(dS^T scale) Q and the column
//   sums of dS in registers over every query row in order (four
//   products); then writes dK, dV and its head's dbias partials once.
// - then fused_attention_dbias_sum (attention_common.cuh) adds the
//   partials over heads in head order, as for the short backward.
//
// Why D takes a sweep of its own: algebraically D_i = rowsum(g_i o_i), but
// the forward's output is bf16, and D from it moves dbias (a sum of 12 x Sq
// terms P_ij D_i) past its bound, 1e-3 + 1e-4 |plain|
// (tests/test_torch_attention_long.py emulates it at ViLT's shapes).  No
// row-wide array is held anywhere, so both passes take any Sq and Skv.
//
// Bodies:
// - bf16: every product on the tensor cores (mma.sync m16n8k16, bf16 in,
//   f32 accumulate; products of bf16 operands are exact in f32, so dP is
//   the plain version's up to summation order), every fragment loaded by
//   ldmatrix (.trans where the operand is read along its columns), tiles
//   staged by a double-buffered cp.async ring (tile t + 1 in flight while
//   tile t is computed).  Each warp works 16 keys at a time, so it holds
//   a 16 x 16 block of S and dP, not a tile's: the dQ pass keeps the Q and
//   g fragments and dQ (16 x 64 f32) in registers, the dK/dV pass the K and
//   V fragments, dK and dV (16 x 64 f32 each) and the dbias sums.  P
//   enters dV rounded to bf16, where the TPU kernel and the plain version
//   keep it in f32: dV then differs by about one bf16 step of its terms,
//   inside the bf16 bound the short backward is held to (3e-2 + 1e-2
//   |plain|).  exp is __expf (ex2.approx), a few f32 ulp, far below those
//   roundings.  At D = 64 the dQ pass uses 126 registers (capped for 4
//   blocks per SM) and 55.8 KB of shared memory, the dK/dV pass 168
//   registers (3 blocks per SM, 8 bytes spilled) and 57.1 KB.  Measured
//   against this on the H100 (A B B A, PERF.md): 3 blocks per SM for the
//   dQ pass, warp steps of 32 or 64 keys (more independent products, more
//   registers), A fragments reloaded from shared memory instead of held,
//   and ring tiles of 32 for 5 blocks per SM were all slower.  The dK/dV
//   pass is the warpgroup shape wgmma wants (64 keys, B from shared
//   memory); it stays on mma.sync + ldmatrix, whose fragments the softmax
//   reads and writes in registers directly, where wgmma's would need its
//   own operand layouts in shared memory: later work.
// - f32: the same two passes on the CUDA cores (fmaf in f32), query tiles
//   of 32 rows in the dQ pass and key tiles of 32 in the dK/dV pass, each
//   walking the other side in tiles; checked, not timed.
//
// What bounds it on an H100 (chip_smoke.py's _bound_ms: q, k, v, g read
// and dq, dk, dv written once; 10 flops per score and head dim for S, dP,
// dV, dQ, dK): bytes at ViLT-B/32's training stream, 165 / 185 tokens at
// batch 256, 135.7 / 152.1 us; 228 us at 277 tokens; the products at 597
// tokens, batch 64, 177 us.  This design does 9 products per score where
// the bound counts 5 (S and dP three times: once per sweep and once in the
// dK/dV pass), and each block re-reads its row's other side from L2.
//
// Limits: any Sq and Skv, D <= 64; the wrapper raises beyond them.  A
// fully masked row (bias -10000 everywhere) has finite statistics, so its
// P and gradients are finite.

#include "attention_common.cuh"

namespace {

constexpr int kF32TileQ = 32;   // query rows per f32 dQ block
constexpr int kF32TileK = 32;   // keys per f32 dK/dV block, and per f32 dQ step
constexpr int kF32ChunkQ = 64;  // query rows per f32 dK/dV step
constexpr int kBwdF32Threads = 256;

__device__ __forceinline__ long long row_index(const Args& a, int b, int h, int i) {
  return (static_cast<long long>(b) * a.heads + h) * a.sq + i;
}

// ---------------------------------------------------------------------------
// bf16, the dQ pass.  Shared memory, bf16 unless noted, row stride DP + 8
// (ldmatrix rows in distinct banks, 16-byte aligned): Qs, Gs (kTileQ x
// DP) zero-padded; two stages of Ks, Vs (kKvTile x DP) zero-padded and
// bias f32 (kKvTile, -inf past skv).
// ---------------------------------------------------------------------------

struct DqLayout {
  int dp, ld;
  size_t g_off, k_off, v_off, b_off, bytes;
};

__host__ __device__ inline DqLayout dq_layout(int d) {
  DqLayout L;
  L.dp = (d + 15) / 16 * 16;
  L.ld = L.dp + 8;
  const size_t bf = sizeof(__nv_bfloat16);
  L.g_off = bf * kTileQ * L.ld;  // every offset a multiple of 16 bytes
  L.k_off = L.g_off + bf * kTileQ * L.ld;
  L.v_off = L.k_off + 2 * bf * kKvTile * L.ld;
  L.b_off = L.v_off + 2 * bf * kKvTile * L.ld;
  L.bytes = L.b_off + 2 * sizeof(float) * kKvTile;
  return L;
}

// Key tile step % ktiles into stage `stage` (load_kv_tile), committed as
// one group (an empty one when step is past the last).
__device__ __forceinline__ void stage_keys(const Args& a, int b, int h, int step, int ktiles,
                                           unsigned char* smem_raw, const DqLayout& L,
                                           int stage, int tid) {
  if (step < 2 * ktiles) {
    load_kv_tile(a, b, h, step % ktiles * kKvTile,
                 reinterpret_cast<__nv_bfloat16*>(smem_raw + L.k_off) + stage * kKvTile * L.ld,
                 reinterpret_cast<__nv_bfloat16*>(smem_raw + L.v_off) + stage * kKvTile * L.ld,
                 reinterpret_cast<float*>(smem_raw + L.b_off) + stage * kKvTile, L.ld, L.dp, tid);
  }
  cp_async_commit();
}

// One warp's 16 x 16 block of S = X Y^T over the head dim for the rows
// of its A fragments xa and the 16 rows of y (keys or queries): the
// n-tiles (rows 0-7 and 8-15 of y) in acc[0] and acc[1].
__device__ __forceinline__ void product_16x16(float (&acc)[2][4],
                                              const uint32_t (&xa)[kMaxDim / 16][4],
                                              const __nv_bfloat16* y, int ld, int dp, int lane) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[0][e] = acc[1][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kMaxDim / 16; ++kk) {
    if (kk * 16 < dp) {
      uint32_t bf[4];
      lds_b_rows(bf, y + kk * 16, ld, lane);
      mma_16x8x16(acc[0], xa[kk], bf[0], bf[1]);
      mma_16x8x16(acc[1], xa[kk], bf[2], bf[3]);
    }
  }
}

// Registers capped for 4 blocks per SM (126 used; 3 blocks: 146 used and
// 5% slower, PERF.md).
__global__ void __launch_bounds__(kMmaThreads, 4) long_bwd_dq_bf16(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const FwdTile f = fwd_tile(a, sizeof(__nv_bfloat16));
  const int b = f.b, h = f.h, q0 = f.q0;
  const int sq = f.t.sq, d = a.dim;
  const long long row = static_cast<long long>(a.heads) * d;  // g and dq row stride
  const DqLayout L = dq_layout(d);
  const __nv_bfloat16* qs = reinterpret_cast<const __nv_bfloat16*>(smem_raw);
  const __nv_bfloat16* gs = reinterpret_cast<const __nv_bfloat16*>(smem_raw + L.g_off);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ktiles = (a.skv + kKvTile - 1) / kKvTile;

  load_tile(reinterpret_cast<__nv_bfloat16*>(smem_raw), L.ld,
            static_cast<const __nv_bfloat16*>(f.t.q) + b * a.q_bs + h * d, a.q_rs, sq, kTileQ, d,
            L.dp, tid);
  load_tile(reinterpret_cast<__nv_bfloat16*>(smem_raw + L.g_off), L.ld,
            static_cast<const __nv_bfloat16*>(a.g) + (static_cast<long long>(b) * a.sq + q0) * row + h * d,
            row, sq, kTileQ, d, L.dp, tid);
  stage_keys(a, b, h, 0, ktiles, smem_raw, L, 0, tid);  // one group: Q, g and key tile 0

  // Warp w owns query rows r0 .. r0 + 15; a lane holds rows r0 + g (e < 2)
  // and r0 + g + 8 (e >= 2).  Warps past the tile's rows take part in the
  // loads and barriers only.
  const int r0 = warp * 16;
  const bool active = r0 < sq;
  const int g = lane >> 2, t = (lane & 3) * 2;
  const float* lse = a.lse + 2 * row_index(a, b, h, q0);
  // Rows past sq: m = +inf makes their P 0.
  const float m0 = r0 + g < sq ? lse[2 * (r0 + g)] : CUDART_INF_F;
  const float m1 = r0 + g + 8 < sq ? lse[2 * (r0 + g + 8)] : CUDART_INF_F;
  const float ll0 = r0 + g < sq ? lse[2 * (r0 + g) + 1] : 0.f;
  const float ll1 = r0 + g + 8 < sq ? lse[2 * (r0 + g + 8) + 1] : 0.f;
  uint32_t qa[kMaxDim / 16][4], ga[kMaxDim / 16][4];
  float dq[kMaxDim / 8][4];
#pragma unroll
  for (int dt = 0; dt < kMaxDim / 8; ++dt) dq[dt][0] = dq[dt][1] = dq[dt][2] = dq[dt][3] = 0.f;
  float dd0 = 0.f, dd1 = 0.f;  // D of rows r0 + g and r0 + g + 8 (lane partials, then whole)

  for (int step = 0; step < 2 * ktiles; ++step) {
    const int stage = step & 1, k0 = step % ktiles * kKvTile;
    const int nk = min(a.skv - k0, kKvTile);
    stage_keys(a, b, h, step + 1, ktiles, smem_raw, L, stage ^ 1, tid);
    cp_async_wait_group<1>();
    __syncthreads();
    if (active) {
      const __nv_bfloat16* ks =
          reinterpret_cast<const __nv_bfloat16*>(smem_raw + L.k_off) + stage * kKvTile * L.ld;
      const __nv_bfloat16* vs =
          reinterpret_cast<const __nv_bfloat16*>(smem_raw + L.v_off) + stage * kKvTile * L.ld;
      const float* bs = reinterpret_cast<const float*>(smem_raw + L.b_off) + stage * kKvTile;
      if (step == 0) {
#pragma unroll
        for (int kk = 0; kk < kMaxDim / 16; ++kk) {
          if (kk * 16 < L.dp) {
            lds_a(qa[kk], qs + r0 * L.ld + kk * 16, L.ld, lane);
            lds_a(ga[kk], gs + r0 * L.ld + kk * 16, L.ld, lane);
          }
        }
      }
      const bool second = step >= ktiles;
      if (second && step == ktiles) {
        // The first sweep is done: D over every key.
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          dd0 += __shfl_xor_sync(0xffffffffu, dd0, off);
          dd1 += __shfl_xor_sync(0xffffffffu, dd1, off);
        }
      }
      // 16 keys at a time: P and dP for the warp's 16 rows x keys kc ..
      // kc + 15, then D (first sweep) or dS and dQ (second).
      for (int kc = 0; kc < nk; kc += 16) {
        float s[2][4], dp[2][4];
        product_16x16(s, qa, ks + kc * L.ld, L.ld, L.dp, lane);
        product_16x16(dp, ga, vs + kc * L.ld, L.ld, L.dp, lane);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = s[n][e] * a.scale + bs[kc + n * 8 + t + (e & 1)];
            s[n][e] = __expf((x - (e < 2 ? m0 : m1)) - (e < 2 ? ll0 : ll1));
          }
        }
        if (!second) {
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            dd0 += s[n][0] * dp[n][0] + s[n][1] * dp[n][1];
            dd1 += s[n][2] * dp[n][2] + s[n][3] * dp[n][3];
          }
        } else {
#pragma unroll
          for (int n = 0; n < 2; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] *= dp[n][e] - (e < 2 ? dd0 : dd1);
          }
          uint32_t af[4];
          acc_to_a(af, s, a.scale);
          accumulate_16xd(dq, af, ks + kc * L.ld, L.ld, L.dp, lane);
        }
      }
    }
    __syncthreads();  // the stage is free for step + 2
  }
  if (!active) return;

  __nv_bfloat16* dqp = static_cast<__nv_bfloat16*>(a.dq) +
                       (static_cast<long long>(b) * a.sq + q0) * row + h * d;
#pragma unroll
  for (int dt = 0; dt < kMaxDim / 8; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = r0 + g + (e >= 2 ? 8 : 0), c = dt * 8 + t + (e & 1);
      if (i < sq && c < d) dqp[i * row + c] = __float2bfloat16(dq[dt][e]);
    }
  }
  if ((lane & 3) == 0) {
    float* dsum = a.dsum + row_index(a, b, h, q0);
    if (r0 + g < sq) dsum[r0 + g] = dd0;
    if (r0 + g + 8 < sq) dsum[r0 + g + 8] = dd1;
  }
}

// ---------------------------------------------------------------------------
// bf16, the dK/dV pass.  Shared memory, bf16 unless noted, row stride DP +
// 8: Ks, Vs (kKvTile x DP) zero-padded; two stages of the query tile's Qs,
// Gs (kTileQ x DP) zero-padded, and its statistics (m, log(sum)) and D
// f32 (kTileQ x 2 and kTileQ; m +inf and D 0 past sq, so those rows' P and
// dS are 0); bias f32 (kKvTile).
// ---------------------------------------------------------------------------

struct DkvLayout {
  int dp, ld;
  size_t v_off, q_off, g_off, l_off, d_off, b_off, bytes;
};

__host__ __device__ inline DkvLayout dkv_layout(int d) {
  DkvLayout L;
  L.dp = (d + 15) / 16 * 16;
  L.ld = L.dp + 8;
  const size_t bf = sizeof(__nv_bfloat16), f = sizeof(float);
  L.v_off = bf * kKvTile * L.ld;  // every offset a multiple of 16 bytes
  L.q_off = L.v_off + bf * kKvTile * L.ld;
  L.g_off = L.q_off + 2 * bf * kTileQ * L.ld;
  L.l_off = L.g_off + 2 * bf * kTileQ * L.ld;
  L.d_off = L.l_off + 2 * f * 2 * kTileQ;
  L.b_off = L.d_off + 2 * f * kTileQ;
  L.bytes = L.b_off + f * kKvTile;
  return L;
}

// Query tile qt into stage `stage` (Q, g, the statistics and D by
// cp.async), committed as one group (an empty one past the last tile).
__device__ __forceinline__ void stage_queries(const Args& a, int b, int h, int qt,
                                              unsigned char* smem_raw, const DkvLayout& L,
                                              int stage, int tid) {
  const int c0 = qt * kTileQ;
  if (c0 < a.sq) {
    const int nq = min(a.sq - c0, kTileQ), d = a.dim;
    const long long row = static_cast<long long>(a.heads) * d;
    __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.q_off) + stage * kTileQ * L.ld;
    __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.g_off) + stage * kTileQ * L.ld;
    float* ls = reinterpret_cast<float*>(smem_raw + L.l_off) + stage * 2 * kTileQ;
    float* ds = reinterpret_cast<float*>(smem_raw + L.d_off) + stage * kTileQ;
    load_tile(qs, L.ld, static_cast<const __nv_bfloat16*>(a.q) + b * a.q_bs + c0 * a.q_rs + h * d,
              a.q_rs, nq, kTileQ, d, L.dp, tid);
    load_tile(gs, L.ld,
              static_cast<const __nv_bfloat16*>(a.g) + (static_cast<long long>(b) * a.sq + c0) * row + h * d,
              row, nq, kTileQ, d, L.dp, tid);
    const long long r = row_index(a, b, h, c0);
    for (int i = tid; i < kTileQ; i += kMmaThreads) {
      if (i < nq) {
        cp_async8(ls + 2 * i, a.lse + 2 * (r + i));
        cp_async4(ds + i, a.dsum + r + i);
      } else {
        ls[2 * i] = CUDART_INF_F;
        ls[2 * i + 1] = 0.f;
        ds[i] = 0.f;
      }
    }
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kMmaThreads, 3) long_bwd_dkv_bf16(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int sq = a.sq, skv = a.skv, d = a.dim;
  const int ktiles = (skv + kKvTile - 1) / kKvTile;
  const int bh = blockIdx.x / ktiles, b = bh / a.heads, h = bh % a.heads;
  const int k0 = blockIdx.x % ktiles * kKvTile, nk = min(skv - k0, kKvTile);
  const long long row = static_cast<long long>(a.heads) * d;
  const DkvLayout L = dkv_layout(d);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.v_off);
  float* bs = reinterpret_cast<float*>(smem_raw + L.b_off);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane >> 2, t = (lane & 3) * 2;
  const int qtiles = (sq + kTileQ - 1) / kTileQ;

  load_kv_tile(a, b, h, k0, ks, vs, bs, L.ld, L.dp, tid);
  stage_queries(a, b, h, 0, smem_raw, L, 0, tid);  // one group: K, V, bias and query tile 0

  // Warp w owns keys r0 .. r0 + 15 of the tile, as the rows of the
  // transposed products: a lane holds keys r0 + g (e < 2) and r0 + g + 8,
  // queries 8 n + t + (e & 1).  Warps past the tile's keys take part in
  // the loads and barriers only.
  const int r0 = warp * 16;
  const bool active = r0 < nk;
  uint32_t ka[kMaxDim / 16][4], va[kMaxDim / 16][4];
  float bias0 = 0.f, bias1 = 0.f;
  float dk[kMaxDim / 8][4], dv[kMaxDim / 8][4];
#pragma unroll
  for (int dt = 0; dt < kMaxDim / 8; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.f;
  }
  float db0 = 0.f, db1 = 0.f;  // column sums of dS for keys r0 + g, r0 + g + 8

  for (int qt = 0; qt < qtiles; ++qt) {
    const int stage = qt & 1, nq = min(sq - qt * kTileQ, kTileQ);
    stage_queries(a, b, h, qt + 1, smem_raw, L, stage ^ 1, tid);
    cp_async_wait_group<1>();
    __syncthreads();
    if (active) {
      if (qt == 0) {
#pragma unroll
        for (int kk = 0; kk < kMaxDim / 16; ++kk) {
          if (kk * 16 < L.dp) {
            lds_a(ka[kk], ks + r0 * L.ld + kk * 16, L.ld, lane);
            lds_a(va[kk], vs + r0 * L.ld + kk * 16, L.ld, lane);
          }
        }
        bias0 = bs[r0 + g];
        bias1 = bs[r0 + g + 8];
      }
      const __nv_bfloat16* qs =
          reinterpret_cast<const __nv_bfloat16*>(smem_raw + L.q_off) + stage * kTileQ * L.ld;
      const __nv_bfloat16* gs =
          reinterpret_cast<const __nv_bfloat16*>(smem_raw + L.g_off) + stage * kTileQ * L.ld;
      const float* ls = reinterpret_cast<const float*>(smem_raw + L.l_off) + stage * 2 * kTileQ;
      const float* ds = reinterpret_cast<const float*>(smem_raw + L.d_off) + stage * kTileQ;
      // 16 queries at a time: P^T, dP^T and dS^T for the warp's 16 keys,
      // then the k-step over those queries of dV and dK.
      for (int qc = 0; qc < nq; qc += 16) {
        float pt[2][4], dst[2][4];
        product_16x16(pt, ka, qs + qc * L.ld, L.ld, L.dp, lane);
        product_16x16(dst, va, gs + qc * L.ld, L.ld, L.dp, lane);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = qc + n * 8 + t + (e & 1);
            const float x = pt[n][e] * a.scale + (e < 2 ? bias0 : bias1);
            const float p = __expf((x - ls[2 * i]) - ls[2 * i + 1]);
            pt[n][e] = p;
            dst[n][e] = p * (dst[n][e] - ds[i]);
          }
          db0 += dst[n][0] + dst[n][1];
          db1 += dst[n][2] + dst[n][3];
        }
        uint32_t af[4];
        acc_to_a(af, pt, 1.f);
        accumulate_16xd(dv, af, gs + qc * L.ld, L.ld, L.dp, lane);
        acc_to_a(af, dst, a.scale);
        accumulate_16xd(dk, af, qs + qc * L.ld, L.ld, L.dp, lane);
      }
    }
    __syncthreads();  // the stage is free for tile qt + 2
  }
  if (!active) return;

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    db0 += __shfl_xor_sync(0xffffffffu, db0, off);
    db1 += __shfl_xor_sync(0xffffffffu, db1, off);
  }
  const long long kv0 = (static_cast<long long>(b) * skv + k0) * row + h * d;
  __nv_bfloat16* dkp = static_cast<__nv_bfloat16*>(a.dk) + kv0;
  __nv_bfloat16* dvp = static_cast<__nv_bfloat16*>(a.dv) + kv0;
#pragma unroll
  for (int dt = 0; dt < kMaxDim / 8; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = r0 + g + (e >= 2 ? 8 : 0), c = dt * 8 + t + (e & 1);
      if (j < nk && c < d) {
        dkp[j * row + c] = __float2bfloat16(dk[dt][e]);
        dvp[j * row + c] = __float2bfloat16(dv[dt][e]);
      }
    }
  }
  if ((lane & 3) == 0) {
    float* part = a.dbias_part + (static_cast<long long>(b) * a.heads + h) * skv + k0;
    if (r0 + g < nk) part[r0 + g] = db0;
    if (r0 + g + 8 < nk) part[r0 + g + 8] = db1;
  }
}

// ---------------------------------------------------------------------------
// f32, the dQ pass, CUDA cores.  Shared memory, f32, ld = dim + 1: Q, G
// (kF32TileQ x ld), the key tile's K, V (kF32TileK x ld), P dP (first
// sweep) or dS (second) (kF32TileQ x (kF32TileK + 1)), bias (kF32TileK),
// each row's statistics (m, log(sum)) and D (kF32TileQ x 2 and kF32TileQ).
// P = expf((s - m) - log(sum)), as softmax gives it up to a few ulp.
// ---------------------------------------------------------------------------

constexpr int kF32DqElems = kF32TileQ * kMaxDim / kBwdF32Threads;

size_t dq_f32_smem_bytes(int d) {
  const size_t ld = d + 1, ldp = kF32TileK + 1;
  return sizeof(float) *
         (2 * kF32TileQ * ld + 2 * kF32TileK * ld + kF32TileQ * ldp + kF32TileK + 3 * kF32TileQ);
}

__device__ __forceinline__ float dot_f32(const float* x, const float* y, int d) {
  float acc = 0.f;
#pragma unroll 8
  for (int c = 0; c < d; ++c) acc = fmaf(x[c], y[c], acc);
  return acc;
}

__global__ void __launch_bounds__(kBwdF32Threads) long_bwd_dq_f32(Args a) {
  extern __shared__ float smem[];
  const int tiles = (a.sq + kF32TileQ - 1) / kF32TileQ;
  const int bh = blockIdx.x / tiles, b = bh / a.heads, h = bh % a.heads;
  const int q0 = blockIdx.x % tiles * kF32TileQ, sq = min(a.sq - q0, kF32TileQ);
  const int skv = a.skv, d = a.dim, ld = d + 1, ldp = kF32TileK + 1;
  const long long row = static_cast<long long>(a.heads) * d;
  float* qs = smem;
  float* gs = qs + kF32TileQ * ld;
  float* ks = gs + kF32TileQ * ld;
  float* vs = ks + kF32TileK * ld;
  float* ps = vs + kF32TileK * ld;
  float* bs = ps + kF32TileQ * ldp;
  float* ls = bs + kF32TileK;
  float* dds = ls + 2 * kF32TileQ;
  const int tid = threadIdx.x;
  constexpr int kThreads = kBwdF32Threads;

  load_rows_f32(qs, ld, static_cast<const float*>(a.q) + b * a.q_bs + q0 * a.q_rs + h * d,
                a.q_rs, sq, d, tid, kThreads);
  load_rows_f32(gs, ld,
                static_cast<const float*>(a.g) + (static_cast<long long>(b) * a.sq + q0) * row + h * d,
                row, sq, d, tid, kThreads);
  for (int i = tid; i < 2 * sq; i += kThreads) ls[i] = a.lse[2 * row_index(a, b, h, q0) + i];
  float dd = 0.f;  // thread i < sq: row i's D
  float dq[kF32DqElems];
#pragma unroll
  for (int e = 0; e < kF32DqElems; ++e) dq[e] = 0.f;

  for (int sweep = 0; sweep < 2; ++sweep) {
    for (int k0 = 0; k0 < skv; k0 += kF32TileK) {
      const int nk = min(skv - k0, kF32TileK);
      __syncthreads();  // the previous step is done with K, V and P
      load_rows_f32(ks, ld, static_cast<const float*>(a.k) + b * a.k_bs + k0 * a.k_rs + h * d,
                    a.k_rs, nk, d, tid, kThreads);
      load_rows_f32(vs, ld, static_cast<const float*>(a.v) + b * a.v_bs + k0 * a.v_rs + h * d,
                    a.v_rs, nk, d, tid, kThreads);
      for (int j = tid; j < nk; j += kThreads) bs[j] = a.bias[b * skv + k0 + j];
      __syncthreads();

      for (int idx = tid; idx < sq * nk; idx += kThreads) {
        const int i = idx / nk, j = idx % nk;
        const float x = fmaf(dot_f32(qs + i * ld, ks + j * ld, d), a.scale, bs[j]);
        const float p = expf((x - ls[2 * i]) - ls[2 * i + 1]);
        const float dp = dot_f32(gs + i * ld, vs + j * ld, d);
        ps[i * ldp + j] = sweep == 0 ? p * dp : p * (dp - dds[i]);
      }
      __syncthreads();

      if (sweep == 0) {
        if (tid < sq) {
          for (int j = 0; j < nk; ++j) dd += ps[tid * ldp + j];
        }
      } else {
#pragma unroll
        for (int e = 0; e < kF32DqElems; ++e) {
          const int idx = tid + e * kThreads;
          if (idx < sq * d) {
            const int i = idx / d, c = idx % d;
            const float* dsi = ps + i * ldp;
            float acc = dq[e];
#pragma unroll 4
            for (int j = 0; j < nk; ++j) acc = fmaf(dsi[j] * a.scale, ks[j * ld + c], acc);
            dq[e] = acc;
          }
        }
      }
    }
    if (sweep == 0 && tid < sq) {
      dds[tid] = dd;  // read after the next barrier
      a.dsum[row_index(a, b, h, q0 + tid)] = dd;
    }
  }

  float* dqp = static_cast<float*>(a.dq) + (static_cast<long long>(b) * a.sq + q0) * row + h * d;
#pragma unroll
  for (int e = 0; e < kF32DqElems; ++e) {
    const int idx = tid + e * kThreads;
    if (idx < sq * d) dqp[idx / d * row + idx % d] = dq[e];
  }
}

// ---------------------------------------------------------------------------
// f32, the dK/dV pass, CUDA cores.  Shared memory, f32: K, V (kF32TileK x
// ld), the chunk's Q, G (kF32ChunkQ x ld), P^T and dS^T (kF32TileK x
// (kF32ChunkQ + 1)), bias (kF32TileK), the chunk's statistics and D
// (kF32ChunkQ x 2 and kF32ChunkQ).  Each thread accumulates kF32Elems (key, column) elements of dK
// and dV over every query row in order.
// ---------------------------------------------------------------------------

constexpr int kF32Elems = kF32TileK * kMaxDim / kBwdF32Threads;

size_t dkv_f32_smem_bytes(int d) {
  const size_t ld = d + 1, ldc = kF32ChunkQ + 1;
  return sizeof(float) *
         (2 * kF32TileK * ld + 2 * kF32ChunkQ * ld + 2 * kF32TileK * ldc + kF32TileK + 3 * kF32ChunkQ);
}

__global__ void __launch_bounds__(kBwdF32Threads) long_bwd_dkv_f32(Args a) {
  extern __shared__ float smem[];
  const int sq = a.sq, skv = a.skv, d = a.dim, ld = d + 1, ldc = kF32ChunkQ + 1;
  const int ktiles = (skv + kF32TileK - 1) / kF32TileK;
  const int bh = blockIdx.x / ktiles, b = bh / a.heads, h = bh % a.heads;
  const int k0 = blockIdx.x % ktiles * kF32TileK, nk = min(skv - k0, kF32TileK);
  const long long row = static_cast<long long>(a.heads) * d;
  float* ks = smem;
  float* vs = ks + kF32TileK * ld;
  float* qs = vs + kF32TileK * ld;
  float* gs = qs + kF32ChunkQ * ld;
  float* pt = gs + kF32ChunkQ * ld;
  float* dst = pt + kF32TileK * ldc;
  float* bs = dst + kF32TileK * ldc;
  float* ls = bs + kF32TileK;
  float* dds = ls + 2 * kF32ChunkQ;
  const int tid = threadIdx.x;
  constexpr int kThreads = kBwdF32Threads;

  load_rows_f32(ks, ld, static_cast<const float*>(a.k) + b * a.k_bs + k0 * a.k_rs + h * d, a.k_rs,
                nk, d, tid, kThreads);
  load_rows_f32(vs, ld, static_cast<const float*>(a.v) + b * a.v_bs + k0 * a.v_rs + h * d, a.v_rs,
                nk, d, tid, kThreads);
  for (int j = tid; j < nk; j += kThreads) bs[j] = a.bias[b * skv + k0 + j];

  // dbias: up to Sq terms per key, whose sum reaches |50| at 20 keys:
  // compensated (Kahan), so its f32 error stays near one rounding of the
  // sum, as the plain version's pairwise sum.
  float dk[kF32Elems], dv[kF32Elems], db = 0.f, db_c = 0.f;
#pragma unroll
  for (int e = 0; e < kF32Elems; ++e) dk[e] = dv[e] = 0.f;

  for (int c0 = 0; c0 < sq; c0 += kF32ChunkQ) {
    const int nq = min(sq - c0, kF32ChunkQ);
    __syncthreads();  // the previous chunk is done (and the first loads landed)
    load_rows_f32(qs, ld, static_cast<const float*>(a.q) + b * a.q_bs + c0 * a.q_rs + h * d,
                  a.q_rs, nq, d, tid, kThreads);
    load_rows_f32(gs, ld,
                  static_cast<const float*>(a.g) + (static_cast<long long>(b) * sq + c0) * row + h * d,
                  row, nq, d, tid, kThreads);
    for (int i = tid; i < 2 * nq; i += kThreads) ls[i] = a.lse[2 * row_index(a, b, h, c0) + i];
    for (int i = tid; i < nq; i += kThreads) dds[i] = a.dsum[row_index(a, b, h, c0 + i)];
    __syncthreads();

    // The same operations as the dQ pass, so the same P.
    for (int idx = tid; idx < nk * nq; idx += kThreads) {
      const int j = idx / nq, i = idx % nq;
      const float x = fmaf(dot_f32(qs + i * ld, ks + j * ld, d), a.scale, bs[j]);
      const float p = expf((x - ls[2 * i]) - ls[2 * i + 1]);
      pt[j * ldc + i] = p;
      dst[j * ldc + i] = p * (dot_f32(gs + i * ld, vs + j * ld, d) - dds[i]);
    }
    __syncthreads();

#pragma unroll
    for (int e = 0; e < kF32Elems; ++e) {
      const int idx = tid + e * kThreads;
      if (idx < nk * d) {
        const int j = idx / d, c = idx % d;
        const float* pj = pt + j * ldc;
        const float* dsj = dst + j * ldc;
        for (int i = 0; i < nq; ++i) {
          dv[e] = fmaf(pj[i], gs[i * ld + c], dv[e]);
          dk[e] = fmaf(dsj[i] * a.scale, qs[i * ld + c], dk[e]);
        }
      }
    }
    if (tid < nk) {
      for (int i = 0; i < nq; ++i) {
        const float y = dst[tid * ldc + i] - db_c;
        const float t = db + y;
        db_c = (t - db) - y;
        db = t;
      }
    }
  }

  const long long kv0 = (static_cast<long long>(b) * skv + k0) * row + h * d;
#pragma unroll
  for (int e = 0; e < kF32Elems; ++e) {
    const int idx = tid + e * kThreads;
    if (idx < nk * d) {
      const int j = idx / d, c = idx % d;
      static_cast<float*>(a.dk)[kv0 + j * row + c] = dk[e];
      static_cast<float*>(a.dv)[kv0 + j * row + c] = dv[e];
    }
  }
  if (tid < nk) a.dbias_part[(static_cast<long long>(b) * a.heads + h) * skv + k0 + tid] = db;
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

int launch_long_bwd(const Args& a, float* dbias, int dtype, int batch, cudaStream_t s) {
  int err;
  if (dtype == 1) {
    err = launch(long_bwd_dq_bf16, a, batch, kMmaThreads, dq_layout(a.dim).bytes, s,
                 (a.sq + kTileQ - 1) / kTileQ);
    if (err == 0) {
      err = launch(long_bwd_dkv_bf16, a, batch, kMmaThreads, dkv_layout(a.dim).bytes, s,
                   (a.skv + kKvTile - 1) / kKvTile);
    }
  } else if (dtype == 0) {
    err = launch(long_bwd_dq_f32, a, batch, kBwdF32Threads, dq_f32_smem_bytes(a.dim), s,
                 (a.sq + kF32TileQ - 1) / kF32TileQ);
    if (err == 0) {
      err = launch(long_bwd_dkv_f32, a, batch, kBwdF32Threads, dkv_f32_smem_bytes(a.dim), s,
                   (a.skv + kF32TileK - 1) / kF32TileK);
    }
  } else {
    return -1;
  }
  if (err != 0) return err;
  return launch_dbias_sum(a.dbias_part, dbias, batch, a.heads, a.skv, s);
}

}  // namespace

extern "C" {

// The argument list of rgqa_fused_attention_bwd (fused_attention_bwd.cu)
// plus lse, the forward's (batch, heads, sq, 2) f32 row statistics (m,
// log(sum)) (rgqa_fused_attention_long_fwd), and dsum, a (batch, heads, sq) f32
// scratch for D that the dQ pass hands the dK/dV pass.  dtype 0 = float32,
// 1 = bfloat16; q/k/v strides in elements, their last dimension
// contiguous; g, dq, dk, dv contiguous (B, S, heads * dim) in the input
// dtype; dbias_part (B, heads, Skv) f32 scratch, dbias the (B, Skv) f32
// result.  Returns the cudaError_t of the launches (0 on success); -1 for
// arguments outside the kernel's limits.
int rgqa_fused_attention_long_bwd(
    const void* q, const void* k, const void* v, const void* bias, const void* g,
    void* dq, void* dk, void* dv, void* dbias_part, void* dbias, void* lse, void* dsum,
    int dtype, int batch, int sq, int skv, int heads, int dim,
    long long q_bs, long long q_rs, long long k_bs, long long k_rs,
    long long v_bs, long long v_rs, float scale, void* stream) {
  // The f32 passes have the most blocks: tiles of 32 rows or keys.
  if (!within_long_limits(batch, sq, skv, heads, dim, 32)) return -1;
  Args a = make_args(q, k, v, bias, sq, skv, heads, dim, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs,
                     scale);
  a.g = g;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.dbias_part = static_cast<float*>(dbias_part);
  a.lse = static_cast<float*>(lse);
  a.dsum = static_cast<float*>(dsum);
  return launch_long_bwd(a, static_cast<float*>(dbias), dtype, batch,
                         static_cast<cudaStream_t>(stream));
}

}  // extern "C"

RGQA_CUDA_ERROR_STRING
