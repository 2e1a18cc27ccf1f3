// Fused multi-head attention backward for long streams, on the natural
// (B, S, H*D) layout.
//
// Replaces the Pallas TPU kernel rgqa_tpu/ops/attention.py:_fused_bwd_kernel
// where it runs at ViLT's 165-185-token streams (launched by
// _fused_bwd_pallas_raw under the raised VMEM tiers of _fit_bwd_block):
// the backward of every ViLT training step, 12 calls per step.  Per
// (batch row, head), for the output gradient g, it computes what the
// short backward (fused_attention_bwd.cu) does:
//
//     P = softmax(q k^T / sqrt(D) + bias)            (recomputed, f32)
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
// Why not the short kernel's body: it keeps a (row, head)'s whole Sq x Skv
// problem in shared memory (P and dP in f32, dS in bf16 both ways, G and
// V in f32), about 514 KB at 165 x 165 against the 227 KB a block may
// have.  The TPU held the whole (Bt, Sq, Skv) block in VMEM; on Hopper the
// work is tiled, and three sums cross any tiling: dK and dV sum over every
// query row, dQ and D over every key, dbias over heads and query rows.
// The design splits the work where the sums allow and never adds floats
// from two blocks into one place, so two runs give identical bits:
//
// - pass 1 (rows), one block per (batch row, head, query tile), the tile
//   fastest: the tile's Q and G, the row's whole K and V.  It recomputes
//   the tile's P, takes D_i = rowsum(dP P) over every key, then dS and
//   dQ = round(dS scale) K, written once, and leaves each row's statistics
//   (row max, the softmax's sum term, D) in a (B, H, Sq, 3) f32 scratch.
// - pass 2 (keys), one block per (batch row, head, key tile): its keys' K
//   and V, looping over the query rows in chunks.  It recomputes P from the
//   row statistics (the same operations as pass 1, so the same P), dP and
//   dS, and accumulates dV += P^T g, dK += round(dS scale)^T Q and the
//   column sums of dS in registers over all query rows in order, then
//   writes dK and dV once and its head's dbias partials.
// - then fused_attention_dbias_sum (attention_common.cuh) adds the
//   partials over heads in head order, as for the short backward.
//
// Bodies:
// - bf16: every product on the tensor cores (mma.sync m16n8k16, bf16 in,
//   f32 accumulate; products of bf16 operands are exact in f32, so dP is
//   the plain version's up to summation order).  Pass 1 keeps each warp's
//   16 query rows of P in registers in the accumulator layout (as the long
//   forward keeps its scores) and computes dP twice, once for D and once
//   for dS, rather than hold it too.  Pass 2 works in the transposed
//   orientation, each warp owning 16 keys: S^T = K Q^T and dP^T = V g^T
//   with K and V as register A fragments, P^T and dS^T straight from the
//   accumulators into the A fragments of dV and dK.  P enters dV rounded
//   to bf16, where the TPU kernel and the plain version keep it in f32:
//   dV then differs by about one bf16 step of its terms, inside the bf16
//   bound the short backward is held to (3e-2 + 1e-2 |plain|).  exp is
//   __expf (ex2.approx), a few f32 ulp, far below those roundings.
// - f32: the same two passes on the CUDA cores (fmaf in f32), query tiles
//   of 32 rows in pass 1 (its P and dP tiles beside the whole K and V:
//   217 KB at 256 keys), key tiles of 32 in pass 2.
//
// What bounds it on an H100: bytes.  At ViLT's training shapes (batch 32
// + RP = 64 rows, 165 tokens, 12 heads of 64, bf16) a call reads q, k, v
// and g and writes dq, dk and dv, 7 x 64 x 165 x 768 x 2 B = 113.5 MB,
// 33.9 us at 3.35 TB/s, against 13.4 GFLOP of products (5 per score),
// 13.5 us at 989 TFLOP/s.  Each pass-1 block re-reads its row's K and V
// and each pass-2 block its row's Q and g (from L2 while the tiles of a
// row run together), and P and dP are computed twice; wgmma, TMA and a
// one-pass design that keeps dK/dV partials on chip are later work.
//
// Limits: any Sq (in tiles), Skv <= 256 (pass 1 holds a row's whole K and
// V, and the bf16 body a row's scores in registers), D <= 64, as the long
// forward; the wrapper raises beyond them.  A fully masked row (bias
// -10000 everywhere) has a finite max, so its P and gradients are finite.

#include "attention_common.cuh"

namespace {

constexpr int kKeyTile = 64;  // keys per bf16 pass-2 block: 4 warps x 16
constexpr int kChunkQ = 32;   // query rows per bf16 pass-2 step
constexpr int kF32TileQ = 32;   // query rows per f32 pass-1 block
constexpr int kF32TileK = 32;   // keys per f32 pass-2 block
constexpr int kF32ChunkQ = 64;  // query rows per f32 pass-2 step
constexpr int kBwdF32Threads = 256;

__device__ __forceinline__ float* row_stats(const Args& a, int b, int h, int i) {
  return a.stats + ((static_cast<long long>(b) * a.heads + h) * a.sq + i) * 3;
}

// ---------------------------------------------------------------------------
// bf16, pass 1 (rows).  Shared memory, bf16 unless noted, row strides
// DP + 8 as in the long forward: Qs, Gs (kTileQ x DP) zero-padded; Ks, Vs
// (SKP x DP) zero-padded; bias f32 (SKP, -inf past skv).  Row statistics:
// the row max m and 1/sum, P = __expf(s - m) * (1/sum).
// ---------------------------------------------------------------------------

struct RowsLayout {
  int skp, dp, ldq;
  size_t g_off, k_off, v_off, b_off, bytes;
};

__host__ __device__ inline RowsLayout rows_layout(int skv, int d) {
  RowsLayout L;
  L.skp = (skv + 15) / 16 * 16;
  L.dp = (d + 15) / 16 * 16;
  L.ldq = L.dp + 8;
  const size_t bf = sizeof(__nv_bfloat16);
  L.g_off = bf * kTileQ * L.ldq;  // every offset a multiple of 16 bytes
  L.k_off = L.g_off + bf * kTileQ * L.ldq;
  L.v_off = L.k_off + bf * L.skp * L.ldq;
  L.b_off = L.v_off + bf * L.skp * L.ldq;
  L.bytes = L.b_off + sizeof(float) * L.skp;
  return L;
}

// One warp's 16 x 8 tile of dP = G V^T for the keys nt * 8 .. nt * 8 + 7.
__device__ __forceinline__ void dp_tile(float (&dp)[4], const uint32_t (&ga)[kMaxDim / 16][4],
                                        const __nv_bfloat16* vs, int ldq, int dpad, int nt,
                                        int lane) {
  dp[0] = dp[1] = dp[2] = dp[3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kMaxDim / 16; ++kk) {
    if (kk * 16 < dpad) {
      uint32_t b0, b1;
      b_frag_rows(b0, b1, vs + nt * 8 * ldq + kk * 16, ldq, lane);
      mma_16x8x16(dp, ga[kk][0], ga[kk][1], ga[kk][2], ga[kk][3], b0, b1);
    }
  }
}

// kNT: tiles of 8 keys each thread holds P for (skv <= 8 kNT, even).
template <int kNT>
__global__ void __launch_bounds__(kMmaThreads) long_bwd_rows_bf16(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const FwdTile f = fwd_tile(a, sizeof(__nv_bfloat16));
  const int b = f.b, h = f.h, q0 = f.q0;
  const int sq = f.t.sq, skv = a.skv, d = a.dim;
  const long long row = static_cast<long long>(a.heads) * d;  // g and dq row stride
  const RowsLayout L = rows_layout(skv, d);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.g_off);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.k_off);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.v_off);
  float* bs = reinterpret_cast<float*>(smem_raw + L.b_off);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  load_tile(qs, L.ldq, static_cast<const __nv_bfloat16*>(f.t.q) + b * a.q_bs + h * d, a.q_rs,
            sq, kTileQ, d, L.dp, tid);
  load_tile(gs, L.ldq,
            static_cast<const __nv_bfloat16*>(a.g) + (static_cast<long long>(b) * a.sq + q0) * row + h * d,
            row, sq, kTileQ, d, L.dp, tid);
  load_tile(ks, L.ldq, static_cast<const __nv_bfloat16*>(a.k) + b * a.k_bs + h * d, a.k_rs,
            skv, L.skp, d, L.dp, tid);
  load_tile(vs, L.ldq, static_cast<const __nv_bfloat16*>(a.v) + b * a.v_bs + h * d, a.v_rs,
            skv, L.skp, d, L.dp, tid);
  for (int j = tid; j < L.skp; j += kMmaThreads) {
    bs[j] = j < skv ? a.bias[b * skv + j] : -CUDART_INF_F;
  }
  cp_async_wait_all();
  __syncthreads();

  const int r0 = warp * 16;  // the warp's first row in the tile
  if (r0 >= sq) return;      // no barrier follows
  const int g = lane >> 2, t = (lane & 3) * 2;

  // P for rows r0 + g (p[nt][0..1]) and r0 + g + 8 (p[nt][2..3]), keys
  // nt * 8 + t and + 1, as the long forward computes it; 0 past skv.
  float p[kNT][4];
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;
  {
    uint32_t qa[kMaxDim / 16][4];
#pragma unroll
    for (int kk = 0; kk < kMaxDim / 16; ++kk) {
      if (kk * 16 < L.dp) a_frag(qa[kk], qs + r0 * L.ldq + kk * 16, L.ldq, lane);
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      p[nt][0] = p[nt][1] = p[nt][2] = p[nt][3] = 0.f;
      if (nt * 8 < skv) {
#pragma unroll
        for (int kk = 0; kk < kMaxDim / 16; ++kk) {
          if (kk * 16 < L.dp) {
            uint32_t b0, b1;
            b_frag_rows(b0, b1, ks + nt * 8 * L.ldq + kk * 16, L.ldq, lane);
            mma_16x8x16(p[nt], qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3], b0, b1);
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = nt * 8 + t + (e & 1);
        p[nt][e] = j < skv ? fmaf(p[nt][e], a.scale, bs[j]) : -CUDART_INF_F;
      }
      m0 = fmaxf(m0, fmaxf(p[nt][0], p[nt][1]));
      m1 = fmaxf(m1, fmaxf(p[nt][2], p[nt][3]));
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = nt * 8 + t + (e & 1);
      p[nt][e] = j < skv ? __expf(p[nt][e] - (e < 2 ? m0 : m1)) : 0.f;
    }
    sum0 += p[nt][0] + p[nt][1];
    sum1 += p[nt][2] + p[nt][3];
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
  }
  const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    p[nt][0] *= inv0;
    p[nt][1] *= inv0;
    p[nt][2] *= inv1;
    p[nt][3] *= inv1;
  }

  uint32_t ga[kMaxDim / 16][4];
#pragma unroll
  for (int kk = 0; kk < kMaxDim / 16; ++kk) {
    if (kk * 16 < L.dp) a_frag(ga[kk], gs + r0 * L.ldq + kk * 16, L.ldq, lane);
  }
  // D = rowsum(dP P) over every key (V is zero past skv, so dP is too).
  float dd0 = 0.f, dd1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    if (nt * 8 < skv) {
      float dp[4];
      dp_tile(dp, ga, vs, L.ldq, L.dp, nt, lane);
      dd0 += dp[0] * p[nt][0] + dp[1] * p[nt][1];
      dd1 += dp[2] * p[nt][2] + dp[3] * p[nt][3];
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    dd0 += __shfl_xor_sync(0xffffffffu, dd0, o);
    dd1 += __shfl_xor_sync(0xffffffffu, dd1, o);
  }

  // dQ = bf16(dS * scale) K: dP again, tile by tile; the dS tiles of keys
  // 16kk .. 16kk + 15 are the A fragment of the k-step over those keys.
  float dq[kMaxDim / 8][4];
#pragma unroll
  for (int dt = 0; dt < kMaxDim / 8; ++dt) dq[dt][0] = dq[dt][1] = dq[dt][2] = dq[dt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kNT / 2; ++kk) {
    if (kk * 16 < skv) {
      float ds[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int nt = 2 * kk + half;
        float dp[4];
        dp_tile(dp, ga, vs, L.ldq, L.dp, nt, lane);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ds[half][e] = p[nt][e] * (dp[e] - (e < 2 ? dd0 : dd1)) * a.scale;
        }
      }
      const uint32_t a0 = pack_f32_pair(ds[0][0], ds[0][1]);
      const uint32_t a1 = pack_f32_pair(ds[0][2], ds[0][3]);
      const uint32_t a2 = pack_f32_pair(ds[1][0], ds[1][1]);
      const uint32_t a3 = pack_f32_pair(ds[1][2], ds[1][3]);
#pragma unroll
      for (int dt = 0; dt < kMaxDim / 8; ++dt) {
        if (dt * 8 < d) {
          uint32_t b0, b1;
          b_frag(b0, b1, ks + kk * 16 * L.ldq + dt * 8, L.ldq, lane);
          mma_16x8x16(dq[dt], a0, a1, a2, a3, b0, b1);
        }
      }
    }
  }

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
    if (r0 + g < sq) {
      float* st = row_stats(a, b, h, q0 + r0 + g);
      st[0] = m0;
      st[1] = inv0;
      st[2] = dd0;
    }
    if (r0 + g + 8 < sq) {
      float* st = row_stats(a, b, h, q0 + r0 + g + 8);
      st[0] = m1;
      st[1] = inv1;
      st[2] = dd1;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16, pass 2 (keys).  Shared memory, bf16 unless noted, row strides
// DP + 8: Ks, Vs (kKeyTile x DP) and the chunk's Qs, Gs (kChunkQ x DP),
// zero-padded; bias f32 (kKeyTile, -inf past the tile's keys); the chunk's
// row statistics f32 (kChunkQ x 3).
// ---------------------------------------------------------------------------

struct KeysLayout {
  int dp, ldq;
  size_t v_off, q_off, g_off, b_off, s_off, bytes;
};

__host__ __device__ inline KeysLayout keys_layout(int d) {
  KeysLayout L;
  L.dp = (d + 15) / 16 * 16;
  L.ldq = L.dp + 8;
  const size_t bf = sizeof(__nv_bfloat16);
  L.v_off = bf * kKeyTile * L.ldq;  // every offset a multiple of 16 bytes
  L.q_off = L.v_off + bf * kKeyTile * L.ldq;
  L.g_off = L.q_off + bf * kChunkQ * L.ldq;
  L.b_off = L.g_off + bf * kChunkQ * L.ldq;
  L.s_off = L.b_off + sizeof(float) * kKeyTile;
  L.bytes = L.s_off + sizeof(float) * 3 * kChunkQ;
  return L;
}

__global__ void __launch_bounds__(kMmaThreads) long_bwd_keys_bf16(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int sq = a.sq, skv = a.skv, d = a.dim;
  const int ktiles = (skv + kKeyTile - 1) / kKeyTile;
  const int bh = blockIdx.x / ktiles, b = bh / a.heads, h = bh % a.heads;
  const int k0 = blockIdx.x % ktiles * kKeyTile, nk = min(skv - k0, kKeyTile);
  const long long row = static_cast<long long>(a.heads) * d;
  const KeysLayout L = keys_layout(d);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.v_off);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.q_off);
  __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.g_off);
  float* bs = reinterpret_cast<float*>(smem_raw + L.b_off);
  float* st = reinterpret_cast<float*>(smem_raw + L.s_off);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane >> 2, t = (lane & 3) * 2;

  load_tile(ks, L.ldq, static_cast<const __nv_bfloat16*>(a.k) + b * a.k_bs + k0 * a.k_rs + h * d,
            a.k_rs, nk, kKeyTile, d, L.dp, tid);
  load_tile(vs, L.ldq, static_cast<const __nv_bfloat16*>(a.v) + b * a.v_bs + k0 * a.v_rs + h * d,
            a.v_rs, nk, kKeyTile, d, L.dp, tid);
  for (int j = tid; j < kKeyTile; j += kMmaThreads) {
    bs[j] = j < nk ? a.bias[b * skv + k0 + j] : -CUDART_INF_F;
  }
  cp_async_wait_all();
  __syncthreads();

  // The warp's 16 keys (rows r0 + g and r0 + g + 8 of the tile) as A
  // fragments; warps past the tile's keys take part in the barriers only.
  const int r0 = warp * 16;
  const bool active = r0 < nk;
  uint32_t ka[kMaxDim / 16][4], va[kMaxDim / 16][4];
#pragma unroll
  for (int kk = 0; kk < kMaxDim / 16; ++kk) {
    if (kk * 16 < L.dp) {
      a_frag(ka[kk], ks + r0 * L.ldq + kk * 16, L.ldq, lane);
      a_frag(va[kk], vs + r0 * L.ldq + kk * 16, L.ldq, lane);
    }
  }
  const float bias0 = bs[r0 + g], bias1 = bs[r0 + g + 8];
  float dk[kMaxDim / 8][4], dv[kMaxDim / 8][4];
#pragma unroll
  for (int dt = 0; dt < kMaxDim / 8; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.f;
  }
  float db0 = 0.f, db1 = 0.f;  // column sums of dS for keys r0 + g, r0 + g + 8

  for (int c0 = 0; c0 < sq; c0 += kChunkQ) {
    const int nq = min(sq - c0, kChunkQ);
    __syncthreads();  // every warp is done with the previous chunk
    load_tile(qs, L.ldq, static_cast<const __nv_bfloat16*>(a.q) + b * a.q_bs + c0 * a.q_rs + h * d,
              a.q_rs, nq, kChunkQ, d, L.dp, tid);
    load_tile(gs, L.ldq,
              static_cast<const __nv_bfloat16*>(a.g) + (static_cast<long long>(b) * sq + c0) * row + h * d,
              row, nq, kChunkQ, d, L.dp, tid);
    for (int i = tid; i < 3 * kChunkQ; i += kMmaThreads) {
      st[i] = i < 3 * nq ? row_stats(a, b, h, c0)[i] : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();
    if (!active) continue;

    // P^T (16 keys x kChunkQ queries) and dP^T = V g^T; query i = nt * 8 +
    // t + (e & 1), key r0 + g (e < 2) or r0 + g + 8.
    float pt[kChunkQ / 8][4], ds[kChunkQ / 8][4];
#pragma unroll
    for (int nt = 0; nt < kChunkQ / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) pt[nt][e] = ds[nt][e] = 0.f;
      if (nt * 8 < nq) {
#pragma unroll
        for (int kk = 0; kk < kMaxDim / 16; ++kk) {
          if (kk * 16 < L.dp) {
            uint32_t b0, b1;
            b_frag_rows(b0, b1, qs + nt * 8 * L.ldq + kk * 16, L.ldq, lane);
            mma_16x8x16(pt[nt], ka[kk][0], ka[kk][1], ka[kk][2], ka[kk][3], b0, b1);
            b_frag_rows(b0, b1, gs + nt * 8 * L.ldq + kk * 16, L.ldq, lane);
            mma_16x8x16(ds[nt], va[kk][0], va[kk][1], va[kk][2], va[kk][3], b0, b1);
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = nt * 8 + t + (e & 1);
        float pe = 0.f, dse = 0.f;
        if (i < nq) {
          const float* si = st + 3 * i;
          pe = __expf(fmaf(pt[nt][e], a.scale, e < 2 ? bias0 : bias1) - si[0]) * si[1];
          dse = pe * (ds[nt][e] - si[2]);
        }
        pt[nt][e] = pe;
        ds[nt][e] = dse;
      }
      db0 += ds[nt][0] + ds[nt][1];
      db1 += ds[nt][2] + ds[nt][3];
    }

    // dV += P^T g and dK += bf16(dS^T scale) Q, k-steps over the chunk's
    // queries 16kk .. 16kk + 15.
#pragma unroll
    for (int kk = 0; kk < kChunkQ / 16; ++kk) {
      if (kk * 16 < nq) {
        const int lo = 2 * kk, hi = 2 * kk + 1;
        const uint32_t p0 = pack_f32_pair(pt[lo][0], pt[lo][1]);
        const uint32_t p1 = pack_f32_pair(pt[lo][2], pt[lo][3]);
        const uint32_t p2 = pack_f32_pair(pt[hi][0], pt[hi][1]);
        const uint32_t p3 = pack_f32_pair(pt[hi][2], pt[hi][3]);
        const uint32_t s0 = pack_f32_pair(ds[lo][0] * a.scale, ds[lo][1] * a.scale);
        const uint32_t s1 = pack_f32_pair(ds[lo][2] * a.scale, ds[lo][3] * a.scale);
        const uint32_t s2 = pack_f32_pair(ds[hi][0] * a.scale, ds[hi][1] * a.scale);
        const uint32_t s3 = pack_f32_pair(ds[hi][2] * a.scale, ds[hi][3] * a.scale);
#pragma unroll
        for (int dt = 0; dt < kMaxDim / 8; ++dt) {
          if (dt * 8 < d) {
            uint32_t b0, b1;
            b_frag(b0, b1, gs + kk * 16 * L.ldq + dt * 8, L.ldq, lane);
            mma_16x8x16(dv[dt], p0, p1, p2, p3, b0, b1);
            b_frag(b0, b1, qs + kk * 16 * L.ldq + dt * 8, L.ldq, lane);
            mma_16x8x16(dk[dt], s0, s1, s2, s3, b0, b1);
          }
        }
      }
    }
  }
  if (!active) return;

#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    db0 += __shfl_xor_sync(0xffffffffu, db0, o);
    db1 += __shfl_xor_sync(0xffffffffu, db1, o);
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
// f32, pass 1 (rows), CUDA cores.  Shared memory, f32: Q, G (kF32TileQ x
// ld), K, V (skv x ld), P and dP / dS (kF32TileQ x (skv + 1)), bias (skv),
// row statistics (kF32TileQ x 3); ld = dim + 1.  Row statistics: the row
// max m and the sum, P = expf(s - m) / sum, as softmax_rows computes it.
// ---------------------------------------------------------------------------

size_t rows_f32_smem_bytes(int skv, int d) {
  const size_t ld = d + 1, ldp = skv + 1;
  return sizeof(float) *
         (2 * kF32TileQ * ld + 2 * skv * ld + 2 * kF32TileQ * ldp + skv + 3 * kF32TileQ);
}

__device__ __forceinline__ float dot_f32(const float* x, const float* y, int d) {
  float acc = 0.f;
#pragma unroll 8
  for (int c = 0; c < d; ++c) acc = fmaf(x[c], y[c], acc);
  return acc;
}

__global__ void __launch_bounds__(kBwdF32Threads) long_bwd_rows_f32(Args a) {
  extern __shared__ float smem[];
  const int tiles = (a.sq + kF32TileQ - 1) / kF32TileQ;
  const int bh = blockIdx.x / tiles, b = bh / a.heads, h = bh % a.heads;
  const int q0 = blockIdx.x % tiles * kF32TileQ, sq = min(a.sq - q0, kF32TileQ);
  const int skv = a.skv, d = a.dim, ld = d + 1, ldp = skv + 1;
  const long long row = static_cast<long long>(a.heads) * d;
  float* qs = smem;
  float* gs = qs + kF32TileQ * ld;
  float* ks = gs + kF32TileQ * ld;
  float* vs = ks + skv * ld;
  float* ps = vs + skv * ld;
  float* dps = ps + kF32TileQ * ldp;
  float* bs = dps + kF32TileQ * ldp;
  float* rst = bs + skv;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  constexpr int kThreads = kBwdF32Threads, kWarps = kThreads / 32;

  load_rows_f32(qs, ld, static_cast<const float*>(a.q) + b * a.q_bs + q0 * a.q_rs + h * d,
                a.q_rs, sq, d, tid, kThreads);
  load_rows_f32(gs, ld,
                static_cast<const float*>(a.g) + (static_cast<long long>(b) * a.sq + q0) * row + h * d,
                row, sq, d, tid, kThreads);
  load_rows_f32(ks, ld, static_cast<const float*>(a.k) + b * a.k_bs + h * d, a.k_rs, skv, d,
                tid, kThreads);
  load_rows_f32(vs, ld, static_cast<const float*>(a.v) + b * a.v_bs + h * d, a.v_rs, skv, d,
                tid, kThreads);
  for (int j = tid; j < skv; j += kThreads) bs[j] = a.bias[b * skv + j];
  __syncthreads();

  for (int idx = tid; idx < sq * skv; idx += kThreads) {
    const int i = idx / skv, j = idx % skv;
    ps[i * ldp + j] = fmaf(dot_f32(qs + i * ld, ks + j * ld, d), a.scale, bs[j]);
    dps[i * ldp + j] = dot_f32(gs + i * ld, vs + j * ld, d);
  }
  __syncthreads();

  // Softmax by rows (one warp per row, kLongPerLane keys per lane), with
  // D = rowsum(dP P).
  for (int i = warp; i < sq; i += kWarps) {
    float* pi = ps + i * ldp;
    const float* dpi = dps + i * ldp;
    float x[kLongPerLane];
#pragma unroll
    for (int c = 0; c < kLongPerLane; ++c) {
      x[c] = lane + 32 * c < skv ? pi[lane + 32 * c] : -CUDART_INF_F;
    }
    float m = x[0];
#pragma unroll
    for (int c = 1; c < kLongPerLane; ++c) m = fmaxf(m, x[c]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kLongPerLane; ++c) {
      x[c] = lane + 32 * c < skv ? expf(x[c] - m) : 0.f;
      sum += x[c];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    float dd = 0.f;
#pragma unroll
    for (int c = 0; c < kLongPerLane; ++c) {
      if (lane + 32 * c < skv) {
        const float pv = x[c] / sum;
        pi[lane + 32 * c] = pv;
        dd += dpi[lane + 32 * c] * pv;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dd += __shfl_xor_sync(0xffffffffu, dd, o);
    if (lane == 0) {
      rst[3 * i] = m;
      rst[3 * i + 1] = sum;
      rst[3 * i + 2] = dd;
    }
  }
  __syncthreads();

  for (int idx = tid; idx < sq * skv; idx += kThreads) {
    const int i = idx / skv, j = idx % skv;
    dps[i * ldp + j] = ps[i * ldp + j] * (dps[i * ldp + j] - rst[3 * i + 2]);
  }
  __syncthreads();

  float* dq = static_cast<float*>(a.dq) + (static_cast<long long>(b) * a.sq + q0) * row + h * d;
  for (int idx = tid; idx < sq * d; idx += kThreads) {
    const int i = idx / d, c = idx % d;
    const float* dsi = dps + i * ldp;
    float acc = 0.f;
#pragma unroll 4
    for (int j = 0; j < skv; ++j) acc = fmaf(dsi[j] * a.scale, ks[j * ld + c], acc);
    dq[i * row + c] = acc;
  }
  for (int i = tid; i < sq; i += kThreads) {
    float* out = row_stats(a, b, h, q0 + i);
    out[0] = rst[3 * i];
    out[1] = rst[3 * i + 1];
    out[2] = rst[3 * i + 2];
  }
}

// ---------------------------------------------------------------------------
// f32, pass 2 (keys), CUDA cores.  Shared memory, f32: K, V (kF32TileK x
// ld), the chunk's Q, G (kF32ChunkQ x ld), P^T and dS^T (kF32TileK x
// (kF32ChunkQ + 1)), bias (kF32TileK), the chunk's row statistics
// (kF32ChunkQ x 3).  Each thread accumulates kF32Elems (key, column)
// elements of dK and dV over every query row in order.
// ---------------------------------------------------------------------------

constexpr int kF32Elems = kF32TileK * kMaxDim / kBwdF32Threads;

size_t keys_f32_smem_bytes(int d) {
  const size_t ld = d + 1, ldc = kF32ChunkQ + 1;
  return sizeof(float) *
         (2 * kF32TileK * ld + 2 * kF32ChunkQ * ld + 2 * kF32TileK * ldc + kF32TileK + 3 * kF32ChunkQ);
}

__global__ void __launch_bounds__(kBwdF32Threads) long_bwd_keys_f32(Args a) {
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
  float* st = bs + kF32TileK;
  const int tid = threadIdx.x;
  constexpr int kThreads = kBwdF32Threads;

  load_rows_f32(ks, ld, static_cast<const float*>(a.k) + b * a.k_bs + k0 * a.k_rs + h * d, a.k_rs,
                nk, d, tid, kThreads);
  load_rows_f32(vs, ld, static_cast<const float*>(a.v) + b * a.v_bs + k0 * a.v_rs + h * d, a.v_rs,
                nk, d, tid, kThreads);
  for (int j = tid; j < nk; j += kThreads) bs[j] = a.bias[b * skv + k0 + j];

  float dk[kF32Elems], dv[kF32Elems], db = 0.f;
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
    for (int i = tid; i < 3 * nq; i += kThreads) st[i] = row_stats(a, b, h, c0)[i];
    __syncthreads();

    // The same operations as pass 1, so the same P.
    for (int idx = tid; idx < nk * nq; idx += kThreads) {
      const int j = idx / nq, i = idx % nq;
      const float* si = st + 3 * i;
      const float x = fmaf(dot_f32(qs + i * ld, ks + j * ld, d), a.scale, bs[j]);
      const float p = expf(x - si[0]) / si[1];
      pt[j * ldc + i] = p;
      dst[j * ldc + i] = p * (dot_f32(gs + i * ld, vs + j * ld, d) - si[2]);
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
      for (int i = 0; i < nq; ++i) db += dst[tid * ldc + i];
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

int launch_rows_bf16(const Args& a, int batch, cudaStream_t s) {
  const size_t smem = rows_layout(a.skv, a.dim).bytes;
  const int tiles = (a.sq + kTileQ - 1) / kTileQ;
  if (a.skv <= 128) return launch(long_bwd_rows_bf16<16>, a, batch, kMmaThreads, smem, s, tiles);
  if (a.skv <= 192) return launch(long_bwd_rows_bf16<24>, a, batch, kMmaThreads, smem, s, tiles);
  return launch(long_bwd_rows_bf16<32>, a, batch, kMmaThreads, smem, s, tiles);
}

int launch_long_bwd(const Args& a, float* dbias, int dtype, int batch, cudaStream_t s) {
  int err;
  if (dtype == 1) {
    err = launch_rows_bf16(a, batch, s);
    if (err == 0) {
      err = launch(long_bwd_keys_bf16, a, batch, kMmaThreads, keys_layout(a.dim).bytes, s,
                   (a.skv + kKeyTile - 1) / kKeyTile);
    }
  } else if (dtype == 0) {
    err = launch(long_bwd_rows_f32, a, batch, kBwdF32Threads, rows_f32_smem_bytes(a.skv, a.dim),
                 s, (a.sq + kF32TileQ - 1) / kF32TileQ);
    if (err == 0) {
      err = launch(long_bwd_keys_f32, a, batch, kBwdF32Threads, keys_f32_smem_bytes(a.dim), s,
                   (a.skv + kF32TileK - 1) / kF32TileK);
    }
  } else {
    return -1;
  }
  if (err != 0) return err;
  const int n = batch * a.skv, threads = 256;
  fused_attention_dbias_sum<<<(n + threads - 1) / threads, threads, 0, s>>>(
      a.dbias_part, dbias, batch, a.heads, a.skv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The argument list of rgqa_fused_attention_bwd (fused_attention_bwd.cu)
// plus stats, a (batch, heads, sq, 3) f32 scratch for the row statistics
// pass 1 hands pass 2.  dtype 0 = float32, 1 = bfloat16; q/k/v strides in
// elements, their last dimension contiguous; g, dq, dk, dv contiguous
// (B, S, heads * dim) in the input dtype; dbias_part (B, heads, Skv) f32
// scratch, dbias the (B, Skv) f32 result.  Returns the cudaError_t of the
// launches (0 on success); -1 for arguments outside the kernel's limits.
int rgqa_fused_attention_long_bwd(
    const void* q, const void* k, const void* v, const void* bias, const void* g,
    void* dq, void* dk, void* dv, void* dbias_part, void* dbias, void* stats,
    int dtype, int batch, int sq, int skv, int heads, int dim,
    long long q_bs, long long q_rs, long long k_bs, long long k_rs,
    long long v_bs, long long v_rs, float scale, void* stream) {
  // The f32 passes have the most blocks: tiles of 32 rows or keys.
  const int longest = sq > skv ? sq : skv;
  if (!within_long_limits(batch, sq, skv, heads, dim) ||
      static_cast<long long>(batch) * heads * ((longest + 31) / 32) >= (1LL << 31)) {
    return -1;
  }
  Args a = make_args(q, k, v, bias, sq, skv, heads, dim, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs,
                     scale);
  a.g = g;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.dbias_part = static_cast<float*>(dbias_part);
  a.stats = static_cast<float*>(stats);
  return launch_long_bwd(a, static_cast<float*>(dbias), dtype, batch,
                         static_cast<cudaStream_t>(stream));
}

}  // extern "C"

RGQA_CUDA_ERROR_STRING
