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
// with the numerics of the short kernel (fused_attention.cu): products of
// input-dtype operands with f32 accumulation, scores and softmax in f32,
// P rounded to the input dtype before the PV product.  When the caller
// passes lse (training: the backward's row statistics), each query row
// also gets (m, log(sum)), its scores' max and the log of its softmax sum,
// in a (B, H, Sq, 2) f32 tensor: their sum is the row's log-sum-exp, kept
// in two parts because a fully masked row's scores lie near -1e4, where
// one f32 holds the sum only to 2^-10, and exp(s - lse) would then scale
// the whole row's P by up to 5e-4; exp((s - m) - log(sum)) is exact to a
// few ulp.  Without lse the output is unchanged.
//
// One block per (batch row, head, query tile of kTileQ = 64 rows), the
// tile index fastest so that the tiles of a row run together.  Two bodies
// per dtype, chosen by Skv:
//
// Skv <= kLongWholeKv = 256, the whole-row bodies (ViLT-B/32's path): the
// block holds the row's whole K and V in shared memory next to its query
// tile, and each query row gets its complete softmax in one pass.
// - bf16 (fused_attention_long_bf16): each of the 4 warps owns 16 query
//   rows and keeps their scores in registers, in the accumulator layout
//   of mma.sync m16n8k16 (kNT tiles of 8 keys, 4 values each per lane):
//   S = Q K^T on the tensor cores, the row max and sum by quad shuffles,
//   P rounded to bf16 straight into the A fragments of the PV product
//   (the layouts coincide), O = P V on the tensor cores, the output
//   written once.  Nothing but Q, K, V and the bias touches shared
//   memory, and after the loads there is no barrier.  The kernel is bound
//   by its instruction stream, not by bytes, so the softmax takes exp as
//   ex2.approx (__expf) and 1/sum once per row, whose f32 errors (a few
//   ulp) are far below the bf16 rounding of P, and the registers are
//   capped so that 3 blocks share an SM: each step cut the time at batch
//   256 by 1.2-1.4x (PERF.md).  A first version kept the tile's scores
//   and probabilities in shared memory (the short kernel's body with
//   query tiles): one block of 4 warps per SM, every phase behind a
//   barrier, 2.6-3.2 ms per call at batch 256.
// - f32: the short kernel's CUDA-core body (attention_common.cuh,
//   fused_attention_f32) with query tiles, kLongPerLane = 8 keys per lane
//   in the softmax and kLongF32Threads = 1024 threads, exact to the plain
//   version's order.
//
// Skv > 256, the key-tiled bodies: the whole-row bodies hold a row's K
// and V in shared memory and, in bf16, each warp's scores for every key
// in registers, which caps them at 256 keys.  These walk the keys in
// tiles of kKvTile = 64 with an online softmax: a running max m and sum l
// per row, O rescaled by exp(m_old - m_new) when the max moves, O / l
// once at the end.
// - bf16 (fused_attention_long_tiled_bf16): K, V and bias tiles stream
//   through a double-buffered cp.async ring (tile t + 1 in flight while
//   tile t is computed, one barrier pair per tile, no plain global load); each warp keeps its
//   16 rows' Q fragments, O (16 x 64 f32) and (m, l) in registers; S = Q
//   K^T and O += P V on the tensor cores with every fragment loaded by
//   ldmatrix (.trans for V); P = exp(S - m) rounded to bf16 unnormalised.
//   128 registers (capped for 4 blocks per SM; 36 bytes spilled) and
//   46.6 KB of shared memory at D = 64.
// - f32 (fused_attention_long_tiled_f32): the same algorithm on the CUDA
//   cores (scores in shared memory by tile, expf, fmaf in key order),
//   checked, not timed.
//
// What bounds it on an H100 (bf16, 12 heads of 64; chip_smoke.py's
// _bound_ms): at 165-185 tokens, batch 256, a call moves 260-291 MB (q,
// k, v read once, the output written once) against 21-27 GFLOP, so bytes
// bound it, 78-87 us at 3.35 TB/s; at 277 tokens 436 MB, 130 us (61 us of
// products); at 597 tokens, batch 64, 235 MB (70.1 us) against 70 GFLOP
// (70.9 us): the products.  q, k and v are read by stride straight out
// of the fused QKV projection (cp.async, no transposes, no (B, H, Sq,
// Skv) mask in device memory); each query tile re-reads its row's K and
// V (from L2 while the row's tiles run together).  wgmma and TMA are
// later work.
//
// Limits: any Sq and Skv, D <= 64 (the wrapper raises beyond that); f32
// and bf16 inputs; the bias is a (B, Skv) f32 additive mask.  A fully
// masked row (bias -10000 everywhere) has a finite max, hence a finite
// lse and output.

#include "attention_common.cuh"

namespace {

// Shared memory of the bf16 body, bf16 unless noted; row strides DP + 8
// as in FwdShortLayout: Qs (kTileQ x DP), Ks and Vs (SKP x DP) zero-padded,
// bias f32 (SKP, -inf past skv).
struct LongLayout {
  int skp, dp, ldq;
  size_t k_off, v_off, b_off, bytes;
};

__host__ __device__ inline LongLayout long_layout(int skv, int d) {
  LongLayout L;
  L.skp = (skv + 15) / 16 * 16;
  L.dp = (d + 15) / 16 * 16;
  L.ldq = L.dp + 8;
  const size_t bf = sizeof(__nv_bfloat16);
  L.k_off = bf * kTileQ * L.ldq;  // every offset a multiple of 16 bytes
  L.v_off = L.k_off + bf * L.skp * L.ldq;
  L.b_off = L.v_off + bf * L.skp * L.ldq;
  L.bytes = L.b_off + sizeof(float) * L.skp;
  return L;
}

// kNT: tiles of 8 keys each thread holds scores for (skv <= 8 kNT, even).
template <int kNT>
__global__ void __launch_bounds__(kMmaThreads, 3) fused_attention_long_bf16(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const FwdTile f = fwd_tile(a, sizeof(__nv_bfloat16));
  const int b = f.b, h = f.h, q0 = f.q0;
  const int sq = f.t.sq, skv = a.skv, d = a.dim;
  const LongLayout L = long_layout(skv, d);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.k_off);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.v_off);
  float* bs = reinterpret_cast<float*>(smem_raw + L.b_off);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  load_tile(qs, L.ldq, static_cast<const __nv_bfloat16*>(f.t.q) + b * a.q_bs + h * d, a.q_rs,
            sq, kTileQ, d, L.dp, tid);
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
  if (r0 >= sq) return;      // no barrier follows: idle warps of a ragged tile stop
  const int g = lane >> 2, t = (lane & 3) * 2;

  // S = Q K^T * scale + bias for rows r0 + g (s[nt][0..1]) and r0 + g + 8
  // (s[nt][2..3]), keys nt * 8 + t and + 1; -inf past skv.
  uint32_t qa[kMaxDim / 16][4];
#pragma unroll
  for (int kk = 0; kk < kMaxDim / 16; ++kk) {
    if (kk * 16 < L.dp) {
      const __nv_bfloat16* qrow = qs + (r0 + g) * L.ldq + kk * 16 + t;
      qa[kk][0] = ld_pair(qrow);
      qa[kk][1] = ld_pair(qrow + 8 * L.ldq);
      qa[kk][2] = ld_pair(qrow + 8);
      qa[kk][3] = ld_pair(qrow + 8 * L.ldq + 8);
    }
  }
  float s[kNT][4];
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    if (nt * 8 < skv) {
#pragma unroll
      for (int kk = 0; kk < kMaxDim / 16; ++kk) {
        if (kk * 16 < L.dp) {
          const __nv_bfloat16* krow = ks + (nt * 8 + g) * L.ldq + kk * 16 + t;
          mma_16x8x16(s[nt], qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3], ld_pair(krow),
                      ld_pair(krow + 8));
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = nt * 8 + t + (e & 1);
      s[nt][e] = j < skv ? s[nt][e] * a.scale + bs[j] : -CUDART_INF_F;
    }
    m0 = fmaxf(m0, fmaxf(s[nt][0], s[nt][1]));
    m1 = fmaxf(m1, fmaxf(s[nt][2], s[nt][3]));
  }
  // A row's values sit in the 4 lanes of a quad.  A fully masked row
  // (all -10000) still has a finite max, so every e is finite, sum >= 1.
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
      s[nt][e] = j < skv ? __expf(s[nt][e] - (e < 2 ? m0 : m1)) : 0.f;
    }
    sum0 += s[nt][0] + s[nt][1];
    sum1 += s[nt][2] + s[nt][3];
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
  }
  const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
  if (a.lse != nullptr && (lane & 3) == 0) {
    float* lse = a.lse + 2 * ((static_cast<long long>(b) * a.heads + h) * a.sq + q0 + r0 + g);
    if (r0 + g < sq) {
      lse[0] = m0;
      lse[1] = logf(sum0);
    }
    if (r0 + g + 8 < sq) {
      lse[16] = m1;
      lse[17] = logf(sum1);
    }
  }

  // O = P V, P = e * (1 / sum) in bf16: the accumulators of key tiles 2kk and
  // 2kk + 1 are the A fragment of the k-step over keys 16kk .. 16kk + 15.
  float o[kMaxDim / 8][4];
#pragma unroll
  for (int dt = 0; dt < kMaxDim / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kNT / 2; ++kk) {
    if (kk * 16 < skv) {
      const int lo = 2 * kk, hi = 2 * kk + 1;
      const uint32_t a0 = pack_pair(__float2bfloat16(s[lo][0] * inv0), __float2bfloat16(s[lo][1] * inv0));
      const uint32_t a1 = pack_pair(__float2bfloat16(s[lo][2] * inv1), __float2bfloat16(s[lo][3] * inv1));
      const uint32_t a2 = pack_pair(__float2bfloat16(s[hi][0] * inv0), __float2bfloat16(s[hi][1] * inv0));
      const uint32_t a3 = pack_pair(__float2bfloat16(s[hi][2] * inv1), __float2bfloat16(s[hi][3] * inv1));
      const __nv_bfloat16* vrow = vs + (kk * 16 + t) * L.ldq + g;
#pragma unroll
      for (int dt = 0; dt < kMaxDim / 8; ++dt) {
        if (dt * 8 < d) {
          const __nv_bfloat16* v = vrow + dt * 8;
          mma_16x8x16(o[dt], a0, a1, a2, a3, pack_pair(v[0], v[L.ldq]),
                      pack_pair(v[8 * L.ldq], v[9 * L.ldq]));
        }
      }
    }
  }

  const long long out_rs = static_cast<long long>(a.heads) * d;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out) +
                       static_cast<long long>(b) * a.sq * out_rs + q0 * out_rs + h * d;
#pragma unroll
  for (int dt = 0; dt < kMaxDim / 8; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = r0 + g + (e >= 2 ? 8 : 0), c = dt * 8 + t + (e & 1);
      if (i < sq && c < d) out[i * out_rs + c] = __float2bfloat16(o[dt][e]);
    }
  }
}

// ---------------------------------------------------------------------------
// Key-tiled bodies (Skv > kLongWholeKv).
// ---------------------------------------------------------------------------

// Shared memory of the key-tiled bf16 body, bf16 unless noted, row stride
// DP + 8 (144 bytes at D = 64: the 8 rows an ldmatrix reads start in
// distinct banks, every row 16-byte aligned): Qs (kTileQ x DP), then two
// stages of Ks, Vs (kKvTile x DP) and bias f32 (kKvTile, -inf past skv).
struct TiledLayout {
  int dp, ld;
  size_t k_off, v_off, b_off, bytes;
};

__host__ __device__ inline TiledLayout tiled_layout(int d) {
  TiledLayout L;
  L.dp = (d + 15) / 16 * 16;
  L.ld = L.dp + 8;
  const size_t bf = sizeof(__nv_bfloat16);
  L.k_off = bf * kTileQ * L.ld;  // every offset a multiple of 16 bytes
  L.v_off = L.k_off + 2 * bf * kKvTile * L.ld;
  L.b_off = L.v_off + 2 * bf * kKvTile * L.ld;
  L.bytes = L.b_off + 2 * sizeof(float) * kKvTile;
  return L;
}

// Key tile kt into stage `stage` (load_kv_tile), committed as one group
// (an empty one when kt is past the last tile).
__device__ __forceinline__ void stage_kv_tile(const Args& a, int b, int h, int kt,
                                              unsigned char* smem_raw, const TiledLayout& L,
                                              int stage, int tid) {
  const int k0 = kt * kKvTile;
  if (k0 < a.skv) {
    load_kv_tile(a, b, h, k0,
                 reinterpret_cast<__nv_bfloat16*>(smem_raw + L.k_off) + stage * kKvTile * L.ld,
                 reinterpret_cast<__nv_bfloat16*>(smem_raw + L.v_off) + stage * kKvTile * L.ld,
                 reinterpret_cast<float*>(smem_raw + L.b_off) + stage * kKvTile, L.ld, L.dp, tid);
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kMmaThreads, 4) fused_attention_long_tiled_bf16(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const FwdTile f = fwd_tile(a, sizeof(__nv_bfloat16));
  const int b = f.b, h = f.h, q0 = f.q0;
  const int sq = f.t.sq, d = a.dim;
  const TiledLayout L = tiled_layout(d);
  const __nv_bfloat16* qs = reinterpret_cast<const __nv_bfloat16*>(smem_raw);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ktiles = (a.skv + kKvTile - 1) / kKvTile;

  load_tile(reinterpret_cast<__nv_bfloat16*>(smem_raw), L.ld,
            static_cast<const __nv_bfloat16*>(f.t.q) + b * a.q_bs + h * d, a.q_rs, sq, kTileQ, d,
            L.dp, tid);
  stage_kv_tile(a, b, h, 0, smem_raw, L, 0, tid);  // one group: Q and tile 0

  // Warp w owns query rows r0 .. r0 + 15; a lane holds rows r0 + g (e < 2)
  // and r0 + g + 8 (e >= 2), keys / columns 8 nt + t + (e & 1).  Warps
  // past the tile's rows take part in the loads and barriers only.
  const int r0 = warp * 16;
  const bool active = r0 < sq;
  const int g = lane >> 2, t = (lane & 3) * 2;
  uint32_t qa[kMaxDim / 16][4];
  float o[kMaxDim / 8][4];
#pragma unroll
  for (int dt = 0; dt < kMaxDim / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;

  for (int kt = 0; kt < ktiles; ++kt) {
    const int stage = kt & 1;
    // Tile kt + 1 goes into the other stage, which every warp left at the
    // barrier that ended step kt - 1.
    stage_kv_tile(a, b, h, kt + 1, smem_raw, L, stage ^ 1, tid);
    cp_async_wait_group<1>();
    __syncthreads();
    if (active) {
      const __nv_bfloat16* ks =
          reinterpret_cast<const __nv_bfloat16*>(smem_raw + L.k_off) + stage * kKvTile * L.ld;
      const __nv_bfloat16* vs =
          reinterpret_cast<const __nv_bfloat16*>(smem_raw + L.v_off) + stage * kKvTile * L.ld;
      const float* bs = reinterpret_cast<const float*>(smem_raw + L.b_off) + stage * kKvTile;
      if (kt == 0) {
#pragma unroll
        for (int kk = 0; kk < kMaxDim / 16; ++kk) {
          if (kk * 16 < L.dp) lds_a(qa[kk], qs + r0 * L.ld + kk * 16, L.ld, lane);
        }
      }
      // S = Q K^T * scale + bias, -inf past skv (the bias stage says so).
      float s[kKvTile / 8][4];
#pragma unroll
      for (int nt = 0; nt < kKvTile / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kMaxDim / 16; ++kk) {
        if (kk * 16 < L.dp) {
#pragma unroll
          for (int np = 0; np < kKvTile / 16; ++np) {
            uint32_t bf[4];
            lds_b_rows(bf, ks + np * 16 * L.ld + kk * 16, L.ld, lane);
            mma_16x8x16(s[2 * np], qa[kk], bf[0], bf[1]);
            mma_16x8x16(s[2 * np + 1], qa[kk], bf[2], bf[3]);
          }
        }
      }
      float tm0 = -CUDART_INF_F, tm1 = -CUDART_INF_F;
#pragma unroll
      for (int nt = 0; nt < kKvTile / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = s[nt][e] * a.scale + bs[nt * 8 + t + (e & 1)];
        tm0 = fmaxf(tm0, fmaxf(s[nt][0], s[nt][1]));
        tm1 = fmaxf(tm1, fmaxf(s[nt][2], s[nt][3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        tm0 = fmaxf(tm0, __shfl_xor_sync(0xffffffffu, tm0, off));
        tm1 = fmaxf(tm1, __shfl_xor_sync(0xffffffffu, tm1, off));
      }
      // Every tile holds a key below skv, whose score is finite: so is the
      // new max, and the first step's rescale is exp(-inf) = 0.
      const float n0 = fmaxf(m0, tm0), n1 = fmaxf(m1, tm1);
      const float c0 = __expf(m0 - n0), c1 = __expf(m1 - n1);
      m0 = n0;
      m1 = n1;
      l0 *= c0;
      l1 *= c1;
#pragma unroll
      for (int dt = 0; dt < kMaxDim / 8; ++dt) {
        o[dt][0] *= c0;
        o[dt][1] *= c0;
        o[dt][2] *= c1;
        o[dt][3] *= c1;
      }
#pragma unroll
      for (int nt = 0; nt < kKvTile / 8; ++nt) {
        s[nt][0] = __expf(s[nt][0] - m0);
        s[nt][1] = __expf(s[nt][1] - m0);
        s[nt][2] = __expf(s[nt][2] - m1);
        s[nt][3] = __expf(s[nt][3] - m1);
        l0 += s[nt][0] + s[nt][1];
        l1 += s[nt][2] + s[nt][3];
      }
      // O += P V: the accumulators of key tiles 2kk and 2kk + 1 are the A
      // fragment of the k-step over keys 16kk .. 16kk + 15.
#pragma unroll
      for (int kk = 0; kk < kKvTile / 16; ++kk) {
        const uint32_t pa[4] = {pack_f32_pair(s[2 * kk][0], s[2 * kk][1]),
                                pack_f32_pair(s[2 * kk][2], s[2 * kk][3]),
                                pack_f32_pair(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_f32_pair(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp2 = 0; dp2 < kMaxDim / 16; ++dp2) {
          if (dp2 * 16 < L.dp) {
            uint32_t bf[4];
            lds_b_trans(bf, vs + kk * 16 * L.ld + dp2 * 16, L.ld, lane);
            mma_16x8x16(o[2 * dp2], pa, bf[0], bf[1]);
            mma_16x8x16(o[2 * dp2 + 1], pa, bf[2], bf[3]);
          }
        }
      }
    }
    __syncthreads();  // the stage is free for tile kt + 2
  }
  if (!active) return;

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const long long out_rs = static_cast<long long>(a.heads) * d;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out) +
                       static_cast<long long>(b) * a.sq * out_rs + q0 * out_rs + h * d;
#pragma unroll
  for (int dt = 0; dt < kMaxDim / 8; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = r0 + g + (e >= 2 ? 8 : 0), c = dt * 8 + t + (e & 1);
      if (i < sq && c < d) out[i * out_rs + c] = __float2bfloat16(o[dt][e] * (e < 2 ? inv0 : inv1));
    }
  }
  if (a.lse != nullptr && (lane & 3) == 0) {
    float* lse = a.lse + 2 * ((static_cast<long long>(b) * a.heads + h) * a.sq + q0 + r0 + g);
    if (r0 + g < sq) {
      lse[0] = m0;
      lse[1] = logf(l0);
    }
    if (r0 + g + 8 < sq) {
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

int launch_long_bf16(const Args& a, int batch, cudaStream_t s) {
  const int tiles = (a.sq + kTileQ - 1) / kTileQ;
  if (a.skv > kLongWholeKv) {
    return launch(fused_attention_long_tiled_bf16, a, batch, kMmaThreads,
                  tiled_layout(a.dim).bytes, s, tiles);
  }
  const LongLayout L = long_layout(a.skv, a.dim);
  if (a.skv <= 128) {
    return launch(fused_attention_long_bf16<16>, a, batch, kMmaThreads, L.bytes, s, tiles);
  }
  if (a.skv <= 192) {
    return launch(fused_attention_long_bf16<24>, a, batch, kMmaThreads, L.bytes, s, tiles);
  }
  return launch(fused_attention_long_bf16<32>, a, batch, kMmaThreads, L.bytes, s, tiles);
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
  return launch(fused_attention_f32<false, kLongPerLane, kLongF32Threads>, a, batch,
                kLongF32Threads, fwd_f32_smem_bytes(tile_rows(a.sq), a.skv, a.dim), s, tiles);
}

}  // extern "C"

RGQA_CUDA_ERROR_STRING
