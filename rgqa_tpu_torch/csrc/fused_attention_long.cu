// Fused multi-head attention forward for long streams, on the natural
// (B, S, H*D) layout.
//
// Replaces the Pallas TPU kernel rgqa_tpu/ops/attention.py:_fused_kernel
// on the query-tiled grid (launched by _fused_qblocked_raw), which serves
// ViLT's single stream: 20 or 40 text tokens + 144 patches + CLS, so 165
// or 185 tokens, 12 heads of 64.  Per (batch row, head) it computes
//
//     out[b, :, h*D:(h+1)*D] = softmax(q_h k_h^T / sqrt(D) + bias[b]) v_h
//
// with the numerics of the short kernel (fused_attention.cu): products of
// input-dtype operands with f32 accumulation, scores and softmax in f32,
// P rounded to the input dtype before the PV product.
//
// The algorithm is the TPU's, not its blocks: one block per (batch row,
// head, query tile of kTileQ = 64 rows), the tile index fastest so that
// the tiles of a row run together.  The block holds the row's whole K and
// V in shared memory next to its query tile, and each query row gets its
// complete softmax over all Skv keys in one pass, without online
// rescaling.
//
// - bf16 (fused_attention_long_bf16 below): each of the 4 warps owns 16
//   query rows and keeps their scores in registers, in the accumulator
//   layout of mma.sync m16n8k16 (kNT tiles of 8 keys, 4 values each per
//   lane): S = Q K^T on the tensor cores, the row max and sum by quad
//   shuffles, P rounded to bf16 straight into the A fragments of the PV
//   product (the layouts coincide), O = P V on the tensor cores, the
//   output written once.  Nothing but Q, K, V and the bias touches shared
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
// What bounds it on an H100: at ViLT's shapes (batch 256, 165-185 tokens)
// a call moves 260-291 MB (q, k, v read once, the output written once)
// against 21-27 GFLOP of products, so the bound is bytes, 78-87 us at
// 3.35 TB/s, not the tensor cores (22-27 us at 989 TFLOP/s).  q, k and v
// are read by stride straight out of the fused QKV projection (cp.async,
// no transposes, no (B, H, Sq, Skv) mask in device memory); each tile
// re-reads its row's K and V (47 KB per (row, head) at 185 keys, from L2
// while the row's tiles run together).  wgmma and TMA are later work.
//
// Limits: any Sq (in query tiles), Skv <= 256, D <= 64 (the wrapper
// raises beyond that); f32 and bf16 inputs; the bias is a (B, Skv) f32
// additive mask.

#include "attention_common.cuh"

namespace {

// Shared memory of the bf16 body, bf16 unless noted; row strides DP + 8
// as in FwdLayout: Qs (kTileQ x DP), Ks and Vs (SKP x DP) zero-padded,
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

int launch_long_bf16(const Args& a, int batch, cudaStream_t s) {
  const LongLayout L = long_layout(a.skv, a.dim);
  const int tiles = (a.sq + kTileQ - 1) / kTileQ;
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

// The argument list of rgqa_fused_attention_fwd (fused_attention.cu):
// dtype 0 = float32, 1 = bfloat16; strides in elements, the last
// dimension of q, k and v contiguous; the output is a contiguous
// (batch, sq, heads * dim) tensor of the input dtype.  Returns the
// cudaError_t of the launch (0 on success); -1 for arguments outside the
// kernel's limits.
int rgqa_fused_attention_long_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* out,
    int dtype, int batch, int sq, int skv, int heads, int dim,
    long long q_bs, long long q_rs, long long k_bs, long long k_rs,
    long long v_bs, long long v_rs, float scale, void* stream) {
  if (!within_long_limits(batch, sq, skv, heads, dim)) return -1;
  Args a = make_args(q, k, v, bias, sq, skv, heads, dim, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs,
                     scale);
  a.out = out;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_long_bf16(a, batch, s);
  if (dtype != 0) return -1;
  return launch(fused_attention_f32<false, kLongPerLane, kLongF32Threads>, a, batch,
                kLongF32Threads, fwd_f32_smem_bytes(tile_rows(a.sq), a.skv, a.dim), s,
                (a.sq + kTileQ - 1) / kTileQ);
}

}  // extern "C"

RGQA_CUDA_ERROR_STRING
