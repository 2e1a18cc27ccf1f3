// Device code shared by the port's attention kernels on the natural
// (B, S, H*D) layout: fused_attention.cu (forward), fused_attention_bwd.cu
// (backward), fused_attention_dropout.cu (forward and backward with
// dropout on the attention probabilities), and the long-stream forward
// and backward (fused_attention_long.cu, fused_attention_long_bwd.cu),
// which take the loaders, the mma.sync fragment helpers and the dbias
// head sum from here.
//
// Every kernel runs one block per (batch row, head) and keeps that pair's
// whole problem in shared memory (LXMERT's sequences are 20 and 36 tokens,
// heads 64 wide).  The f32 forward body also takes a query tile (kTileQ
// rows each): fused_attention_long.cu runs it, and a bf16 body of its
// own, on a (batch row, head, query tile) grid for ViLT's 165-185-token
// streams, with each tile's complete softmax over every key; at <= 64
// query rows there is one tile and the body is the short kernel's.  The
// forward and
// backward bodies are templates on kDrop: the dropout kernels are the
// same code with the mask applied, so at rate 0 (threshold 0, keep scale
// 1) they compute bit for bit what the deterministic ones do.
//
// The dropout mask is keyed on the element: keep(b, h, i, j) is byte
// j % 16 of Philox4x32-10 at counter (j / 16, i, h, b) under the 64-bit
// seed, kept iff the byte >= threshold.  It does not depend on the launch
// geometry, so the backward replays it exactly, and the plain version
// (rgqa_tpu_torch.ops.attention.dropout_keep_mask_ref) draws the same bits.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxSeq = 64;
constexpr int kMaxDim = 64;
// The long-stream forward (fused_attention_long.cu): any number of query
// rows in tiles of kTileQ, up to kLongMaxKv keys, kLongMaxKv / 32 keys
// per lane in the softmax.
constexpr int kTileQ = 64;
constexpr int kLongMaxKv = 256;

struct Args {
  const void* q;        // (B, Sq, H*D), element strides below
  const void* k;        // (B, Skv, H*D)
  const void* v;        // (B, Skv, H*D)
  const float* bias;    // (B, Skv) additive mask, contiguous f32
  const void* g;        // backward: dL/d(out), contiguous (B, Sq, H*D)
  void* out;            // forward: contiguous (B, Sq, H*D)
  void* dq;             // backward: contiguous, the input dtype
  void* dk;
  void* dv;
  float* dbias_part;    // backward: (B, H, Skv) per-head sums of dS
  float* stats;         // long backward: (B, H, Sq, 3) f32 row max, sum term, D
  int sq, skv, heads, dim;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs;
  float scale;          // 1 / sqrt(dim)
  unsigned long long seed;  // dropout
  int threshold;            // keep iff byte >= threshold (0..255)
  float keep_scale;         // 256 / (256 - threshold)
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// ---------------------------------------------------------------------------
// Dropout bits.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

__device__ __forceinline__ bool dropout_keep(const Args& a, int b, int h, int i, int j) {
  const uint4 w = philox4x32_10(
      make_uint4(static_cast<uint32_t>(j >> 4), static_cast<uint32_t>(i),
                 static_cast<uint32_t>(h), static_cast<uint32_t>(b)),
      static_cast<uint32_t>(a.seed), static_cast<uint32_t>(a.seed >> 32));
  const int s = j & 15;
  const uint32_t word = s < 4 ? w.x : s < 8 ? w.y : s < 12 ? w.z : w.w;
  return ((word >> (8 * (s & 3))) & 0xFFu) >= static_cast<uint32_t>(a.threshold);
}

// ---------------------------------------------------------------------------
// Pieces of both bodies.
// ---------------------------------------------------------------------------

// Row softmax of s (sq x skv, row stride lds) by warps; each lane holds
// the kPerLane columns lane, lane + 32, ... (so skv <= 32 kPerLane).  A
// row whose scores are all large negative (fully masked by -10000) still
// has a finite max, so every e is finite and the sum >= 1.  emit(i, j, p)
// stores one probability, for every i < rows and j < cols: rows and
// columns beyond sq x skv get p = 0 (the zero padding of the tensor-core
// body).  The max and the lane's sum run over its columns in order.
template <int kPerLane = 2, typename Emit>
__device__ __forceinline__ void softmax_rows(const float* s, int lds, int sq, int skv,
                                             int rows, int cols, int warp, int warps,
                                             int lane, Emit emit) {
  for (int i = warp; i < rows; i += warps) {
    float p[kPerLane];
#pragma unroll
    for (int c = 0; c < kPerLane; ++c) p[c] = 0.f;
    if (i < sq) {
      const float* row = s + i * lds;
      float x[kPerLane];
#pragma unroll
      for (int c = 0; c < kPerLane; ++c) {
        x[c] = lane + 32 * c < skv ? row[lane + 32 * c] : -CUDART_INF_F;
      }
      float m = x[0];
#pragma unroll
      for (int c = 1; c < kPerLane; ++c) m = fmaxf(m, x[c]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
#pragma unroll
      for (int c = 0; c < kPerLane; ++c) p[c] = lane + 32 * c < skv ? expf(x[c] - m) : 0.f;
      float sum = p[0];
#pragma unroll
      for (int c = 1; c < kPerLane; ++c) sum += p[c];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
#pragma unroll
      for (int c = 0; c < kPerLane; ++c) p[c] = p[c] / sum;
    }
#pragma unroll
    for (int c = 0; c < kPerLane; ++c) {
      if (lane + 32 * c < cols) emit(i, lane + 32 * c, p[c]);
    }
  }
}

// rows x d of a strided source into f32 shared memory (row stride ld).
template <typename T>
__device__ __forceinline__ void load_rows_f32(float* dst, int ld, const T* src, long long rs,
                                              int rows, int d, int tid, int nthreads) {
  for (int i = tid; i < rows * d; i += nthreads) {
    const int r = i / d, c = i % d;
    dst[r * ld + c] = to_f32(src[r * rs + c]);
  }
}

// S = Q K^T * scale + bias on the CUDA cores, f32 (the f32 bodies).
__device__ __forceinline__ void scores_f32(float* ps, int ldp, const float* qs,
                                           const float* ks, int ld, const float* bs,
                                           const Args& a, int tid, int nthreads) {
  const int skv = a.skv, d = a.dim;
  for (int idx = tid; idx < a.sq * skv; idx += nthreads) {
    const int i = idx / skv, j = idx % skv;
    const float* qi = qs + i * ld;
    const float* kj = ks + j * ld;
    float acc = 0.f;
#pragma unroll 8
    for (int c = 0; c < d; ++c) acc = fmaf(qi[c], kj[c], acc);
    ps[i * ldp + j] = acc * a.scale + bs[j];
  }
}

// ---- tensor cores: mma.sync m16n8k16, bf16 x bf16 -> f32 ----

constexpr int kMmaThreads = 128;
constexpr int kMmaWarps = kMmaThreads / 32;

// 16 bytes global -> shared without passing through registers; the copy
// lands once the issuing thread runs cp_async_wait_all().
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// rows_p x dp tile of a strided (rows x d) bf16 source into shared memory,
// zero outside it.  When the source allows 16-byte copies they go out as
// cp.async, all in flight at once: the caller runs cp_async_wait_all()
// before the barrier that publishes the tile.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int ld,
                                          const __nv_bfloat16* src, long long rs,
                                          int rows, int rows_p, int d, int dp, int tid) {
  const bool vec = d % 8 == 0 && rs % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0;
  if (vec) {
    const int chunks = dp / 8;
    for (int i = tid; i < rows_p * chunks; i += kMmaThreads) {
      const int r = i / chunks, c = i % chunks * 8;
      if (r < rows && c < d) {
        cp_async16(dst + r * ld + c, src + r * rs + c);
      } else {
        *reinterpret_cast<uint4*>(dst + r * ld + c) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int i = tid; i < rows_p * dp; i += kMmaThreads) {
      const int r = i / dp, c = i % dp;
      dst[r * ld + c] = (r < rows && c < d) ? src[r * rs + c] : zero;
    }
  }
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);  // two consecutive bf16, 4-byte aligned
}

__device__ __forceinline__ uint32_t pack_pair(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ void mma_16x8x16(float (&acc)[4], uint32_t a0, uint32_t a1,
                                            uint32_t a2, uint32_t a3, uint32_t b0,
                                            uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_f32_pair(float lo, float hi) {
  return pack_pair(__float2bfloat16(lo), __float2bfloat16(hi));
}

// Fragments of mma.sync m16n8k16 from shared memory, one warp (g = lane /
// 4 the fragment's row or column group, t = 2 (lane % 4)):
// a_frag: A, the 16 x 16 block at p (row-major, row stride ld);
// b_frag_rows: B (16 x 8) with B(k, n) at p[n * ld + k] (K^T read from
//   key rows: k runs along a row);
// b_frag: B with B(k, n) at p[k * ld + n] (a matrix read from its rows).
__device__ __forceinline__ void a_frag(uint32_t (&f)[4], const __nv_bfloat16* p, int ld,
                                       int lane) {
  const int g = lane >> 2, t = (lane & 3) * 2;
  f[0] = ld_pair(p + g * ld + t);
  f[1] = ld_pair(p + (g + 8) * ld + t);
  f[2] = ld_pair(p + g * ld + t + 8);
  f[3] = ld_pair(p + (g + 8) * ld + t + 8);
}

__device__ __forceinline__ void b_frag_rows(uint32_t& b0, uint32_t& b1,
                                            const __nv_bfloat16* p, int ld, int lane) {
  const int g = lane >> 2, t = (lane & 3) * 2;
  b0 = ld_pair(p + g * ld + t);
  b1 = ld_pair(p + g * ld + t + 8);
}

__device__ __forceinline__ void b_frag(uint32_t& b0, uint32_t& b1, const __nv_bfloat16* p,
                                       int ld, int lane) {
  const int g = lane >> 2, t = (lane & 3) * 2;
  b0 = pack_pair(p[t * ld + g], p[(t + 1) * ld + g]);
  b1 = pack_pair(p[(t + 8) * ld + g], p[(t + 9) * ld + g]);
}

// acc += A (16 x 16, row-major at a, stride lda) x B, one warp, where B
// is 16 x 8 with element (k, n) at b[n * ldb + k] (b_rows: K^T read from
// key rows) or at b[k * ldb + n] (!b_rows: a matrix read from its rows).
template <bool b_rows>
__device__ __forceinline__ void mma_tile(float (&acc)[4], const __nv_bfloat16* a, int lda,
                                         const __nv_bfloat16* b, int ldb, int lane) {
  uint32_t af[4], b0, b1;
  a_frag(af, a, lda, lane);
  if (b_rows) {
    b_frag_rows(b0, b1, b, ldb, lane);
  } else {
    b_frag(b0, b1, b, ldb, lane);
  }
  mma_16x8x16(acc, af[0], af[1], af[2], af[3], b0, b1);
}

// C (m_rows_p x n) = A (m_rows_p x k_p, row stride lda) x B (k_p x n,
// row-major, stride ldb), by (16-row, 8-column) tiles over the block's
// warps; store(i, c, value) for i < m and c < n.
template <typename Store>
__device__ __forceinline__ void mma_product(const __nv_bfloat16* a, int lda,
                                            const __nv_bfloat16* b, int ldb, int m_p, int k_p,
                                            int m, int n, int warp, int lane, Store store) {
  const int g = lane >> 2, t = (lane & 3) * 2;
  const int m_tiles = m_p / 16, n_tiles = (n + 7) / 8;
  for (int task = warp; task < m_tiles * n_tiles; task += kMmaWarps) {
    const int m0 = task / n_tiles * 16, n0 = task % n_tiles * 8;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < k_p; k0 += 16) {
      mma_tile<false>(acc, a + m0 * lda + k0, lda, b + k0 * ldb + n0, ldb, lane);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = m0 + g + (e >= 2 ? 8 : 0), c = n0 + t + (e & 1);
      if (i < m && c < n) store(i, c, acc[e]);
    }
  }
}

// S = Q K^T * scale + bias on the tensor cores into ss (sq x (skv + 1)),
// one (16-row, 8-key) tile per warp task; Qs / Ks zero-padded tiles.
__device__ __forceinline__ void scores_mma(float* ss, const __nv_bfloat16* qs,
                                           const __nv_bfloat16* ks, int ldq, int sqp, int dp,
                                           const float* bs, const Args& a, int warp, int lane) {
  const int sq = a.sq, skv = a.skv;
  const int g = lane >> 2, t = (lane & 3) * 2;
  const int m_tiles = sqp / 16, n_tiles = (skv + 7) / 8;
  for (int task = warp; task < m_tiles * n_tiles; task += kMmaWarps) {
    const int m0 = task / n_tiles * 16, n0 = task % n_tiles * 8;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < dp; k0 += 16) {
      mma_tile<true>(acc, qs + m0 * ldq + k0, ldq, ks + n0 * ldq + k0, ldq, lane);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = m0 + g + (e >= 2 ? 8 : 0), j = n0 + t + (e & 1);
      if (i < sq && j < skv) ss[i * (skv + 1) + j] = acc[e] * a.scale + bs[j];
    }
  }
}

// ---------------------------------------------------------------------------
// Forward.  out[b, :, h*D:(h+1)*D] = softmax(q_h k_h^T * scale + bias) v_h,
// with P (dropped and scaled when kDrop) rounded to the input dtype before
// the PV product, as the Pallas _fused_kernel / _fused_drop_kernel.
//
// A long-stream block (fwd_tile; the f32 body here, the bf16 one in
// fused_attention_long.cu), blockIdx.x = (b * heads + h) * tiles + tile,
// computes the query rows [q0, q0 + rows) with q0 = tile * kTileQ: the
// tile's Q, the row's whole K and V, and each query row's complete softmax
// over all skv keys (one pass, no online rescaling), as the Pallas
// query-tiled grid (_fused_qblocked_raw) does.  The tile index runs
// fastest, so the tiles of one (row, head) run together.  Shared memory
// is sized for tile_rows(sq) = min(sq, kTileQ) query rows.
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;
// The long stream's f32 block holds one query tile and a whole row's K
// and V, so one block fills an SM's shared memory: its warps alone hide
// the latency of the shared-memory loads, hence four times the threads.
constexpr int kLongF32Threads = 4 * kF32Threads;
constexpr int kLongPerLane = kLongMaxKv / 32;

__host__ __device__ inline int tile_rows(int sq) { return sq < kTileQ ? sq : kTileQ; }

// The (batch row, head, query tile) a forward block works on; t is the
// block's Args with q moved to the tile's first row and sq = its rows.
struct FwdTile {
  int b, h, q0;
  Args t;
};

__device__ __forceinline__ FwdTile fwd_tile(const Args& a, size_t elem) {
  const int tiles = (a.sq + kTileQ - 1) / kTileQ;
  const int bh = blockIdx.x / tiles;
  FwdTile f;
  f.b = bh / a.heads;
  f.h = bh % a.heads;
  f.q0 = blockIdx.x % tiles * kTileQ;
  f.t = a;
  f.t.q = static_cast<const unsigned char*>(a.q) + f.q0 * a.q_rs * elem;
  f.t.sq = min(a.sq - f.q0, kTileQ);
  return f;
}

// f32: CUDA cores (fmaf), exact to the plain version's summation order
// rather than rounding operands to TF32.  Shared memory, f32: Q (sq x ld),
// K, V (skv x ld), S/P (sq x (skv + 1)), bias; ld = dim + 1 so that
// threads walking K rows hit distinct banks; sq = tile_rows(a.sq).
size_t fwd_f32_smem_bytes(int sq, int skv, int d) {
  const size_t ld = d + 1;
  return sizeof(float) * (sq * ld + 2 * skv * ld + sq * (skv + 1) + skv);
}

template <bool kDrop, int kPerLane = 2, int kThreads = kF32Threads>
__global__ void __launch_bounds__(kThreads) fused_attention_f32(Args a) {
  extern __shared__ float smem[];
  const FwdTile f = fwd_tile(a, sizeof(float));
  const int b = f.b, h = f.h, q0 = f.q0;
  const int sq = f.t.sq, skv = a.skv, d = a.dim;
  const int ld = d + 1, ldp = skv + 1;
  float* qs = smem;
  float* ks = qs + tile_rows(a.sq) * ld;
  float* vs = ks + skv * ld;
  float* ps = vs + skv * ld;
  float* bs = ps + tile_rows(a.sq) * ldp;
  const int tid = threadIdx.x;

  load_rows_f32(qs, ld, static_cast<const float*>(f.t.q) + b * a.q_bs + h * d, a.q_rs, sq, d,
                tid, kThreads);
  load_rows_f32(ks, ld, static_cast<const float*>(a.k) + b * a.k_bs + h * d, a.k_rs, skv, d,
                tid, kThreads);
  load_rows_f32(vs, ld, static_cast<const float*>(a.v) + b * a.v_bs + h * d, a.v_rs, skv, d,
                tid, kThreads);
  for (int j = tid; j < skv; j += kThreads) bs[j] = a.bias[b * skv + j];
  __syncthreads();

  scores_f32(ps, ldp, qs, ks, ld, bs, f.t, tid, kThreads);
  __syncthreads();

  softmax_rows<kPerLane>(ps, ldp, sq, skv, sq, skv, tid / 32, kThreads / 32, tid % 32,
                         [&](int i, int j, float p) {
                           if (kDrop) p = dropout_keep(a, b, h, q0 + i, j) ? p * a.keep_scale : 0.f;
                           ps[i * ldp + j] = p;
                         });
  __syncthreads();

  const long long out_rs = static_cast<long long>(a.heads) * d;
  float* out = static_cast<float*>(a.out) + static_cast<long long>(b) * a.sq * out_rs +
               q0 * out_rs + h * d;
  for (int idx = tid; idx < sq * d; idx += kThreads) {
    const int i = idx / d, c = idx % d;
    const float* pi = ps + i * ldp;
    float acc = 0.f;
#pragma unroll 4
    for (int j = 0; j < skv; ++j) acc = fmaf(pi[j], vs[j * ld + c], acc);
    out[i * out_rs + c] = acc;
  }
}

// bf16: both products on the tensor cores.  Shared memory, bf16 unless
// noted; every row stride is (padded width + 8) elements, so that the 8
// rows one fragment load touches start in distinct banks, and rows stay
// 16-byte aligned:
//   Qs  (SQP x DP)   query rows, zero-padded to SQP = round_up(sq, 16)
//                    rows and DP = round_up(dim, 16) columns
//   Ks  (SKP x DP)   key rows, zero-padded to SKP = round_up(skv, 16)
//   Vs  (SKP x DP)   value rows, zero-padded likewise
//   Ps  (SQP x SKP)  probabilities in bf16, zero outside sq x skv
//   Ss  f32 (sq x (skv + 1)) scores;  bias f32 (skv)
struct FwdLayout {
  int sqp, skp, dp;   // padded extents
  int ldq, ldp;       // row strides (elements) of Qs/Ks/Vs and of Ps
  size_t q_off, k_off, v_off, p_off, s_off, b_off, bytes;
};

__host__ __device__ inline FwdLayout fwd_layout(int sq, int skv, int d) {
  FwdLayout L;
  L.sqp = (sq + 15) / 16 * 16;
  L.skp = (skv + 15) / 16 * 16;
  L.dp = (d + 15) / 16 * 16;
  L.ldq = L.dp + 8;
  L.ldp = L.skp + 8;
  const size_t bf = sizeof(__nv_bfloat16);
  L.q_off = 0;  // every offset below is a multiple of 16 bytes
  L.k_off = L.q_off + bf * L.sqp * L.ldq;
  L.v_off = L.k_off + bf * L.skp * L.ldq;
  L.p_off = L.v_off + bf * L.skp * L.ldq;
  L.s_off = L.p_off + bf * L.sqp * L.ldp;
  L.b_off = L.s_off + sizeof(float) * sq * (skv + 1);
  L.bytes = L.b_off + sizeof(float) * skv;
  return L;
}

template <bool kDrop>
__global__ void __launch_bounds__(kMmaThreads) fused_attention_bf16(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int sq = a.sq, skv = a.skv, d = a.dim;
  const FwdLayout L = fwd_layout(sq, skv, d);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.q_off);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.k_off);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.v_off);
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.p_off);
  float* ss = reinterpret_cast<float*>(smem_raw + L.s_off);
  float* bs = reinterpret_cast<float*>(smem_raw + L.b_off);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  load_tile(qs, L.ldq, static_cast<const __nv_bfloat16*>(a.q) + b * a.q_bs + h * d,
            a.q_rs, sq, L.sqp, d, L.dp, tid);
  load_tile(ks, L.ldq, static_cast<const __nv_bfloat16*>(a.k) + b * a.k_bs + h * d,
            a.k_rs, skv, L.skp, d, L.dp, tid);
  load_tile(vs, L.ldq, static_cast<const __nv_bfloat16*>(a.v) + b * a.v_bs + h * d,
            a.v_rs, skv, L.skp, d, L.dp, tid);
  for (int j = tid; j < skv; j += kMmaThreads) bs[j] = a.bias[b * skv + j];
  cp_async_wait_all();
  __syncthreads();

  scores_mma(ss, qs, ks, L.ldq, L.sqp, L.dp, bs, a, warp, lane);
  __syncthreads();

  // P in bf16 over the whole padded SQP x SKP tile (zeros outside).
  softmax_rows(ss, skv + 1, sq, skv, L.sqp, L.skp, warp, kMmaWarps, lane,
               [&](int i, int j, float p) {
                 if (kDrop && i < sq && j < skv) {
                   p = dropout_keep(a, b, h, i, j) ? p * a.keep_scale : 0.f;
                 }
                 ps[i * L.ldp + j] = __float2bfloat16(p);
               });
  __syncthreads();

  // O = P V: one (16-row, 8-column) output tile per warp task.
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out) +
                       static_cast<long long>(b) * sq * a.heads * d + h * d;
  const long long out_rs = static_cast<long long>(a.heads) * d;
  mma_product(ps, L.ldp, vs, L.ldq, L.sqp, L.skp, sq, d, warp, lane,
              [&](int i, int c, float x) { out[i * out_rs + c] = __float2bfloat16(x); });
}

// ---------------------------------------------------------------------------
// Backward, as the Pallas _fused_bwd_kernel / _fused_drop_bwd_kernel:
// recompute P; dP = g V^T and dV = P_drop^T g, both in f32 on the CUDA
// cores (g and v exact in f32); with dropout dP is masked and scaled;
// dS = P (dP - rowsum(dP P)); dbias = sum over heads and query rows of
// dS; dS * scale rounded to the input dtype; dQ = dS K, dK = dS^T Q.
// ---------------------------------------------------------------------------

// The steps both backward bodies share, after P (f32, row stride ldp) is
// in ps: from f32 G and V (row stride ld) it writes dV to global memory,
// and leaves dS (not yet scaled) in dps and the per-head dbias sums in
// a.dbias_part.  km holds the dropout mask, one byte per element.
template <bool kDrop, typename T>
__device__ __forceinline__ void bwd_grads(const Args& a, int b, int h, const float* gs,
                                          const float* vs, int ld, const float* ps,
                                          float* dps, int ldp, float* rs, uint8_t* km,
                                          int tid, int nthreads) {
  const int sq = a.sq, skv = a.skv, d = a.dim;
  const int warp = tid / 32, warps = nthreads / 32, lane = tid % 32;
  for (int idx = tid; idx < sq * skv; idx += nthreads) {
    const int i = idx / skv, j = idx % skv;
    const float* gi = gs + i * ld;
    const float* vj = vs + j * ld;
    float acc = 0.f;
#pragma unroll 8
    for (int c = 0; c < d; ++c) acc = fmaf(gi[c], vj[c], acc);
    if (kDrop) {
      const bool keep = dropout_keep(a, b, h, i, j);
      km[idx] = keep;
      acc = keep ? acc * a.keep_scale : 0.f;
    }
    dps[i * ldp + j] = acc;
  }
  __syncthreads();

  T* dv = static_cast<T*>(a.dv) + static_cast<long long>(b) * skv * a.heads * d + h * d;
  const long long row = static_cast<long long>(a.heads) * d;
  for (int idx = tid; idx < skv * d; idx += nthreads) {
    const int j = idx / d, c = idx % d;
    float acc = 0.f;
    for (int i = 0; i < sq; ++i) {
      float p = ps[i * ldp + j];
      if (kDrop) p = km[i * skv + j] ? p * a.keep_scale : 0.f;
      acc = fmaf(p, gs[i * ld + c], acc);
    }
    dv[j * row + c] = from_f32<T>(acc);
  }
  for (int i = warp; i < sq; i += warps) {
    const float* pi = ps + i * ldp;
    const float* dpi = dps + i * ldp;
    float s = (lane < skv ? dpi[lane] * pi[lane] : 0.f) +
              (lane + 32 < skv ? dpi[lane + 32] * pi[lane + 32] : 0.f);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) rs[i] = s;
  }
  __syncthreads();

  for (int idx = tid; idx < sq * skv; idx += nthreads) {
    const int i = idx / skv, j = idx % skv;
    dps[i * ldp + j] = ps[i * ldp + j] * (dps[i * ldp + j] - rs[i]);
  }
  __syncthreads();

  float* part = a.dbias_part + (static_cast<long long>(b) * a.heads + h) * skv;
  for (int j = tid; j < skv; j += nthreads) {
    float s = 0.f;
    for (int i = 0; i < sq; ++i) s += dps[i * ldp + j];
    part[j] = s;
  }
  __syncthreads();
}

// f32 body, CUDA cores.  Shared memory, f32: Q, G (sq x ld), K, V
// (skv x ld), P and dP/dS (sq x (skv + 1)), bias (skv), row sums (sq),
// then the mask bytes (sq x skv).
size_t bwd_f32_smem_bytes(int sq, int skv, int d) {
  const size_t ld = d + 1;
  return sizeof(float) * (2 * sq * ld + 2 * skv * ld + 2 * sq * (skv + 1) + skv + sq) +
         sq * skv;
}

template <bool kDrop>
__global__ void __launch_bounds__(kF32Threads) fused_attention_bwd_f32(Args a) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int sq = a.sq, skv = a.skv, d = a.dim;
  const int ld = d + 1, ldp = skv + 1;
  const long long row = static_cast<long long>(a.heads) * d;
  float* qs = smem;
  float* gs = qs + sq * ld;
  float* ks = gs + sq * ld;
  float* vs = ks + skv * ld;
  float* ps = vs + skv * ld;
  float* dps = ps + sq * ldp;
  float* bs = dps + sq * ldp;
  float* rs = bs + skv;
  uint8_t* km = reinterpret_cast<uint8_t*>(rs + sq);
  const int tid = threadIdx.x;

  load_rows_f32(qs, ld, static_cast<const float*>(a.q) + b * a.q_bs + h * d, a.q_rs, sq, d,
                tid, kF32Threads);
  load_rows_f32(ks, ld, static_cast<const float*>(a.k) + b * a.k_bs + h * d, a.k_rs, skv, d,
                tid, kF32Threads);
  load_rows_f32(vs, ld, static_cast<const float*>(a.v) + b * a.v_bs + h * d, a.v_rs, skv, d,
                tid, kF32Threads);
  load_rows_f32(gs, ld, static_cast<const float*>(a.g) + b * sq * row + h * d, row, sq, d,
                tid, kF32Threads);
  for (int j = tid; j < skv; j += kF32Threads) bs[j] = a.bias[b * skv + j];
  __syncthreads();

  scores_f32(ps, ldp, qs, ks, ld, bs, a, tid, kF32Threads);
  __syncthreads();
  softmax_rows(ps, ldp, sq, skv, sq, skv, tid / 32, kF32Threads / 32, tid % 32,
               [&](int i, int j, float p) { ps[i * ldp + j] = p; });
  __syncthreads();

  bwd_grads<kDrop, float>(a, b, h, gs, vs, ld, ps, dps, ldp, rs, km, tid, kF32Threads);

  for (int idx = tid; idx < sq * skv; idx += kF32Threads) {
    dps[idx / skv * ldp + idx % skv] *= a.scale;
  }
  __syncthreads();

  float* dq = static_cast<float*>(a.dq) + static_cast<long long>(b) * sq * row + h * d;
  for (int idx = tid; idx < sq * d; idx += kF32Threads) {
    const int i = idx / d, c = idx % d;
    const float* dsi = dps + i * ldp;
    float acc = 0.f;
#pragma unroll 4
    for (int j = 0; j < skv; ++j) acc = fmaf(dsi[j], ks[j * ld + c], acc);
    dq[i * row + c] = acc;
  }
  float* dk = static_cast<float*>(a.dk) + static_cast<long long>(b) * skv * row + h * d;
  for (int idx = tid; idx < skv * d; idx += kF32Threads) {
    const int j = idx / d, c = idx % d;
    float acc = 0.f;
#pragma unroll 4
    for (int i = 0; i < sq; ++i) acc = fmaf(dps[i * ldp + j], qs[i * ld + c], acc);
    dk[j * row + c] = acc;
  }
}

// bf16 body: S, dQ and dK on the tensor cores, dP and dV on the CUDA
// cores in f32.  Shared memory:
//   Qs, Ks  bf16 (SQP / SKP x DP, stride DP + 8), zero-padded, as the forward
//   Gf, Vf  f32 (sq / skv x (dim + 1)), g and v converted exactly
//   P, dP   f32 (sq x (skv + 1))
//   dS      bf16 (SQP x SKP, stride SKP + 8), dS^T bf16 (SKP x SQP,
//           stride SQP + 8), zero-padded
//   bias f32 (skv), row sums f32 (sq), mask bytes (sq x skv)
struct BwdLayout {
  int sqp, skp, dp, ldq, ld, ldp, ldds, ldt;
  size_t q_off, k_off, g_off, v_off, p_off, dp_off, ds_off, dt_off, b_off, r_off, m_off, bytes;
};

__host__ __device__ inline BwdLayout bwd_layout(int sq, int skv, int d) {
  BwdLayout L;
  L.sqp = (sq + 15) / 16 * 16;
  L.skp = (skv + 15) / 16 * 16;
  L.dp = (d + 15) / 16 * 16;
  L.ldq = L.dp + 8;
  L.ld = d + 1;
  L.ldp = skv + 1;
  L.ldds = L.skp + 8;
  L.ldt = L.sqp + 8;
  const size_t bf = sizeof(__nv_bfloat16), f = sizeof(float);
  L.q_off = 0;
  L.k_off = align16(L.q_off + bf * L.sqp * L.ldq);
  L.g_off = align16(L.k_off + bf * L.skp * L.ldq);
  L.v_off = align16(L.g_off + f * sq * L.ld);
  L.p_off = align16(L.v_off + f * skv * L.ld);
  L.dp_off = align16(L.p_off + f * sq * L.ldp);
  L.ds_off = align16(L.dp_off + f * sq * L.ldp);
  L.dt_off = align16(L.ds_off + bf * L.sqp * L.ldds);
  L.b_off = align16(L.dt_off + bf * L.skp * L.ldt);
  L.r_off = L.b_off + f * skv;
  L.m_off = L.r_off + f * sq;
  L.bytes = L.m_off + sq * skv;
  return L;
}

template <bool kDrop>
__global__ void __launch_bounds__(kMmaThreads) fused_attention_bwd_bf16(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int sq = a.sq, skv = a.skv, d = a.dim;
  const long long row = static_cast<long long>(a.heads) * d;
  const BwdLayout L = bwd_layout(sq, skv, d);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.q_off);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.k_off);
  float* gf = reinterpret_cast<float*>(smem_raw + L.g_off);
  float* vf = reinterpret_cast<float*>(smem_raw + L.v_off);
  float* ps = reinterpret_cast<float*>(smem_raw + L.p_off);
  float* dps = reinterpret_cast<float*>(smem_raw + L.dp_off);
  __nv_bfloat16* dss = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.ds_off);
  __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.dt_off);
  float* bs = reinterpret_cast<float*>(smem_raw + L.b_off);
  float* rs = reinterpret_cast<float*>(smem_raw + L.r_off);
  uint8_t* km = smem_raw + L.m_off;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  load_tile(qs, L.ldq, static_cast<const __nv_bfloat16*>(a.q) + b * a.q_bs + h * d,
            a.q_rs, sq, L.sqp, d, L.dp, tid);
  load_tile(ks, L.ldq, static_cast<const __nv_bfloat16*>(a.k) + b * a.k_bs + h * d,
            a.k_rs, skv, L.skp, d, L.dp, tid);
  load_rows_f32(vf, L.ld, static_cast<const __nv_bfloat16*>(a.v) + b * a.v_bs + h * d,
                a.v_rs, skv, d, tid, kMmaThreads);
  load_rows_f32(gf, L.ld, static_cast<const __nv_bfloat16*>(a.g) + b * sq * row + h * d,
                row, sq, d, tid, kMmaThreads);
  for (int j = tid; j < skv; j += kMmaThreads) bs[j] = a.bias[b * skv + j];
  cp_async_wait_all();
  __syncthreads();

  scores_mma(ps, qs, ks, L.ldq, L.sqp, L.dp, bs, a, warp, lane);
  __syncthreads();
  softmax_rows(ps, L.ldp, sq, skv, sq, skv, warp, kMmaWarps, lane,
               [&](int i, int j, float p) { ps[i * L.ldp + j] = p; });
  __syncthreads();

  bwd_grads<kDrop, __nv_bfloat16>(a, b, h, gf, vf, L.ld, ps, dps, L.ldp, rs, km, tid,
                                  kMmaThreads);

  // dS * scale in bf16, in both orientations, zero outside sq x skv.
  for (int idx = tid; idx < L.sqp * L.skp; idx += kMmaThreads) {
    const int i = idx / L.skp, j = idx % L.skp;
    const __nv_bfloat16 x =
        __float2bfloat16(i < sq && j < skv ? dps[i * L.ldp + j] * a.scale : 0.f);
    dss[i * L.ldds + j] = x;
    dst[j * L.ldt + i] = x;
  }
  __syncthreads();

  __nv_bfloat16* dq = static_cast<__nv_bfloat16*>(a.dq) + static_cast<long long>(b) * sq * row + h * d;
  mma_product(dss, L.ldds, ks, L.ldq, L.sqp, L.skp, sq, d, warp, lane,
              [&](int i, int c, float x) { dq[i * row + c] = __float2bfloat16(x); });
  __nv_bfloat16* dk = static_cast<__nv_bfloat16*>(a.dk) + static_cast<long long>(b) * skv * row + h * d;
  mma_product(dst, L.ldt, qs, L.ldq, L.skp, L.sqp, skv, d, warp, lane,
              [&](int j, int c, float x) { dk[j * row + c] = __float2bfloat16(x); });
}

// dbias[b, j] = sum over heads, in head order, of the per-head partials:
// deterministic, no atomics.
__global__ void fused_attention_dbias_sum(const float* part, float* dbias, int batch,
                                          int heads, int skv) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= batch * skv) return;
  const int b = idx / skv, j = idx % skv;
  float s = 0.f;
  for (int h = 0; h < heads; ++h) s += part[(static_cast<long long>(b) * heads + h) * skv + j];
  dbias[idx] = s;
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

bool within_limits(int batch, int sq, int skv, int heads, int dim) {
  return batch > 0 && sq > 0 && skv > 0 && heads > 0 && dim > 0 && sq <= kMaxSeq &&
         skv <= kMaxSeq && dim <= kMaxDim;
}

// The long-stream forward: any sq (in query tiles), skv <= kLongMaxKv.
bool within_long_limits(int batch, int sq, int skv, int heads, int dim) {
  return batch > 0 && sq > 0 && skv > 0 && heads > 0 && dim > 0 &&
         static_cast<long long>(batch) * heads * ((sq + kTileQ - 1) / kTileQ) < (1LL << 31) &&
         skv <= kLongMaxKv && dim <= kMaxDim;
}

Args make_args(const void* q, const void* k, const void* v, const void* bias, int sq,
               int skv, int heads, int dim, long long q_bs, long long q_rs, long long k_bs,
               long long k_rs, long long v_bs, long long v_rs, float scale) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = static_cast<const float*>(bias);
  a.sq = sq;
  a.skv = skv;
  a.heads = heads;
  a.dim = dim;
  a.q_bs = q_bs;
  a.q_rs = q_rs;
  a.k_bs = k_bs;
  a.k_rs = k_rs;
  a.v_bs = v_bs;
  a.v_rs = v_rs;
  a.scale = scale;
  a.threshold = 0;
  a.keep_scale = 1.f;
  return a;
}

// One block per (batch row, head, query tile), the tile fastest.
template <typename Kernel>
int launch(Kernel kernel, const Args& a, int batch, int threads, size_t smem,
           cudaStream_t stream, int tiles = 1) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>(batch) * a.heads * static_cast<unsigned>(tiles);
  kernel<<<blocks, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = bfloat16; sq <= kMaxSeq (one query tile).
template <bool kDrop>
int launch_fwd(const Args& a, int dtype, int batch, cudaStream_t s) {
  if (dtype == 0) {
    return launch(fused_attention_f32<kDrop>, a, batch, kF32Threads,
                  fwd_f32_smem_bytes(a.sq, a.skv, a.dim), s);
  }
  if (dtype == 1) {
    return launch(fused_attention_bf16<kDrop>, a, batch, kMmaThreads,
                  fwd_layout(a.sq, a.skv, a.dim).bytes, s);
  }
  return -1;
}

template <bool kDrop>
int launch_bwd(const Args& a, float* dbias, int dtype, int batch, cudaStream_t s) {
  int err = -1;
  if (dtype == 0) {
    err = launch(fused_attention_bwd_f32<kDrop>, a, batch, kF32Threads,
                 bwd_f32_smem_bytes(a.sq, a.skv, a.dim), s);
  } else if (dtype == 1) {
    err = launch(fused_attention_bwd_bf16<kDrop>, a, batch, kMmaThreads,
                 bwd_layout(a.sq, a.skv, a.dim).bytes, s);
  }
  if (err != 0) return err;
  const int n = batch * a.skv, threads = 256;
  fused_attention_dbias_sum<<<(n + threads - 1) / threads, threads, 0, s>>>(
      a.dbias_part, dbias, batch, a.heads, a.skv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define RGQA_CUDA_ERROR_STRING                                              \
  extern "C" const char* rgqa_cuda_error_string(int err) {                 \
    return err < 0 ? "argument outside the kernel's limits"                 \
                   : cudaGetErrorString(static_cast<cudaError_t>(err));     \
  }
