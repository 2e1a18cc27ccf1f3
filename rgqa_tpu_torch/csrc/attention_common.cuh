// Device code shared by the port's attention kernels on the natural
// (B, S, H*D) layout: fused_attention.cu (forward), fused_attention_bwd.cu
// (backward), fused_attention_dropout.cu (forward and backward with
// dropout on the attention probabilities), and the long-stream forward
// and backward (fused_attention_long.cu, fused_attention_long_bwd.cu),
// which take the loaders, the mma.sync fragment helpers and the dbias
// head sum from here, and the experiments' kernels (xfuse.cu runs the
// forward bodies below on two problems or with a structural mask;
// headfold.cu and epilogue.cu build on the helpers).
//
// Every short kernel keeps a (batch row, head)'s whole problem in shared
// memory (LXMERT's sequences are 20 and 36 tokens, heads 64 wide): the
// forwards and the f32 backward run one block per (row, head), the bf16
// backward one block per row and pair of heads, in turn; both bf16
// bodies (fused_attention_fwd_short_bf16, fused_attention_bwd_short_bf16)
// keep the score tiles and every product in registers.  The f32 forward
// body also takes a query tile (kTileQ rows each): fused_attention_long.cu
// runs it on a (batch row, head, query tile) grid for f32 streams of up
// to kLongWholeKv keys, with each tile's complete softmax over every key;
// at <= 64 query rows there is one tile and the body is the short
// kernel's.  Longer f32 streams, every bf16 stream beyond 64 tokens (a
// wgmma body of its own) and the long backward walk key tiles.  The
// forward and backward bodies are templates on kDrop: the dropout kernels
// (#4 / #5 here and in fused_attention_dropout.cu; 4L / 5L, the long
// forward and backward with kDrop) are the same code with the mask
// applied, so at rate 0 (threshold 0, keep scale 1) they compute bit for
// bit what the deterministic ones do.
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
// The long-stream kernels (fused_attention_long.cu,
// fused_attention_long_bwd.cu): any number of query rows in tiles of
// kTileQ and any number of keys.  Up to kLongWholeKv keys the f32
// forward runs its whole-row body (kLongWholeKv / 32 keys per lane in the
// softmax); beyond, in the bf16 forward and in the backward, keys come in
// tiles of kKvTile.
constexpr int kTileQ = 64;
constexpr int kLongWholeKv = 256;
constexpr int kKvTile = 64;
constexpr int kTileGroups = kKvTile / 16;  // keep_bits16 words of a row in a key tile

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
  float* lse;           // long forward: (B, H, Sq, 2) f32 row statistics (m, log(sum)):
                        // the row's max and the log of its softmax sum, whose sum is
                        // the log-sum-exp of its scores; written when not null;
                        // long backward: read, P = exp((s - m) - log(sum))
  float* dsum;          // long backward: (B, H, Sq) f32 D = rowsum(dP P) scratch
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

// The keep bits of keys 16 c .. 16 c + 15 of query row i (bit s for key
// 16 c + s): one Philox4x32-10 call, bit for bit dropout_keep's.
__device__ __forceinline__ uint32_t keep_bits16(const Args& a, int b, int h, int i, int c) {
  const uint4 w = philox4x32_10(
      make_uint4(static_cast<uint32_t>(c), static_cast<uint32_t>(i), static_cast<uint32_t>(h),
                 static_cast<uint32_t>(b)),
      static_cast<uint32_t>(a.seed), static_cast<uint32_t>(a.seed >> 32));
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
  uint32_t bits = 0;
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    const uint32_t byte = (words[s >> 2] >> (8 * (s & 3))) & 0xFFu;
    bits |= static_cast<uint32_t>(byte >= static_cast<uint32_t>(a.threshold)) << s;
  }
  return bits;
}

// Keep bit of key j in a row's keep_bits16 words (ngr words a row).
__device__ __forceinline__ bool keep_bit(const uint32_t* km, int ngr, int i, int j) {
  return (km[i * ngr + (j >> 4)] >> (j & 15)) & 1u;
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
// row_stats(i, m, sum), called by lane 0 for each row i < sq, sees the
// row's max and sum (NoRowStats: nothing).
struct NoRowStats {
  __device__ __forceinline__ void operator()(int, float, float) const {}
};

template <int kPerLane = 2, typename Emit, typename RowStats = NoRowStats>
__device__ __forceinline__ void softmax_rows(const float* s, int lds, int sq, int skv,
                                             int rows, int cols, int warp, int warps,
                                             int lane, Emit emit,
                                             RowStats row_stats = RowStats()) {
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
      if (lane == 0) row_stats(i, m, sum);
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

// A structural term added to the scores after the bias, mask(i, j) for
// the block's query row i and key j (the experiments' kernels: xfuse.cu,
// headfold.cu); NoMask adds nothing and leaves the code of the other
// kernels as it was.
struct NoMask {
  static constexpr bool kOn = false;
  __device__ __forceinline__ float operator()(int, int) const { return 0.f; }
};

// S = Q K^T * scale + bias on the CUDA cores, f32 (the f32 bodies).
template <typename Mask = NoMask>
__device__ __forceinline__ void scores_f32(float* ps, int ldp, const float* qs,
                                           const float* ks, int ld, const float* bs,
                                           const Args& a, int tid, int nthreads,
                                           const Mask& mask = Mask()) {
  const int skv = a.skv, d = a.dim;
  for (int idx = tid; idx < a.sq * skv; idx += nthreads) {
    const int i = idx / skv, j = idx % skv;
    const float* qi = qs + i * ld;
    const float* kj = ks + j * ld;
    float acc = 0.f;
#pragma unroll 8
    for (int c = 0; c < d; ++c) acc = fmaf(qi[c], kj[c], acc);
    float x = acc * a.scale + bs[j];
    if (Mask::kOn) x += mask(i, j);
    ps[i * ldp + j] = x;
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

// 4 or 8 bytes global -> shared likewise (the f32 bias, row statistics
// and D of the key-tiled bodies' rings; src and dst aligned to the size).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}

// cp.async groups: commit the copies issued so far; wait until at most n
// of this thread's groups are in flight.  The key-tiled bodies commit once
// per tile and the epilogue's bf16 body once per K or V window (an empty
// group past the last), so cp_async_wait_group<1>() leaves the prefetch
// of the next in flight.
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int n>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// rows_p x dp tile of a strided (rows x d) bf16 source into shared memory,
// zero outside it.  When the source allows 16-byte copies they go out as
// cp.async, all in flight at once: the caller runs cp_async_wait_all()
// before the barrier that publishes the tile.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int ld,
                                          const __nv_bfloat16* src, long long rs,
                                          int rows, int rows_p, int d, int dp, int tid,
                                          int nthreads = kMmaThreads) {
  const bool vec = d % 8 == 0 && rs % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0;
  if (vec) {
    const int chunks = dp / 8;
    for (int i = tid; i < rows_p * chunks; i += nthreads) {
      const int r = i / chunks, c = i % chunks * 8;
      if (r < rows && c < d) {
        cp_async16(dst + r * ld + c, src + r * rs + c);
      } else {
        *reinterpret_cast<uint4*>(dst + r * ld + c) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int i = tid; i < rows_p * dp; i += nthreads) {
      const int r = i / dp, c = i % dp;
      dst[r * ld + c] = (r < rows && c < d) ? src[r * rs + c] : zero;
    }
  }
}

// Key rows k0 .. k0 + kKvTile - 1 of a (batch row, head)'s K and V into
// ks and vs (bf16, row stride ld, zero past skv) and their bias into bs
// (f32, -inf past skv), all by cp.async (a plain load of the bias would
// stall the block for a memory latency): a stage of the long backward's
// rings; the caller commits the group.
__device__ __forceinline__ void load_kv_tile(const Args& a, int b, int h, int k0,
                                             __nv_bfloat16* ks, __nv_bfloat16* vs, float* bs,
                                             int ld, int dp, int tid) {
  const int nk = min(a.skv - k0, kKvTile), d = a.dim;
  load_tile(ks, ld, static_cast<const __nv_bfloat16*>(a.k) + b * a.k_bs + k0 * a.k_rs + h * d,
            a.k_rs, nk, kKvTile, d, dp, tid);
  load_tile(vs, ld, static_cast<const __nv_bfloat16*>(a.v) + b * a.v_bs + k0 * a.v_rs + h * d,
            a.v_rs, nk, kKvTile, d, dp, tid);
  for (int j = tid; j < kKvTile; j += kMmaThreads) {
    if (j < nk) {
      cp_async4(bs + j, a.bias + b * a.skv + k0 + j);
    } else {
      bs[j] = -CUDART_INF_F;
    }
  }
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

// ldmatrix: four 8 x 8 bf16 matrices from shared memory, one warp; lane l
// gives the address of row l % 8 of matrix l / 8 (16-byte aligned), and
// r[m] holds matrix m in the fragment layout of mma.sync (lane l: row l /
// 4, columns 2 (l % 4) and + 1; .trans: the transposed matrix).  With p
// at row m0 + l % 16, column k0 + l / 16 * 8 of a row-major A they are
// its m16n8k16 A fragment; with trans, at row k0 + l % 16, column n0 + l /
// 16 * 8 of a row-major B, the B fragments of columns n0 and n0 + 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// Fragments by ldmatrix from a row-major bf16 tile (row stride ld, a
// multiple of 8 elements), for mma.sync m16n8k16:
// lds_a: the A fragment of the 16 x 16 block at p;
// lds_b_rows: B fragments (b[0], b[1]) and (b[2], b[3]) of the n-tiles
//   n0 and n0 + 8 with B(k, n) = p[n * ld + k], p at (n0, k0): K^T read
//   from key rows;
// lds_b_trans: the same with B(k, n) = p[k * ld + n], p at (k0, n0): a
//   matrix read from its rows (V in P V).
__device__ __forceinline__ void lds_a(uint32_t (&f)[4], const __nv_bfloat16* p, int ld,
                                      int lane) {
  ldsm_x4(f, p + (lane & 15) * ld + (lane >> 4) * 8);
}

__device__ __forceinline__ void lds_b_rows(uint32_t (&b)[4], const __nv_bfloat16* p, int ld,
                                           int lane) {
  ldsm_x4(b, p + ((lane & 7) + (lane >> 4) * 8) * ld + ((lane >> 3) & 1) * 8);
}

__device__ __forceinline__ void lds_b_trans(uint32_t (&b)[4], const __nv_bfloat16* p, int ld,
                                            int lane) {
  ldsm_x4_trans(b, p + (lane & 15) * ld + (lane >> 4) * 8);
}

__device__ __forceinline__ void mma_16x8x16(float (&acc)[4], const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  mma_16x8x16(acc, a[0], a[1], a[2], a[3], b0, b1);
}

// lds_a_trans: the A fragment of the 16 x 16 block A(m, k) = p[k * ld +
// m], p at (k0, m0): a matrix read along its columns (P^T or dS^T from
// the rows of P or dS) by ldmatrix.trans.
__device__ __forceinline__ void lds_a_trans(uint32_t (&f)[4], const __nv_bfloat16* p, int ld,
                                            int lane) {
  ldsm_x4_trans(f, p + ((lane & 7) + ((lane >> 4) & 1) * 8) * ld + ((lane >> 3) & 1) * 8);
}

// acc (16 x DP, n-tiles of 8 columns) += A (16 x 16) Y, Y the 16 rows of
// y (row-major, read along columns by ldmatrix.trans).
__device__ __forceinline__ void accumulate_16xd(float (&acc)[kMaxDim / 8][4],
                                                const uint32_t (&af)[4], const __nv_bfloat16* y,
                                                int ld, int dp, int lane) {
#pragma unroll
  for (int dp2 = 0; dp2 < kMaxDim / 16; ++dp2) {
    if (dp2 * 16 < dp) {
      uint32_t bf[4];
      lds_b_trans(bf, y + dp2 * 16, ld, lane);
      mma_16x8x16(acc[2 * dp2], af, bf[0], bf[1]);
      mma_16x8x16(acc[2 * dp2 + 1], af, bf[2], bf[3]);
    }
  }
}

// The A fragment of a 16 x 16 block held as two accumulator n-tiles, each
// value times `scale`, rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&af)[4], const float (&x)[2][4], float scale) {
  af[0] = pack_f32_pair(x[0][0] * scale, x[0][1] * scale);
  af[1] = pack_f32_pair(x[0][2] * scale, x[0][3] * scale);
  af[2] = pack_f32_pair(x[1][0] * scale, x[1][1] * scale);
  af[3] = pack_f32_pair(x[1][2] * scale, x[1][3] * scale);
}

// ---------------------------------------------------------------------------
// Forward.  out[b, :, h*D:(h+1)*D] = softmax(q_h k_h^T * scale + bias) v_h,
// with P (dropped and scaled when kDrop) rounded to the input dtype before
// the PV product, as the Pallas _fused_kernel / _fused_drop_kernel.  The
// whole-row f32 body of the long stream and of the experiments below; the
// short f32 bodies of #1 / #4 and #3 / #5 after it; the short bf16 body
// (fwd_short_body) after the backward.
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
constexpr int kLongPerLane = kLongWholeKv / 32;

__host__ __device__ inline int tile_rows(int sq) { return sq < kTileQ ? sq : kTileQ; }

// The (batch row, head, query tile) a forward block works on; t is the
// block's Args with q moved to the tile's first row and sq = its rows.
struct FwdTile {
  int b, h, q0;
  Args t;
};

__device__ __forceinline__ FwdTile fwd_tile(const Args& a, size_t elem, unsigned blk) {
  const int tiles = (a.sq + kTileQ - 1) / kTileQ;
  const int bh = blk / tiles;
  FwdTile f;
  f.b = bh / a.heads;
  f.h = bh % a.heads;
  f.q0 = blk % tiles * kTileQ;
  f.t = a;
  f.t.q = static_cast<const unsigned char*>(a.q) + f.q0 * a.q_rs * elem;
  f.t.sq = min(a.sq - f.q0, kTileQ);
  return f;
}

__device__ __forceinline__ FwdTile fwd_tile(const Args& a, size_t elem) {
  return fwd_tile(a, elem, blockIdx.x);
}

// f32: CUDA cores (fmaf), exact to the plain version's summation order
// rather than rounding operands to TF32, one thread per output element.
// Shared memory, f32: Q (sq x ld), K, V (skv x ld), S/P (sq x (skv + 1)),
// bias; ld = dim + 1 so that threads walking K rows hit distinct banks;
// sq = tile_rows(a.sq); with the dropout (the long stream's 4L), the keep
// bits after them (sq x ceil(skv / 16) u32).
size_t fwd_f32_smem_bytes(int sq, int skv, int d, bool drop = false) {
  const size_t ld = d + 1;
  return sizeof(float) * (sq * ld + 2 * skv * ld + sq * (skv + 1) + skv +
                          (drop ? sq * ((skv + 15) / 16) : 0));
}

// The body of block blk (blockIdx.x of a kernel that runs only this
// problem); the experiments' kernels run two problems in one grid, or
// add a structural mask.  kDrop (4L's f32 body up to kLongWholeKv keys):
// the keep bits of the tile's rows drawn into shared memory while Q, K
// and V load, one keep_bits16 call per row and 16 keys, and P dropped and
// scaled after the softmax, whose sum is the undropped one's.
template <int kPerLane, int kThreads, typename Mask = NoMask, bool kDrop = false>
__device__ __forceinline__ void fwd_f32_body(const Args& a, unsigned blk, float* smem,
                                             const Mask& mask = Mask()) {
  const FwdTile f = fwd_tile(a, sizeof(float), blk);
  const int b = f.b, h = f.h, q0 = f.q0;
  const int sq = f.t.sq, skv = a.skv, d = a.dim;
  const int ld = d + 1, ldp = skv + 1;
  float* qs = smem;
  float* ks = qs + tile_rows(a.sq) * ld;
  float* vs = ks + skv * ld;
  float* ps = vs + skv * ld;
  float* bs = ps + tile_rows(a.sq) * ldp;
  uint32_t* km = reinterpret_cast<uint32_t*>(bs + skv);
  const int ngr = (skv + 15) / 16;
  const int tid = threadIdx.x;

  load_rows_f32(qs, ld, static_cast<const float*>(f.t.q) + b * a.q_bs + h * d, a.q_rs, sq, d,
                tid, kThreads);
  load_rows_f32(ks, ld, static_cast<const float*>(a.k) + b * a.k_bs + h * d, a.k_rs, skv, d,
                tid, kThreads);
  load_rows_f32(vs, ld, static_cast<const float*>(a.v) + b * a.v_bs + h * d, a.v_rs, skv, d,
                tid, kThreads);
  for (int j = tid; j < skv; j += kThreads) bs[j] = a.bias[b * skv + j];
  if (kDrop) {
    for (int idx = tid; idx < sq * ngr; idx += kThreads) {
      km[idx] = keep_bits16(a, b, h, q0 + idx / ngr, idx % ngr);
    }
  }
  __syncthreads();

  scores_f32(ps, ldp, qs, ks, ld, bs, f.t, tid, kThreads, mask);
  __syncthreads();

  float* lse = a.lse ? a.lse + 2 * ((static_cast<long long>(b) * a.heads + h) * a.sq + q0) : nullptr;
  softmax_rows<kPerLane>(ps, ldp, sq, skv, sq, skv, tid / 32, kThreads / 32, tid % 32,
                         [&](int i, int j, float p) {
                           if (kDrop) p = keep_bit(km, ngr, i, j) ? p * a.keep_scale : 0.f;
                           ps[i * ldp + j] = p;
                         },
                         [&](int i, float m, float sum) {
                           if (lse) {
                             lse[2 * i] = m;
                             lse[2 * i + 1] = logf(sum);
                           }
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

template <int kPerLane, int kThreads, bool kDrop = false>
__global__ void __launch_bounds__(kThreads) fused_attention_f32(Args a) {
  extern __shared__ float smem[];
  fwd_f32_body<kPerLane, kThreads, NoMask, kDrop>(a, blockIdx.x, smem);
}

// ---------------------------------------------------------------------------
// Short f32 bodies: #1 (and #4 with kDrop), fused_attention_fwd_short_f32,
// and #3 (and #5), fused_attention_bwd_short_f32; Sq, Skv <= 64.
//
// Every product runs on the CUDA cores in f32 (fmaf; no TF32, no tensor
// core), each output one fmaf chain over its reduction index in ascending
// order from 0, and the row softmax is softmax_rows over S in shared
// memory: so every output is bit for bit what the one-thread-per-output
// body these replace computed (checked on the H100 against it, PERF.md
// section 6).  That body read both operands of every fmaf from shared
// memory, which capped an SM at 16 f32 FMAs a clock of its 128 lanes.
// Here each thread owns a 4 x 4 tile of outputs in registers and reads
// its operands as float4 (16-byte) loads, 8 FMAs a load and 16
// independent chains a thread.  A warp's float4 load most likely takes
// four wavefronts, which would cap the products near half the f32 rate;
// 8 x 4 tiles (128 registers, spills, half the warps) were slower at
// every shape on the H100.  The products and their tiles:
//
//   S = Q K^T, dP = G V^T (reduce over the head dim): rows i = rg + RG m,
//     keys j = kg + KG n (m, n < 4; RG, KG = ceil(rows / 4), ceil(keys /
//     4)), key groups fastest, so a warp's float4 reads of K (V) hit
//     consecutive rows;
//   O = P V, dQ = dS K (reduce over keys): rows i = rg + RG m, columns
//     4 cg .. 4 cg + 3, column groups fastest;
//   dV = P_drop^T G, dK = dS^T Q (reduce over query rows): keys 4 jg ..
//     4 jg + 3, columns 4 cg .. 4 cg + 3.
//
// Rows past the problem are clamped to its last row when loaded (their
// outputs are not stored).  Row strides (f32_ld) are multiples of 4 floats
// with an odd count of 16-byte chunks, so the float4 reads of 8
// consecutive rows at one column fall in 8 distinct bank groups.  Q, K, V
// (and G) are staged by cp.async in two groups: the second (V; G and V in
// the backward) lands while the first product runs.  The dropout mask
// (kDrop) is drawn as keep_bits16 (one Philox call per row and 16 keys,
// bit for bit dropout_keep) into shared memory while the tiles are in
// flight.
//
// Forward: one block per (batch row, head), RG x 16 threads (RG x max(KG,
// DG)): the S pass, a barrier, S over Q, the softmax (dropout in its
// emit; one key a lane up to 32 keys, kPerLane), P V, O written once.  Splitting a head's query rows over blocks
// re-reads K and V for each split and measured no faster at any batch
// (PERF.md section 6), so there is no query tiling.
//
// Backward: one block per (batch row, head) in phases over query rows,
// then keys, as the bf16 body: S (into its own space) and dP (held in
// registers across the barrier after which V is dead, then over V); the
// softmax; D = rowsum(dP P) by warps over rows (the first body's code) and
// dV; dS = P (dP - D) by columns, its column sums (dbias, unscaled, in
// row order) and dS scale in place; dQ and dK, each written once.
//
// Per SM at CLIP's 50 x 50 (224 threads a block): the forward 4 blocks
// (64 registers; 41.8 KB of shared memory would allow 5), the backward 3
// (80 registers, 66.0 KB).
// ---------------------------------------------------------------------------

// A row stride of f32 tiles holding n columns: n rounded up to 4, plus 4
// when that is an even number of 16-byte chunks.
__host__ __device__ inline int f32_ld(int n) {
  const int r = (n + 3) / 4 * 4;
  return (r / 4) % 2 ? r : r + 4;
}

// rows x d of a strided f32 source into shared memory (row stride ld, a
// multiple of 4), by cp.async 16 bytes a copy where the source allows
// (not committed), else one plain load at a time.
__device__ __forceinline__ void stage_rows_f32(float* dst, int ld, const float* src,
                                               long long rs, int rows, int d, int tid,
                                               int nthreads) {
  if (d % 4 == 0 && rs % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    const int chunks = d / 4;
    for (int i = tid; i < rows * chunks; i += nthreads) {
      const int r = i / chunks, c = i % chunks * 4;
      cp_async16(dst + r * ld + c, src + r * rs + c);
    }
  } else {
    for (int i = tid; i < rows * d; i += nthreads) {
      const int r = i / d, c = i % d;
      dst[r * ld + c] = src[r * rs + c];
    }
  }
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float f4(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ void zero_tile(float (&acc)[4][4]) {
#pragma unroll
  for (int m = 0; m < 4; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;
}

// acc[m][n] = sum over c < d, in order, of x[xr[m]][c] y[yr[n]][c]: a
// 4 x 4 tile of X Y^T (S, dP), rows of X and Y (row stride ld) in shared
// memory; four terms a step from float4 reads, then the tail of d.
__device__ __forceinline__ void tile_xyt(float (&acc)[4][4], const float* x, const float* y,
                                         int ld, const int (&xr)[4], const int (&yr)[4],
                                         int d) {
  zero_tile(acc);
  const int d4 = d & ~3;
#pragma unroll 1
  for (int c = 0; c < d4; c += 4) {
    float4 xv[4], yv[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) xv[m] = lds4(x + xr[m] * ld + c);
#pragma unroll
    for (int n = 0; n < 4; ++n) yv[n] = lds4(y + yr[n] * ld + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[m][n] = fmaf(f4(xv[m], e), f4(yv[n], e), acc[m][n]);
      }
    }
  }
  for (int c = d4; c < d; ++c) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[m][n] = fmaf(x[xr[m] * ld + c], y[yr[n] * ld + c], acc[m][n]);
    }
  }
}

// acc[m][u] = sum over j < n, in order, of x[xr[m]][j] y[j][c0 + u]: a
// 4 x 4 tile of X Y (O = P V, dQ = dS K), X's rows (stride ldx) read four
// terms a step as float4, Y's rows (stride ldy) at columns c0 .. c0 + 3.
__device__ __forceinline__ void tile_xy(float (&acc)[4][4], const float* x, int ldx,
                                        const int (&xr)[4], const float* y, int ldy, int c0,
                                        int n) {
  zero_tile(acc);
  const int n4 = n & ~3;
#pragma unroll 1
  for (int j = 0; j < n4; j += 4) {
    float4 xv[4], yv[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) xv[m] = lds4(x + xr[m] * ldx + j);
#pragma unroll
    for (int e = 0; e < 4; ++e) yv[e] = lds4(y + (j + e) * ldy + c0);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float xm = f4(xv[m], e);
        acc[m][0] = fmaf(xm, yv[e].x, acc[m][0]);
        acc[m][1] = fmaf(xm, yv[e].y, acc[m][1]);
        acc[m][2] = fmaf(xm, yv[e].z, acc[m][2]);
        acc[m][3] = fmaf(xm, yv[e].w, acc[m][3]);
      }
    }
  }
  for (int j = n4; j < n; ++j) {
    const float4 yv = lds4(y + j * ldy + c0);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float xm = x[xr[m] * ldx + j];
      acc[m][0] = fmaf(xm, yv.x, acc[m][0]);
      acc[m][1] = fmaf(xm, yv.y, acc[m][1]);
      acc[m][2] = fmaf(xm, yv.z, acc[m][2]);
      acc[m][3] = fmaf(xm, yv.w, acc[m][3]);
    }
  }
}

// acc[n][u] = sum over i < rows, in order, of x'[i][j0 + n] y[i][c0 + u]
// with x' = drop(i, x[i][j0 .. j0 + 3]): a 4 x 4 tile of X^T Y (dV = P_drop^T
// G, dK = dS^T Q), both read as float4 along their rows, one row a step.
struct NoDrop {
  __device__ __forceinline__ void operator()(int, float4&) const {}
};

template <typename Drop>
__device__ __forceinline__ void tile_xty(float (&acc)[4][4], const float* x, int ldx, int j0,
                                         const float* y, int ldy, int c0, int rows,
                                         const Drop& drop) {
  zero_tile(acc);
#pragma unroll 4
  for (int i = 0; i < rows; ++i) {
    float4 xv = lds4(x + i * ldx + j0);
    drop(i, xv);
    const float4 yv = lds4(y + i * ldy + c0);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const float xn = f4(xv, n);
      acc[n][0] = fmaf(xn, yv.x, acc[n][0]);
      acc[n][1] = fmaf(xn, yv.y, acc[n][1]);
      acc[n][2] = fmaf(xn, yv.z, acc[n][2]);
      acc[n][3] = fmaf(xn, yv.w, acc[n][3]);
    }
  }
}

// A thread's tile acc[m][u] (row r0 + rstep m, columns c0 .. c0 + 3) into
// global memory (row stride rs): rows < rows, columns < d; one float4
// store a row when d and rs are multiples of 4 and out is 16-byte aligned.
__device__ __forceinline__ void store_tile_f32(float* out, long long rs, const float (&acc)[4][4],
                                               int r0, int rstep, int rows, int c0, int d) {
  const bool vec = d % 4 == 0 && rs % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int r = r0 + rstep * m;
    if (r >= rows) continue;
    float* o = out + r * rs + c0;
    if (vec) {
      *reinterpret_cast<float4*>(o) = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (c0 + u < d) o[u] = acc[m][u];
      }
    }
  }
}

// The keep bits of every query row and key group into km.
__device__ __forceinline__ void draw_keep_bits(const Args& a, int b, int h, uint32_t* km,
                                               int ngr, int tid, int nthreads) {
  for (int idx = tid; idx < a.sq * ngr; idx += nthreads) {
    km[idx] = keep_bits16(a, b, h, idx / ngr, idx % ngr);
  }
}

// Blocks of at most kShortF32Threads (16 x 16 tiles of 4 x 4 cover 64 x
// 64); the blocks per SM that the registers must allow.
constexpr int kShortF32Threads = 256;
constexpr int kFwdF32MinBlocks = 4;  // <= 64 registers a thread
constexpr int kBwdF32MinBlocks = 3;  // <= 80

__host__ __device__ inline int groups4(int n) { return (n + 3) / 4; }

__host__ __device__ inline int round_warps(int n) { return n < 32 ? 32 : (n + 31) / 32 * 32; }

// Shared memory of the short f32 forward, f32 offsets (each a multiple of
// 4): Q (sq x ld), then S / P over it (sq x ldp); K, V (skv x ld); bias
// (skv, rounded to 4); the keep bits (sq x ngr u32).  41.8 KB at 50 x 50,
// 30.0 KB at 36 x 36, 16.6 KB at 20 x 20.
struct FwdF32Layout {
  int ld, ldp, ngr;
  size_t k_off, v_off, b_off, m_off, bytes;
};

__host__ __device__ inline FwdF32Layout fwd_f32_layout(int sq, int skv, int d) {
  FwdF32Layout L;
  L.ld = f32_ld(d);
  L.ldp = f32_ld(skv);
  L.ngr = (skv + 15) / 16;
  L.k_off = static_cast<size_t>(sq) * (L.ld > L.ldp ? L.ld : L.ldp);
  L.v_off = L.k_off + static_cast<size_t>(skv) * L.ld;
  L.b_off = L.v_off + static_cast<size_t>(skv) * L.ld;
  L.m_off = L.b_off + groups4(skv) * 4;
  L.bytes = sizeof(float) * (L.m_off + static_cast<size_t>(sq) * L.ngr);
  return L;
}

inline int fwd_f32_threads(int sq, int skv, int d) {
  const int kg = groups4(skv), dg = groups4(d);
  return round_warps(groups4(sq) * (kg > dg ? kg : dg));
}

template <bool kDrop, int kPerLane>
__global__ void __launch_bounds__(kShortF32Threads, kFwdF32MinBlocks)
    fused_attention_fwd_short_f32(Args a) {
  extern __shared__ __align__(16) float smem_f32[];
  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int sq = a.sq, skv = a.skv, d = a.dim;
  const FwdF32Layout L = fwd_f32_layout(sq, skv, d);
  const int ld = L.ld, ldp = L.ldp;
  float* qs = smem_f32;
  float* ps = smem_f32;  // S / P over Q once the scores are in registers
  float* ks = smem_f32 + L.k_off;
  float* vs = smem_f32 + L.v_off;
  float* bs = smem_f32 + L.b_off;
  uint32_t* km = reinterpret_cast<uint32_t*>(smem_f32 + L.m_off);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int rg_n = groups4(sq), kg_n = groups4(skv), dg_n = groups4(d);

  stage_rows_f32(qs, ld, static_cast<const float*>(a.q) + b * a.q_bs + h * d, a.q_rs, sq, d,
                 tid, nthreads);
  stage_rows_f32(ks, ld, static_cast<const float*>(a.k) + b * a.k_bs + h * d, a.k_rs, skv, d,
                 tid, nthreads);
  for (int j = tid; j < skv; j += nthreads) {
    cp_async4(bs + j, a.bias + static_cast<long long>(b) * skv + j);
  }
  cp_async_commit();
  stage_rows_f32(vs, ld, static_cast<const float*>(a.v) + b * a.v_bs + h * d, a.v_rs, skv, d,
                 tid, nthreads);
  cp_async_commit();
  if (kDrop) draw_keep_bits(a, b, h, km, L.ngr, tid, nthreads);
  cp_async_wait_group<1>();
  __syncthreads();  // Q, K and the bias

  // S = Q K^T, this thread's rows rg + RG m and keys kg + KG n.
  float acc[4][4];
  const bool s_tile = tid < rg_n * kg_n;
  const int rg = tid / kg_n, kg = tid % kg_n;
  if (s_tile) {
    int xr[4], yr[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      xr[m] = min(rg + rg_n * m, sq - 1);
      yr[m] = min(kg + kg_n * m, skv - 1);
    }
    tile_xyt(acc, qs, ks, ld, xr, yr, d);
  }
  cp_async_wait_all();
  __syncthreads();  // every thread is past Q; V has landed
  if (s_tile) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int i = rg + rg_n * m, j = kg + kg_n * n;
        if (i < sq && j < skv) {
          float x = acc[m][n] * a.scale + bs[j];
          ps[i * ldp + j] = x;
        }
      }
    }
  }
  __syncthreads();
  softmax_rows<kPerLane>(ps, ldp, sq, skv, sq, skv, tid / 32, nthreads / 32, tid % 32,
                         [&](int i, int j, float p) {
                           if (kDrop) p = keep_bit(km, L.ngr, i, j) ? p * a.keep_scale : 0.f;
                           ps[i * ldp + j] = p;
                         });
  __syncthreads();

  // O = P V, rows rg + RG m, columns 4 cg ..
  if (tid < rg_n * dg_n) {
    const int org = tid / dg_n, cg = tid % dg_n;
    int xr[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) xr[m] = min(org + rg_n * m, sq - 1);
    tile_xy(acc, ps, ldp, xr, vs, ld, 4 * cg, skv);
    const long long out_rs = static_cast<long long>(a.heads) * d;
    store_tile_f32(static_cast<float*>(a.out) + static_cast<long long>(b) * sq * out_rs + h * d,
                   out_rs, acc, org, rg_n, sq, 4 * cg, d);
  }
}

// ---------------------------------------------------------------------------
// Backward, as the Pallas _fused_bwd_kernel / _fused_drop_bwd_kernel:
// recompute P; dP = g V^T and dV = P_drop^T g; with dropout dP is masked
// and scaled; dS = P (dP - rowsum(dP P)); dbias = sum over heads and
// query rows of dS; dS * scale rounded to the input dtype; dQ = dS K,
// dK = dS^T Q.  The f32 body (fused_attention_bwd_short_f32) runs every
// product on the CUDA cores; the bf16 body (below it) every product on the
// tensor cores, in one pass.
// ---------------------------------------------------------------------------

// Shared memory of the short f32 backward, f32 offsets (each a multiple
// of 4): Q, G (sq x ld); K (skv x ld); V, then dP / dS over it (skv x ld
// or sq x ldp, the larger); P (sq x ldp); bias (skv), D (sq), rounded to
// 4; the keep bits (sq x ngr u32).  66.0 KB at 50 x 50, 45.1 KB at 36 x
// 36, 23.7 KB at 20 x 20.
struct BwdF32Layout {
  int ld, ldp, ngr;
  size_t g_off, k_off, v_off, p_off, b_off, r_off, m_off, bytes;
};

__host__ __device__ inline BwdF32Layout bwd_f32_layout(int sq, int skv, int d) {
  BwdF32Layout L;
  L.ld = f32_ld(d);
  L.ldp = f32_ld(skv);
  L.ngr = (skv + 15) / 16;
  const size_t v = static_cast<size_t>(skv) * L.ld, dp = static_cast<size_t>(sq) * L.ldp;
  L.g_off = static_cast<size_t>(sq) * L.ld;
  L.k_off = 2 * L.g_off;
  L.v_off = L.k_off + static_cast<size_t>(skv) * L.ld;
  L.p_off = L.v_off + (v > dp ? v : dp);
  L.b_off = L.p_off + dp;
  L.r_off = L.b_off + groups4(skv) * 4;
  L.m_off = L.r_off + groups4(sq) * 4;
  L.bytes = sizeof(float) * (L.m_off + static_cast<size_t>(sq) * L.ngr);
  return L;
}

inline int bwd_f32_threads(int sq, int skv, int d) {
  const int rg = groups4(sq), kg = groups4(skv), dg = groups4(d);
  int n = rg * kg;
  if (rg * dg > n) n = rg * dg;
  if (kg * dg > n) n = kg * dg;
  return round_warps(n);
}

template <bool kDrop, int kPerLane>
__global__ void __launch_bounds__(kShortF32Threads, kBwdF32MinBlocks)
    fused_attention_bwd_short_f32(Args a) {
  extern __shared__ __align__(16) float smem_f32[];
  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int sq = a.sq, skv = a.skv, d = a.dim;
  const BwdF32Layout L = bwd_f32_layout(sq, skv, d);
  const int ld = L.ld, ldp = L.ldp;
  const long long row = static_cast<long long>(a.heads) * d;  // g, dq, dk, dv row stride
  float* qs = smem_f32;
  float* gs = smem_f32 + L.g_off;
  float* ks = smem_f32 + L.k_off;
  float* vs = smem_f32 + L.v_off;
  float* dps = vs;  // dP, then dS scale, once V is dead
  float* ps = smem_f32 + L.p_off;
  float* bs = smem_f32 + L.b_off;
  float* rs = smem_f32 + L.r_off;
  uint32_t* km = reinterpret_cast<uint32_t*>(smem_f32 + L.m_off);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid / 32, warps = nthreads / 32, lane = tid % 32;
  const int rg_n = groups4(sq), kg_n = groups4(skv), dg_n = groups4(d);

  stage_rows_f32(qs, ld, static_cast<const float*>(a.q) + b * a.q_bs + h * d, a.q_rs, sq, d,
                 tid, nthreads);
  stage_rows_f32(ks, ld, static_cast<const float*>(a.k) + b * a.k_bs + h * d, a.k_rs, skv, d,
                 tid, nthreads);
  for (int j = tid; j < skv; j += nthreads) {
    cp_async4(bs + j, a.bias + static_cast<long long>(b) * skv + j);
  }
  cp_async_commit();
  stage_rows_f32(gs, ld, static_cast<const float*>(a.g) + b * sq * row + h * d, row, sq, d, tid,
                 nthreads);
  stage_rows_f32(vs, ld, static_cast<const float*>(a.v) + b * a.v_bs + h * d, a.v_rs, skv, d,
                 tid, nthreads);
  cp_async_commit();
  if (kDrop) draw_keep_bits(a, b, h, km, L.ngr, tid, nthreads);
  cp_async_wait_group<1>();
  __syncthreads();  // Q, K and the bias

  // Phase 1, query rows.  S = Q K^T * scale + bias into P's space, then
  // dP = G V^T (masked and scaled with kDrop) in registers.
  float acc[4][4];
  const bool s_tile = tid < rg_n * kg_n;
  const int rg = tid / kg_n, kg = tid % kg_n;
  int xr[4], yr[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    xr[m] = min(rg + rg_n * m, sq - 1);
    yr[m] = min(kg + kg_n * m, skv - 1);
  }
  if (s_tile) {
    tile_xyt(acc, qs, ks, ld, xr, yr, d);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int i = rg + rg_n * m, j = kg + kg_n * n;
        if (i < sq && j < skv) {
          float x = acc[m][n] * a.scale + bs[j];
          ps[i * ldp + j] = x;
        }
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();  // G and V; S
  if (s_tile) tile_xyt(acc, gs, vs, ld, xr, yr, d);
  __syncthreads();  // every thread is past V
  if (s_tile) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int i = rg + rg_n * m, j = kg + kg_n * n;
        if (i < sq && j < skv) {
          float x = acc[m][n];
          if (kDrop) x = keep_bit(km, L.ngr, i, j) ? x * a.keep_scale : 0.f;
          dps[i * ldp + j] = x;
        }
      }
    }
  }
  softmax_rows<kPerLane>(ps, ldp, sq, skv, sq, skv, warp, warps, lane,
                         [&](int i, int j, float p) { ps[i * ldp + j] = p; });
  __syncthreads();  // P and dP

  // D = rowsum(dP P) by warps over rows (the first body's code); dV =
  // P_drop^T G, keys 4 jg ..
  for (int i = warp; i < sq; i += warps) {
    const float* pi = ps + i * ldp;
    const float* dpi = dps + i * ldp;
    float s = (lane < skv ? dpi[lane] * pi[lane] : 0.f) +
              (lane + 32 < skv ? dpi[lane + 32] * pi[lane + 32] : 0.f);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) rs[i] = s;
  }
  const long long kv0 = static_cast<long long>(b) * skv * row + h * d;
  const bool kv_tile = tid < kg_n * dg_n;
  const int jg = tid / dg_n, cg = tid % dg_n;
  if (kv_tile) {
    if (kDrop) {
      const int grp = (4 * jg) >> 4, sh = (4 * jg) & 15;
      tile_xty(acc, ps, ldp, 4 * jg, gs, ld, 4 * cg, sq, [&](int i, float4& p) {
        const uint32_t bits = km[i * L.ngr + grp] >> sh;
        p.x = bits & 1u ? p.x * a.keep_scale : 0.f;
        p.y = bits & 2u ? p.y * a.keep_scale : 0.f;
        p.z = bits & 4u ? p.z * a.keep_scale : 0.f;
        p.w = bits & 8u ? p.w * a.keep_scale : 0.f;
      });
    } else {
      tile_xty(acc, ps, ldp, 4 * jg, gs, ld, 4 * cg, sq, NoDrop());
    }
    store_tile_f32(static_cast<float*>(a.dv) + kv0, row, acc, 4 * jg, 1, skv, 4 * cg, d);
  }
  __syncthreads();  // D

  // dS = P (dP - D) down each key's column: its sum over the rows in order
  // (the head's dbias partial), then dS scale in place.
  float* part = a.dbias_part + (static_cast<long long>(b) * a.heads + h) * skv;
  for (int j = tid; j < skv; j += nthreads) {
    float s = 0.f;
    for (int i = 0; i < sq; ++i) {
      const float v = ps[i * ldp + j] * (dps[i * ldp + j] - rs[i]);
      s += v;
      dps[i * ldp + j] = v * a.scale;
    }
    part[j] = s;
  }
  __syncthreads();  // dS scale

  // Phase 2: dQ = (dS scale) K, rows rg + RG m; dK = (dS scale)^T Q, keys
  // 4 jg ..
  if (tid < rg_n * dg_n) {
    const int qrg = tid / dg_n, qcg = tid % dg_n;
    int qr[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) qr[m] = min(qrg + rg_n * m, sq - 1);
    tile_xy(acc, dps, ldp, qr, ks, ld, 4 * qcg, skv);
    store_tile_f32(static_cast<float*>(a.dq) + static_cast<long long>(b) * sq * row + h * d, row,
                   acc, qrg, rg_n, sq, 4 * qcg, d);
  }
  if (kv_tile) {
    tile_xty(acc, dps, ldp, 4 * jg, qs, ld, 4 * cg, sq, NoDrop());
    store_tile_f32(static_cast<float*>(a.dk) + kv0, row, acc, 4 * jg, 1, skv, 4 * cg, d);
  }
}

// bf16 body (the short backward, #3 and, with kDrop, #5): one pass, every
// product on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate), the score tiles in registers.  At Sq, Skv <= 64 one block
// sees every query row and every key of its (row, head), so S, P, dP and
// dS are formed once, with no recomputation and no row statistics: five
// products per score, the count the bound takes.  A block takes
// kShortBwdHeads heads of one batch row in turn (the bias is loaded
// once); the next head's Q, g, K and V are staged by cp.async into the
// second of two stages while the current head computes.  One warp per 16
// query rows or keys (2-4 warps), and per head
//
// - phase 1, query rows: warp w the 16 rows 16 w .. 16 w + 15, with no
//   barrier inside the phase: S = Q K^T and dP = g V^T into accumulators
//   (kNT = SKP / 8 n-tiles of 8 keys), the row softmax by quad shuffles
//   (P in f32), dP masked and scaled (kDrop), D = rowsum(dP P), dS = P (dP
//   - D), dQ = round(dS scale) K with dS taken from the accumulators
//   straight into A fragments; dQ written once, the warp's column sums of
//   dS (f32) to shared memory;
// - then, behind a barrier (K and V are dead), P_drop and round(dS scale)
//   in bf16 into the space of K and V;
// - phase 2, keys: warp w the 16 keys 16 w .. 16 w + 15: dV = P_drop^T g
//   and dK = dS^T Q, A fragments by ldmatrix.trans, summed over every
//   query row in order; dK and dV written once; the dbias column sums
//   added over the warps in warp order and over the heads in head order.
//
// g and V are bf16, so dP's products are exact in f32: dP is the plain
// version's up to summation order.  P enters dV rounded to bf16, where
// the TPU kernel keeps it in f32 (as in fused_attention_long_bwd.cu): dV
// moves by about one bf16 step of its terms, inside the bf16 bound.  The
// dropout mask: one Philox call per (row, 16 keys), its 16 keep bits in
// shared memory, drawn while the head's tiles are in flight.  Shared
// memory (27.6 KB a stage at 36 x 36, 56.5 KB in all), bf16 unless
// noted, row strides (padded width + 8) elements (ldmatrix rows in
// distinct banks, 16-byte aligned), per stage:
//   Qs, Gs (SQP x DP), Ks, Vs (SKP x DP), zero-padded to multiples of 16
//   (the keys to at least 32, so that kNT = SKP / 8 is 4, 6 or 8);
//   after phase 1 P_drop and dS scale (SQP x SKP each) over Ks and Vs;
// then bias f32 (SKP), the warps' dS column sums f32 (SQP / 16 x SKP) and
// the keep bits u32 (Sq x SKP / 16).
struct ShortBwdLayout {
  int sqp, skp, dp, ld, ldp;  // padded extents; row strides of Q/G/K/V and of P/dS
  size_t g_off, k_off, v_off, ds_off, stage;  // within a stage (P at k_off)
  size_t b_off, c_off, m_off, bytes;
};

__host__ __device__ inline ShortBwdLayout short_bwd_layout(int sq, int skv, int d) {
  ShortBwdLayout L;
  L.sqp = (sq + 15) / 16 * 16;
  L.skp = skv > 16 ? (skv + 15) / 16 * 16 : 32;  // kNT = SKP / 8 is 4, 6 or 8
  L.dp = (d + 15) / 16 * 16;
  L.ld = L.dp + 8;
  L.ldp = L.skp + 8;
  const size_t bf = sizeof(__nv_bfloat16), f = sizeof(float);
  const size_t kv = 2 * bf * L.skp * L.ld, pds = 2 * bf * L.sqp * L.ldp;
  L.g_off = bf * L.sqp * L.ld;  // every offset a multiple of 16 bytes
  L.k_off = 2 * L.g_off;
  L.v_off = L.k_off + bf * L.skp * L.ld;
  L.ds_off = L.k_off + bf * L.sqp * L.ldp;
  L.stage = L.k_off + (kv > pds ? kv : pds);
  L.b_off = 2 * L.stage;
  L.c_off = L.b_off + f * L.skp;
  L.m_off = L.c_off + f * (L.sqp / 16) * L.skp;
  L.bytes = L.m_off + sizeof(uint32_t) * sq * (L.skp / 16);
  return L;
}

// Head h's Q, g, K and V into the stage at st, by cp.async (not committed).
__device__ __forceinline__ void stage_head(const Args& a, int b, int h, unsigned char* st,
                                           const ShortBwdLayout& L, int tid, int nthreads) {
  const int d = a.dim;
  const long long row = static_cast<long long>(a.heads) * d;
  load_tile(reinterpret_cast<__nv_bfloat16*>(st), L.ld,
            static_cast<const __nv_bfloat16*>(a.q) + b * a.q_bs + h * d, a.q_rs, a.sq, L.sqp, d,
            L.dp, tid, nthreads);
  load_tile(reinterpret_cast<__nv_bfloat16*>(st + L.g_off), L.ld,
            static_cast<const __nv_bfloat16*>(a.g) + static_cast<long long>(b) * a.sq * row + h * d,
            row, a.sq, L.sqp, d, L.dp, tid, nthreads);
  load_tile(reinterpret_cast<__nv_bfloat16*>(st + L.k_off), L.ld,
            static_cast<const __nv_bfloat16*>(a.k) + b * a.k_bs + h * d, a.k_rs, a.skv, L.skp, d,
            L.dp, tid, nthreads);
  load_tile(reinterpret_cast<__nv_bfloat16*>(st + L.v_off), L.ld,
            static_cast<const __nv_bfloat16*>(a.v) + b * a.v_bs + h * d, a.v_rs, a.skv, L.skp, d,
            L.dp, tid, nthreads);
}

// Rows r0 .. r0 + 15 of a warp's 16 x DP accumulators (columns < d, rows
// < rows) into out (row stride rs), in bf16; pairs of columns as one
// 4-byte store when d is even.
__device__ __forceinline__ void store_16xd(__nv_bfloat16* out, long long rs,
                                           const float (&acc)[kMaxDim / 8][4], int r0, int rows,
                                           int d, int lane) {
  const int g = lane >> 2, t = (lane & 3) * 2;
#pragma unroll
  for (int dt = 0; dt < kMaxDim / 8; ++dt) {
    const int c = dt * 8 + t;
    if (c >= d) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = r0 + g + 8 * half;
      if (i >= rows) continue;
      __nv_bfloat16* o = out + i * rs + c;
      if ((d & 1) == 0) {
        *reinterpret_cast<uint32_t*>(o) = pack_f32_pair(acc[dt][2 * half], acc[dt][2 * half + 1]);
      } else {
        o[0] = __float2bfloat16(acc[dt][2 * half]);
        if (c + 1 < d) o[1] = __float2bfloat16(acc[dt][2 * half + 1]);
      }
    }
  }
}

// Heads per block, and blocks of kMmaThreads per SM that the registers
// must allow (128 registers a thread; 0-36 bytes spill, at most 4 at
// 32 keys).  Measured on the H100 against one head per block and other caps
// (PERF.md section 6): 1, 3, 4 and 12 heads per block, no cap (156-202
// registers) and caps of 3, 5 and 6 blocks (168, 96 and 80 registers).
constexpr int kShortBwdHeads = 2;
constexpr int kShortBwdMinBlocks = 4;

template <bool kDrop, int kNT>
__global__ void __launch_bounds__(kMmaThreads, kShortBwdMinBlocks)
    fused_attention_bwd_short_bf16(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int sq = a.sq, skv = a.skv, d = a.dim;
  const ShortBwdLayout L = short_bwd_layout(sq, skv, d);
  const int groups = (a.heads + kShortBwdHeads - 1) / kShortBwdHeads;
  const int b = blockIdx.x / groups, grp = blockIdx.x % groups;
  const int h0 = grp * kShortBwdHeads, nh = min(kShortBwdHeads, a.heads - h0);
  const int tid = threadIdx.x, nthreads = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = (lane & 3) * 2;
  const int ngr = L.skp >> 4;  // 16-key groups of the keep bits (past skv unused)
  const long long row = static_cast<long long>(a.heads) * d;  // g, dq, dk, dv row stride
  float* bs = reinterpret_cast<float*>(smem_raw + L.b_off);
  float* cs = reinterpret_cast<float*>(smem_raw + L.c_off);
  uint32_t* km = reinterpret_cast<uint32_t*>(smem_raw + L.m_off);

  for (int j = tid; j < skv; j += nthreads) {
    cp_async4(bs + j, a.bias + static_cast<long long>(b) * skv + j);
  }
  stage_head(a, b, h0, smem_raw, L, tid, nthreads);
  cp_async_commit();
  float db = 0.f;  // thread j < skv: key j's dbias over the block's heads

  for (int hi = 0; hi < nh; ++hi) {
    const int h = h0 + hi;
    unsigned char* st = smem_raw + (hi & 1) * L.stage;
    if (kDrop) {
      for (int idx = tid; idx < sq * ngr; idx += nthreads) {
        km[idx] = keep_bits16(a, b, h, idx / ngr, idx % ngr);
      }
    }
    cp_async_wait_all();
    __syncthreads();  // head hi's tiles and keep bits; every warp is past head hi - 1
    if (hi + 1 < nh) {
      stage_head(a, b, h + 1, smem_raw + ((hi + 1) & 1) * L.stage, L, tid, nthreads);
      cp_async_commit();
    }
    const __nv_bfloat16* qs = reinterpret_cast<const __nv_bfloat16*>(st);
    const __nv_bfloat16* gs = reinterpret_cast<const __nv_bfloat16*>(st + L.g_off);
    const __nv_bfloat16* ks = reinterpret_cast<const __nv_bfloat16*>(st + L.k_off);
    const __nv_bfloat16* vs = reinterpret_cast<const __nv_bfloat16*>(st + L.v_off);

    // Phase 1.  A lane holds rows r0 + g (e < 2) and r0 + g + 8 (e >= 2),
    // keys 8 n + t + (e & 1).  Rows past sq get P = 0, so their dS, P_drop
    // and column sums are 0.
    const int r0 = warp * 16;
    const bool rows_active = r0 < sq;
    uint32_t pa[kNT / 2][4], sa[kNT / 2][4];  // P_drop and round(dS scale), A fragments of 16 keys
    if (rows_active) {
      float s[kNT][4], dp[kNT][4];
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < kMaxDim / 16; ++kk) {
        if (kk * 16 < L.dp) {
          uint32_t qa[4], ga[4];
          lds_a(qa, qs + r0 * L.ld + kk * 16, L.ld, lane);
          lds_a(ga, gs + r0 * L.ld + kk * 16, L.ld, lane);
#pragma unroll
          for (int np = 0; np < kNT / 2; ++np) {
            uint32_t kb[4], vb[4];
            lds_b_rows(kb, ks + np * 16 * L.ld + kk * 16, L.ld, lane);
            lds_b_rows(vb, vs + np * 16 * L.ld + kk * 16, L.ld, lane);
            mma_16x8x16(s[2 * np], qa, kb[0], kb[1]);
            mma_16x8x16(s[2 * np + 1], qa, kb[2], kb[3]);
            mma_16x8x16(dp[2 * np], ga, vb[0], vb[1]);
            mma_16x8x16(dp[2 * np + 1], ga, vb[2], vb[3]);
          }
        }
      }
      // The row softmax: scale, bias, max and sum over the quad's lanes.
      float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = n * 8 + t + (e & 1);
          const float x = j < skv ? s[n][e] * a.scale + bs[j] : -CUDART_INF_F;
          s[n][e] = x;
          if (e < 2) m0 = fmaxf(m0, x); else m1 = fmaxf(m1, x);
        }
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
      }
      float l0 = 0.f, l1 = 0.f;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = __expf(s[n][e] - (e < 2 ? m0 : m1));  // 0 past skv
          s[n][e] = p;
          if (e < 2) l0 += p; else l1 += p;
        }
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      const float inv0 = r0 + g < sq ? 1.f / l0 : 0.f, inv1 = r0 + g + 8 < sq ? 1.f / l1 : 0.f;
      // P; dP masked and scaled; P_drop into A fragments; D.
      float dd0 = 0.f, dd1 = 0.f;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        uint32_t bits0 = ~0u, bits1 = ~0u;
        if (kDrop) {
          bits0 = r0 + g < sq ? km[(r0 + g) * ngr + (n >> 1)] : 0u;
          bits1 = r0 + g + 8 < sq ? km[(r0 + g + 8) * ngr + (n >> 1)] : 0u;
        }
        float pd[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = s[n][e] * (e < 2 ? inv0 : inv1);
          s[n][e] = p;
          pd[e] = p;
          if (kDrop) {
            const bool keep = ((e < 2 ? bits0 : bits1) >> ((n & 1) * 8 + t + (e & 1))) & 1u;
            dp[n][e] = keep ? dp[n][e] * a.keep_scale : 0.f;
            pd[e] = keep ? p * a.keep_scale : 0.f;
          }
          if (e < 2) dd0 += p * dp[n][e]; else dd1 += p * dp[n][e];
        }
        pa[n >> 1][(n & 1) * 2] = pack_f32_pair(pd[0], pd[1]);
        pa[n >> 1][(n & 1) * 2 + 1] = pack_f32_pair(pd[2], pd[3]);
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        dd0 += __shfl_xor_sync(0xffffffffu, dd0, off);
        dd1 += __shfl_xor_sync(0xffffffffu, dd1, off);
      }
      // dS = P (dP - D): round(dS scale) into A fragments, the column sums
      // of dS over the warp's 16 rows (lanes of one t, by shuffles).
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[n][e] = s[n][e] * (dp[n][e] - (e < 2 ? dd0 : dd1));
        sa[n >> 1][(n & 1) * 2] = pack_f32_pair(dp[n][0] * a.scale, dp[n][1] * a.scale);
        sa[n >> 1][(n & 1) * 2 + 1] = pack_f32_pair(dp[n][2] * a.scale, dp[n][3] * a.scale);
        float c0 = dp[n][0] + dp[n][2], c1 = dp[n][1] + dp[n][3];
#pragma unroll
        for (int off = 4; off <= 16; off <<= 1) {
          c0 += __shfl_xor_sync(0xffffffffu, c0, off);
          c1 += __shfl_xor_sync(0xffffffffu, c1, off);
        }
        if (g == 0) {
          cs[warp * L.skp + n * 8 + t] = c0;
          cs[warp * L.skp + n * 8 + t + 1] = c1;
        }
      }
      // dQ = round(dS scale) K, written once.
      float dq[kMaxDim / 8][4];
#pragma unroll
      for (int dt = 0; dt < kMaxDim / 8; ++dt) dq[dt][0] = dq[dt][1] = dq[dt][2] = dq[dt][3] = 0.f;
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        accumulate_16xd(dq, sa[np], ks + np * 16 * L.ld, L.ld, L.dp, lane);
      }
      store_16xd(static_cast<__nv_bfloat16*>(a.dq) + static_cast<long long>(b) * sq * row + h * d,
                 row, dq, r0, sq, d, lane);
    }
    __syncthreads();  // every warp is done with K and V

    __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(st + L.k_off);
    __nv_bfloat16* dss = reinterpret_cast<__nv_bfloat16*>(st + L.ds_off);
    if (rows_active) {
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
#pragma unroll
        for (int f = 0; f < 4; ++f) {  // fragment register f: row g + 8 (f & 1), keys + 8 (f >> 1)
          const int off = (r0 + g + 8 * (f & 1)) * L.ldp + np * 16 + 8 * (f >> 1) + t;
          *reinterpret_cast<uint32_t*>(ps + off) = pa[np][f];
          *reinterpret_cast<uint32_t*>(dss + off) = sa[np][f];
        }
      }
    }
    __syncthreads();  // P_drop, dS and the column sums

    // Phase 2: dV = P_drop^T g and dK = dS^T Q for keys j0 .. j0 + 15.
    const int j0 = warp * 16;
    if (j0 < skv) {
      float dk[kMaxDim / 8][4], dv[kMaxDim / 8][4];
#pragma unroll
      for (int dt = 0; dt < kMaxDim / 8; ++dt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.f;
      }
#pragma unroll
      for (int kq = 0; kq < kMaxSeq / 16; ++kq) {
        if (kq * 16 < L.sqp) {
          uint32_t pf[4], sf[4];
          lds_a_trans(pf, ps + kq * 16 * L.ldp + j0, L.ldp, lane);
          lds_a_trans(sf, dss + kq * 16 * L.ldp + j0, L.ldp, lane);
          accumulate_16xd(dv, pf, gs + kq * 16 * L.ld, L.ld, L.dp, lane);
          accumulate_16xd(dk, sf, qs + kq * 16 * L.ld, L.ld, L.dp, lane);
        }
      }
      const long long kv0 = static_cast<long long>(b) * skv * row + h * d;
      store_16xd(static_cast<__nv_bfloat16*>(a.dk) + kv0, row, dk, j0, skv, d, lane);
      store_16xd(static_cast<__nv_bfloat16*>(a.dv) + kv0, row, dv, j0, skv, d, lane);
    }
    if (tid < skv) {
      for (int w = 0; w < L.sqp / 16; ++w) db += cs[w * L.skp + tid];
    }
  }
  if (tid < skv) a.dbias_part[(static_cast<long long>(b) * groups + grp) * skv + tid] = db;
}

// dbias[b, j] = sum over heads (or head groups), in order, of the
// partials: deterministic, no atomics.
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
// Short bf16 forward (#1, and #4 with kDrop; xfuse.cu's dual and cat
// kernels run the same body): Sq, Skv <= 64, one pass in registers.
//
// A warp owns a 16-row query strip of one head and keeps its whole row of
// scores in accumulators: S = Q K^T on the tensor cores (mma.sync
// m16n8k16, Q's A fragments and K's B fragments by ldmatrix) into kNT =
// SKP / 8 n-tiles of 8 keys; scale, bias (and the Mask term) added there;
// the row max and sum by quad shuffles (a row's keys lie on the four
// lanes of a quad); P = e / sum (__expf, one reciprocal per row), dropped
// and scaled when kDrop, rounded to bf16 straight into the A fragments of
// O = P V (V's B fragments by ldmatrix.trans); O written once.  No S or P
// in shared memory and no barrier but the one that publishes the tiles.
//
// One block per (batch row, head), one warp per 16 query rows (2-4
// warps).  The dropout mask (kDrop) stays in registers: a quad holds two
// rows, and the 2 x SKP / 16 Philox calls of its (row, 16 keys) are split
// over its lanes, drawn while the tiles are in flight, and passed round
// by shuffles (keep_nibbles).  Shared memory, bf16, row stride DP + 8
// elements (ldmatrix rows in distinct banks, 16-byte aligned): Qs (SQP x
// DP), Ks and Vs (SKP x DP), zero-padded to multiples of 16 (keys to at
// least 32, so that kNT is 4, 6 or 8); then the bias, f32 (SKP): 20.7 KB
// at 36 x 36.
// ---------------------------------------------------------------------------

// Blocks of kFwdMaxThreads per SM that the registers must allow: 80
// registers a thread (uncapped 78-103).  Measured on the H100 against no
// cap and 8 blocks, and against 2 and 4 heads per block, side by side or
// in turn with the next head's tiles in flight (PERF.md section 6, the
// forward's variant table): one head per block was the fastest at batch
// 256 and 64, and this cap gained 0-6% at 256 and tied at 64.
constexpr int kFwdMaxThreads = kMaxSeq / 16 * 32;
constexpr int kFwdMinBlocks = 6;

struct FwdShortLayout {
  int sqp, skp, dp, ld;  // padded extents; the tiles' row stride
  size_t k_off, v_off, b_off, bytes;
};

__host__ __device__ inline FwdShortLayout fwd_short_layout(int sq, int skv, int d) {
  FwdShortLayout L;
  L.sqp = (sq + 15) / 16 * 16;
  L.skp = skv > 16 ? (skv + 15) / 16 * 16 : 32;
  L.dp = (d + 15) / 16 * 16;
  L.ld = L.dp + 8;
  const size_t bf = sizeof(__nv_bfloat16);
  L.k_off = bf * L.sqp * L.ld;  // every offset a multiple of 16 bytes
  L.v_off = L.k_off + bf * L.skp * L.ld;
  L.b_off = L.v_off + bf * L.skp * L.ld;
  L.bytes = L.b_off + sizeof(float) * L.skp;
  return L;
}

// kNT for skv keys; the threads of a block for sq query rows.
inline int fwd_short_nt(int skv) { return fwd_short_layout(1, skv, 16).skp / 8; }
inline int fwd_short_threads(int sq) { return (sq + 15) / 16 * 32; }

// The keep bits of a lane's scores, rows i and i + 8 (i = r0 + lane / 4)
// of head h: the quad draws keep_bits16 for (row i + 8 hf, keys 16 c ..)
// as call k = hf kG + c, lane l of the quad the calls l, l + 4, and
// passes them round by shuffles.  Nibble k keeps the lane's keys 16 c + t,
// + 1, + 8, + 9 (t = 2 (lane % 4)): bit (n & 1) 2 + (e & 1) of nibble
// (e / 2) kG + n / 2 keeps accumulator element e of n-tile n.
template <int kG>
__device__ __forceinline__ uint32_t keep_nibbles(const Args& a, int b, int h, int i, int lane) {
  constexpr int kCalls = 2 * kG, kMine = (kCalls + 3) / 4;
  const int ql = lane & 3, t = ql * 2;
  uint32_t mine[kMine];
#pragma unroll
  for (int s = 0; s < kMine; ++s) {
    const int k = ql + 4 * s;
    mine[s] = k < kCalls ? keep_bits16(a, b, h, i + 8 * (k / kG), k % kG) : 0u;
  }
  uint32_t nib = 0;
#pragma unroll
  for (int k = 0; k < kCalls; ++k) {
    const uint32_t w = __shfl_sync(0xffffffffu, mine[k >> 2], (lane & ~3) | (k & 3));
    nib |= (((w >> t) & 3u) | (((w >> (8 + t)) & 3u) << 2)) << (4 * k);
  }
  return nib;
}

// The body of block blk (blockIdx.x of a kernel that runs only this
// problem; xfuse.cu's dual kernel runs two problems in one grid, at the
// larger problem's block size, so warps past this problem's strips idle).
template <bool kDrop, int kNT, typename Mask = NoMask>
__device__ __forceinline__ void fwd_short_body(const Args& a, unsigned blk, unsigned char* smem,
                                               const Mask& mask = Mask()) {
  constexpr int kG = kNT / 2;  // 16-key groups: the k-steps of P V
  const int sq = a.sq, skv = a.skv, d = a.dim;
  const FwdShortLayout L = fwd_short_layout(sq, skv, d);
  const int b = blk / a.heads, h = blk % a.heads;
  const int tid = threadIdx.x, nthreads = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = warp * 16, g = lane >> 2, t = (lane & 3) * 2;
  const bool active = r0 < L.sqp;  // warp-uniform
  const long long row = static_cast<long long>(a.heads) * d;  // the output's row stride
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + L.k_off);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + L.v_off);
  float* bs = reinterpret_cast<float*>(smem + L.b_off);

  for (int j = tid; j < skv; j += nthreads) {
    cp_async4(bs + j, a.bias + static_cast<long long>(b) * skv + j);
  }
  load_tile(qs, L.ld, static_cast<const __nv_bfloat16*>(a.q) + b * a.q_bs + h * d, a.q_rs, sq,
            L.sqp, d, L.dp, tid, nthreads);
  load_tile(ks, L.ld, static_cast<const __nv_bfloat16*>(a.k) + b * a.k_bs + h * d, a.k_rs, skv,
            L.skp, d, L.dp, tid, nthreads);
  load_tile(vs, L.ld, static_cast<const __nv_bfloat16*>(a.v) + b * a.v_bs + h * d, a.v_rs, skv,
            L.skp, d, L.dp, tid, nthreads);
  uint32_t keep = 0;
  if (kDrop && active) keep = keep_nibbles<kG>(a, b, h, r0 + g, lane);
  cp_async_wait_all();
  __syncthreads();  // the tiles and the bias
  if (!active) return;

  // S: a lane holds rows r0 + g (e < 2) and r0 + g + 8 (e >= 2), keys
  // 8 n + t + (e & 1).
  float s[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kMaxDim / 16; ++kk) {
    if (kk * 16 < L.dp) {
      uint32_t qa[4];
      lds_a(qa, qs + r0 * L.ld + kk * 16, L.ld, lane);
#pragma unroll
      for (int np = 0; np < kG; ++np) {
        uint32_t kb[4];
        lds_b_rows(kb, ks + np * 16 * L.ld + kk * 16, L.ld, lane);
        mma_16x8x16(s[2 * np], qa, kb[0], kb[1]);
        mma_16x8x16(s[2 * np + 1], qa, kb[2], kb[3]);
      }
    }
  }
  // The row softmax: scale, bias, max and sum over the quad's lanes.
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = n * 8 + t + (e & 1);
      float x = -CUDART_INF_F;
      if (j < skv) {
        x = s[n][e] * a.scale + bs[j];
        if (Mask::kOn) x += mask(r0 + g + 8 * (e >> 1), j);
      }
      s[n][e] = x;
      if (e < 2) m0 = fmaxf(m0, x); else m1 = fmaxf(m1, x);
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = __expf(s[n][e] - (e < 2 ? m0 : m1));  // 0 past skv
      s[n][e] = p;
      if (e < 2) l0 += p; else l1 += p;
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;  // a row's max term is 1: sum >= 1
  // O = P V, 16 keys a step: P (dropped and scaled) rounded to bf16 into
  // the A fragment of the step.
  float o[kMaxDim / 8][4];
#pragma unroll
  for (int dt = 0; dt < kMaxDim / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
#pragma unroll
  for (int c = 0; c < kG; ++c) {
    float p[2][4];
#pragma unroll
    for (int hn = 0; hn < 2; ++hn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[2 * c + hn][e] * (e < 2 ? inv0 : inv1);
        if (kDrop) {
          const bool kept = (keep >> (4 * ((e >> 1) * kG + c) + 2 * hn + (e & 1))) & 1u;
          x = kept ? x * a.keep_scale : 0.f;
        }
        p[hn][e] = x;
      }
    }
    uint32_t pa[4];
    acc_to_a(pa, p, 1.f);
    accumulate_16xd(o, pa, vs + c * 16 * L.ld, L.ld, L.dp, lane);
  }
  store_16xd(static_cast<__nv_bfloat16*>(a.out) + static_cast<long long>(b) * sq * row + h * d,
             row, o, r0, sq, d, lane);
}

template <bool kDrop, int kNT>
__global__ void __launch_bounds__(kFwdMaxThreads, kFwdMinBlocks)
    fused_attention_fwd_short_bf16(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  fwd_short_body<kDrop, kNT>(a, blockIdx.x, smem_raw);
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

bool within_limits(int batch, int sq, int skv, int heads, int dim) {
  return batch > 0 && sq > 0 && skv > 0 && heads > 0 && dim > 0 && sq <= kMaxSeq &&
         skv <= kMaxSeq && dim <= kMaxDim;
}

// The long-stream kernels: any sq and skv, in tiles of `tile` rows (the
// grid's block count stays below 2^31).
bool within_long_limits(int batch, int sq, int skv, int heads, int dim, int tile = kTileQ) {
  const int longest = sq > skv ? sq : skv;
  return batch > 0 && sq > 0 && skv > 0 && heads > 0 && dim > 0 &&
         static_cast<long long>(batch) * heads * ((longest + tile - 1) / tile) < (1LL << 31) &&
         dim <= kMaxDim;
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

// Let kernel take smem bytes of dynamic shared memory (above 48 KB only
// by this opt-in); the cudaError_t of the call.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

// One block per (batch row, head, query tile), the tile fastest.
template <typename Kernel>
int launch(Kernel kernel, const Args& a, int batch, int threads, size_t smem,
           cudaStream_t stream, int tiles = 1) {
  if (const int err = allow_smem(kernel, smem)) return err;
  const unsigned blocks = static_cast<unsigned>(batch) * a.heads * static_cast<unsigned>(tiles);
  kernel<<<blocks, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The short bf16 forward: one block per (batch row, head).
template <bool kDrop, int kNT>
int launch_fwd_short(const Args& a, int batch, cudaStream_t s) {
  const auto kernel = fused_attention_fwd_short_bf16<kDrop, kNT>;
  const size_t smem = fwd_short_layout(a.sq, a.skv, a.dim).bytes;
  if (const int err = allow_smem(kernel, smem)) return err;
  kernel<<<static_cast<unsigned>(batch) * a.heads, fwd_short_threads(a.sq), smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The short f32 forward: one block per (batch row, head).  Up to 32 keys
// the softmax takes one key a lane (softmax_rows<1>): the second key a
// lane of softmax_rows<2> is empty there and adds an exact 0, so the
// probabilities are the same bits with half the softmax's work.
template <bool kDrop, int kPerLane>
int launch_fwd_f32(const Args& a, int batch, cudaStream_t s) {
  const auto kernel = fused_attention_fwd_short_f32<kDrop, kPerLane>;
  const size_t smem = fwd_f32_layout(a.sq, a.skv, a.dim).bytes;
  if (const int err = allow_smem(kernel, smem)) return err;
  kernel<<<static_cast<unsigned>(batch) * a.heads, fwd_f32_threads(a.sq, a.skv, a.dim), smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = bfloat16; sq <= kMaxSeq.
template <bool kDrop>
int launch_fwd(const Args& a, int dtype, int batch, cudaStream_t s) {
  if (dtype == 0) {
    return a.skv <= 32 ? launch_fwd_f32<kDrop, 1>(a, batch, s) : launch_fwd_f32<kDrop, 2>(a, batch, s);
  }
  if (dtype != 1) return -1;
  switch (fwd_short_nt(a.skv)) {
    case 4: return launch_fwd_short<kDrop, 4>(a, batch, s);  // LXMERT's 20 keys
    case 6: return launch_fwd_short<kDrop, 6>(a, batch, s);  // its 36
    default: return launch_fwd_short<kDrop, 8>(a, batch, s);
  }
}

// fused_attention_dbias_sum over (batch, parts, skv) partials.
int launch_dbias_sum(const float* part, float* dbias, int batch, int parts, int skv,
                     cudaStream_t s) {
  const int n = batch * skv, threads = 256;
  fused_attention_dbias_sum<<<(n + threads - 1) / threads, threads, 0, s>>>(part, dbias, batch,
                                                                            parts, skv);
  return static_cast<int>(cudaGetLastError());
}

// The short bf16 backward: batch * ceil(heads / kShortBwdHeads) blocks,
// their dbias partials (one per head group) into a.dbias_part, added in
// group order by fused_attention_dbias_sum.  kNT = SKP / 8: accumulators
// for the padded keys and no more.
template <bool kDrop, int kNT>
int launch_bwd_short(const Args& a, float* dbias, int batch, cudaStream_t s) {
  const auto kernel = fused_attention_bwd_short_bf16<kDrop, kNT>;
  const ShortBwdLayout L = short_bwd_layout(a.sq, a.skv, a.dim);
  const int groups = (a.heads + kShortBwdHeads - 1) / kShortBwdHeads;
  if (const int err = allow_smem(kernel, L.bytes)) return err;
  const int threads = 2 * max(L.sqp, L.skp);  // one warp per 16 query rows or keys
  kernel<<<static_cast<unsigned>(batch) * groups, threads, L.bytes, s>>>(a);
  if (const int err = static_cast<int>(cudaGetLastError())) return err;
  return launch_dbias_sum(a.dbias_part, dbias, batch, groups, a.skv, s);
}

template <bool kDrop>
int launch_bwd(const Args& a, float* dbias, int dtype, int batch, cudaStream_t s) {
  if (dtype == 1) {
    switch (short_bwd_layout(a.sq, a.skv, a.dim).skp / 16) {
      case 2: return launch_bwd_short<kDrop, 4>(a, dbias, batch, s);  // LXMERT's 20 keys
      case 3: return launch_bwd_short<kDrop, 6>(a, dbias, batch, s);  // its 36
      default: return launch_bwd_short<kDrop, 8>(a, dbias, batch, s);
    }
  }
  if (dtype != 0) return -1;
  const auto kernel = a.skv <= 32 ? fused_attention_bwd_short_f32<kDrop, 1>  // as launch_fwd_f32
                                  : fused_attention_bwd_short_f32<kDrop, 2>;
  const size_t smem = bwd_f32_layout(a.sq, a.skv, a.dim).bytes;
  if (const int err = allow_smem(kernel, smem)) return err;
  kernel<<<static_cast<unsigned>(batch) * a.heads, bwd_f32_threads(a.sq, a.skv, a.dim), smem, s>>>(a);
  if (const int err = static_cast<int>(cudaGetLastError())) return err;
  return launch_dbias_sum(a.dbias_part, dbias, batch, a.heads, a.skv, s);
}

}  // namespace

#define RGQA_CUDA_ERROR_STRING                                              \
  extern "C" const char* rgqa_cuda_error_string(int err) {                 \
    return err < 0 ? "argument outside the kernel's limits"                 \
                   : cudaGetErrorString(static_cast<cudaError_t>(err));     \
  }
