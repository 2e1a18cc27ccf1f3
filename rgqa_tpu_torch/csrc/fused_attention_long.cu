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
//   that wgmma reads (no copies in device memory; swizzled_tile.cuh: at
//   D = 64 a thread's chunks of a tile are one column of the swizzle, a
//   start and a stride, no index arithmetic a chunk): the loads of tiles
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
// syncs.  The body holds 128 registers and 67 KB of shared memory, so
// two blocks share an SM: 4 warpgroups, which hide each other's softmax
// and loads.  The loader's fixed chunk columns made it 5-12% faster than
// index arithmetic a chunk (PERF.md §6), bits unchanged.
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
// f32, on the CUDA cores in exact f32 (fmaf, no TF32), bit for bit the
// first f32 bodies (one thread per output, both operands of every fmaf
// from shared memory, a whole row's K and V in 216 KB of shared memory at
// 256 keys; beyond, the same scalar scheme under an online softmax):
// each thread owns 4 x 4 tiles of S and of O in registers and reads its
// operands as float4 (8 FMAs a shared-memory load where the first bodies
// did 0.5), K and V stream through a two-stage cp.async ring; up to
// kLongWholeKv = 256 keys fused_attention_long_f32 takes each row's
// complete softmax (S of the query tile in shared memory, 101.7 KB at 185
// keys: two blocks an SM), beyond it fused_attention_long_tiled_f32 the
// online softmax over key tiles (105.2 KB, two blocks an SM).  In f32 the
// products bound the call: 320 / 402 us at 165 / 185 tokens, batch 256,
// against 155 / 174 us of bytes (67 TFLOP/s, 3.35 TB/s).
//
// 4L, the dropout variant (rgqa_fused_attention_dropout_long_fwd; the
// Pallas _fused_drop_kernel where its stream is longer than 64 tokens,
// UNITER's 76 with 40-token questions): every body above with kDrop, P
// dropped and scaled (keep ? P * 256/(256-t) : 0) after the softmax,
// whose sum, and the lse written for the backward, stay the undropped
// P's.  The mask is fused_attention_dropout.cu's, keep_bits16 words (one
// Philox4x32-10 call per query row and 16 keys).  In the bf16 body each
// warpgroup draws its own rows' words in registers while the tensor
// cores compute the tile's S (issued as an asynchronous group; the draw
// is held ahead of the wait): quad lane j draws 16-key group j for the
// lane's two rows, 2 calls a thread a tile, and each lane takes group c's
// word from quad lane c by a shuffle and the bits of its m16n8 C-fragment
// columns (8 n + tq + (e & 1)): no shared memory for the mask, 128
// registers, no spills.  Tried and dropped (PERF.md §6): the parent's
// draw into a ring stage of shared memory beside each tile, by every
// thread before the tile's barrier (1-6% slower than this, with the same
// loader); a producer warpgroup that issues the copies and draws the
// words into that ring, published by the tile's barrier (a third
// warpgroup a block: one block an SM, setmaxnreg cannot fit two; 22-77%
// slower); one warpgroup a block up to 128 rows (3 blocks an SM at 76
// tokens: 9-10% slower).  The f32
// bodies draw the words of their query tile while the first loads are in
// flight (whole row), or each key tile's while its loads are (key-tiled),
// into shared memory.  At rate 0 (t = 0, scale 1) 4L computes #2's bits.
//
// Limits: any Sq and Skv, D <= 64 (the wrapper raises beyond that); f32
// and bf16 inputs; the bias is a (B, Skv) f32 additive mask.  A fully
// masked row (bias -10000 everywhere) has a finite max, hence a finite
// lse and output.

#include "attention_common.cuh"
#include "wgmma.cuh"
#include "swizzled_tile.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16: wgmma over a ring of key tiles.
// ---------------------------------------------------------------------------

constexpr int kRingStages = 3;            // key tiles the ring holds
static_assert(kRingStages >= 2, "the ring needs a stage in flight beside the one computed");

// Shared memory of a block of `wg` warpgroups: their Q tiles, then the
// ring's K and V stages (each tile on a 1024-byte boundary, the
// swizzle's period), then the ring's bias stages (kKvTile f32 each, -inf
// past skv).  The launch adds one period so that the kernel can align the
// tiles itself.
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

// Key tile kt (keys kt * kKvTile ..) of a (batch row, head) into ring
// stage kt % kRingStages by the block's kThreads threads: K, V and the
// bias; one cp.async group, an empty one when kt is past the last tile.
template <int kThreads>
__device__ __forceinline__ void stage_ring(const Args& a, int b, int h, int kt,
                                           unsigned char* smem, const RingLayout& L, int tid) {
  const int k0 = kt * kKvTile;
  if (k0 < a.skv) {
    const int st = kt % kRingStages, nk = min(a.skv - k0, kKvTile), d = a.dim;
    load_swizzled<kThreads>(reinterpret_cast<__nv_bfloat16*>(smem + L.k_off + st * kTileBytes),
                  static_cast<const __nv_bfloat16*>(a.k) + b * a.k_bs + k0 * a.k_rs + h * d,
                  a.k_rs, d, nk, tid);
    load_swizzled<kThreads>(reinterpret_cast<__nv_bfloat16*>(smem + L.v_off + st * kTileBytes),
                  static_cast<const __nv_bfloat16*>(a.v) + b * a.v_bs + k0 * a.v_rs + h * d,
                  a.v_rs, d, nk, tid);
    float* bs = reinterpret_cast<float*>(smem + L.b_off) + st * kKvTile;
    for (int j = tid; j < kKvTile; j += kThreads) {
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
// ring together, so K and V are read once per group.  kDrop (4L): P
// dropped and scaled after the row sums, which stay the undropped P's,
// before its bf16 rounding into the A fragments of P V.
template <int kWG, bool kDrop>
__global__ void __launch_bounds__(kWG * kMmaThreads, ring_min_blocks(kWG))
    fused_attention_long_wgmma(Args a) {
  static_assert(kWG == 1 || kWG == 2, "1 or 2 warpgroups a block");
  constexpr int kThreads = kWG * kMmaThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align_to_period(smem_raw);
  const RingLayout L = ring_layout(kWG);
  const int groups = ((a.sq + kTileQ - 1) / kTileQ + kWG - 1) / kWG;
  const int bh = blockIdx.x / groups, b = bh / a.heads, h = bh % a.heads;
  const int first = blockIdx.x % groups * kWG;  // the group's first query tile
  const int d = a.dim, tid = threadIdx.x, wg = tid / kMmaThreads;
  const int ktiles = (a.skv + kKvTile - 1) / kKvTile;

#pragma unroll
  for (int w = 0; w < kWG; ++w) {
    const int t0 = (first + w) * kTileQ;
    load_swizzled<kThreads>(reinterpret_cast<__nv_bfloat16*>(smem + w * kTileBytes),
                  static_cast<const __nv_bfloat16*>(a.q) + b * a.q_bs + t0 * a.q_rs + h * d,
                  a.q_rs, d, max(0, min(kTileQ, a.sq - t0)), tid);
  }
#pragma unroll
  for (int kt = 0; kt < kRingStages - 1; ++kt) {
    stage_ring<kThreads>(a, b, h, kt, smem, L, tid);  // the Q tiles ride in tile 0's group
  }

  // A thread holds rows i0 = 16 warp + g and i0 + 8 of its warpgroup's
  // tile, columns 8 n + tq + (e & 1) in element 4 n + e of s (keys) and
  // o (head dims); e >= 2 is row i0 + 8 (wgmma.cuh).
  const int q0 = (first + wg) * kTileQ;
  const bool active = q0 < a.sq;
  const int lane = tid & 31, warp = (tid >> 5) & 3, g = lane >> 2, tq = (lane & 3) * 2;
  const int i0 = warp * 16 + g;
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
    stage_ring<kThreads>(a, b, h, kt + kRingStages - 1, smem, L, tid);
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
    // kDrop (4L): the tile's keep words are drawn while the tensor cores
    // compute S: quad lane j draws 16-key group j of the tile for the
    // lane's two rows (2 Philox calls a thread a tile); the empty asm
    // holds the draw ahead of the wait.
    uint32_t kw0 = 0u, kw1 = 0u;
    if (kDrop) {
      const int c = kt * kTileGroups + (lane & 3);
      kw0 = keep_bits16(a, b, h, q0 + i0, c);
      kw1 = keep_bits16(a, b, h, q0 + i0 + 8, c);
      asm volatile("" : "+r"(kw0), "+r"(kw1));
    }
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
    if (kDrop) {
      // The lane's rows' keep words, one per 16 keys: element e of column
      // tile n is key 8 n + tq + (e & 1), bit 8 (n & 1) + tq + (e & 1) of
      // word n / 2 of row i0 (e < 2) or i0 + 8.
#pragma unroll
      for (int c = 0; c < kTileGroups; ++c) {
        const uint32_t w0 = quad_word(kw0, c, lane), w1 = quad_word(kw1, c, lane);
#pragma unroll
        for (int i = 8 * c; i < 8 * c + 8; ++i) {
          const int bit = 8 * ((i >> 2) & 1) + tq + (i & 1);
          s[i] = (((i & 2) ? w1 : w0) >> bit) & 1u ? s[i] * a.keep_scale : 0.f;
        }
      }
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

// ---------------------------------------------------------------------------
// f32: the CUDA cores, 4 x 4 register tiles of exact f32 FMAs
// (attention_common.cuh's tile_xyt / tile_xy_acc, the short f32 bodies'
// products), one block of kLongF32Threads per (batch row, head, query tile
// of kTileQ), the tile fastest.  Every tile in shared memory has the row
// stride kF32Ld, and K and V come through a ring of two stages filled by
// cp.async (the next tile lands while the current one's products run).  Each output is one
// fmaf chain in the first bodies' order (S over the head dim, O over the
// keys, both from 0 in ascending order), and the softmax is theirs, so
// the outputs and the row statistics are bit for bit the first bodies'.
// ---------------------------------------------------------------------------

// Up to kLongWholeKv keys (fused_attention_long_f32): Q; the ring's two
// stages (the key tiles of K, then those of V); the row's S, then P
// (kTileQ x f32_ld(skv)); the row's bias; with kDrop the tile's keep
// words (kTileQ x ceil(skv / 16) u32), f32 offsets.  101.7 KB at 185
// keys (two blocks an SM), 121.0 KB at 256 (one).
struct WholeRowLayout {
  int ldp, ngr;
  size_t r_off, p_off, b_off, m_off, bytes;
};

__host__ __device__ inline WholeRowLayout whole_row_layout(int skv) {
  WholeRowLayout L;
  L.ldp = f32_ld(skv);
  L.ngr = (skv + 15) / 16;
  L.r_off = kF32Tile;
  L.p_off = L.r_off + 2 * kF32Tile;
  L.b_off = L.p_off + static_cast<size_t>(kTileQ) * L.ldp;
  L.m_off = L.b_off + groups4(skv) * 4;
  L.bytes = sizeof(float) * (L.m_off + static_cast<size_t>(kTileQ) * L.ngr);
  return L;
}

// The tile's rows: S = Q K^T * scale + bias over the key tiles (thread
// rows rg + RG m, keys kg + KG n of the tile, as the short forward), a
// barrier, the row softmax (softmax_rows, the dropout in its emit, the
// statistics from its sum), a barrier, O += P V over the value tiles
// (rows rg + RG m, columns 4 cg ..), written once.  The ring streams K_0
// .. K_{n-1}, V_0 .. V_{n-1}: V_0 lands under the last S tile.  kDrop
// (4L): the tile's keep words are drawn while Q and the first key tile
// are in flight.  kPerLane: keys a lane in the softmax (3, 4, 6 or 8 up to
// 96, 128, 192 or 256 keys; a lane's empty keys add exact zeros, so every
// width gives the same bits, and the fitted one spends no exp or division
// on keys past the row).
template <bool kDrop, int kPerLane>
__global__ void __launch_bounds__(kLongF32Threads, 2) fused_attention_long_f32(Args a) {
  extern __shared__ __align__(16) float smem_f32[];
  const int skv = a.skv, d = a.dim;
  const WholeRowLayout L = whole_row_layout(skv);
  const int tiles = (a.sq + kTileQ - 1) / kTileQ;
  const int bh = blockIdx.x / tiles, b = bh / a.heads, h = bh % a.heads;
  const int q0 = blockIdx.x % tiles * kTileQ, rows = min(a.sq - q0, kTileQ);
  const int ldp = L.ldp, ktiles = (skv + kKvTile - 1) / kKvTile;
  float* qs = smem_f32;
  float* ring = smem_f32 + L.r_off;
  float* ps = smem_f32 + L.p_off;
  float* bs = smem_f32 + L.b_off;
  uint32_t* km = reinterpret_cast<uint32_t*>(smem_f32 + L.m_off);
  const int tid = threadIdx.x;
  const int rg_n = groups4(rows), dg_n = groups4(d);
  const float* kp = static_cast<const float*>(a.k) + b * a.k_bs + h * d;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_bs + h * d;

  // Tile t of the stream into stage t & 1: one cp.async group.
  const auto stage = [&](int t) {
    const bool key = t < ktiles;
    const int k0 = (key ? t : t - ktiles) * kKvTile;
    const long long rs = key ? a.k_rs : a.v_rs;
    stage_rows_f32(ring + (t & 1) * kF32Tile, kF32Ld, (key ? kp : vp) + k0 * rs, rs,
                   min(skv - k0, kKvTile), d, tid, kLongF32Threads);
    cp_async_commit();
  };

  stage_rows_f32(qs, kF32Ld, static_cast<const float*>(a.q) + b * a.q_bs + q0 * a.q_rs + h * d, a.q_rs,
                 rows, d, tid, kLongF32Threads);
  for (int j = tid; j < skv; j += kLongF32Threads) {
    cp_async4(bs + j, a.bias + static_cast<long long>(b) * skv + j);
  }
  stage(0);  // Q and the bias ride in the first key tile's group
  if (kDrop) {
    for (int idx = tid; idx < rows * L.ngr; idx += kLongF32Threads) {
      km[idx] = keep_bits16(a, b, h, q0 + idx / L.ngr, idx % L.ngr);
    }
  }
  float o[4][4];
  zero_tile(o);
  float* lse = a.lse ? a.lse + 2 * ((static_cast<long long>(b) * a.heads + h) * a.sq + q0) : nullptr;

  for (int t = 0; t < 2 * ktiles; ++t) {
    // Tile t has landed and every thread is done with tile t - 1, whose
    // stage the next load takes.
    cp_async_wait_all();
    __syncthreads();
    if (t + 1 < 2 * ktiles) stage(t + 1);
    if (t == ktiles) {  // every score is in: the softmax, then P V
      softmax_rows<kPerLane>(ps, ldp, rows, skv, rows, skv, tid / 32, kLongF32Threads / 32, tid % 32,
                             [&](int i, int j, float p) {
                               if (kDrop) p = keep_bit(km, L.ngr, i, j) ? p * a.keep_scale : 0.f;
                               ps[i * ldp + j] = p;
                             },
                             [&](int i, float m, float sum) {
                               if (lse) {
                                 lse[2 * i] = m;
                                 lse[2 * i + 1] = logf(sum);
                               }
                             });
      __syncthreads();
    }
    const float* tile = ring + (t & 1) * kF32Tile;
    const int k0 = (t < ktiles ? t : t - ktiles) * kKvTile, nk = min(skv - k0, kKvTile);
    int xr[4];
    if (t < ktiles) {
      const int kg_n = groups4(nk);
      if (tid < rg_n * kg_n) {
        const int rg = tid / kg_n, kg = tid % kg_n;
        int yr[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          xr[m] = min(rg + rg_n * m, rows - 1);
          yr[m] = min(kg + kg_n * m, nk - 1);
        }
        float acc[4][4];
        tile_xyt<2>(acc, qs, tile, kF32Ld, xr, yr, d);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const int i = rg + rg_n * m, j = kg + kg_n * n;
            if (i < rows && j < nk) {
              float x = acc[m][n] * a.scale + bs[k0 + j];
              ps[i * ldp + k0 + j] = x;
            }
          }
        }
      }
    } else if (tid < rg_n * dg_n) {
#pragma unroll
      for (int m = 0; m < 4; ++m) xr[m] = min(tid / dg_n + rg_n * m, rows - 1);
      tile_xy_acc<false, 2>(o, ps + k0, ldp, xr, tile, kF32Ld, 4 * (tid % dg_n), nk);
    }
  }
  if (tid < rg_n * dg_n) {
    const long long out_rs = static_cast<long long>(a.heads) * d;
    store_tile_f32(static_cast<float*>(a.out) + (static_cast<long long>(b) * a.sq + q0) * out_rs + h * d,
                   out_rs, o, tid / dg_n, rg_n, rows, 4 * (tid % dg_n), d);
  }
}

// Beyond kLongWholeKv keys (fused_attention_long_tiled_f32), per key tile
// of kKvTile: S into shared memory, the online softmax by warps (a row's
// running max m, sum l and this tile's rescale c = exp(m_old - m_new)),
// O = O c + P V in registers, O / l once at the end.  Shared memory: Q;
// two ring stages of (K, V, bias); the tile's S / P; m, l, c per row; with
// kDrop two stages of keep words (kTileQ x kTileGroups u32), the next
// tile's drawn while its loads are in flight; 105.2 KB, two blocks an SM.
constexpr int kTiledStage = 2 * kF32Tile + kKvTile;

size_t tiled_f32_smem_bytes() {
  return sizeof(float) * (2 * kF32Tile + 2 * kTiledStage + 3 * kTileQ + 2 * kTileQ * kTileGroups);
}

template <bool kDrop>
__global__ void __launch_bounds__(kLongF32Threads, 2) fused_attention_long_tiled_f32(Args a) {
  extern __shared__ __align__(16) float smem_f32[];
  const int skv = a.skv, d = a.dim;
  const int tiles = (a.sq + kTileQ - 1) / kTileQ;
  const int bh = blockIdx.x / tiles, b = bh / a.heads, h = bh % a.heads;
  const int q0 = blockIdx.x % tiles * kTileQ, rows = min(a.sq - q0, kTileQ);
  const int ktiles = (skv + kKvTile - 1) / kKvTile;
  float* qs = smem_f32;
  float* ps = qs + kF32Tile;
  float* ring = ps + kF32Tile;
  float* rm = ring + 2 * kTiledStage;  // running max, sum and this tile's rescale per row
  float* rl = rm + kTileQ;
  float* rc = rl + kTileQ;
  uint32_t* km = reinterpret_cast<uint32_t*>(rc + kTileQ);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  constexpr int kWarps = kLongF32Threads / 32;
  const int rg_n = groups4(rows), dg_n = groups4(d);
  const float* kp = static_cast<const float*>(a.k) + b * a.k_bs + h * d;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_bs + h * d;

  // Key tile t's K, V and bias into stage t & 1: one cp.async group.
  const auto stage = [&](int t) {
    float* st = ring + (t & 1) * kTiledStage;
    const int k0 = t * kKvTile, nk = min(skv - k0, kKvTile);
    stage_rows_f32(st, kF32Ld, kp + k0 * a.k_rs, a.k_rs, nk, d, tid, kLongF32Threads);
    stage_rows_f32(st + kF32Tile, kF32Ld, vp + k0 * a.v_rs, a.v_rs, nk, d, tid, kLongF32Threads);
    for (int j = tid; j < nk; j += kLongF32Threads) {
      cp_async4(st + 2 * kF32Tile + j, a.bias + static_cast<long long>(b) * skv + k0 + j);
    }
    cp_async_commit();
  };
  // kDrop: key tile t's keep words of the tile's rows into stage t & 1.
  const auto draw = [&](int t) {
    uint32_t* w = km + (t & 1) * kTileQ * kTileGroups;
    const int k0 = t * kKvTile;
    for (int idx = tid; idx < rows * kTileGroups; idx += kLongF32Threads) {
      const int c = idx % kTileGroups;
      w[idx] = k0 + 16 * c < skv ? keep_bits16(a, b, h, q0 + idx / kTileGroups, k0 / 16 + c) : 0u;
    }
  };

  stage_rows_f32(qs, kF32Ld, static_cast<const float*>(a.q) + b * a.q_bs + q0 * a.q_rs + h * d, a.q_rs,
                 rows, d, tid, kLongF32Threads);
  stage(0);  // Q rides in the first tile's group
  for (int i = tid; i < kTileQ; i += kLongF32Threads) {
    rm[i] = -CUDART_INF_F;
    rl[i] = 0.f;
  }
  if (kDrop) draw(0);
  float o[4][4];
  zero_tile(o);
  int xr[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) xr[m] = min(tid / dg_n + rg_n * m, rows - 1);  // O's rows

  for (int t = 0; t < ktiles; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t landed; every thread is done with tile t - 1
    if (t + 1 < ktiles) {
      stage(t + 1);
      if (kDrop) draw(t + 1);
    }
    const float* st = ring + (t & 1) * kTiledStage;
    const uint32_t* w = km + (t & 1) * kTileQ * kTileGroups;
    const int k0 = t * kKvTile, nk = min(skv - k0, kKvTile), kg_n = groups4(nk);

    // Scores in the first body's order of products.
    if (tid < rg_n * kg_n) {
      const int rg = tid / kg_n, kg = tid % kg_n;
      int sr[4], yr[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        sr[m] = min(rg + rg_n * m, rows - 1);
        yr[m] = min(kg + kg_n * m, nk - 1);
      }
      float acc[4][4];
      tile_xyt<2>(acc, qs, st, kF32Ld, sr, yr, d);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int i = rg + rg_n * m, j = kg + kg_n * n;
          if (i < rows && j < nk) ps[i * kF32Ld + j] = acc[m][n] * a.scale + st[2 * kF32Tile + j];
        }
      }
    }
    __syncthreads();

    // Online softmax, one warp per row, keys lane and lane + 32.
    for (int i = warp; i < rows; i += kWarps) {
      float* pi = ps + i * kF32Ld;
      const float x0 = lane < nk ? pi[lane] : -CUDART_INF_F;
      const float x1 = lane + 32 < nk ? pi[lane + 32] : -CUDART_INF_F;
      float mt = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float mn = fmaxf(rm[i], mt);
      const float p0 = lane < nk ? expf(x0 - mn) : 0.f;
      const float p1 = lane + 32 < nk ? expf(x1 - mn) : 0.f;
      // The sum is the undropped P's; P V takes P dropped and scaled.
      const auto dropped = [&](float p, int j) {
        return !kDrop ? p : keep_bit(w, kTileGroups, i, j) ? p * a.keep_scale : 0.f;
      };
      if (lane < nk) pi[lane] = dropped(p0, lane);
      if (lane + 32 < nk) pi[lane + 32] = dropped(p1, lane + 32);
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

    if (tid < rg_n * dg_n) {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float c = rc[xr[m]];
#pragma unroll
        for (int u = 0; u < 4; ++u) o[m][u] = o[m][u] * c;
      }
      tile_xy_acc<false, 2>(o, ps, kF32Ld, xr, st + kF32Tile, kF32Ld, 4 * (tid % dg_n), nk);
    }
  }

  if (tid < rg_n * dg_n) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float l = rl[xr[m]];
#pragma unroll
      for (int u = 0; u < 4; ++u) o[m][u] = o[m][u] / l;
    }
    const long long out_rs = static_cast<long long>(a.heads) * d;
    store_tile_f32(static_cast<float*>(a.out) + (static_cast<long long>(b) * a.sq + q0) * out_rs + h * d,
                   out_rs, o, tid / dg_n, rg_n, rows, 4 * (tid % dg_n), d);
  }
  if (a.lse != nullptr) {
    float* lse = a.lse + 2 * ((static_cast<long long>(b) * a.heads + h) * a.sq + q0);
    for (int i = tid; i < rows; i += kLongF32Threads) {
      lse[2 * i] = rm[i];
      lse[2 * i + 1] = logf(rl[i]);
    }
  }
}

template <int kWG, bool kDrop>
int launch_ring(const Args& a, int batch, cudaStream_t s) {
  const auto kernel = fused_attention_long_wgmma<kWG, kDrop>;
  const size_t smem = ring_smem_bytes(kWG);
  if (const int err = allow_smem(kernel, smem)) return err;
  const int groups = ((a.sq + kTileQ - 1) / kTileQ + kWG - 1) / kWG;
  const unsigned blocks = static_cast<unsigned>(batch) * a.heads * static_cast<unsigned>(groups);
  kernel<<<blocks, kWG * kMmaThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Two warpgroups a block (one when there is one query tile): at 118
// registers two blocks share an SM, 4 warpgroups.
template <bool kDrop>
int launch_long_bf16(const Args& a, int batch, cudaStream_t s) {
  return a.sq <= kTileQ ? launch_ring<1, kDrop>(a, batch, s) : launch_ring<2, kDrop>(a, batch, s);
}

template <bool kDrop>
int launch_long_f32(const Args& a, int batch, cudaStream_t s) {
  const int tiles = (a.sq + kTileQ - 1) / kTileQ;
  if (a.skv > kLongWholeKv) {
    return launch(fused_attention_long_tiled_f32<kDrop>, a, batch, kLongF32Threads, tiled_f32_smem_bytes(), s,
                  tiles);
  }
  const size_t smem = whole_row_layout(a.skv).bytes;
  if (a.skv <= 3 * 32) return launch(fused_attention_long_f32<kDrop, 3>, a, batch, kLongF32Threads, smem, s, tiles);
  if (a.skv <= 4 * 32) return launch(fused_attention_long_f32<kDrop, 4>, a, batch, kLongF32Threads, smem, s, tiles);
  if (a.skv <= 6 * 32) return launch(fused_attention_long_f32<kDrop, 6>, a, batch, kLongF32Threads, smem, s, tiles);
  return launch(fused_attention_long_f32<kDrop, 8>, a, batch, kLongF32Threads, smem, s, tiles);
}

template <bool kDrop>
int launch_long_fwd(const Args& a, int dtype, int batch, cudaStream_t s) {
  if (dtype == 1) return launch_long_bf16<kDrop>(a, batch, s);
  if (dtype != 0) return -1;
  return launch_long_f32<kDrop>(a, batch, s);
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
  return launch_long_fwd<false>(a, dtype, batch, static_cast<cudaStream_t>(stream));
}

// Blocks an SM of the bf16 body at its shared memory
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor): out[0..3] the instances
// <kWG, kDrop> = <1, 0>, <1, 1>, <2, 0>, <2, 1>.  Returns the first
// cudaError_t (0 on success).
int rgqa_fused_attention_long_occupancy(int* out) {
  int err = 0;
  err = err ? err : blocks_per_sm(fused_attention_long_wgmma<1, false>, kMmaThreads, ring_smem_bytes(1), out + 0);
  err = err ? err : blocks_per_sm(fused_attention_long_wgmma<1, true>, kMmaThreads, ring_smem_bytes(1), out + 1);
  err = err ? err : blocks_per_sm(fused_attention_long_wgmma<2, false>, 2 * kMmaThreads, ring_smem_bytes(2), out + 2);
  err = err ? err : blocks_per_sm(fused_attention_long_wgmma<2, true>, 2 * kMmaThreads, ring_smem_bytes(2), out + 3);
  return err;
}

// Blocks an SM of the f32 bodies at their shared memory
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor): out[0..2] the
// whole-row body at 76, 185 and 256 keys, out[3] the key-tiled body (the
// dropout instances take the same shared memory).  Returns the first
// cudaError_t (0 on success).
int rgqa_fused_attention_long_f32_occupancy(int* out) {
  int err = 0;
  err = err ? err : blocks_per_sm(fused_attention_long_f32<false, 3>, kLongF32Threads, whole_row_layout(76).bytes, out + 0);
  err = err ? err : blocks_per_sm(fused_attention_long_f32<false, 6>, kLongF32Threads, whole_row_layout(185).bytes, out + 1);
  err = err ? err : blocks_per_sm(fused_attention_long_f32<false, 8>, kLongF32Threads, whole_row_layout(256).bytes, out + 2);
  err = err ? err : blocks_per_sm(fused_attention_long_tiled_f32<false>, kLongF32Threads, tiled_f32_smem_bytes(), out + 3);
  return err;
}

// 4L: as rgqa_fused_attention_long_fwd, plus the dropout arguments of
// rgqa_fused_attention_dropout_fwd (fused_attention_dropout.cu): seed (64
// bits), threshold t in [0, 255] and keep_scale = 256 / (256 - t).  lse,
// when not null, receives the undropped scores' statistics, which the
// backward (rgqa_fused_attention_dropout_long_bwd) takes.
int rgqa_fused_attention_dropout_long_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* out, void* lse,
    int dtype, int batch, int sq, int skv, int heads, int dim,
    long long q_bs, long long q_rs, long long k_bs, long long k_rs,
    long long v_bs, long long v_rs, float scale,
    unsigned long long seed, int threshold, float keep_scale, void* stream) {
  if (!within_long_limits(batch, sq, skv, heads, dim) || threshold < 0 || threshold > 255) {
    return -1;
  }
  Args a = make_args(q, k, v, bias, sq, skv, heads, dim, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs,
                     scale);
  a.out = out;
  a.lse = static_cast<float*>(lse);
  a.seed = seed;
  a.threshold = threshold;
  a.keep_scale = keep_scale;
  return launch_long_fwd<true>(a, dtype, batch, static_cast<cudaStream_t>(stream));
}

}  // extern "C"

RGQA_CUDA_ERROR_STRING
