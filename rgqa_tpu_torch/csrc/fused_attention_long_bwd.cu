// Fused multi-head attention backward for long streams, on the natural
// (B, S, H*D) layout: #3L, and with kDrop 5L.
//
// Replaces the Pallas TPU kernel rgqa_tpu/ops/attention.py:_fused_bwd_kernel
// where it runs at ViLT's streams (launched by _fused_bwd_pallas_raw under
// the raised VMEM tiers of _fit_bwd_block; from 246 tokens on the JAX
// package differentiates its XLA path instead, which computes the same
// function): the backward of every ViLT training step, 12 calls per step;
// with kDrop, _fused_drop_bwd_kernel beyond 64 tokens (UNITER's 76-token
// stream with 40-token questions: 12 calls an RP step).  Per (batch row,
// head), for the output gradient g and the forward's row statistics (m,
// log(sum)) (fused_attention_long.cu), it computes what the short backward
// (fused_attention_bwd.cu) does:
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
// Three sums cross any tiling: dK and dV over every query row, dQ and D
// over every key, dbias over heads and query rows.  Two passes split the
// work where the sums allow and never add floats from two blocks into
// one place, so two runs give identical bits (no float atomics):
//
// - the dQ pass, one block per (batch row, head, query tile of 64), the
//   tile fastest: it keeps its Q and g tiles and its rows' statistics,
//   walks the key tiles and accumulates dQ, written once, and each row's
//   (D, c) into a (B, H, Sq, 2) f32 scratch for the next pass;
// - the dK/dV pass, one block per (batch row, head, key tile of 64), on
//   the same stream after it: it keeps its K and V tiles, walks the query
//   tiles with their (D, c) and statistics, accumulates dK and dV (and
//   with dbias the column sums of dS), and writes them once;
// - with dbias, fused_attention_dbias_sum (attention_common.cuh) adds the
//   (B, H, Skv) partials over heads in head order, as the short backward.
//
// Two routes (kExact).  D = rowsum(dP P) is algebraically rowsum(g o out),
// the forward's output, but from the bf16 output it moves dbias (a sum of
// 12 x Sq terms P_ij D_i) past its bound, 1e-3 + 1e-4 |plain|
// (tests/test_torch_attention_long.py emulates it at ViLT's shapes).  No
// model path differentiates the mask (bias_vector's), so:
// - exact (dbias wanted: the wrapper's default): the dQ pass first sweeps
//   the keys for D (S and dP: two products a score), then sweeps them
//   again for dS and dQ (three); the dK/dV pass computes S^T, P^T, dP^T,
//   dS^T, dV and dK (four) and the dbias partials: 9 products a score;
// - without dbias (out given, as every model path calls it): the dQ pass
//   takes D_i = sum(g_i o out_i) in f32 from the output in its prologue
//   (16-byte loads, the quad's lanes a quarter of the head's dims each)
//   and sweeps the keys once; no partials, no head sum: 7 products a
//   score.  D from the output moves dq / dk / dv by far less than their
//   bf16 bound, 3e-2 + 1e-2 |plain| (tests/test_torch_long_dropout_route.py
//   emulates the route at UNITER's and ViLT's shapes: 3.4e-3 - 1.3e-2).
//   On this route P = 2^(s scale log2e + bias log2e + c) with c = -(m +
//   log(sum)) log2e per query row, taken once in the dQ pass and handed on
//   in the scratch: 3 operations a score where exp((x - m) - log(sum))
//   takes 5; a fully masked row's scores lie near -1e4, where the terms
//   cancel to 2^-10 (P within ~1e-3 of itself; the exact route, whose
//   dbias sums such rows, keeps the two-part form).
//
// bf16 bodies (long_bwd_dq_bf16 / long_bwd_dkv_bf16 <kDrop, kExact>): every
// product on Hopper's warpgroup products (wgmma.cuh), one warpgroup a
// block, the block's own 64-row tiles and the other side's stream in the
// 128-byte swizzle (swizzled_tile.cuh), the stream through a ring of
// kBwdStages = 3 stages filled by cp.async (a thread's four 16-byte chunks
// of a tile one column of the swizzle: a start and a stride), one barrier
// a tile, as #2's body (fused_attention_long.cu):
// - the dQ pass: S = Q K^T and dP = g V^T as two commit groups of wgmma
//   m64n64k16 from shared memory; P computed while dP's group runs; dS =
//   P (dP - D) rounded to bf16 after the scale straight into the register
//   A fragments of dQ += dS K (K MN-major from the stage, as V in #2's P
//   V); S, P, dP and dS never touch shared memory.  128-168 registers (3
//   blocks an SM by registers and by its 66 KB of shared memory), no
//   spills;
// - the dK/dV pass: S^T = K Q^T and dP^T = V g^T from shared memory (two
//   groups), then P_drop^T into A fragments and dV += P_drop^T g issued at
//   once, dS^T computed while it runs, then dK += dS^T Q (g and Q
//   MN-major from the stage), its fragments packed once dV's group is
//   done with P's.  160-168 registers, the cap for 3 blocks an SM (67 KB
//   of shared memory); 5L's dbias instance spills 24 bytes.
// P enters dV rounded to bf16 where the TPU kernel and the plain version
// keep it in f32: dV then differs by about one bf16 step of its terms,
// inside the bf16 bound (3e-2 + 1e-2 |plain|).  exp is ex2.approx (a few
// f32 ulp), far below those roundings.
// Tried on the H100 and dropped (PERF.md §6): the shared-memory carveout
// set to its maximum (no change: the passes already hold 3 blocks an SM),
// the dK/dV pass at 2 blocks an SM for more registers (2-9% slower a call
// but at one shape); two commit groups with P computed under dP's
// product (kept: as fast, and the keep mask lives in one register).  The
// mma.sync passes this replaced (#3L's and then 5L's) held fragments by
// ldmatrix and took 9 products a score on every route.
//
// f32: the same two passes on the CUDA cores (fmaf in f32), query tiles
// of 32 rows in the dQ pass and key tiles of 32 in the dK/dV pass, each
// walking the other side in tiles, D always by its sweep; checked, not
// timed.
//
// What bounds it on an H100 (chip_smoke.py's _bound_ms: q, k, v, g read
// and dq, dk, dv written once; 10 flops per score and head dim for S, dP,
// dV, dQ, dK): bytes at ViLT-B/32's training stream, 165 / 185 tokens at
// batch 256, 135.7 / 152.1 us; 228 us at 277 tokens; the products at 597
// tokens, batch 64, 177 us; UNITER's 76 tokens at batch 32, 7.8 us.  Both
// passes read their other side once per block (from L2 for a row's other
// blocks) and compute S and dP twice: 7 products a score where the bound
// counts 5.
//
// 5L, the dropout variant (rgqa_fused_attention_dropout_long_bwd), given
// 4L's statistics and, without dbias, 4L's dropped output: each pass
// replays 4L's mask from the seed, keep_bits16 words drawn once a tile
// and pass in registers while products run (2 Philox calls a thread a
// tile; no shared memory, so the passes hold as many blocks an SM as
// #3L's): in the dQ pass under the tile's S and dP, in the dK/dV pass
// under the previous tile's dK product, where the S^T and dP^T
// accumulators are dead (drawn beside them the pass spilled 64 bytes and
// ran 3-5% slower); 2 draws a score without dbias, 3 with it.
// dP is dropped and scaled (keep ? dP 256/(256-t) : 0) before D and dS;
// dV takes P_drop.  In the dQ pass quad lane j draws 16-key group j of
// the lane's two rows and the lanes take the words by shuffles; in the
// dK/dV pass a warp's 16 keys are one 16-key group, lane l draws query
// rows l and l + 32, and each lane gathers its 32 elements' bits into one
// mask register.  At rate 0 5L computes #3L's bits on both routes.
//
// Limits: any Sq and Skv, D <= 64; the wrapper raises beyond them.  A
// fully masked row (bias -10000 everywhere) has finite statistics, so its
// P and gradients are finite.

#include "attention_common.cuh"
#include "wgmma.cuh"
#include "swizzled_tile.cuh"

namespace {

constexpr int kF32TileQ = 32;   // query rows per f32 dQ block
constexpr int kF32TileK = 32;   // keys per f32 dK/dV block, and per f32 dQ step
constexpr int kF32ChunkQ = 64;  // query rows per f32 dK/dV step
constexpr int kBwdF32Threads = 256;
constexpr int kF32Groups = kF32TileK / 16;  // keep_bits16 words of a row in an f32 key tile

__device__ __forceinline__ long long row_index(const Args& a, int b, int h, int i) {
  return (static_cast<long long>(b) * a.heads + h) * a.sq + i;
}

// ---------------------------------------------------------------------------
// The dropout (5L, kDrop): each pass replays the forward's mask from the
// seed.  dP is masked and scaled (dP_drop = keep ? dP * 256/(256-t) : 0)
// before D = rowsum(dP_drop P) and dS = P (dP_drop - D); dV takes P_drop
// = keep ? P * 256/(256-t) : 0; P, from the forward's statistics, is the
// undropped softmax.  The f32 passes draw a tile's keep_bits16 words into
// shared memory with the tile (draw_tile_bits); the bf16 passes draw
// theirs in registers (their bodies below).
// ---------------------------------------------------------------------------

// The keep words of query rows i0 .. i0 + rows - 1 (i0 + r < sq) and the
// `groups` 16-key groups from key k0 (those below skv) into km, row r's
// word c at km[r * groups + c]; 0 elsewhere.
__device__ __forceinline__ void draw_tile_bits(const Args& a, int b, int h, uint32_t* km, int i0,
                                               int rows, int k0, int groups, int tid,
                                               int nthreads) {
  for (int idx = tid; idx < rows * groups; idx += nthreads) {
    const int i = i0 + idx / groups, c = idx % groups;
    km[idx] = i < a.sq && k0 + 16 * c < a.skv ? keep_bits16(a, b, h, i, k0 / 16 + c) : 0u;
  }
}

// ---------------------------------------------------------------------------
// bf16: both passes on wgmma (wgmma.cuh), one warpgroup a block, its
// operands in 64-row tiles in the 128-byte swizzle (swizzled_tile.cuh),
// the other side streamed through a ring of kBwdStages stages by
// cp.async, one barrier a tile (as #2's body, fused_attention_long.cu).
// kExact: D by a sweep of its own and the dbias partials (a caller that
// wants dbias); otherwise D = rowsum(g o out) from the forward's output.
// ---------------------------------------------------------------------------

constexpr int kBwdStages = 3;  // tiles the ring holds
constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the SFU (ex2.approx.ftz: a few f32 ulp, as __expf's).
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
static_assert(kBwdStages >= 2, "the ring needs a stage in flight beside the one computed");

// The wgmma accumulators of a 64 x 64 tile, zeroed.
__device__ __forceinline__ void zero32(float (&x)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] = 0.f;
}

// X (64 x 16 c .. 16 c + 15 of a 64 x 64 accumulator tile) times `scale`,
// rounded to bf16, as the register A fragments of wgmma: columns 16 c ..
// 16 c + 15 are accumulators 8 c .. 8 c + 7.
__device__ __forceinline__ void acc_to_frags(uint32_t (&fa)[4][4], const float (&x)[32], float scale) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int r = 0; r < 4; ++r) fa[c][r] = pack_f32_pair(x[8 * c + 2 * r] * scale, x[8 * c + 2 * r + 1] * scale);
  }
}

// acc (64 x 64) = (acc ? acc : 0) + X Y^T over the head dim, X and Y 64-row
// K-major tiles at descriptors dx, dy (4 steps of 16).
__device__ __forceinline__ void product_xyt(float (&acc)[32], uint64_t dx, uint64_t dy) {
#pragma unroll
  for (int kk = 0; kk < kMaxDim / 16; ++kk) WgmmaSS<64>::mma(acc, dx + 2 * kk, dy + 2 * kk, 1);
}

// acc (64 x 64) += A Y: A (64 x 64) the register fragments fa, Y the 64
// rows of an MN-major tile at descriptor dy (16 rows a step).
__device__ __forceinline__ void product_ay(float (&acc)[32], const uint32_t (&fa)[4][4], uint64_t dy) {
#pragma unroll
  for (int c = 0; c < 4; ++c) WgmmaRS64::mma(acc, fa[c], dy + c * 16 * 8, 1);
}

// ---------------------------------------------------------------------------
// bf16, the dQ pass: one block per (batch row, head, query tile of 64),
// the tile fastest.  Shared memory (each tile on the swizzle's period):
// the Q and g tiles, the ring's K and V stages and its bias stages (f32,
// -inf past skv).
// ---------------------------------------------------------------------------

struct DqLayout {
  size_t g_off, k_off, v_off, b_off, bytes;
};

__host__ __device__ inline DqLayout dq_layout() {
  DqLayout L;
  L.g_off = kTileBytes;
  L.k_off = 2 * kTileBytes;
  L.v_off = L.k_off + kTileBytes * kBwdStages;
  L.b_off = L.v_off + kTileBytes * kBwdStages;
  L.bytes = L.b_off + sizeof(float) * kKvTile * kBwdStages;
  return L;
}

size_t dq_smem_bytes() { return dq_layout().bytes + kSwizzlePeriod; }

// Step `step` of the pass (key tile step % ktiles) into ring stage step %
// kBwdStages: K, V and the bias; one cp.async group, an empty one past
// the last step.
__device__ __forceinline__ void stage_keys(const Args& a, int b, int h, int step, int steps,
                                           int ktiles, unsigned char* smem, const DqLayout& L,
                                           int tid) {
  if (step < steps) {
    const int st = step % kBwdStages, k0 = step % ktiles * kKvTile;
    const int nk = min(a.skv - k0, kKvTile), d = a.dim;
    load_swizzled<kMmaThreads>(reinterpret_cast<__nv_bfloat16*>(smem + L.k_off + st * kTileBytes),
                  static_cast<const __nv_bfloat16*>(a.k) + b * a.k_bs + k0 * a.k_rs + h * d, a.k_rs,
                  d, nk, tid);
    load_swizzled<kMmaThreads>(reinterpret_cast<__nv_bfloat16*>(smem + L.v_off + st * kTileBytes),
                  static_cast<const __nv_bfloat16*>(a.v) + b * a.v_bs + k0 * a.v_rs + h * d, a.v_rs,
                  d, nk, tid);
    float* bs = reinterpret_cast<float*>(smem + L.b_off) + st * kKvTile;
    for (int j = tid; j < kKvTile; j += kMmaThreads) {
      if (j < nk) {
        cp_async4(bs + j, a.bias + static_cast<long long>(b) * a.skv + k0 + j);
      } else {
        bs[j] = -CUDART_INF_F;
      }
    }
  }
  cp_async_commit();
}

// D of query rows i and i + 8 (each < sq, else 0) from the forward's
// output: the four lanes of a quad each sum 16 of the head's dims of g o
// out in f32 (two 16-byte loads of each where the layout allows), then
// the quad adds them.
__device__ __forceinline__ void d_from_out(const Args& a, int b, int h, int i, float& d0, float& d1,
                                           int lane) {
  const int d = a.dim, c0 = (lane & 3) * 16;
  const long long row = static_cast<long long>(a.heads) * d;
  const long long base = (static_cast<long long>(b) * a.sq + i) * row + h * d;
  const __nv_bfloat16* g = static_cast<const __nv_bfloat16*>(a.g) + base;
  const __nv_bfloat16* o = static_cast<const __nv_bfloat16*>(a.out) + base;
  float part[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (i + 8 * r >= a.sq) continue;
    const __nv_bfloat16* gr = g + 8 * r * row + c0;
    const __nv_bfloat16* orow = o + 8 * r * row + c0;
    if (d == kMaxDim && row % 8 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(o) % 16 == 0) {
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const uint4 gw = *reinterpret_cast<const uint4*>(gr + 8 * v);
        const uint4 ow = *reinterpret_cast<const uint4*>(orow + 8 * v);
        const uint32_t gu[4] = {gw.x, gw.y, gw.z, gw.w}, ou[4] = {ow.x, ow.y, ow.z, ow.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 gf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&gu[e]));
          const float2 of = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ou[e]));
          part[r] = fmaf(gf.x, of.x, part[r]);
          part[r] = fmaf(gf.y, of.y, part[r]);
        }
      }
    } else {
      for (int c = 0; c < 16 && c0 + c < d; ++c) {
        part[r] = fmaf(__bfloat162float(gr[c]), __bfloat162float(orow[c]), part[r]);
      }
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    part[0] += __shfl_xor_sync(0xffffffffu, part[0], off);
    part[1] += __shfl_xor_sync(0xffffffffu, part[1], off);
  }
  d0 = part[0];
  d1 = part[1];
}

// Registers capped for 3 blocks an SM (4 by the shared memory).
template <bool kDrop, bool kExact>
__global__ void __launch_bounds__(kMmaThreads, 3) long_bwd_dq_bf16(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align_to_period(smem_raw);
  const DqLayout L = dq_layout();
  const int tiles = (a.sq + kTileQ - 1) / kTileQ;
  const int bh = blockIdx.x / tiles, b = bh / a.heads, h = bh % a.heads;
  const int q0 = blockIdx.x % tiles * kTileQ, rows = min(a.sq - q0, kTileQ), d = a.dim;
  const long long row = static_cast<long long>(a.heads) * d;  // g and dq row stride
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = (lane & 3) * 2, i0 = warp * 16 + g;
  const int ktiles = (a.skv + kKvTile - 1) / kKvTile;
  const int steps = kExact ? 2 * ktiles : ktiles;

  load_swizzled<kMmaThreads>(reinterpret_cast<__nv_bfloat16*>(smem),
                static_cast<const __nv_bfloat16*>(a.q) + b * a.q_bs + q0 * a.q_rs + h * d, a.q_rs, d,
                rows, tid);
  load_swizzled<kMmaThreads>(reinterpret_cast<__nv_bfloat16*>(smem + L.g_off),
                static_cast<const __nv_bfloat16*>(a.g) + (static_cast<long long>(b) * a.sq + q0) * row + h * d,
                row, d, rows, tid);
#pragma unroll
  for (int s = 0; s < kBwdStages - 1; ++s) {
    stage_keys(a, b, h, s, steps, ktiles, smem, L, tid);  // Q and g ride in the first group
  }

  // A lane holds query rows i0 and i0 + 8 of the tile, keys 8 n + tq + (e
  // & 1) in element 4 n + e of S, dP and dQ (head dims); e >= 2 is row i0
  // + 8.  Rows past sq: m = +inf makes their P 0.
  const float* lse = a.lse + 2 * row_index(a, b, h, q0);
  const float m0 = i0 < rows ? lse[2 * i0] : CUDART_INF_F;
  const float m1 = i0 + 8 < rows ? lse[2 * (i0 + 8)] : CUDART_INF_F;
  const float ll0 = i0 < rows ? lse[2 * i0 + 1] : 0.f;
  const float ll1 = i0 + 8 < rows ? lse[2 * (i0 + 8) + 1] : 0.f;
  // Without kExact, P = 2^(s scale log2e + (bias log2e + c)) with the
  // row's c = -(m + log(sum)) log2e: 3 operations a score where the exact
  // route's exp((x - m) - log(sum)) takes 5.  A fully masked row's scores
  // lie near -1e4, where c and bias log2e cancel to 2^-10 (P within
  // ~1e-3 of itself; the exact route, whose dbias sums such rows, keeps
  // the two-part form).  Rows past sq: c = -inf, P = 0.
  const float c0 = -(m0 + ll0) * kLog2e, c1 = -(m1 + ll1) * kLog2e;
  const float scale2 = a.scale * kLog2e;
  float dd0 = 0.f, dd1 = 0.f;  // D of rows i0 and i0 + 8 (kExact: lane partials until the sweep ends)
  if (!kExact) d_from_out(a, b, h, q0 + i0, dd0, dd1, lane);
  float dq[32];
  zero32(dq);
  const uint64_t dqs = wgmma_desc_sw128(smem), dgs = wgmma_desc_sw128(smem + L.g_off);

  for (int step = 0; step < steps; ++step) {
    // Step `step`'s tile has landed (this thread's copies), is visible to
    // wgmma (the fence) and everyone's (the barrier), and the warpgroup is
    // done with step - 1's stage, which the next load takes.
    cp_async_wait_group<kBwdStages - 2>();
    fence_proxy_async();
    __syncthreads();
    stage_keys(a, b, h, step + kBwdStages - 1, steps, ktiles, smem, L, tid);
    const int st = step % kBwdStages, kt = step % ktiles;
    const bool second = !kExact || step >= ktiles;  // dS and dQ (else D's sweep)
    if (kExact && step == ktiles) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        dd0 += __shfl_xor_sync(0xffffffffu, dd0, off);
        dd1 += __shfl_xor_sync(0xffffffffu, dd1, off);
      }
    }

    // S = Q K^T and dP = g V^T (wgmma m64n64k16, all from shared memory),
    // two groups; with kDrop the tile's keep words are drawn while they
    // run: quad lane j draws 16-key group j for the lane's two rows (2
    // Philox calls a thread a tile; the empty asm holds the draw ahead of
    // the wait).  P is computed while dP's group runs.
    float s[32], dp[32];
    zero32(s);
    zero32(dp);
    const uint64_t dks = wgmma_desc_sw128(smem + L.k_off + st * kTileBytes);
    const uint64_t dvs = wgmma_desc_sw128(smem + L.v_off + st * kTileBytes);
    wgmma_fence();
    product_xyt(s, dqs, dks);
    wgmma_commit();
    product_xyt(dp, dgs, dvs);
    wgmma_commit();
    uint32_t kw0 = 0u, kw1 = 0u;
    if (kDrop) {
      const int c = kt * kTileGroups + (lane & 3);
      kw0 = keep_bits16(a, b, h, q0 + i0, c);
      kw1 = keep_bits16(a, b, h, q0 + i0 + 8, c);
      asm volatile("" : "+r"(kw0), "+r"(kw1));
    }
    wgmma_wait<1>();
    fence_operands(s);

    // P from the forward's statistics.
    const float* bs = reinterpret_cast<const float*>(smem + L.b_off) + st * kKvTile;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float bias = bs[8 * (i >> 2) + tq + (i & 1)];
      if (kExact) {
        const float x = s[i] * a.scale + bias;
        s[i] = __expf((x - ((i & 2) ? m1 : m0)) - ((i & 2) ? ll1 : ll0));
      } else {
        s[i] = ex2_approx(fmaf(s[i], scale2, fmaf(bias, kLog2e, (i & 2) ? c1 : c0)));
      }
    }
    wgmma_wait<0>();
    fence_operands(dp);
    // dP dropped and scaled (kDrop: bit 8 (n & 1) + tq + (e & 1) of word
    // n / 2 of the element's row).
    if (kDrop) {
#pragma unroll
      for (int c = 0; c < kTileGroups; ++c) {
        const uint32_t w0 = quad_word(kw0, c, lane), w1 = quad_word(kw1, c, lane);
#pragma unroll
        for (int i = 8 * c; i < 8 * c + 8; ++i) {
          const int bit = 8 * ((i >> 2) & 1) + tq + (i & 1);
          dp[i] = (((i & 2) ? w1 : w0) >> bit) & 1u ? dp[i] * a.keep_scale : 0.f;
        }
      }
    }
    if (!second) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (i & 2) dd1 += s[i] * dp[i]; else dd0 += s[i] * dp[i];
      }
      continue;
    }
    // dS = P (dP - D), rounded to bf16 after the scale into the A
    // fragments of dQ += dS K (K MN-major from the stage: key rows).
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= dp[i] - ((i & 2) ? dd1 : dd0);
    uint32_t sa[4][4];
    acc_to_frags(sa, s, a.scale);
    wgmma_fence();
    product_ay(dq, sa, dks);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(dq);
    fence_operands(sa);
  }

  __nv_bfloat16* dqp = static_cast<__nv_bfloat16*>(a.dq) + (static_cast<long long>(b) * a.sq + q0) * row + h * d;
#pragma unroll
  for (int n = 0; n < kMaxDim / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + (e >= 2 ? 8 : 0), c = n * 8 + tq + (e & 1);
      if (i < rows && c < d) dqp[i * row + c] = __float2bfloat16(dq[4 * n + e]);
    }
  }
  if ((lane & 3) == 0) {  // (D, c) of the rows for the dK/dV pass
    float2* dc = reinterpret_cast<float2*>(a.dsum) + row_index(a, b, h, q0);
    if (i0 < rows) dc[i0] = make_float2(dd0, c0);
    if (i0 + 8 < rows) dc[i0 + 8] = make_float2(dd1, c1);
  }
}

// ---------------------------------------------------------------------------
// bf16, the dK/dV pass: one block per (batch row, head, key tile of 64),
// on the stream after the dQ pass.  Shared memory (tiles on the swizzle's
// period): the K and V tiles, the ring's Q and g stages, and per stage the
// query tile's (D, c) from the dQ pass and (kExact) its statistics (m,
// log(sum)), f32 (c -inf, m +inf, D 0 past sq, so those rows' P and dS
// are 0).
// ---------------------------------------------------------------------------

struct DkvLayout {
  size_t v_off, q_off, g_off, l_off, d_off, bytes;
};

__host__ __device__ inline DkvLayout dkv_layout() {
  DkvLayout L;
  L.v_off = kTileBytes;
  L.q_off = 2 * kTileBytes;
  L.g_off = L.q_off + kTileBytes * kBwdStages;
  L.l_off = L.g_off + kTileBytes * kBwdStages;
  L.d_off = L.l_off + sizeof(float) * 2 * kTileQ * kBwdStages;
  L.bytes = L.d_off + sizeof(float) * 2 * kTileQ * kBwdStages;
  return L;
}

size_t dkv_smem_bytes() { return dkv_layout().bytes + kSwizzlePeriod; }

// Query tile qt into ring stage qt % kBwdStages: Q, g, (D, c) and with
// kExact the statistics, by cp.async; one group, an empty one past the
// last tile.
template <bool kExact>
__device__ __forceinline__ void stage_queries(const Args& a, int b, int h, int qt,
                                              unsigned char* smem, const DkvLayout& L, int tid) {
  const int c0 = qt * kTileQ;
  if (c0 < a.sq) {
    const int st = qt % kBwdStages, nq = min(a.sq - c0, kTileQ), d = a.dim;
    const long long row = static_cast<long long>(a.heads) * d;
    load_swizzled<kMmaThreads>(reinterpret_cast<__nv_bfloat16*>(smem + L.q_off + st * kTileBytes),
                  static_cast<const __nv_bfloat16*>(a.q) + b * a.q_bs + c0 * a.q_rs + h * d, a.q_rs,
                  d, nq, tid);
    load_swizzled<kMmaThreads>(reinterpret_cast<__nv_bfloat16*>(smem + L.g_off + st * kTileBytes),
                  static_cast<const __nv_bfloat16*>(a.g) + (static_cast<long long>(b) * a.sq + c0) * row + h * d,
                  row, d, nq, tid);
    float* ls = reinterpret_cast<float*>(smem + L.l_off) + st * 2 * kTileQ;
    float* dc = reinterpret_cast<float*>(smem + L.d_off) + st * 2 * kTileQ;
    const long long r = row_index(a, b, h, c0);
    for (int i = tid; i < kTileQ; i += kMmaThreads) {
      if (i < nq) {
        if (kExact) cp_async8(ls + 2 * i, a.lse + 2 * (r + i));
        cp_async8(dc + 2 * i, a.dsum + 2 * (r + i));
      } else {
        ls[2 * i] = CUDART_INF_F;
        ls[2 * i + 1] = 0.f;
        dc[2 * i] = 0.f;
        dc[2 * i + 1] = -CUDART_INF_F;
      }
    }
  }
  cp_async_commit();
}

// The keep bits of a lane's 32 elements of S^T for query tile qt (5L's
// dK/dV pass), bit x for element x: a warp's 16 keys are 16-key group c
// of the row, lane l draws query rows l and l + 32 of the tile (2 Philox
// calls), and each lane gathers its columns' words by shuffles (key j0 +
// 8 e2 of query 8 n + tq + e1 is bit g + 8 e2 of that query's word).
__device__ __forceinline__ uint32_t keep_mask_keys(const Args& a, int b, int h, int qt, int c,
                                                   int lane, int tq, int g) {
  const uint32_t kw0 = keep_bits16(a, b, h, qt * kTileQ + lane, c);
  const uint32_t kw1 = keep_bits16(a, b, h, qt * kTileQ + lane + 32, c);
  uint32_t keep = 0u;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e1 = 0; e1 < 2; ++e1) {
      const uint32_t w = __shfl_sync(0xffffffffu, n < 4 ? kw0 : kw1, (8 * n + tq + e1) & 31) >> g;
      keep |= (w & 1u) << (4 * n + e1) | ((w >> 8) & 1u) << (4 * n + 2 + e1);
    }
  }
  return keep;
}

// Registers capped for 3 blocks an SM (as the shared memory allows).
template <bool kDrop, bool kExact>
__global__ void __launch_bounds__(kMmaThreads, 3) long_bwd_dkv_bf16(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align_to_period(smem_raw);
  const DkvLayout L = dkv_layout();
  const int sq = a.sq, skv = a.skv, d = a.dim;
  const int ktiles = (skv + kKvTile - 1) / kKvTile;
  const int bh = blockIdx.x / ktiles, b = bh / a.heads, h = bh % a.heads;
  const int k0 = blockIdx.x % ktiles * kKvTile, nk = min(skv - k0, kKvTile);
  const long long row = static_cast<long long>(a.heads) * d;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = (lane & 3) * 2, j0 = warp * 16 + g;
  const int qtiles = (sq + kTileQ - 1) / kTileQ;

  load_swizzled<kMmaThreads>(reinterpret_cast<__nv_bfloat16*>(smem),
                static_cast<const __nv_bfloat16*>(a.k) + b * a.k_bs + k0 * a.k_rs + h * d, a.k_rs, d,
                nk, tid);
  load_swizzled<kMmaThreads>(reinterpret_cast<__nv_bfloat16*>(smem + L.v_off),
                static_cast<const __nv_bfloat16*>(a.v) + b * a.v_bs + k0 * a.v_rs + h * d, a.v_rs, d,
                nk, tid);
#pragma unroll
  for (int s = 0; s < kBwdStages - 1; ++s) stage_queries<kExact>(a, b, h, s, smem, L, tid);  // K, V in the first group

  // A lane holds keys j0 and j0 + 8 of the tile as the rows of the
  // transposed products (warp w's 16 keys are 16-key group w of the
  // tile), queries 8 n + tq + (e & 1) in element 4 n + e of S^T and dP^T
  // and head dims there in dK and dV; e >= 2 is key j0 + 8.  Keys past
  // skv: bias -inf, so P = 0.
  const float* bias = a.bias + static_cast<long long>(b) * skv + k0;
  const float bias0 = j0 < nk ? bias[j0] : -CUDART_INF_F;
  const float bias1 = j0 + 8 < nk ? bias[j0 + 8] : -CUDART_INF_F;
  // Without kExact, P = 2^(s scale log2e + bias log2e + c) with the query
  // row's c from the dQ pass (as it computes P there).
  const float bl0 = bias0 * kLog2e, bl1 = bias1 * kLog2e, scale2 = a.scale * kLog2e;
  float dk[32], dv[32];
  zero32(dk);
  zero32(dv);
  float db0 = 0.f, db1 = 0.f;  // kExact: column sums of dS for keys j0, j0 + 8
  const uint64_t dks = wgmma_desc_sw128(smem), dvs = wgmma_desc_sw128(smem + L.v_off);
  // kDrop: query tile qt's keep mask, bit x for element x, drawn for the
  // next tile while dK's product runs (when the S^T and dP^T accumulators
  // are dead: drawn beside them, the pass spilled at 168 registers).
  uint32_t keep = kDrop ? keep_mask_keys(a, b, h, 0, k0 / 16 + warp, lane, tq, g) : 0xFFFFFFFFu;

  for (int qt = 0; qt < qtiles; ++qt) {
    cp_async_wait_group<kBwdStages - 2>();
    fence_proxy_async();
    __syncthreads();
    stage_queries<kExact>(a, b, h, qt + kBwdStages - 1, smem, L, tid);
    const int st = qt % kBwdStages;

    // S^T = K Q^T and dP^T = V g^T (wgmma, all from shared memory), two
    // groups.
    float pt[32], dst[32];
    zero32(pt);
    zero32(dst);
    const uint64_t dqs = wgmma_desc_sw128(smem + L.q_off + st * kTileBytes);
    const uint64_t dgs = wgmma_desc_sw128(smem + L.g_off + st * kTileBytes);
    wgmma_fence();
    product_xyt(pt, dks, dqs);
    wgmma_commit();
    product_xyt(dst, dvs, dgs);
    wgmma_commit();

    // P^T from the statistics (while dP^T's group runs), then P dropped
    // and scaled into the A fragments of dV += P_drop^T g (g MN-major from
    // the stage: query rows), issued at once.
    const float2* ls = reinterpret_cast<const float2*>(smem + L.l_off) + st * kTileQ;
    const float2* dc = reinterpret_cast<const float2*>(smem + L.d_off) + st * kTileQ;
    wgmma_wait<1>();
    fence_operands(pt);
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int i = 8 * (x >> 2) + tq + (x & 1);
      if (kExact) {
        const float2 ml = ls[i];
        const float y = pt[x] * a.scale + ((x & 2) ? bias1 : bias0);
        pt[x] = __expf((y - ml.x) - ml.y);
      } else {
        pt[x] = ex2_approx(fmaf(pt[x], scale2, (x & 2) ? bl1 : bl0) + dc[i].y);
      }
    }
    uint32_t pa[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int x = 8 * c + 2 * r;
        pa[c][r] = pack_f32_pair((keep >> x) & 1u ? pt[x] * a.keep_scale : 0.f,
                                 (keep >> (x + 1)) & 1u ? pt[x + 1] * a.keep_scale : 0.f);
      }
    }
    wgmma_fence();
    product_ay(dv, pa, dgs);
    wgmma_commit();

    // dS^T = P (dP_drop - D) (dP^T's group done; dV's may run), rounded to
    // bf16 after the scale into the A fragments of dK += dS^T Q, packed
    // once dV's group is done with P's fragments.
    wgmma_wait<1>();
    fence_operands(dst);
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const float dpv = (keep >> x) & 1u ? dst[x] * a.keep_scale : 0.f;
      dst[x] = pt[x] * (dpv - dc[8 * (x >> 2) + tq + (x & 1)].x);
      if (kExact) {
        if (x & 2) db1 += dst[x]; else db0 += dst[x];
      }
    }
    wgmma_wait<0>();
    fence_operands(dv);
    fence_operands(pa);
    uint32_t sa[4][4];
    acc_to_frags(sa, dst, a.scale);
    wgmma_fence();
    product_ay(dk, sa, dqs);
    wgmma_commit();
    if (kDrop && qt + 1 < qtiles) {
      keep = keep_mask_keys(a, b, h, qt + 1, k0 / 16 + warp, lane, tq, g);
      asm volatile("" : "+r"(keep));  // drawn ahead of the wait
    }
    wgmma_wait<0>();
    fence_operands(dk);
    fence_operands(sa);
  }

  const long long kv0 = (static_cast<long long>(b) * skv + k0) * row + h * d;
  __nv_bfloat16* dkp = static_cast<__nv_bfloat16*>(a.dk) + kv0;
  __nv_bfloat16* dvp = static_cast<__nv_bfloat16*>(a.dv) + kv0;
#pragma unroll
  for (int n = 0; n < kMaxDim / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + (e >= 2 ? 8 : 0), c = n * 8 + tq + (e & 1);
      if (j < nk && c < d) {
        dkp[j * row + c] = __float2bfloat16(dk[4 * n + e]);
        dvp[j * row + c] = __float2bfloat16(dv[4 * n + e]);
      }
    }
  }
  if (kExact) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      db0 += __shfl_xor_sync(0xffffffffu, db0, off);
      db1 += __shfl_xor_sync(0xffffffffu, db1, off);
    }
    if ((lane & 3) == 0) {
      float* part = a.dbias_part + (static_cast<long long>(b) * a.heads + h) * skv + k0;
      if (j0 < nk) part[j0] = db0;
      if (j0 + 8 < nk) part[j0 + 8] = db1;
    }
  }
}

// ---------------------------------------------------------------------------
// f32, the dQ pass, CUDA cores.  Shared memory, f32, ld = dim + 1: Q, G
// (kF32TileQ x ld), the key tile's K, V (kF32TileK x ld), P dP (first
// sweep) or dS (second) (kF32TileQ x (kF32TileK + 1)), bias (kF32TileK),
// each row's statistics (m, log(sum)) and D (kF32TileQ x 2 and kF32TileQ),
// and with kDrop the key tile's keep words (kF32TileQ x kF32Groups u32).
// P = expf((s - m) - log(sum)), as softmax gives it up to a few ulp.
// ---------------------------------------------------------------------------

constexpr int kF32DqElems = kF32TileQ * kMaxDim / kBwdF32Threads;

size_t dq_f32_smem_bytes(int d, bool drop) {
  const size_t ld = d + 1, ldp = kF32TileK + 1;
  return sizeof(float) * (2 * kF32TileQ * ld + 2 * kF32TileK * ld + kF32TileQ * ldp + kF32TileK +
                          3 * kF32TileQ + (drop ? kF32TileQ * kF32Groups : 0));
}

__device__ __forceinline__ float dot_f32(const float* x, const float* y, int d) {
  float acc = 0.f;
#pragma unroll 8
  for (int c = 0; c < d; ++c) acc = fmaf(x[c], y[c], acc);
  return acc;
}

template <bool kDrop>
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
  uint32_t* km = reinterpret_cast<uint32_t*>(dds + kF32TileQ);
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
      if (kDrop) draw_tile_bits(a, b, h, km, q0, kF32TileQ, k0, kF32Groups, tid, kThreads);
      __syncthreads();

      for (int idx = tid; idx < sq * nk; idx += kThreads) {
        const int i = idx / nk, j = idx % nk;
        const float x = fmaf(dot_f32(qs + i * ld, ks + j * ld, d), a.scale, bs[j]);
        const float p = expf((x - ls[2 * i]) - ls[2 * i + 1]);
        float dp = dot_f32(gs + i * ld, vs + j * ld, d);
        if (kDrop) dp = keep_bit(km, kF32Groups, i, j) ? dp * a.keep_scale : 0.f;
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
      a.dsum[2 * row_index(a, b, h, q0 + tid)] = dd;
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
// (kF32ChunkQ x 2 and kF32ChunkQ), and with kDrop the chunk's keep words for
// the block's keys (kF32ChunkQ x kF32Groups u32).  Each thread accumulates
// kF32Elems (key, column) elements of dK and dV over every query row in
// order.
// ---------------------------------------------------------------------------

constexpr int kF32Elems = kF32TileK * kMaxDim / kBwdF32Threads;

size_t dkv_f32_smem_bytes(int d, bool drop) {
  const size_t ld = d + 1, ldc = kF32ChunkQ + 1;
  return sizeof(float) * (2 * kF32TileK * ld + 2 * kF32ChunkQ * ld + 2 * kF32TileK * ldc +
                          kF32TileK + 3 * kF32ChunkQ + (drop ? kF32ChunkQ * kF32Groups : 0));
}

template <bool kDrop>
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
  uint32_t* km = reinterpret_cast<uint32_t*>(dds + kF32ChunkQ);
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
    for (int i = tid; i < nq; i += kThreads) dds[i] = a.dsum[2 * row_index(a, b, h, c0 + i)];
    if (kDrop) draw_tile_bits(a, b, h, km, c0, kF32ChunkQ, k0, kF32Groups, tid, kThreads);
    __syncthreads();

    // The same operations as the dQ pass, so the same P.
    for (int idx = tid; idx < nk * nq; idx += kThreads) {
      const int j = idx / nq, i = idx % nq;
      const float x = fmaf(dot_f32(qs + i * ld, ks + j * ld, d), a.scale, bs[j]);
      const float p = expf((x - ls[2 * i]) - ls[2 * i + 1]);
      float dp = dot_f32(gs + i * ld, vs + j * ld, d);
      if (kDrop) {
        const bool kept = keep_bit(km, kF32Groups, i, j);
        pt[j * ldc + i] = kept ? p * a.keep_scale : 0.f;
        dp = kept ? dp * a.keep_scale : 0.f;
      } else {
        pt[j * ldc + i] = p;
      }
      dst[j * ldc + i] = p * (dp - dds[i]);
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

// The bf16 passes of one route: kExact with D's sweep and the dbias
// partials, else D from the forward's output (a.out) and no partials.
template <bool kDrop, bool kExact>
int launch_long_bwd_bf16(const Args& a, int batch, cudaStream_t s) {
  const int err = launch(long_bwd_dq_bf16<kDrop, kExact>, a, batch, kMmaThreads, dq_smem_bytes(), s,
                         (a.sq + kTileQ - 1) / kTileQ);
  if (err != 0) return err;
  return launch(long_bwd_dkv_bf16<kDrop, kExact>, a, batch, kMmaThreads, dkv_smem_bytes(), s,
                (a.skv + kKvTile - 1) / kKvTile);
}

// a.out null: dbias wanted, so the exact route and the head sum of the
// partials.  Otherwise the bf16 passes take D from a.out and leave dbias
// unwritten; the f32 passes keep their sweep and write it either way.
template <bool kDrop>
int launch_long_bwd(const Args& a, float* dbias, int dtype, int batch, cudaStream_t s) {
  int err;
  if (dtype == 1) {
    if (a.out != nullptr) return launch_long_bwd_bf16<kDrop, false>(a, batch, s);
    err = launch_long_bwd_bf16<kDrop, true>(a, batch, s);
  } else if (dtype == 0) {
    err = launch(long_bwd_dq_f32<kDrop>, a, batch, kBwdF32Threads, dq_f32_smem_bytes(a.dim, kDrop),
                 s, (a.sq + kF32TileQ - 1) / kF32TileQ);
    if (err == 0) {
      err = launch(long_bwd_dkv_f32<kDrop>, a, batch, kBwdF32Threads,
                   dkv_f32_smem_bytes(a.dim, kDrop), s, (a.skv + kF32TileK - 1) / kF32TileK);
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
// log(sum)) (rgqa_fused_attention_long_fwd), and dsum, a (batch, heads, sq, 2) f32
// scratch for each row's (D, c) that the dQ pass hands the dK/dV pass (c
// = -(m + log(sum)) log2e, read without dbias), and out: null when
// dbias is wanted; else the forward's contiguous (B, Sq, heads * dim)
// output, from which the bf16 passes take D = rowsum(g o out) without a
// sweep and write no dbias (the f32 passes ignore it).  dtype 0 = float32,
// 1 = bfloat16; q/k/v strides in elements, their last dimension
// contiguous; g, dq, dk, dv contiguous (B, S, heads * dim) in the input
// dtype; dbias_part (B, heads, Skv) f32 scratch, dbias the (B, Skv) f32
// result.  Returns the cudaError_t of the launches (0 on success); -1 for
// arguments outside the kernel's limits.
int rgqa_fused_attention_long_bwd(
    const void* q, const void* k, const void* v, const void* bias, const void* g,
    void* dq, void* dk, void* dv, void* dbias_part, void* dbias, void* lse, void* dsum,
    const void* out, int dtype, int batch, int sq, int skv, int heads, int dim,
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
  a.out = const_cast<void*>(out);
  return launch_long_bwd<false>(a, static_cast<float*>(dbias), dtype, batch,
                                static_cast<cudaStream_t>(stream));
}

// 5L: as rgqa_fused_attention_long_bwd, plus the forward's dropout
// arguments (rgqa_fused_attention_dropout_long_fwd), whose mask it
// replays; lse is that forward's (the undropped scores' statistics), out
// its dropped output.
// Blocks an SM of each bf16 pass at its shared memory
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor): out[0..3] the dQ pass
// <kDrop, kExact> = <0, 0>, <0, 1>, <1, 0>, <1, 1>, out[4..7] the dK/dV
// pass alike.  Returns the first cudaError_t (0 on success).
int rgqa_fused_attention_long_bwd_occupancy(int* out) {
  const size_t dq = dq_smem_bytes(), dkv = dkv_smem_bytes();
  int err = 0;
  err = err ? err : blocks_per_sm(long_bwd_dq_bf16<false, false>, kMmaThreads, dq, out + 0);
  err = err ? err : blocks_per_sm(long_bwd_dq_bf16<false, true>, kMmaThreads, dq, out + 1);
  err = err ? err : blocks_per_sm(long_bwd_dq_bf16<true, false>, kMmaThreads, dq, out + 2);
  err = err ? err : blocks_per_sm(long_bwd_dq_bf16<true, true>, kMmaThreads, dq, out + 3);
  err = err ? err : blocks_per_sm(long_bwd_dkv_bf16<false, false>, kMmaThreads, dkv, out + 4);
  err = err ? err : blocks_per_sm(long_bwd_dkv_bf16<false, true>, kMmaThreads, dkv, out + 5);
  err = err ? err : blocks_per_sm(long_bwd_dkv_bf16<true, false>, kMmaThreads, dkv, out + 6);
  err = err ? err : blocks_per_sm(long_bwd_dkv_bf16<true, true>, kMmaThreads, dkv, out + 7);
  return err;
}

int rgqa_fused_attention_dropout_long_bwd(
    const void* q, const void* k, const void* v, const void* bias, const void* g,
    void* dq, void* dk, void* dv, void* dbias_part, void* dbias, void* lse, void* dsum,
    const void* out, int dtype, int batch, int sq, int skv, int heads, int dim,
    long long q_bs, long long q_rs, long long k_bs, long long k_rs,
    long long v_bs, long long v_rs, float scale,
    unsigned long long seed, int threshold, float keep_scale, void* stream) {
  if (!within_long_limits(batch, sq, skv, heads, dim, 32) || threshold < 0 || threshold > 255) {
    return -1;
  }
  Args a = make_args(q, k, v, bias, sq, skv, heads, dim, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs,
                     scale);
  a.g = g;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.dbias_part = static_cast<float*>(dbias_part);
  a.lse = static_cast<float*>(lse);
  a.dsum = static_cast<float*>(dsum);
  a.out = const_cast<void*>(out);
  a.seed = seed;
  a.threshold = threshold;
  a.keep_scale = keep_scale;
  return launch_long_bwd<true>(a, static_cast<float*>(dbias), dtype, batch,
                               static_cast<cudaStream_t>(stream));
}

}  // extern "C"

RGQA_CUDA_ERROR_STRING
