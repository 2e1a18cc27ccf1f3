// The attention-epilogue experiment (experiments/epilogue_exp.py): an
// attention layer's attention, output projection, bias, residual and
// LayerNorm in one kernel.
//
// Replaces the Pallas TPU kernel _epi_kernel (launched by
// experiments/epilogue_exp.py:epi_fused).  For q (B, Sq, E), k / v
// (B, Skv, E), a (B, Skv) f32 bias, res (B, Sq, E), W (E, E) in the input
// dtype ((in, out) layout: y = ctx W) and f32 b, gamma, beta (E):
//
//     o_h = softmax(q_h k_h^T / sqrt(D) + bias) v_h, rounded to the input dtype
//     y   = sum_h o_h W[h D:(h + 1) D, :] + b + res        (f32)
//     out = (y - mean(y)) / sqrt(var(y) + eps) * gamma + beta, in the input dtype
//
// with the statistics over E columns in f32.  The out-projection is the
// kernel's own (wgmma in bf16), not a library GEMM.
//
// Design (bf16, epilogue_bf16<kNP>), on Hopper's warpgroup products
// (wgmma.cuh) and its tensor memory accelerator (TMA).  LayerNorm needs
// whole rows, so a block of 4 warpgroups owns kEpiRows = 64 consecutive
// rows of the flattened (B Sq, E) output, wgmma's M, which may span
// several batch rows ("segments").  Its shared memory holds one 64 x 768
// bf16 tile in 12 chunks of 64 columns, each one 128-byte swizzle atom
// wide (8 KB): first the block's queries (chunk h = head h's Q), then its
// context (head h's attention writes o_h over chunk h), then the
// residual, then the output.  No head's context reaches device memory.
//   1. attention: warpgroup w takes heads w, w + 4, w + 8.  Per head it
//      walks windows of whole segments, at most kMaxWindowKeys = 96 keys
//      (epilogue_exp.epi_plan: spw segments a window, kNP keys padded to
//      16; the window's scores are kNP / 2 registers a thread, and at 112
//      keys the body spilled): S = Q_h
//      K_win^T as wgmma m64nNk16, all 64 query rows against the window's
//      keys, the scores of other segments' keys at -inf (6d's stacked
//      form), the softmax on the accumulators by quad shuffles, P =
//      exp(S - m) unnormalised and rounded to bf16 into the register A
//      fragments of O = P V (m64n64k16) as #2's body does, O / l written
//      over chunk h for the window's rows.  K, V and the bias come
//      by cp.async into the warpgroup's own swizzled buffers: the next
//      window's K loads while this one's softmax and P V run, its V while
//      the next S runs.
//   2. projection: acc = b + ctx W, each warpgroup 192 output columns as
//      m64n192k16 from shared memory (W MN-major, the transpose bit), 96
//      f32 accumulators a thread.  W streams through a ring of kStages = 5
//      items of 24 KB: item i is warpgroup i % 4's 192 columns of W's rows
//      64 (i / 4) .. + 63, three 64 x 64 boxes in the 128-byte swizzle,
//      one TMA each, completing the item's own mbarrier (one per item, so
//      a warpgroup ahead of the others never waits on a later fill of the
//      same stage).  A warpgroup refills the stage it has just used with
//      item i + 5 itself, after a barrier of its own 4 warps: nothing
//      waits on another warpgroup to free a stage (a single filling thread
//      that did so left the ring, and the products, waiting on it).  The
//      attention buffers and the ring share memory (stages clear of the
//      buffers are filled at the start).  Once every warpgroup is done
//      with context chunk c (an mbarrier per chunk), warpgroup 3's thread
//      0 loads the residual's chunk c over it by TMA (rows past the
//      output's end read as zero).
//   3. LayerNorm from the accumulators: res added, the row sums across
//      the warpgroups through shared memory (the mean, then the squared
//      deviations), f32 statistics, eps.  The ring, free by then, takes
//      gamma, beta and each thread's second row, so that one row's 48
//      values at a time are in registers: with all 96 and the row's loads
//      the body spilled, and with 224 KB of shared memory a spill goes to
//      L2.  The bf16 rows are written over the residual in shared memory
//      and stored by TMA, 12 boxes of 64 x 64 (rows past the output's end
//      are clipped).  0 bytes spilled at every kNP (chip_smoke.py's build
//      report).
// Tried on the H100 and dropped: a cluster of 2 or 4 row blocks sharing
// each W load by TMA multicast (slower at every shape: each stage's
// refill then waits on the slowest block of the cluster); ring stages of
// 16 rows of all 768 columns (12 boxes of 2 KB) refilled by one thread
// (the W stream then ran several times slower); three K / V
// buffers a warpgroup with windows of at most 80 keys, so that the next
// window's K and V both load during the current one (no faster: the
// attention phase streams K and V at device-memory rate, all blocks
// reading at once).
//
// f32 (epilogue_f32): the same function on the CUDA cores for the check at
// 1e-4: 16 rows a block, every head's context in shared memory, the
// projection with W read from L2, the LayerNorm by warps.  It is not timed.
//
// What bounds it on an H100: at LXMERT's shapes and batch 384 a call moves
// 60-110 MB and does 9-17 GFLOP (mostly the projection), so bytes bound
// it (18-32 us) ahead of the tensor cores (9-17 us).  Every block reads
// all of W (1.18 MB) from L2: 141.6-254.8 MB a call at batch 384.
//
// Limits: E = 768 (12 heads of 64); Sq, Skv <= 64; f32 and bf16.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime (no -lcuda)

#include "attention_common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kEpiE = 768;
constexpr int kEpiDim = 64;
constexpr int kEpiHeads = kEpiE / kEpiDim;
constexpr size_t kSmemMax = 232448;  // 227 KB, the most a block may take

// ---- bf16: wgmma ----

constexpr int kEpiRows = 64;                          // a block's output rows: wgmma's M
constexpr int kEpiWG = 4;                             // warpgroups a block
constexpr int kEpiThreads = kEpiWG * kMmaThreads;
constexpr int kColAtoms = kEpiE / kEpiWG / 64;        // 64-column atoms of a warpgroup's 192 columns
constexpr int kMaxWindowKeys = 96;                    // a window's keys, padded (registers: S is kNP / 2 a thread)
constexpr int kKBlock = 64;                           // W rows a ring item holds: one context chunk, 4 k steps
constexpr int kItems = kEpiE / kKBlock * kEpiWG;      // items: (K block, warpgroup), the warpgroup fastest
constexpr int kStages = 5;                            // the W ring
constexpr uint32_t kSwizzlePeriod = 1024;             // bytes: 8 swizzled rows
constexpr uint32_t kRowBytes = 128;                   // one swizzled row: 64 bf16
constexpr uint32_t kChunkBytes = kEpiRows * kRowBytes;  // 64 rows of 64 columns
constexpr uint32_t kCtxBytes = kChunkBytes * kEpiHeads;
constexpr uint32_t kBoxBytes = kKBlock * kRowBytes;   // one TMA box of W: 64 rows x 64 columns
constexpr uint32_t kStageBytes = kBoxBytes * kColAtoms;  // an item: a warpgroup's 192 columns
constexpr uint32_t kRingBytes = kStageBytes * kStages;
static_assert(kEpiHeads % kEpiWG == 0, "each warpgroup takes as many heads");
static_assert(kItems >= kStages, "the ring is filled from W's first items");
static_assert((kItems + 1 + kEpiHeads) * 8 <= 512, "the mbarriers fit their 512 bytes");

struct EpiArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;  // (B, Skv)
  const void* res;    // contiguous (B Sq, E)
  const void* w;      // contiguous (E, E), (in, out)
  const float* wb;
  const float* gamma;
  const float* beta;
  void* out;          // contiguous (B Sq, E)
  int batch, sq, skv;
  int spw;            // bf16: segments a window (epilogue_exp.epi_plan)
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs;
  float scale, eps;
};

// The rows [r0, r0 + rows) of the flattened output a block owns, and the
// batch rows they span (none for a block past the end).
struct EpiRows {
  long long r0;
  int rows, b_first, segments;
};

__device__ __forceinline__ EpiRows epi_rows(const EpiArgs& a, int per_block) {
  EpiRows r;
  const long long total = static_cast<long long>(a.batch) * a.sq;
  r.r0 = static_cast<long long>(blockIdx.x) * per_block;
  r.rows = static_cast<int>(max(0LL, min(static_cast<long long>(per_block), total - r.r0)));
  r.b_first = static_cast<int>(r.r0 / a.sq);
  r.segments = r.rows > 0 ? static_cast<int>((r.r0 + r.rows - 1) / a.sq) - r.b_first + 1 : 0;
  return r;
}

// Segment s of a block: batch row b, its query rows [i0, i0 + rows), which
// are the block's rows [c0, c0 + rows).
struct Segment {
  int b, i0, rows, c0;
};

__device__ __forceinline__ Segment segment(const EpiArgs& a, const EpiRows& r, int s) {
  Segment g;
  g.b = r.b_first + s;
  const long long row0 = static_cast<long long>(g.b) * a.sq;
  const long long lo = max(r.r0, row0), hi = min(r.r0 + r.rows, row0 + a.sq);
  g.i0 = static_cast<int>(lo - row0);
  g.rows = static_cast<int>(hi - lo);
  g.c0 = static_cast<int>(lo - r.r0);
  return g;
}

// bf16 shared memory (from a 1024-byte boundary): the 64 x 768 tile
// (kCtxBytes), then a region that the ring of W items (kRingBytes), the
// attention buffers before it and the LayerNorm's gamma, beta and second
// rows after it share, the attention buffers at its end: per warpgroup K
// and V (kNP swizzled rows each) and two bias rows (kNP f32 each),
// rounded to the swizzle's period; then the mbarriers (kItems full, the
// residual's, kEpiHeads context chunks done: 512 bytes) and the
// LayerNorm's partial sums (2 x kEpiWG x kEpiRows f32).  `prefetch` ring
// stages lie clear of the attention buffers.
struct EpiLayout {
  uint32_t attn_off, wg_bytes, bar_off, part_off, bytes;
  int prefetch;
};

__host__ __device__ inline EpiLayout epi_layout(int np) {
  EpiLayout L;
  L.wg_bytes = (2 * kRowBytes * np + 2 * sizeof(float) * np + kSwizzlePeriod - 1) / kSwizzlePeriod *
               kSwizzlePeriod;
  const uint32_t attn = L.wg_bytes * kEpiWG;
  const uint32_t region = attn > kRingBytes ? attn : kRingBytes;
  L.attn_off = kCtxBytes + region - attn;
  const int clear = static_cast<int>((L.attn_off - kCtxBytes) / kStageBytes);
  L.prefetch = clear < kStages ? clear : kStages;
  L.bar_off = kCtxBytes + region;
  L.part_off = L.bar_off + 512;
  L.bytes = L.part_off + 2 * kEpiWG * kEpiRows * sizeof(float);
  return L;
}

// As launched: one swizzle period more, so that the kernel can align.
size_t epi_smem_bytes(int np) { return epi_layout(np).bytes + kSwizzlePeriod; }

// ---- mbarriers and TMA (inline PTX) ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Arrive, and expect `bytes` more of TMA transfers in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// Until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Whether the phase of parity `parity` has completed (no waiting).
__device__ __forceinline__ bool mbar_test(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The box at (x, y) (elements along the rows, rows) of a 2D tensor map into
// dst (1024-byte aligned), completing its bytes on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}

// The box at src (1024-byte aligned shared memory) to (x, y) of the map's
// tensor; rows past its end are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int x, int y) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(x), "r"(y)
               : "memory");
}

__device__ __forceinline__ void tma_store_drain() {
  asm volatile("cp.async.bulk.commit_group;\ncp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Barrier of warpgroup wg's 128 threads (named barrier 1 + wg; 0 is
// __syncthreads').
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kMmaThreads) : "memory");
}

__device__ __forceinline__ float2 bf16_pair(const void* p) {
  const uint32_t x = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(x & 0xFFFFu))),
                     __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(x >> 16))));
}

// One 16-byte piece (c = 0..7 of a 128-byte row) of a bf16 source into a
// swizzled row of dst: cp.async when the source allows 16-byte copies.
__device__ __forceinline__ void piece16(unsigned char* dst, const __nv_bfloat16* src, bool vec) {
  if (vec) {
    cp_async16(dst, src);
  } else {
    __nv_bfloat16* d = reinterpret_cast<__nv_bfloat16*>(dst);
    for (int e = 0; e < 8; ++e) d[e] = src[e];
  }
}

// The keys of a window (segments b0, b0 + 1, ... of skv keys each, nk in
// all) of one head (src at the head's first column) into np swizzled rows
// at dst, zero past nk: thread t (of a warpgroup) takes piece t % 8 of rows
// t / 8, + 16, ..., stepping the row's segment rather than dividing.
__device__ __forceinline__ void load_window(unsigned char* dst, const __nv_bfloat16* src, long long bs,
                                            long long rs, int b0, int skv, int nk, int np, int t,
                                            bool vec) {
  constexpr int kStep = kMmaThreads / 8;
  const int c = t & 7;
  int r = t >> 3, sb = r / skv, kk = r - sb * skv;
  for (; r < np; r += kStep) {
    unsigned char* d = dst + r * kRowBytes + ((c ^ (r & 7)) << 4);
    if (r < nk) {
      piece16(d, src + static_cast<long long>(b0 + sb) * bs + kk * rs + c * 8, vec);
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
    for (kk += kStep; kk >= skv; kk -= skv) ++sb;
  }
}

template <int kNP>
__global__ void __launch_bounds__(kEpiThreads, 1)
    epilogue_bf16(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap rmap,
                  const __grid_constant__ CUtensorMap omap, EpiArgs a) {
  static_assert(kNP % 16 == 0 && kNP <= kMaxWindowKeys, "a window is whole 16-key steps");
  constexpr int kNT = kNP / 8;   // 8-key column tiles of S
  constexpr int kKS = kNP / 16;  // 16-key steps of P V
  extern __shared__ __align__(16) unsigned char smem_raw[];  // aligned to the swizzle's period below
  unsigned char* smem = smem_raw + ((kSwizzlePeriod - smem_u32(smem_raw) % kSwizzlePeriod) % kSwizzlePeriod);
  const EpiLayout L = epi_layout(kNP);
  unsigned char* ring = smem + kCtxBytes;
  // mbarriers, each used once (phase 0): full[i] item i has landed; the
  // residual has landed; cdone[c] every warpgroup is done with context chunk c.
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar_off);
  uint64_t* resbar = full + kItems;
  uint64_t* cdone = resbar + 1;
  float* part = reinterpret_cast<float*>(smem + L.part_off);  // [2][kEpiWG][kEpiRows]
  const int tid = threadIdx.x, wg = tid / kMmaThreads, t = tid % kMmaThreads;
  const int lane = tid & 31, warp = t >> 5, g = lane >> 2, tq = (lane & 3) * 2;
  const EpiRows R = epi_rows(a, kEpiRows);
  const int r0 = static_cast<int>(R.r0);  // the launch keeps every row index below 2^31
  const int sq = a.sq, skv = a.skv;

  if (tid == 0) {
    for (int i = 0; i < kItems; ++i) mbar_init(full + i, 1);
    mbar_init(resbar, 1);
    for (int c = 0; c < kEpiHeads; ++c) mbar_init(cdone + c, kEpiWG);
    fence_mbarrier_init();
  }
  __syncthreads();

  // Item i of W into stage i % kStages: rows 64 (i / 4) .. + 63 of
  // warpgroup i % 4's 192 columns, three 64 x 64 boxes.
  const auto fill = [&](int i) {
    const int st = i % kStages;
    mbar_expect_tx(full + i, kStageBytes);
    for (int box = 0; box < kColAtoms; ++box) {
      tma_load(ring + st * kStageBytes + box * kBoxBytes, &wmap, 64 * (kColAtoms * (i % kEpiWG) + box),
               kKBlock * (i / kEpiWG), full + i);
    }
  };
  if (tid == 0) {
    for (int i = 0; i < L.prefetch; ++i) fill(i);
  }

  // The block's queries into the tile (chunk h: head h), zero past its
  // rows; each warpgroup's first window.
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v);
  const bool qvec = ((a.q_bs | a.q_rs) & 7) == 0 && (reinterpret_cast<uintptr_t>(q) & 15) == 0;
  const bool kvec = ((a.k_bs | a.k_rs) & 7) == 0 && (reinterpret_cast<uintptr_t>(k) & 15) == 0;
  const bool vvec = ((a.v_bs | a.v_rs) & 7) == 0 && (reinterpret_cast<uintptr_t>(v) & 15) == 0;
  for (int p = tid; p < kEpiRows * kEpiHeads * 8; p += kEpiThreads) {
    const int row = p / (kEpiHeads * 8), h = p / 8 % kEpiHeads, c = p % 8;
    unsigned char* dst = smem + h * kChunkBytes + row * kRowBytes + ((c ^ (row & 7)) << 4);
    if (row < R.rows) {
      const int gr = r0 + row, b = gr / sq;
      piece16(dst, q + b * a.q_bs + (gr - b * sq) * a.q_rs + h * kEpiDim + c * 8, qvec);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // Unit u of this warpgroup: head wg + kEpiWG * (u / nwin), window u % nwin
  // (segments w spw .. w spw + spw - 1 of the block).
  const int nwin = (R.segments + a.spw - 1) / a.spw;
  const int units = kEpiHeads / kEpiWG * nwin;
  unsigned char* kbuf = smem + L.attn_off + wg * L.wg_bytes;
  unsigned char* vbuf = kbuf + kRowBytes * kNP;
  float* bbuf = reinterpret_cast<float*>(vbuf + kRowBytes * kNP);  // two rows of kNP
  const auto unit_head = [&](int u) { return wg + kEpiWG * (u / nwin); };
  const auto unit_s0 = [&](int u) { return u % nwin * a.spw; };
  const auto unit_keys = [&](int u) { return (min(unit_s0(u) + a.spw, R.segments) - unit_s0(u)) * skv; };
  // K and the bias of unit u (bias row u % 2), one cp.async group (empty past the last).
  const auto load_k = [&](int u) {
    if (u < units) {
      const int b0 = R.b_first + unit_s0(u), nk = unit_keys(u);
      load_window(kbuf, k + unit_head(u) * kEpiDim, a.k_bs, a.k_rs, b0, skv, nk, kNP, t, kvec);
      float* bs = bbuf + (u & 1) * kNP;
      for (int j = t; j < nk; j += kMmaThreads) cp_async4(bs + j, a.bias + static_cast<long long>(b0) * skv + j);
    }
    cp_async_commit();
  };
  const auto load_v = [&](int u) {
    if (u < units) {
      load_window(vbuf, v + unit_head(u) * kEpiDim, a.v_bs, a.v_rs, R.b_first + unit_s0(u), skv, unit_keys(u),
                  kNP, t, vvec);
    }
    cp_async_commit();
  };
  load_k(0);  // the queries ride in this group
  load_v(0);
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();

  // 1. Attention.  A thread holds rows i0 = 16 warp + g and i0 + 8 of the
  // block (e >= 2: i0 + 8), keys 8 n + tq + (e & 1) in s[4 n + e], head
  // columns likewise in o; seg: the block's segment of each row.
  const int i0 = warp * 16 + g;
  int seg[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = i0 + 8 * half;
    seg[half] = i < R.rows ? (r0 + i) / sq - R.b_first : -1;
  }
  for (int u = 0; u < units; ++u) {
    const int h = unit_head(u), s0 = unit_s0(u), s1 = min(s0 + a.spw, R.segments);
    unsigned char* chunk = smem + h * kChunkBytes;

    // S = Q_h K^T: every row of the block against the window's keys.
    float s[4 * kNT];
#pragma unroll
    for (int i = 0; i < 4 * kNT; ++i) s[i] = 0.f;
    const uint64_t dq = wgmma_desc_sw128(chunk), dk = wgmma_desc_sw128(kbuf);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kEpiDim / 16; ++kk) WgmmaSS<kNP>::mma(s, dq + 2 * kk, dk + 2 * kk, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(s);
    wg_sync(wg);  // every warp is done with K
    load_k(u + 1);

    // The row softmax over the keys of the row's own segment (lo .. lo +
    // skv - 1 of the window); a row outside the window gets P = 0.
    const float* bs = bbuf + (u & 1) * kNP;
    int lo[2];
    bool in[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      in[half] = seg[half] >= s0 && seg[half] < s1;
      lo[half] = in[half] ? (seg[half] - s0) * skv : -2 * kMaxSeq;
    }
    float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = n * 8 + tq + (e & 1), l = lo[e >> 1];
        const float x = j >= l && j < l + skv ? s[4 * n + e] * a.scale + bs[j] : -CUDART_INF_F;
        s[4 * n + e] = x;
        if (e < 2) m0 = fmaxf(m0, x); else m1 = fmaxf(m1, x);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
    }
    m0 = in[0] ? m0 : 0.f;
    m1 = in[1] ? m1 : 0.f;
    // P = exp(S - m), unnormalised (as #2's body), rounded to bf16 into the
    // A fragments of P V as it is made, so the scores die as P grows: keys
    // 16 c .. 16 c + 15 are the accumulators of column tiles 2 c, 2 c + 1.
    // O / l at the end.
    float l0 = 0.f, l1 = 0.f;
    uint32_t pa[kKS][4];
#pragma unroll
    for (int c = 0; c < kKS; ++c) {
      float p[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        p[e] = __expf(s[8 * c + e] - ((e & 2) ? m1 : m0));  // 0 off the row's segment
        if (e & 2) l1 += p[e]; else l0 += p[e];
      }
      pa[c][0] = pack_f32_pair(p[0], p[1]);
      pa[c][1] = pack_f32_pair(p[2], p[3]);
      pa[c][2] = pack_f32_pair(p[4], p[5]);
      pa[c][3] = pack_f32_pair(p[6], p[7]);
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = in[0] ? 1.f / l0 : 0.f, inv1 = in[1] ? 1.f / l1 : 0.f;  // a row's max term is 1

    // O = P V once V has landed (the group before K's).
    cp_async_wait_group<1>();
    fence_proxy_async();
    wg_sync(wg);
    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    const uint64_t dv = wgmma_desc_sw128(vbuf);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kKS; ++c) WgmmaRS64::mma(o, pa[c], dv + c * 16 * 8, 1);  // 16 rows down
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(o);
    fence_operands(pa);

    // The window's rows of o_h over their queries in chunk h.
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (!in[half]) continue;
      const int i = i0 + 8 * half;
      const float inv = half ? inv1 : inv0;
#pragma unroll
      for (int n = 0; n < kEpiDim / 8; ++n) {
        *reinterpret_cast<uint32_t*>(chunk + i * kRowBytes + ((n ^ (i & 7)) << 4) + tq * 2) =
            pack_f32_pair(o[4 * n + 2 * half] * inv, o[4 * n + 2 * half + 1] * inv);
      }
    }
    wg_sync(wg);  // every warp is done with V
    load_v(u + 1);
    cp_async_wait_group<1>();  // the next K and its bias
    fence_proxy_async();       // and this thread's context rows, for wgmma
    wg_sync(wg);
  }
  __syncthreads();  // the attention buffers are free for the ring
  if (tid == 0) {
    for (int i = L.prefetch; i < kStages; ++i) fill(i);
  }

  // 2. acc = ctx W: this warpgroup's 192 columns, its items wg, wg + 4, ...
  // (context chunk kb against W's rows 64 kb .. 64 kb + 63), 4 k steps an
  // item.  Once its products on item i are done, the warpgroup itself
  // refills the stage with item i + kStages (its thread 0 issues the TMA
  // after a barrier of its 4 warps): no thread waits for another
  // warpgroup to free a stage.  Each warpgroup arrives on cdone[kb] after
  // its item on chunk kb; warpgroup 3's thread 0 loads the residual's
  // chunk c over context chunk c once every warpgroup has arrived
  // (polling after each of its items, waiting at the end).
  int res_next = 0;  // warpgroup 3's thread 0: the next residual chunk to load
  const auto load_res = [&](bool wait) {
    while (res_next < kEpiHeads && (wait || mbar_test(cdone + res_next, 0))) {
      mbar_wait(cdone + res_next, 0);
      if (res_next == 0) mbar_expect_tx(resbar, kCtxBytes);
      tma_load(smem + res_next * kChunkBytes, &rmap, 64 * res_next, r0, resbar);
      ++res_next;
    }
  };
  // The accumulators start at b (element 4 n + e: column wg 192 + 8 n + tq
  // + (e & 1)), so that y = acc + res after the products.
  float acc[96];
#pragma unroll
  for (int n = 0; n < 24; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[4 * n + e] = __ldg(a.wb + wg * kColAtoms * 64 + 8 * n + tq + (e & 1));
  }
  const uint64_t da0 = wgmma_desc_sw128(smem);
  for (int kb = 0; kb < kEpiE / kKBlock; ++kb) {
    const int i = kb * kEpiWG + wg, st = i % kStages;
    mbar_wait(full + i, 0);
    const uint64_t db = wgmma_desc_sw128_mn(ring + st * kStageBytes, kBoxBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKBlock / 16; ++kk) {
      WgmmaSST192::mma(acc, da0 + kb * (kChunkBytes >> 4) + 2 * kk, db + kk * (16 * kRowBytes >> 4), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    wg_sync(wg);  // the warpgroup's products on the stage are done
    if (t == 0) {
      if (i + kStages < kItems) fill(i + kStages);
      mbar_arrive(cdone + kb);
      if (wg == kEpiWG - 1) load_res(false);
    }
  }
  fence_operands(acc);
  if (wg == kEpiWG - 1 && t == 0) load_res(true);

  // 3. LayerNorm.  y = acc + res; element 4 n + e of acc is row i0 + 8 (e /
  // 2), column wg 192 + 8 n + tq + (e & 1); res (then out) at that element
  // of the tile's chunks.  The ring is free: it takes gamma and beta, and
  // each thread's second row (e >= 2), so that one row at a time is in
  // registers (96 accumulators and the row's loads leave too few of the
  // 128 registers otherwise, and with 224 KB of shared memory a spill goes
  // to L2).
  __syncthreads();  // every warp is done with the ring
  float* vec = reinterpret_cast<float*>(ring);  // [2][kEpiE]: gamma, beta
  float2* stash = reinterpret_cast<float2*>(ring + 2 * kEpiE * sizeof(float));  // [24][kEpiThreads]
  for (int i = tid; i < 2 * kEpiE; i += kEpiThreads) vec[i] = i < kEpiE ? a.gamma[i] : a.beta[i - kEpiE];
#pragma unroll
  for (int n = 0; n < 24; ++n) stash[n * kEpiThreads + tid] = make_float2(acc[4 * n + 2], acc[4 * n + 3]);
  __syncthreads();
  mbar_wait(resbar, 0);
  // Column 8 n + tq of the thread's rows is in chunk wg 3 + n / 8, piece
  // (n % 8) ^ g of the row (i & 7 = g): an address from a row base and one
  // xor.
  unsigned char* row0 = smem + wg * kColAtoms * kChunkBytes + i0 * kRowBytes + tq * 2;
  const uint32_t gx = static_cast<uint32_t>(g) << 4;
  const auto at = [&](int n, int half) {
    return row0 + half * 8 * kRowBytes + (n >> 3) * kChunkBytes + (((n & 7) << 4) ^ gx);
  };
  const float* vg = vec + wg * kColAtoms * 64 + tq;  // gamma of column 8 n + tq at vg[8 n], beta kEpiE on
  float* sums = part;                       // [kEpiWG][kEpiRows]
  float* devs = part + kEpiWG * kEpiRows;   // likewise
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = i0 + 8 * half;
    if (half == 1) {
#pragma unroll
      for (int n = 0; n < 24; ++n) {
        const float2 y = stash[n * kEpiThreads + tid];
        acc[4 * n] = y.x;
        acc[4 * n + 1] = y.y;
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < 24; ++n) {
      const float2 r2 = bf16_pair(at(n, half));
      acc[4 * n] += r2.x;
      acc[4 * n + 1] += r2.y;
      sum += acc[4 * n] + acc[4 * n + 1];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if ((lane & 3) == 0) sums[wg * kEpiRows + i] = sum;
    __syncthreads();
    sum = 0.f;
#pragma unroll
    for (int w2 = 0; w2 < kEpiWG; ++w2) sum += sums[w2 * kEpiRows + i];
    const float mean = sum / kEpiE;
    float dev = 0.f;
#pragma unroll
    for (int n = 0; n < 24; ++n) {
      const float d0 = acc[4 * n] - mean, d1 = acc[4 * n + 1] - mean;
      dev += d0 * d0 + d1 * d1;
    }
    dev += __shfl_xor_sync(0xffffffffu, dev, 1);
    dev += __shfl_xor_sync(0xffffffffu, dev, 2);
    if ((lane & 3) == 0) devs[wg * kEpiRows + i] = dev;
    __syncthreads();
    float var = 0.f;
#pragma unroll
    for (int w2 = 0; w2 < kEpiWG; ++w2) var += devs[w2 * kEpiRows + i];
    const float rstd = rsqrtf(var / kEpiE + a.eps);
#pragma unroll
    for (int n = 0; n < 24; ++n) {
      const float2 g2 = *reinterpret_cast<const float2*>(vg + 8 * n);
      const float2 e2 = *reinterpret_cast<const float2*>(vg + kEpiE + 8 * n);
      const float z0 = (acc[4 * n] - mean) * rstd * g2.x + e2.x;
      const float z1 = (acc[4 * n + 1] - mean) * rstd * g2.y + e2.y;
      *reinterpret_cast<uint32_t*>(at(n, half)) = pack_f32_pair(z0, z1);
    }
  }
  fence_proxy_async();
  __syncthreads();
  if (tid == 0 && R.rows > 0) {
    for (int c = 0; c < kEpiHeads; ++c) tma_store(&omap, smem + c * kChunkBytes, 64 * c, r0);
    tma_store_drain();
  }
}

// f32: 16 rows a block, 256 threads.  Shared memory, f32: the rows'
// context, later y (16 x E); Q (16 x 65), K, V (skv x 65), S/P (16 x
// (skv + 1)), the bias row (skv).
constexpr int kEpiF32Rows = 16;
constexpr int kEpiF32Threads = 256;
constexpr int kEpiF32Cols = kEpiE / kEpiF32Threads;  // columns per thread

size_t epi_f32_bytes(int skv) {
  const int ld = kEpiDim + 1;
  return sizeof(float) *
         (kEpiF32Rows * kEpiE + kEpiF32Rows * ld + 2 * skv * ld + kEpiF32Rows * (skv + 1) + skv);
}

__global__ void __launch_bounds__(kEpiF32Threads) epilogue_f32(EpiArgs a) {
  extern __shared__ float smem[];
  const int ld = kEpiDim + 1, skv = a.skv, ldp = skv + 1;
  float* ctx = smem;
  float* qs = ctx + kEpiF32Rows * kEpiE;
  float* ks = qs + kEpiF32Rows * ld;
  float* vs = ks + skv * ld;
  float* ps = vs + skv * ld;
  float* bs = ps + kEpiF32Rows * ldp;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, warps = kEpiF32Threads / 32;
  const EpiRows R = epi_rows(a, kEpiF32Rows);
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);

  for (int i = tid; i < kEpiF32Rows * kEpiE; i += kEpiF32Threads) ctx[i] = 0.f;
  Args t{};
  t.skv = skv;
  t.dim = kEpiDim;
  t.scale = a.scale;
  for (int h = 0; h < kEpiHeads; ++h) {
    for (int s = 0; s < R.segments; ++s) {
      const Segment g = segment(a, R, s);
      load_rows_f32(qs, ld, q + g.b * a.q_bs + g.i0 * a.q_rs + h * kEpiDim, a.q_rs, g.rows,
                    kEpiDim, tid, kEpiF32Threads);
      load_rows_f32(ks, ld, k + g.b * a.k_bs + h * kEpiDim, a.k_rs, skv, kEpiDim, tid,
                    kEpiF32Threads);
      load_rows_f32(vs, ld, v + g.b * a.v_bs + h * kEpiDim, a.v_rs, skv, kEpiDim, tid,
                    kEpiF32Threads);
      for (int j = tid; j < skv; j += kEpiF32Threads) bs[j] = a.bias[g.b * skv + j];
      __syncthreads();
      t.sq = g.rows;
      scores_f32(ps, ldp, qs, ks, ld, bs, t, tid, kEpiF32Threads);
      __syncthreads();
      softmax_rows(ps, ldp, g.rows, skv, g.rows, skv, warp, warps, lane,
                   [&](int i, int j, float p) { ps[i * ldp + j] = p; });
      __syncthreads();
      for (int idx = tid; idx < g.rows * kEpiDim; idx += kEpiF32Threads) {
        const int i = idx / kEpiDim, c = idx % kEpiDim;
        float o = 0.f;
        for (int j = 0; j < skv; ++j) o = fmaf(ps[i * ldp + j], vs[j * ld + c], o);
        ctx[(g.c0 + i) * kEpiE + h * kEpiDim + c] = o;
      }
      __syncthreads();
    }
  }

  // y = ctx W + b + res, each thread kEpiF32Cols columns of all 16 rows.
  const float* w = static_cast<const float*>(a.w);
  float acc[kEpiF32Rows][kEpiF32Cols];
#pragma unroll
  for (int r = 0; r < kEpiF32Rows; ++r)
#pragma unroll
    for (int j = 0; j < kEpiF32Cols; ++j) acc[r][j] = 0.f;
  for (int kk = 0; kk < kEpiE; ++kk) {
    float wk[kEpiF32Cols];
#pragma unroll
    for (int j = 0; j < kEpiF32Cols; ++j) wk[j] = w[kk * kEpiE + tid + j * kEpiF32Threads];
#pragma unroll
    for (int r = 0; r < kEpiF32Rows; ++r) {
      const float c = ctx[r * kEpiE + kk];
#pragma unroll
      for (int j = 0; j < kEpiF32Cols; ++j) acc[r][j] = fmaf(c, wk[j], acc[r][j]);
    }
  }
  __syncthreads();
  const float* res = static_cast<const float*>(a.res) + R.r0 * kEpiE;
  for (int r = 0; r < R.rows; ++r) {
#pragma unroll
    for (int j = 0; j < kEpiF32Cols; ++j) {
      const int col = tid + j * kEpiF32Threads;
      ctx[r * kEpiE + col] = acc[r][j] + a.wb[col] + res[r * kEpiE + col];
    }
  }
  __syncthreads();

  float* out = static_cast<float*>(a.out) + R.r0 * kEpiE;
  for (int r = warp; r < R.rows; r += warps) {
    const float* y = ctx + r * kEpiE;
    float sum = 0.f;
    for (int c = lane; c < kEpiE; c += 32) sum += y[c];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mean = sum / kEpiE;
    float dev = 0.f;
    for (int c = lane; c < kEpiE; c += 32) dev += (y[c] - mean) * (y[c] - mean);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dev += __shfl_xor_sync(0xffffffffu, dev, o);
    const float rstd = rsqrtf(dev / kEpiE + a.eps);
    for (int c = lane; c < kEpiE; c += 32) out[r * kEpiE + c] = (y[c] - mean) * rstd * a.gamma[c] + a.beta[c];
  }
}


template <typename Kernel>
int launch_epi(Kernel kernel, const EpiArgs& a, int rows_per_block, int threads, size_t smem,
               cudaStream_t stream) {
  if (smem > kSmemMax) return -1;
  if (const int err = allow_smem(kernel, smem)) return err;
  const long long rows = static_cast<long long>(a.batch) * a.sq;
  const unsigned blocks = static_cast<unsigned>((rows + rows_per_block - 1) / rows_per_block);
  kernel<<<blocks, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16 launch: tensor maps and the body for a window of np keys ----

// libcuda's cuTensorMapEncodeTiled, reached through the runtime (the
// library is not linked against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                      : nullptr;
  }();
  return fn;
}

constexpr int kNoEncoder = -2;   // libcuda has no cuTensorMapEncodeTiled
constexpr int kMapRefused = -3;  // it refused a tensor map

// A contiguous (rows, 768) bf16 tensor at base, read or written in boxes of
// box_rows x 64 in the 128-byte swizzle (rows past the end read as zero).
int map_rows(CUtensorMap* map, const void* base, long long rows, unsigned box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kNoEncoder;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kEpiE), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {sizeof(__nv_bfloat16) * kEpiE};
  const cuuint32_t box[2] = {64, box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
                            step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kMapRefused;
}

template <int kNP>
int launch_bf16(const EpiArgs& a, int np, cudaStream_t stream) {
  if constexpr (kNP < kMaxWindowKeys) {
    if (np > kNP) return launch_bf16<kNP + 16>(a, np, stream);
  }
  CUtensorMap maps[3];
  const long long rows = static_cast<long long>(a.batch) * a.sq;
  if (rows > (1LL << 31) - kEpiRows) return -1;  // row indices (and TMA's coordinates) are 32-bit
  if (int err = map_rows(&maps[0], a.w, kEpiE, kKBlock)) return err;
  if (int err = map_rows(&maps[1], a.res, rows, kEpiRows)) return err;
  if (int err = map_rows(&maps[2], a.out, rows, kEpiRows)) return err;
  const auto kernel = epilogue_bf16<kNP>;
  const size_t smem = epi_smem_bytes(kNP);
  if (smem > kSmemMax) return -1;
  if (const int err = allow_smem(kernel, smem)) return err;
  const unsigned blocks = static_cast<unsigned>((rows + kEpiRows - 1) / kEpiRows);
  kernel<<<blocks, kEpiThreads, smem, stream>>>(maps[0], maps[1], maps[2], a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, res, w and the output; bias,
// b, gamma, beta f32).  Strides of q, k, v in elements, their last
// dimension contiguous; res, w and the output contiguous (bf16: 16-byte
// aligned).  spw, np: the bf16 body's segments a window and its window's
// keys padded to 16 (epilogue_exp.epi_plan; the f32 body takes neither).
// Returns the
// cudaError_t of the launch (0 on success); negative for arguments
// outside the kernel's limits (-1) or a tensor map libcuda cannot
// encode (-2, -3).
int rgqa_epilogue(
    const void* q, const void* k, const void* v, const void* bias, const void* res,
    const void* w, const void* wb, const void* gamma, const void* beta, void* out,
    int dtype, int batch, int sq, int skv, int heads, int dim, int spw, int np,
    long long q_bs, long long q_rs, long long k_bs, long long k_rs,
    long long v_bs, long long v_rs, float scale, float eps, void* stream) {
  if (!within_limits(batch, sq, skv, heads, dim) || heads != kEpiHeads || dim != kEpiDim) {
    return -1;
  }
  EpiArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = static_cast<const float*>(bias);
  a.res = res;
  a.w = w;
  a.wb = static_cast<const float*>(wb);
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.out = out;
  a.batch = batch;
  a.sq = sq;
  a.skv = skv;
  a.spw = spw;
  a.q_bs = q_bs;
  a.q_rs = q_rs;
  a.k_bs = k_bs;
  a.k_rs = k_rs;
  a.v_bs = v_bs;
  a.v_rs = v_rs;
  a.scale = scale;
  a.eps = eps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const bool aligned = (reinterpret_cast<uintptr_t>(res) | reinterpret_cast<uintptr_t>(w) |
                          reinterpret_cast<uintptr_t>(out)) % 16 == 0;
    if (spw < 1 || np % 16 != 0 || np < 16 || np > kMaxWindowKeys || spw * skv > np || !aligned) return -1;
    return launch_bf16<16>(a, np, s);
  }
  if (dtype == 0) return launch_epi(epilogue_f32, a, kEpiF32Rows, kEpiF32Threads, epi_f32_bytes(skv), s);
  return -1;
}

const char* rgqa_cuda_error_string(int err) {
  switch (err) {
    case -1: return "argument outside the kernel's limits";
    case kNoEncoder: return "libcuda has no cuTensorMapEncodeTiled";
    case kMapRefused: return "cuTensorMapEncodeTiled refused a tensor map";
    default: return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}

}  // extern "C"
