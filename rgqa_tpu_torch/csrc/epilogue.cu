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
// kernel's own (mma.sync in bf16), not a library GEMM.
//
// Design (bf16, epilogue_bf16): LayerNorm needs whole rows, so a block owns
// kEpiRows = 64 consecutive rows of the flattened (B Sq, E) output, which
// may span several batch rows ("segments"); packing rows rather than batch
// rows keeps every block full and cuts the re-reads of W (1.18 MB in bf16,
// read once per block from L2: ~140-250 MB at batch 384, against ~60-110
// MB of inputs and outputs in device memory).  Two phases:
//   1. attention: four groups of 4 warps share out the (head, segment)
//      tasks, each group behind barriers of its own, and run the short
//      kernel's bf16 body on each
//      (attention_common.cuh: Q, K, V tiles by cp.async, S and P through
//      shared memory, P in bf16, O = P V on the tensor cores), writing
//      o_h into the block's 64 x 768 bf16 context in shared memory; so no
//      head's context reaches device memory, and no accumulator is live;
//   2. projection: the 64 x 768 x 768 product of the context and W on the
//      tensor cores (ldmatrix fragments, mma.sync), W streamed through a
//      ring of two 32-row slices by cp.async (the next slice lands while
//      this one is multiplied), into a 64 x 768 f32 accumulator in
//      registers, 48 columns per warp (4 x 6 mma tiles).
// Then each thread adds b and res to its values, the row sums cross the
// warps through shared memory (two passes: the mean, then the squared
// deviations), and the normalised rows are written once, in bf16.  The
// attention scratch and the W ring share their shared memory.
//
// f32 (epilogue_f32): the same function on the CUDA cores for the check at
// 1e-4: 16 rows a block, every head's context in shared memory, the
// projection with W read from L2, the LayerNorm by warps.  It is not timed.
//
// What bounds it on an H100: at LXMERT's shapes and batch 384 a call moves
// 60-110 MB and does 9-17 GFLOP (mostly the projection), so bytes bound
// it (18-32 us) ahead of the tensor cores (9-17 us); the re-reads of W come
// from L2.  Measured, it runs at ~8-10x that bound, most of it in the
// attention phase, which is latency-bound: one block of 16 warps per SM
// runs the short kernel's barrier-separated body (PERF.md section 6).  A
// first version interleaved the heads' attention with their projections,
// kept the accumulator live throughout, spilled it at the 128-register cap
// and ran 2x slower; synchronising the attention groups apart made the
// phases of the four groups overlap (1.06-1.22x).
//
// Limits: E = 768 (12 heads of 64); Sq, Skv <= 64; f32 and bf16.

#include "attention_common.cuh"

namespace {

constexpr int kEpiE = 768;
constexpr int kEpiDim = 64;
constexpr int kEpiHeads = kEpiE / kEpiDim;
constexpr int kEpiWarps = 16;
constexpr int kEpiThreads = kEpiWarps * 32;
constexpr int kEpiGroups = kEpiWarps / kMmaWarps;  // attention groups of 4 warps
constexpr int kEpiMT = 4;                          // 16-row mma tiles per block
constexpr int kEpiRows = 16 * kEpiMT;
constexpr int kEpiNT = kEpiE / kEpiWarps / 8;      // 8-column mma tiles per warp
constexpr int kEpiLd = kEpiE + 8;                  // row stride (elements) of the context and W slices
constexpr int kEpiSlice = 32;                      // W rows per streamed slice
constexpr size_t kSmemMax = 232448;  // 227 KB, the most a block may take

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
  int batch, sq, skv, groups;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs;
  float scale, eps;
};

// The rows [r0, r0 + rows) of the flattened output a block owns, and the
// batch rows they span.
struct EpiRows {
  long long r0;
  int rows, b_first, segments;
};

__device__ __forceinline__ EpiRows epi_rows(const EpiArgs& a, int per_block) {
  EpiRows r;
  const long long total = static_cast<long long>(a.batch) * a.sq;
  r.r0 = static_cast<long long>(blockIdx.x) * per_block;
  r.rows = static_cast<int>(min(static_cast<long long>(per_block), total - r.r0));
  r.b_first = static_cast<int>(r.r0 / a.sq);
  r.segments = static_cast<int>((r.r0 + r.rows - 1) / a.sq) - r.b_first + 1;
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

// bf16 shared memory: the context (kEpiRows x kEpiLd), the LayerNorm
// partial sums (kEpiWarps x kEpiRows f32), then a region that the
// attention phase and the projection use in turn: per attention group Q,
// whose space P takes once the scores are out (SQP x 72, or SQP x (SKP +
// 8)), K, V (SKP x 72), S (sqs x (skv + 1) f32) and the bias row (skv
// f32), sqs = min(sq, kEpiRows); then the ring of two W slices
// (kEpiSlice x kEpiLd each).
struct EpiLayout {
  int sqs, skp, ldq, ldp;
  size_t k_off, v_off, s_off, b_off, group_bytes;  // within a group
  size_t part_off, u_off, bytes;
};

__host__ __device__ inline EpiLayout epi_layout(int sq, int skv, int groups) {
  EpiLayout L;
  L.sqs = sq < kEpiRows ? sq : kEpiRows;
  const int sqp = (L.sqs + 15) / 16 * 16;
  L.skp = (skv + 15) / 16 * 16;
  L.ldq = kEpiDim + 8;
  L.ldp = L.skp + 8;
  const size_t bf = sizeof(__nv_bfloat16), f = sizeof(float);
  const size_t q_bytes = bf * sqp * L.ldq, p_bytes = bf * sqp * L.ldp;
  L.k_off = align16(q_bytes > p_bytes ? q_bytes : p_bytes);
  L.v_off = L.k_off + bf * L.skp * L.ldq;
  L.s_off = L.v_off + bf * L.skp * L.ldq;
  L.b_off = align16(L.s_off + f * L.sqs * (skv + 1));
  L.group_bytes = align16(L.b_off + f * skv);
  L.part_off = bf * kEpiRows * kEpiLd;
  L.u_off = L.part_off + f * kEpiWarps * kEpiRows;
  const size_t attn = L.group_bytes * groups, ring = 2 * bf * kEpiSlice * kEpiLd;
  L.bytes = L.u_off + (attn > ring ? attn : ring);
  return L;
}

// Barrier of attention group grp's 4 warps (named barrier 1 + grp; 0 is
// __syncthreads').
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "n"(kMmaThreads) : "memory");
}

__device__ __forceinline__ float2 bf16_pair(const __nv_bfloat16* p) {
  const uint32_t x = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(x & 0xFFFFu))),
                     __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(x >> 16))));
}

__global__ void __launch_bounds__(kEpiThreads, 1) epilogue_bf16(EpiArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const EpiLayout L = epi_layout(a.sq, a.skv, a.groups);
  __nv_bfloat16* ctx = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* part = reinterpret_cast<float*>(smem_raw + L.part_off);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.u_off);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int grp = warp / kMmaWarps, gwarp = warp % kMmaWarps, gtid = tid % kMmaThreads;
  unsigned char* gsm = smem_raw + L.u_off + L.group_bytes * (grp < a.groups ? grp : 0);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(gsm);
  __nv_bfloat16* ps = qs;  // P overwrites Q once the scores are out
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(gsm + L.k_off);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(gsm + L.v_off);
  float* ss = reinterpret_cast<float*>(gsm + L.s_off);
  float* bs = reinterpret_cast<float*>(gsm + L.b_off);
  const EpiRows R = epi_rows(a, kEpiRows);
  const int tasks = kEpiHeads * R.segments;
  const int skv = a.skv;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(a.w);

  // Rows past the output's end (the last block) stay zero.
  for (int i = tid; i < kEpiRows * kEpiLd / 8; i += kEpiThreads) {
    reinterpret_cast<uint4*>(ctx)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  Args t{};
  t.skv = skv;
  t.scale = a.scale;

  // The rows past the output's end are zero before any group writes.
  __syncthreads();

  // 1. Attention: task = head * segments + segment; group grp takes tasks
  // grp, grp + groups, ... and synchronises its own 4 warps only (named
  // barrier 1 + grp), so the groups' phases overlap.
  if (grp < a.groups) {
    for (int task = grp; task < tasks; task += a.groups) {
      const int h = task / R.segments;
      const Segment g = segment(a, R, task % R.segments);
      const int rows_p = (g.rows + 15) / 16 * 16;
      load_tile(qs, L.ldq, q + g.b * a.q_bs + g.i0 * a.q_rs + h * kEpiDim, a.q_rs, g.rows, rows_p,
                kEpiDim, kEpiDim, gtid);
      load_tile(ks, L.ldq, k + g.b * a.k_bs + h * kEpiDim, a.k_rs, skv, L.skp, kEpiDim, kEpiDim,
                gtid);
      load_tile(vs, L.ldq, v + g.b * a.v_bs + h * kEpiDim, a.v_rs, skv, L.skp, kEpiDim, kEpiDim,
                gtid);
      for (int j = gtid; j < skv; j += kMmaThreads) bs[j] = a.bias[g.b * skv + j];
      cp_async_wait_all();
      group_sync(grp);
      t.sq = g.rows;
      scores_mma(ss, qs, ks, L.ldq, rows_p, kEpiDim, bs, t, gwarp, lane);
      group_sync(grp);
      softmax_rows(ss, skv + 1, g.rows, skv, rows_p, L.skp, gwarp, kMmaWarps, lane,
                   [&](int i, int j, float p) { ps[i * L.ldp + j] = __float2bfloat16(p); });
      group_sync(grp);
      mma_product(ps, L.ldp, vs, L.ldq, rows_p, L.skp, g.rows, kEpiDim, gwarp, lane,
                  [&](int i, int c, float x) {
                    ctx[(g.c0 + i) * kEpiLd + h * kEpiDim + c] = __float2bfloat16(x);
                  });
      group_sync(grp);  // before the next task's loads overwrite Q, K, V
    }
  }
  __syncthreads();

  // 2. acc = ctx W: this warp's 48 columns of all kEpiRows rows, W's
  // slices through the ring (the attention scratch is free now).
  const auto issue = [&](int slice) {
    __nv_bfloat16* dst = ring + (slice & 1) * kEpiSlice * kEpiLd;
    const __nv_bfloat16* src = w + static_cast<long long>(slice) * kEpiSlice * kEpiE;
    for (int i = tid; i < kEpiSlice * (kEpiE / 8); i += kEpiThreads) {
      const int r = i / (kEpiE / 8), c = i % (kEpiE / 8) * 8;
      cp_async16(dst + r * kEpiLd + c, src + r * kEpiE + c);
    }
    cp_async_commit();
  };
  float acc[kEpiMT][kEpiNT][4];
#pragma unroll
  for (int mt = 0; mt < kEpiMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kEpiNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  const int n_base = warp * kEpiNT * 8;
  constexpr int kSlices = kEpiE / kEpiSlice;
  issue(0);
  for (int slice = 0; slice < kSlices; ++slice) {
    if (slice + 1 < kSlices) {
      issue(slice + 1);  // its buffer was last read before the previous barrier
    } else {
      cp_async_commit();  // an empty group keeps the count below uniform
    }
    cp_async_wait_group<1>();  // this slice has landed
    __syncthreads();
    const __nv_bfloat16* wslice = ring + (slice & 1) * kEpiSlice * kEpiLd;
#pragma unroll
    for (int kt = 0; kt < kEpiSlice / 16; ++kt) {
      const int k0 = slice * kEpiSlice + kt * 16;
#pragma unroll
      for (int np = 0; np < kEpiNT / 2; ++np) {
        uint32_t bf[4];  // B fragments of columns n and n + 8
        ldsm_x4_trans(bf, wslice + (kt * 16 + lane % 16) * kEpiLd + n_base + np * 16 + lane / 16 * 8);
#pragma unroll
        for (int mt = 0; mt < kEpiMT; ++mt) {
          uint32_t af[4];
          ldsm_x4(af, ctx + (mt * 16 + lane % 16) * kEpiLd + k0 + lane / 16 * 8);
          mma_16x8x16(acc[mt][2 * np], af[0], af[1], af[2], af[3], bf[0], bf[1]);
          mma_16x8x16(acc[mt][2 * np + 1], af[0], af[1], af[2], af[3], bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // before the next issue overwrites the other slice
  }

  // y = acc + b + res; each thread holds rows mt * 16 + gr (+ 8) and
  // columns n_base + nt * 8 + tq (+ 1) of the mma accumulator layout.
  const int gr = lane / 4, tq = lane % 4 * 2;
  const __nv_bfloat16* res = static_cast<const __nv_bfloat16*>(a.res) + R.r0 * kEpiE;
  float stat[kEpiMT][2];
#pragma unroll
  for (int mt = 0; mt < kEpiMT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = mt * 16 + gr + 8 * half;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kEpiNT; ++nt) {
        const int col = n_base + nt * 8 + tq;
        float2 y = make_float2(0.f, 0.f);
        if (row < R.rows) {
          const float2 r2 = bf16_pair(res + row * kEpiE + col);
          y.x = acc[mt][nt][2 * half] + a.wb[col] + r2.x;
          y.y = acc[mt][nt][2 * half + 1] + a.wb[col + 1] + r2.y;
        }
        acc[mt][nt][2 * half] = y.x;
        acc[mt][nt][2 * half + 1] = y.y;
        sum += y.x + y.y;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (lane % 4 == 0) part[warp * kEpiRows + row] = sum;
    }
  }
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < kEpiMT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = mt * 16 + gr + 8 * half;
      float sum = 0.f;
      for (int w2 = 0; w2 < kEpiWarps; ++w2) sum += part[w2 * kEpiRows + row];
      stat[mt][half] = sum / kEpiE;  // the mean
    }
  }
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < kEpiMT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = mt * 16 + gr + 8 * half;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kEpiNT; ++nt) {
        const float d0 = acc[mt][nt][2 * half] - stat[mt][half];
        const float d1 = acc[mt][nt][2 * half + 1] - stat[mt][half];
        sum += d0 * d0 + d1 * d1;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (lane % 4 == 0) part[warp * kEpiRows + row] = sum;
    }
  }
  __syncthreads();
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out) + R.r0 * kEpiE;
#pragma unroll
  for (int mt = 0; mt < kEpiMT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = mt * 16 + gr + 8 * half;
      if (row >= R.rows) continue;
      float var = 0.f;
      for (int w2 = 0; w2 < kEpiWarps; ++w2) var += part[w2 * kEpiRows + row];
      const float mean = stat[mt][half], rstd = rsqrtf(var / kEpiE + a.eps);
#pragma unroll
      for (int nt = 0; nt < kEpiNT; ++nt) {
        const int col = n_base + nt * 8 + tq;
        const float z0 = (acc[mt][nt][2 * half] - mean) * rstd * a.gamma[col] + a.beta[col];
        const float z1 = (acc[mt][nt][2 * half + 1] - mean) * rstd * a.gamma[col + 1] + a.beta[col + 1];
        *reinterpret_cast<uint32_t*>(out + row * kEpiE + col) = pack_f32_pair(z0, z1);
      }
    }
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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, res, w and the output; bias,
// b, gamma, beta f32).  Strides of q, k, v in elements, their last
// dimension contiguous; res, w and the output contiguous.  Returns the
// cudaError_t of the launch (0 on success); -1 for arguments outside the
// kernel's limits.
int rgqa_epilogue(
    const void* q, const void* k, const void* v, const void* bias, const void* res,
    const void* w, const void* wb, const void* gamma, const void* beta, void* out,
    int dtype, int batch, int sq, int skv, int heads, int dim,
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
    // As many attention groups as shared memory takes, at most four.
    a.groups = kEpiGroups;
    while (a.groups > 1 && epi_layout(sq, skv, a.groups).bytes > kSmemMax) --a.groups;
    return launch_epi(epilogue_bf16, a, kEpiRows, kEpiThreads, epi_layout(sq, skv, a.groups).bytes, s);
  }
  if (dtype == 0) return launch_epi(epilogue_f32, a, kEpiF32Rows, kEpiF32Threads, epi_f32_bytes(skv), s);
  return -1;
}

}  // extern "C"

RGQA_CUDA_ERROR_STRING
