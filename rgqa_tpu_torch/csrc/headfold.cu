// The head-fold experiment (experiments/headfold_exp.py): each head's
// attention, computed F heads at a time as one stacked product.
//
// Replaces both Pallas TPU bodies of experiments/headfold_exp.py:headfold,
// _concat_kernel (variant "concat": F = 2, same-parity head pairs) and
// _scratch_kernel (variant "scratch": consecutive heads, F in {2, 3, 4,
// 6}).  They compute one function and differ only in which heads share a
// group, so here they are one kernel that takes F and the head order:
// group g holds heads order[g F .. g F + F).  Per (batch row, group) the F
// heads' (Sq, D) slices of q are stacked into one (F Sq, D) matrix, their
// keys into (F Skv, D), and
//
//     S = Q_stack K_stack^T / sqrt(D) + bias + struct,   P = softmax_rows(S)
//     O_stack = P V_stack
//
// where struct is -1e9 wherever the query row's head differs from the
// key's (exp gives exactly 0 in f32, so each row's softmax spans only its
// own head's keys) and the bias is the row's (B, Skv) mask repeated per
// head.  Row f Sq + i of O_stack is query i of the group's head f.  The
// function is the short kernel's (fused_attention.cu) up to the order of
// the sums; the work is not: the cross-head products are done, as on the
// TPU, which is what the experiment weighs against the tensor cores' tile
// shapes.
//
// The bf16 body is built on Hopper's warpgroup products (wgmma.cuh): the
// question on this card is whether stacked short heads fill wgmma's
// 64-row tile, where #1 pads a 20-row head to 32 rows of mma.sync.  One
// warpgroup (4 warps) per (batch row, group, tile of W whole heads'
// stacked query rows) and
//
// - a key window per tile: its own W heads' keys.  W is the most heads
//   that fit in 64 rows (1 above 32 rows, 3 at LXMERT's 20) whose W Skv
//   keys fit wgmma's largest N (256); a last tile of fewer heads shifts
//   its window back inside the group.  The Python fold_plan
//   (rgqa_tpu_torch/experiments/headfold_exp.py) computes the plan and
//   passes W; plan_wgmma checks it.  Outside the window every score
//   carries the -1e9, so dropping those keys leaves the function as it
//   is; inside it the cross-head products are still done.  Measured on
//   the H100 against tiles of 64 rows cut across heads, each with the
//   keys of every head it touches (PERF.md section 6): whole heads win or
//   tie at 24 of the experiment's 25 (shape, F), by up to 1.3x;
// - Q (<= 64 rows), K and V (N = W Skv rounded up to 16 rows: 32-112 at
//   the experiment's shapes) gathered by stride straight from q, k,
//   v (cp.async, no copies in device memory) into 128-byte-swizzled tiles
//   (D <= 64 zero-padded to one 128-byte row), the bias repeated over the
//   window (-inf past it); one wait and one barrier;
// - S = Q K^T as wgmma m64nNk16 (bf16 -> f32, both operands in shared
//   memory, 4 steps of K = 16), left in registers: each warp holds 16 rows
//   in the m16n8 C layout, so #1's quad-shuffle softmax (fused_attention:
//   fwd_short_body in attention_common.cuh; __expf, one reciprocal per
//   row) runs on the accumulators, with the structural term by comparing
//   the key against its row's head;
// - P rounded to bf16 straight into the register A fragments of O = P V,
//   wgmma m64n64k16 with V as B (transposed, from shared memory), N / 16
//   steps; O in 32 f32 registers a thread, written once, stacked row r to
//   (r % Sq, head order[r / Sq]).
// S and P never touch shared memory.  The f32 body runs on the CUDA cores,
// 8 warps, the first design's shared-memory layout (checked, not timed).
//
// What bounds it on an H100: bytes, as for the short kernel: at batch
// 384 and the experiment's shapes one call moves 47-132 MB against at
// most F times the short kernel's products (0.9-22 GFLOP, less inside the
// windows).
//
// Limits: Sq, Skv <= 64, D <= 64, heads <= 16, F Skv <= 384 (the f32
// body's shared memory).

#include "attention_common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kMaxHeads = 16;
constexpr int kFoldMaxKeys = 384;  // F Skv, for the f32 body's shared memory
constexpr int kFoldF32Threads = 256;
constexpr size_t kSmemMax = 232448;  // 227 KB, the most a block may take
constexpr int kFoldTileRows = 64;         // wgmma's M: the most stacked query rows of a tile
constexpr int kFoldMaxWindowKeys = 256;   // wgmma's largest N: a tile's key window
constexpr int kRow = 64;                  // bf16 values in one 128-byte swizzled row
constexpr unsigned kSwizzlePeriod = 1024;  // bytes: 8 swizzled rows

struct FoldArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;  // (B, Skv) f32
  void* out;          // contiguous (B, Sq, H*D)
  int sq, skv, heads, dim, fold, groups, tile, tiles;
  int window;         // bf16: heads in each tile and its key window (W)
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs;
  float scale;
  int order[kMaxHeads];
  // order[i] in bits 4 i .. 4 i + 3: the bf16 body reads its group's heads
  // from one register (a parameter array indexed at run time would be
  // copied to local memory).
  unsigned long long order_bits;
};

// Stacked row r (query or key) of a group: head order[g fold + r / len],
// row r % len of that head.
struct FoldMask {
  static constexpr bool kOn = true;
  int q0, sq, skv;
  __device__ __forceinline__ float operator()(int i, int j) const {
    return (q0 + i) / sq == j / skv ? 0.f : -1e9f;
  }
};

// Gather rows [r0, r0 + rows) of the stack (each row len long in its head)
// into dst (row stride ld), zero-padded to rows_p rows and dp columns.
template <typename T>
__device__ __forceinline__ void gather_rows(T* dst, int ld, const T* src, long long bs,
                                            long long rs, const int* heads, int len, int dim,
                                            int r0, int rows, int rows_p, int dp, int tid,
                                            int nthreads) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = dim % kVec == 0 && rs % kVec == 0 && ld % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(src + bs) % 16 == 0;
  if (vec) {
    const int chunks = dp / kVec;
    for (int i = tid; i < rows_p * chunks; i += nthreads) {
      const int r = i / chunks, c = i % chunks * kVec;
      T* d = dst + r * ld + c;
      if (r < rows && c < dim) {
        const int sr = r0 + r;
        cp_async16(d, src + bs + (sr % len) * rs + heads[sr / len] * dim + c);
      } else {
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  } else {
    for (int i = tid; i < rows_p * dp; i += nthreads) {
      const int r = i / dp, c = i % dp;
      const int sr = r0 + r;
      dst[r * ld + c] = (r < rows && c < dim) ? src[bs + (sr % len) * rs + heads[sr / len] * dim + c]
                                             : from_f32<T>(0.f);
    }
  }
}

// The block's (batch row, group, tile) and its heads.
struct FoldTile {
  int b, group, q0, rows;
  const int* heads;
};

__device__ __forceinline__ FoldTile fold_tile(const FoldArgs& a) {
  FoldTile t;
  const int bg = blockIdx.x / a.tiles;
  t.b = bg / a.groups;
  t.group = bg % a.groups;
  t.heads = a.order + t.group * a.fold;
  t.q0 = blockIdx.x % a.tiles * a.tile;
  t.rows = min(a.tile, a.fold * a.sq - t.q0);
  return t;
}

// ---- bf16: wgmma ----

// Shared memory of the bf16 body for a window of np keys (np a multiple of
// 16): Q (64 rows, zero past the tile's), K, V (np rows each), 128-byte swizzled rows, each tile
// on a 1024-byte boundary; the window's bias (np f32).  The launch adds
// one swizzle period so that the kernel can align the tiles itself.
struct WinLayout {
  size_t k_off, v_off, b_off, bytes;
};

__host__ __device__ inline WinLayout win_layout(int np) {
  WinLayout L;
  constexpr size_t row = sizeof(__nv_bfloat16) * kRow;
  L.k_off = row * kFoldTileRows;
  L.v_off = L.k_off + row * np;
  L.b_off = L.v_off + row * np;
  L.bytes = L.b_off + sizeof(float) * np;
  return L;
}

size_t win_smem_bytes(int np) { return win_layout(np).bytes + kSwizzlePeriod; }

// Stacked rows r0 .. r0 + rows - 1 of a group (row r: row r % len of the
// head at group position r / len, heads[p] in bits 4 p .. 4 p + 3) from
// src (the batch row's start, row stride rs) into rows_p swizzled rows at
// dst: 16-byte chunk c of row r at chunk c ^ (r % 8); zero past `rows`
// and past d.  A thread takes chunk tid % 8 of rows tid / 8, + 16, ...,
// stepping the row's head rather than dividing for it.
__device__ __forceinline__ void gather_swizzled(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                long long rs, unsigned long long heads, int len,
                                                int d, int r0, int rows, int rows_p, int tid) {
  constexpr int kStep = kMmaThreads / 8;
  const bool vec = d % 8 == 0 && rs % 8 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0;
  const int c = tid % 8;
  int r = tid / 8;
  int hp = (r0 + r) / len, hr = r0 + r - hp * len;
  for (; r < rows_p; r += kStep) {
    __nv_bfloat16* chunk = dst + r * kRow + ((c ^ (r & 7)) << 3);
    if (r < rows && c * 8 < d) {
      const __nv_bfloat16* s = src + hr * rs + static_cast<int>((heads >> (4 * hp)) & 15u) * d + c * 8;
      if (vec) {
        cp_async16(chunk, s);
      } else {
        for (int e = 0; e < 8; ++e) chunk[e] = c * 8 + e < d ? s[e] : __float2bfloat16(0.f);
      }
    } else {
      *reinterpret_cast<uint4*>(chunk) = make_uint4(0u, 0u, 0u, 0u);
    }
    for (hr += kStep; hr >= len; hr -= len) ++hp;
  }
}

// The bf16 body: kNP keys in the window (a multiple of 16, <= 256).
template <int kNP>
__global__ void __launch_bounds__(kMmaThreads) headfold_wgmma(FoldArgs a) {
  constexpr int kNT = kNP / 8;   // 8-key column tiles of S
  constexpr int kKS = kNP / 16;  // 16-key steps of P V
  extern __shared__ __align__(16) unsigned char smem_raw[];  // aligned to the swizzle's period below
  unsigned char* smem = smem_raw + ((kSwizzlePeriod - smem_u32(smem_raw) % kSwizzlePeriod) % kSwizzlePeriod);
  const WinLayout L = win_layout(kNP);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + L.k_off);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + L.v_off);
  float* bs = reinterpret_cast<float*>(smem + L.b_off);
  const FoldTile t = fold_tile(a);
  const unsigned long long order = a.order_bits >> (4 * t.group * a.fold);  // the group's heads
  const int sq = a.sq, skv = a.skv, d = a.dim;
  const int h0 = min(t.q0 / sq, a.fold - a.window);  // the window: group positions h0 .. h0 + W - 1
  const int nk = a.window * skv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, tq = (lane & 3) * 2;

  gather_swizzled(qs, static_cast<const __nv_bfloat16*>(a.q) + t.b * a.q_bs, a.q_rs, order, sq, d,
                  t.q0, t.rows, kFoldTileRows, tid);
  gather_swizzled(ks, static_cast<const __nv_bfloat16*>(a.k) + t.b * a.k_bs, a.k_rs, order, skv, d,
                  h0 * skv, nk, kNP, tid);
  gather_swizzled(vs, static_cast<const __nv_bfloat16*>(a.v) + t.b * a.v_bs, a.v_rs, order, skv, d,
                  h0 * skv, nk, kNP, tid);
  for (int j = tid; j < kNP; j += kMmaThreads) {
    if (j < nk) {
      cp_async4(bs + j, a.bias + static_cast<long long>(t.b) * skv + j % skv);
    } else {
      bs[j] = -CUDART_INF_F;
    }
  }
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();  // the tiles and the bias

  // S = Q K^T: a thread holds rows i0 = 16 warp + g and i0 + 8 of the
  // tile, keys 8 n + tq + (e & 1) in s[4 n + e] (e >= 2: row i0 + 8).
  float s[4 * kNT];
#pragma unroll
  for (int i = 0; i < 4 * kNT; ++i) s[i] = 0.f;
  const uint64_t dq = wgmma_desc_sw128(qs), dk = wgmma_desc_sw128(ks);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kMaxDim / 16; ++kk) WgmmaSS<kNP>::mma(s, dq + 2 * kk, dk + 2 * kk, 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(s);

  // The row softmax: scale, bias, the structural term (0 on the keys of
  // the row's own head: window keys lo .. lo + skv - 1), max and sum over
  // the quad's lanes.
  const int i0 = warp * 16 + g;
  const int lo0 = ((t.q0 + i0) / sq - h0) * skv, lo1 = ((t.q0 + i0 + 8) / sq - h0) * skv;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = n * 8 + tq + (e & 1), lo = e < 2 ? lo0 : lo1;
      const float x = s[4 * n + e] * a.scale + bs[j] + (j >= lo && j < lo + skv ? 0.f : -1e9f);
      s[4 * n + e] = x;
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
      const float p = __expf(s[4 * n + e] - (e < 2 ? m0 : m1));  // 0 off the row's head and past nk
      s[4 * n + e] = p;
      if (e < 2) l0 += p; else l1 += p;
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;  // a row's max term is 1: sum >= 1

  // P rounded to bf16 into the A fragments of P V, 16 keys a step: keys
  // 16 c .. 16 c + 15 are the accumulators of column tiles 2 c and 2 c + 1.
  uint32_t pa[kKS][4];
#pragma unroll
  for (int c = 0; c < kKS; ++c) {
    pa[c][0] = pack_f32_pair(s[8 * c] * inv0, s[8 * c + 1] * inv0);
    pa[c][1] = pack_f32_pair(s[8 * c + 2] * inv1, s[8 * c + 3] * inv1);
    pa[c][2] = pack_f32_pair(s[8 * c + 4] * inv0, s[8 * c + 5] * inv0);
    pa[c][3] = pack_f32_pair(s[8 * c + 6] * inv1, s[8 * c + 7] * inv1);
  }
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  const uint64_t dv = wgmma_desc_sw128(vs);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < kKS; ++c) WgmmaRS64::mma(o, pa[c], dv + c * 16 * 8, 1);  // 16 rows down
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(o);
  fence_operands(pa);

  // O: stacked row q0 + i to (its row in the head, the head's columns).
  const long long out_rs = static_cast<long long>(a.heads) * d;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out) + static_cast<long long>(t.b) * sq * out_rs;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = i0 + 8 * half;
    if (i >= t.rows) continue;
    const int r = t.q0 + i, hp = r / sq;
    __nv_bfloat16* row = out + (r - hp * sq) * out_rs + static_cast<int>((order >> (4 * hp)) & 15u) * d;
#pragma unroll
    for (int n = 0; n < kMaxDim / 8; ++n) {
      const int c = n * 8 + tq;
      if (c >= d) continue;
      const float x0 = o[4 * n + 2 * half], x1 = o[4 * n + 2 * half + 1];
      if ((d & 1) == 0) {
        *reinterpret_cast<uint32_t*>(row + c) = pack_f32_pair(x0, x1);
      } else {
        row[c] = __float2bfloat16(x0);
        if (c + 1 < d) row[c + 1] = __float2bfloat16(x1);
      }
    }
  }
}

// ---- f32: CUDA cores ----

// f32 shared memory: Q (T x (D + 1)), K, V (N x (D + 1)), S/P (T x (N +
// 1)), the stacked bias (N).
size_t fold_f32_bytes(int tile, int n, int d) {
  return sizeof(float) * (tile * (d + 1) + 2 * n * (d + 1) + tile * (n + 1) + n);
}

template <int kPerLane>
__global__ void __launch_bounds__(kFoldF32Threads) headfold_f32(FoldArgs a) {
  extern __shared__ float smem[];
  const FoldTile t = fold_tile(a);
  const int n = a.fold * a.skv, d = a.dim, ld = d + 1, ldp = n + 1;
  float* qs = smem;
  float* ks = qs + a.tile * ld;
  float* vs = ks + n * ld;
  float* ps = vs + n * ld;
  float* bs = ps + a.tile * ldp;
  const int tid = threadIdx.x;

  gather_rows(qs, ld, static_cast<const float*>(a.q), t.b * a.q_bs, a.q_rs, t.heads, a.sq, d,
              t.q0, t.rows, t.rows, d, tid, kFoldF32Threads);
  gather_rows(ks, ld, static_cast<const float*>(a.k), t.b * a.k_bs, a.k_rs, t.heads, a.skv, d,
              0, n, n, d, tid, kFoldF32Threads);
  gather_rows(vs, ld, static_cast<const float*>(a.v), t.b * a.v_bs, a.v_rs, t.heads, a.skv, d,
              0, n, n, d, tid, kFoldF32Threads);
  for (int j = tid; j < n; j += kFoldF32Threads) bs[j] = a.bias[t.b * a.skv + j % a.skv];
  __syncthreads();

  Args s{};
  s.sq = t.rows;
  s.skv = n;
  s.dim = d;
  s.scale = a.scale;
  scores_f32(ps, ldp, qs, ks, ld, bs, s, tid, kFoldF32Threads, FoldMask{t.q0, a.sq, a.skv});
  __syncthreads();

  softmax_rows<kPerLane>(ps, ldp, t.rows, n, t.rows, n, tid / 32, kFoldF32Threads / 32, tid % 32,
                         [&](int i, int j, float p) { ps[i * ldp + j] = p; });
  __syncthreads();

  const long long out_rs = static_cast<long long>(a.heads) * d;
  float* out = static_cast<float*>(a.out) + static_cast<long long>(t.b) * a.sq * out_rs;
  for (int idx = tid; idx < t.rows * d; idx += kFoldF32Threads) {
    const int i = idx / d, c = idx % d;
    const float* pi = ps + i * ldp;
    float acc = 0.f;
#pragma unroll 4
    for (int j = 0; j < n; ++j) acc = fmaf(pi[j], vs[j * ld + c], acc);
    const int r = t.q0 + i;
    out[(r % a.sq) * out_rs + t.heads[r / a.sq] * d + c] = acc;
  }
}

template <typename Kernel>
int launch_fold(Kernel kernel, const FoldArgs& a, int batch, int threads, size_t smem,
                cudaStream_t stream) {
  if (const int err = allow_smem(kernel, smem)) return err;
  const unsigned blocks = static_cast<unsigned>(batch) * a.groups * a.tiles;
  kernel<<<blocks, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 body for the smallest kNP >= np (np a multiple of 16).
template <int kNP>
int launch_wgmma(const FoldArgs& a, int batch, int np, cudaStream_t stream) {
  if constexpr (kNP < kFoldMaxWindowKeys) {
    if (np > kNP) return launch_wgmma<kNP + 16>(a, batch, np, stream);
  }
  return launch_fold(headfold_wgmma<kNP>, a, batch, kMmaThreads, win_smem_bytes(kNP), stream);
}

// bf16: tiles of `window` whole heads (fold_plan's W), and a check that
// they fit wgmma and each tile's rows lie in its window; the window's
// keys, a multiple of 16, or -1 when the plan does not fit the body.
int plan_wgmma(FoldArgs& a, int window) {
  const int stacked = a.fold * a.sq;
  const int np = (window * a.skv + 15) / 16 * 16;
  if (window < 1 || window > a.fold || window * a.sq > kFoldTileRows || np > kFoldMaxWindowKeys) {
    return -1;
  }
  a.window = window;
  a.tile = window * a.sq;
  a.tiles = (stacked + a.tile - 1) / a.tile;
  for (int q0 = 0; q0 < stacked; q0 += a.tile) {
    const int h0 = min(q0 / a.sq, a.fold - window);
    const int last = (min(q0 + a.tile, stacked) - 1) / a.sq;
    if (last >= h0 + window) return -1;
  }
  return np;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  order: heads entries, a permutation
// of 0..heads-1; group g is order[g fold .. g fold + fold).  window: the
// bf16 body's heads per key window (headfold_exp.fold_plan; the f32 body
// takes none).  Strides in elements, the last dimension of q, k and v
// contiguous; the output is a contiguous (batch, sq, heads * dim) tensor
// of the input dtype.  Returns the cudaError_t of the launch (0 on
// success); -1 for arguments outside the kernel's limits.
int rgqa_headfold(
    const void* q, const void* k, const void* v, const void* bias, void* out,
    int dtype, int batch, int sq, int skv, int heads, int dim, int fold, int window,
    const int* order, long long q_bs, long long q_rs, long long k_bs, long long k_rs,
    long long v_bs, long long v_rs, float scale, void* stream) {
  if (!within_limits(batch, sq, skv, heads, dim) || heads > kMaxHeads || fold <= 0 ||
      heads % fold != 0 || fold * skv > kFoldMaxKeys || (dtype != 0 && dtype != 1)) {
    return -1;
  }
  FoldArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.sq = sq;
  a.skv = skv;
  a.heads = heads;
  a.dim = dim;
  a.fold = fold;
  a.groups = heads / fold;
  a.q_bs = q_bs;
  a.q_rs = q_rs;
  a.k_bs = k_bs;
  a.k_rs = k_rs;
  a.v_bs = v_bs;
  a.v_rs = v_rs;
  a.scale = scale;
  bool seen[kMaxHeads] = {};
  for (int h = 0; h < heads; ++h) {
    if (order[h] < 0 || order[h] >= heads || seen[order[h]]) return -1;
    seen[order[h]] = true;
    a.order[h] = order[h];
    a.order_bits |= static_cast<unsigned long long>(order[h]) << (4 * h);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const int np = plan_wgmma(a, window);
    if (np < 0) return -1;
    return launch_wgmma<16>(a, batch, np, s);
  }
  const int n = fold * skv, stacked = fold * sq, np = (n + 15) / 16 * 16;
  // The largest query tile whose shared memory fits; at most the stack.
  size_t smem = 0;
  a.tile = 0;
  for (int tile = 64; tile >= 16; tile -= 16) {
    const size_t bytes = fold_f32_bytes(tile, n, dim);
    if (bytes <= kSmemMax) {
      a.tile = tile;
      smem = bytes;
      break;
    }
  }
  if (a.tile == 0) return -1;
  const int whole = (stacked + 15) / 16 * 16;
  if (whole < a.tile) {
    a.tile = whole;
    smem = fold_f32_bytes(a.tile, n, dim);
  }
  a.tiles = (stacked + a.tile - 1) / a.tile;
  if (np <= 64) return launch_fold(headfold_f32<2>, a, batch, kFoldF32Threads, smem, s);
  if (np <= 128) return launch_fold(headfold_f32<4>, a, batch, kFoldF32Threads, smem, s);
  if (np <= 256) return launch_fold(headfold_f32<8>, a, batch, kFoldF32Threads, smem, s);
  return launch_fold(headfold_f32<12>, a, batch, kFoldF32Threads, smem, s);
}

// The bf16 body's dynamic shared memory for a window of np keys (np a
// multiple of 16, at most 256), as launched; -1 outside that.
int rgqa_headfold_window_smem(int np) {
  if (np < 16 || np > kFoldMaxWindowKeys || np % 16 != 0) return -1;
  return static_cast<int>(win_smem_bytes(np));
}

}  // extern "C"

RGQA_CUDA_ERROR_STRING
