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
// the sums; the work is not: the masked quadrants' products are done, as
// on the TPU, which is what the experiment weighs against the tensor
// cores' tile shapes (on mma.sync m16n8k16 a 20-row head pads to 32 rows,
// two stacked heads, 40 rows, to 48).
//
// The TPU wrapper pads Sq and Skv to multiples of 8 with -1e9 on the
// padded keys; here the loaders zero-pad to whole 16-row tiles and the
// ragged edge is masked (the structural term uses the true lengths).
//
// Design: one block per (batch row, group, tile of T stacked query rows),
// T the largest of 64, 48, 32, 16 whose shared memory fits (F = 6 at
// 56x56 stacks 336 rows and keys).  The block gathers its F heads' rows
// straight from q, k, v by stride (cp.async, no copies in device memory),
// and keeps the stacked K and V, the tile's Q, scores and probabilities
// in shared memory.  bf16: both products on the tensor cores (mma.sync,
// f32 accumulate), P rounded to bf16 before PV, 4 warps; f32: the CUDA
// cores, 8 warps.  Each row's softmax is one pass over its F Skv scores.
//
// What bounds it on an H100: bytes, as for the short kernel: at batch
// 384 and the experiment's shapes one call moves 47-132 MB against F
// times the short kernel's products (0.9-22 GFLOP).
//
// Limits: Sq, Skv <= 64, D <= 64, F Skv <= 384, heads <= 16.

#include "attention_common.cuh"

namespace {

constexpr int kMaxHeads = 16;
constexpr int kFoldMaxKeys = 384;
constexpr int kFoldF32Threads = 256;
constexpr size_t kSmemMax = 232448;  // 227 KB, the most a block may take

struct FoldArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;  // (B, Skv) f32
  void* out;          // contiguous (B, Sq, H*D)
  int sq, skv, heads, dim, fold, groups, tile, tiles;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs;
  float scale;
  int order[kMaxHeads];
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
  int b, q0, rows;
  const int* heads;
};

__device__ __forceinline__ FoldTile fold_tile(const FoldArgs& a) {
  FoldTile t;
  const int bg = blockIdx.x / a.tiles;
  t.b = bg / a.groups;
  t.heads = a.order + (bg % a.groups) * a.fold;
  t.q0 = blockIdx.x % a.tiles * a.tile;
  t.rows = min(a.tile, a.fold * a.sq - t.q0);
  return t;
}

// bf16 shared memory: Qs (T x DP + 8), Ks, Vs (NP x DP + 8), Ps (T x NP +
// 8) bf16; Ss (T x (N + 1)) and the stacked bias (N) f32; T a multiple of
// 16, NP = round_up(N, 16), N = fold * skv.
struct FoldLayout {
  int np, dp, ldq, ldp;
  size_t k_off, v_off, p_off, s_off, b_off, bytes;
};

__host__ __device__ inline FoldLayout fold_layout(int tile, int n, int d) {
  FoldLayout L;
  L.np = (n + 15) / 16 * 16;
  L.dp = (d + 15) / 16 * 16;
  L.ldq = L.dp + 8;
  L.ldp = L.np + 8;
  const size_t bf = sizeof(__nv_bfloat16);
  L.k_off = bf * tile * L.ldq;
  L.v_off = L.k_off + bf * L.np * L.ldq;
  L.p_off = L.v_off + bf * L.np * L.ldq;
  L.s_off = L.p_off + bf * tile * L.ldp;
  L.b_off = L.s_off + sizeof(float) * tile * (n + 1);
  L.bytes = L.b_off + sizeof(float) * n;
  return L;
}

template <int kPerLane>
__global__ void __launch_bounds__(kMmaThreads) headfold_bf16(FoldArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const FoldTile t = fold_tile(a);
  const int n = a.fold * a.skv, d = a.dim;
  const FoldLayout L = fold_layout(a.tile, n, d);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.k_off);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.v_off);
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.p_off);
  float* ss = reinterpret_cast<float*>(smem_raw + L.s_off);
  float* bs = reinterpret_cast<float*>(smem_raw + L.b_off);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rows_p = (t.rows + 15) / 16 * 16;

  gather_rows(qs, L.ldq, static_cast<const __nv_bfloat16*>(a.q), t.b * a.q_bs, a.q_rs, t.heads,
              a.sq, d, t.q0, t.rows, rows_p, L.dp, tid, kMmaThreads);
  gather_rows(ks, L.ldq, static_cast<const __nv_bfloat16*>(a.k), t.b * a.k_bs, a.k_rs, t.heads,
              a.skv, d, 0, n, L.np, L.dp, tid, kMmaThreads);
  gather_rows(vs, L.ldq, static_cast<const __nv_bfloat16*>(a.v), t.b * a.v_bs, a.v_rs, t.heads,
              a.skv, d, 0, n, L.np, L.dp, tid, kMmaThreads);
  for (int j = tid; j < n; j += kMmaThreads) bs[j] = a.bias[t.b * a.skv + j % a.skv];
  cp_async_wait_all();
  __syncthreads();

  Args s{};
  s.sq = t.rows;
  s.skv = n;
  s.scale = a.scale;
  scores_mma(ss, qs, ks, L.ldq, rows_p, L.dp, bs, s, warp, lane, FoldMask{t.q0, a.sq, a.skv});
  __syncthreads();

  softmax_rows<kPerLane>(ss, n + 1, t.rows, n, rows_p, L.np, warp, kMmaWarps, lane,
                         [&](int i, int j, float p) { ps[i * L.ldp + j] = __float2bfloat16(p); });
  __syncthreads();

  const long long out_rs = static_cast<long long>(a.heads) * d;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out) + static_cast<long long>(t.b) * a.sq * out_rs;
  mma_product(ps, L.ldp, vs, L.ldq, rows_p, L.np, t.rows, d, warp, lane,
              [&](int i, int c, float x) {
                const int r = t.q0 + i;
                out[(r % a.sq) * out_rs + t.heads[r / a.sq] * d + c] = __float2bfloat16(x);
              });
}

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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  order: heads entries, a permutation
// of 0..heads-1; group g is order[g fold .. g fold + fold).  Strides in
// elements, the last dimension of q, k and v contiguous; the output is a
// contiguous (batch, sq, heads * dim) tensor of the input dtype.  Returns
// the cudaError_t of the launch (0 on success); -1 for arguments outside
// the kernel's limits.
int rgqa_headfold(
    const void* q, const void* k, const void* v, const void* bias, void* out,
    int dtype, int batch, int sq, int skv, int heads, int dim, int fold, const int* order,
    long long q_bs, long long q_rs, long long k_bs, long long k_rs,
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
  }
  const int n = fold * skv, stacked = fold * sq, np = (n + 15) / 16 * 16;
  // The largest query tile whose shared memory fits; at most the stack.
  size_t smem = 0;
  a.tile = 0;
  for (int tile = 64; tile >= 16; tile -= 16) {
    const size_t bytes = dtype == 1 ? fold_layout(tile, n, dim).bytes : fold_f32_bytes(tile, n, dim);
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
    smem = dtype == 1 ? fold_layout(a.tile, n, dim).bytes : fold_f32_bytes(a.tile, n, dim);
  }
  a.tiles = (stacked + a.tile - 1) / a.tile;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (np <= 64) return launch_fold(headfold_bf16<2>, a, batch, kMmaThreads, smem, s);
    if (np <= 128) return launch_fold(headfold_bf16<4>, a, batch, kMmaThreads, smem, s);
    if (np <= 256) return launch_fold(headfold_bf16<8>, a, batch, kMmaThreads, smem, s);
    return launch_fold(headfold_bf16<12>, a, batch, kMmaThreads, smem, s);
  }
  if (np <= 64) return launch_fold(headfold_f32<2>, a, batch, kFoldF32Threads, smem, s);
  if (np <= 128) return launch_fold(headfold_f32<4>, a, batch, kFoldF32Threads, smem, s);
  if (np <= 256) return launch_fold(headfold_f32<8>, a, batch, kFoldF32Threads, smem, s);
  return launch_fold(headfold_f32<12>, a, batch, kFoldF32Threads, smem, s);
}

}  // extern "C"

RGQA_CUDA_ERROR_STRING
