// Fused multi-head attention forward on the natural (B, S, H*D) layout.
//
// Replaces the Pallas TPU kernel rgqa_tpu/ops/attention.py:_fused_kernel
// (launched by _fused_pallas_raw).  Per (batch row, head) it computes
//
//     out[b, :, h*D:(h+1)*D] = softmax(q_h k_h^T / sqrt(D) + bias[b]) v_h
//
// with the TPU kernel's numerics: products of input-dtype operands with
// f32 accumulation, scores and softmax in f32, the probabilities rounded
// to the input dtype before the PV product.  The plain PyTorch version
// (rgqa_tpu_torch.ops.attention.attention_natural_ref) follows the XLA
// reference instead and keeps P in f32, so in bf16 the two differ by the
// rounding of P: within 3e-2 (the JAX package's own bar) plus 1e-2 of the
// output's magnitude, since one bf16 step of an output above 4 exceeds
// 3e-2 by itself.
//
// What bounds it on an H100: at LXMERT's shapes (20 or 36 tokens, 12
// heads of 64) one (row, head) pair moves a few KB of operands and does
// a few hundred KFLOP, so the whole problem of a pair fits in shared
// memory and the kernel is bound by moving it: global loads of q/k/v,
// and shared-memory traffic of the products.  The design keeps
// everything for one pair in shared memory (Q, K, V, the bias row, the
// score and probability tiles), reads q/k/v straight out of the
// projection outputs by stride (no transposes in device memory, no
// (B, H, Sq, Skv) mask), and writes the output once.
//
// Two bodies, one block per (batch row, head):
// - bf16: both products on the tensor cores with mma.sync m16n8k16
//   (bf16 in, f32 accumulate), operands padded with zeros to whole
//   16-row / 16-deep tiles in shared memory.  This cuts the shared-memory
//   traffic of the products, which bounded a first version that ran
//   them on the CUDA cores.
// - f32: both products on the CUDA cores in f32 (fmaf), which keeps f32
//   exact to the plain version's summation order rather than rounding
//   operands to TF32.
// wgmma and TMA (Hopper's warpgroup MMA and bulk copies) are later work.
//
// Limits: Sq, Skv <= 64 and D <= 64 (the wrapper raises beyond that);
// f32 and bf16 inputs; the bias is a (B, Skv) f32 additive mask.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxSeq = 64;
constexpr int kMaxDim = 64;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  void* out;
  int sq, skv, heads, dim;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs;  // element strides
  float scale;
};

// Row softmax of s (sq x skv, row stride lds) by warps; each lane holds
// columns lane and lane + 32.  A row whose scores are all large negative
// (fully masked by -10000) still has a finite max, so every e is finite
// and the sum >= 1.  emit(i, j, p) stores one probability, for every
// i < rows and j < cols: rows and columns beyond sq x skv get p = 0 (the
// zero padding of the tensor-core body).
template <typename Emit>
__device__ __forceinline__ void softmax_rows(const float* s, int lds, int sq, int skv,
                                             int rows, int cols, int warp, int warps,
                                             int lane, Emit emit) {
  for (int i = warp; i < rows; i += warps) {
    float p0 = 0.f, p1 = 0.f;
    if (i < sq) {
      const float* row = s + i * lds;
      const float x0 = lane < skv ? row[lane] : -CUDART_INF_F;
      const float x1 = lane + 32 < skv ? row[lane + 32] : -CUDART_INF_F;
      float m = fmaxf(x0, x1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      const float e0 = lane < skv ? expf(x0 - m) : 0.f;
      const float e1 = lane + 32 < skv ? expf(x1 - m) : 0.f;
      float sum = e0 + e1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      p0 = e0 / sum;
      p1 = e1 / sum;
    }
    if (lane < cols) emit(i, lane, p0);
    if (lane + 32 < cols) emit(i, lane + 32, p1);
  }
}

// ---------------------------------------------------------------------------
// f32 body: CUDA cores.  Shared memory, f32: Q (sq x ld), K (skv x ld),
// V (skv x ld), S/P (sq x (skv + 1)), bias (skv); ld = dim + 1 so that
// threads walking K rows hit distinct banks.
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;

size_t f32_smem_bytes(int sq, int skv, int d) {
  const size_t ld = d + 1;
  return sizeof(float) * (sq * ld + 2 * skv * ld + sq * (skv + 1) + skv);
}

__global__ void __launch_bounds__(kF32Threads) fused_attention_f32(Args a) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int sq = a.sq, skv = a.skv, d = a.dim;
  const int ld = d + 1, ldp = skv + 1;
  float* qs = smem;
  float* ks = qs + sq * ld;
  float* vs = ks + skv * ld;
  float* ps = vs + skv * ld;
  float* bs = ps + sq * ldp;
  const float* q = static_cast<const float*>(a.q) + b * a.q_bs + h * d;
  const float* k = static_cast<const float*>(a.k) + b * a.k_bs + h * d;
  const float* v = static_cast<const float*>(a.v) + b * a.v_bs + h * d;
  const int tid = threadIdx.x;

  for (int i = tid; i < sq * d; i += kF32Threads) {
    const int r = i / d, c = i % d;
    qs[r * ld + c] = q[r * a.q_rs + c];
  }
  for (int i = tid; i < skv * d; i += kF32Threads) {
    const int r = i / d, c = i % d;
    ks[r * ld + c] = k[r * a.k_rs + c];
    vs[r * ld + c] = v[r * a.v_rs + c];
  }
  for (int j = tid; j < skv; j += kF32Threads) bs[j] = a.bias[b * skv + j];
  __syncthreads();

  for (int idx = tid; idx < sq * skv; idx += kF32Threads) {
    const int i = idx / skv, j = idx % skv;
    const float* qi = qs + i * ld;
    const float* kj = ks + j * ld;
    float acc = 0.f;
#pragma unroll 8
    for (int c = 0; c < d; ++c) acc = fmaf(qi[c], kj[c], acc);
    ps[i * ldp + j] = acc * a.scale + bs[j];
  }
  __syncthreads();

  softmax_rows(ps, ldp, sq, skv, sq, skv, tid / 32, kF32Threads / 32, tid % 32,
               [&](int i, int j, float p) { ps[i * ldp + j] = p; });
  __syncthreads();

  float* out = static_cast<float*>(a.out) + static_cast<long long>(b) * sq * a.heads * d + h * d;
  const long long out_rs = static_cast<long long>(a.heads) * d;
  for (int idx = tid; idx < sq * d; idx += kF32Threads) {
    const int i = idx / d, c = idx % d;
    const float* pi = ps + i * ldp;
    float acc = 0.f;
#pragma unroll 4
    for (int j = 0; j < skv; ++j) acc = fmaf(pi[j], vs[j * ld + c], acc);
    out[i * out_rs + c] = acc;
  }
}

// ---------------------------------------------------------------------------
// bf16 body: tensor cores (mma.sync m16n8k16, bf16 x bf16 -> f32).
//
// Shared memory, bf16 unless noted; every row stride is (padded width + 8)
// elements, so that the 8 rows one fragment load touches start in
// distinct banks, and rows stay 16-byte aligned:
//   Qs  (SQP x DP)   query rows, zero-padded to SQP = round_up(sq, 16)
//                    rows and DP = round_up(dim, 16) columns
//   Ks  (SKP x DP)   key rows, zero-padded to SKP = round_up(skv, 16)
//   Vs  (SKP x DP)   value rows, zero-padded likewise
//   Ps  (SQP x SKP)  probabilities in bf16, zero outside sq x skv
//   Ss  f32 (sq x (skv + 1)) scores;  bias f32 (skv)
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;
constexpr int kMmaWarps = kMmaThreads / 32;

struct MmaLayout {
  int sqp, skp, dp;   // padded extents
  int ldq, ldp;       // row strides (elements) of Qs/Ks/Vs and of Ps
  size_t q_off, k_off, v_off, p_off, s_off, b_off, bytes;
};

__host__ __device__ inline MmaLayout mma_layout(int sq, int skv, int d) {
  MmaLayout L;
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

// rows_p x DP tile of a strided (rows x d) source into shared memory,
// zero outside it; 16-byte copies when the source allows them.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int ld,
                                          const __nv_bfloat16* src, long long rs,
                                          int rows, int rows_p, int d, int dp, int tid) {
  const bool vec = d % 8 == 0 && rs % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0;
  if (vec) {
    const int chunks = dp / 8;
    for (int i = tid; i < rows_p * chunks; i += kMmaThreads) {
      const int r = i / chunks, c = i % chunks * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows && c < d) val = __ldg(reinterpret_cast<const uint4*>(src + r * rs + c));
      *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
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

// acc += A (16 x 16, row-major at a, stride lda) x B, one warp, where B
// is 16 x 8 with element (k, n) at b[n * ldb + k] (b_rows: K^T read from
// key rows) or at b[k * ldb + n] (!b_rows: V read from value rows).
template <bool b_rows>
__device__ __forceinline__ void mma_tile(float (&acc)[4], const __nv_bfloat16* a, int lda,
                                         const __nv_bfloat16* b, int ldb, int lane) {
  const int g = lane >> 2, t = (lane & 3) * 2;
  const uint32_t a0 = ld_pair(a + g * lda + t);
  const uint32_t a1 = ld_pair(a + (g + 8) * lda + t);
  const uint32_t a2 = ld_pair(a + g * lda + t + 8);
  const uint32_t a3 = ld_pair(a + (g + 8) * lda + t + 8);
  uint32_t b0, b1;
  if (b_rows) {
    b0 = ld_pair(b + g * ldb + t);
    b1 = ld_pair(b + g * ldb + t + 8);
  } else {
    b0 = pack_pair(b[t * ldb + g], b[(t + 1) * ldb + g]);
    b1 = pack_pair(b[(t + 8) * ldb + g], b[(t + 9) * ldb + g]);
  }
  mma_16x8x16(acc, a0, a1, a2, a3, b0, b1);
}

__global__ void __launch_bounds__(kMmaThreads) fused_attention_bf16(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int sq = a.sq, skv = a.skv, d = a.dim;
  const MmaLayout L = mma_layout(sq, skv, d);
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
  __syncthreads();

  // S = Q K^T * scale + bias: one (16-row, 8-key) tile per warp task.
  const int g = lane >> 2, t = (lane & 3) * 2;
  const int m_tiles = L.sqp / 16;
  const int n_tiles = (skv + 7) / 8;
  for (int task = warp; task < m_tiles * n_tiles; task += kMmaWarps) {
    const int m0 = task / n_tiles * 16, n0 = task % n_tiles * 8;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < L.dp; k0 += 16) {
      mma_tile<true>(acc, qs + m0 * L.ldq + k0, L.ldq, ks + n0 * L.ldq + k0, L.ldq, lane);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = m0 + g + (e >= 2 ? 8 : 0), j = n0 + t + (e & 1);
      if (i < sq && j < skv) ss[i * (skv + 1) + j] = acc[e] * a.scale + bs[j];
    }
  }
  __syncthreads();

  // P in bf16 over the whole padded SQP x SKP tile (zeros outside).
  softmax_rows(ss, skv + 1, sq, skv, L.sqp, L.skp, warp, kMmaWarps, lane,
               [&](int i, int j, float p) { ps[i * L.ldp + j] = __float2bfloat16(p); });
  __syncthreads();

  // O = P V: one (16-row, 8-column) output tile per warp task.
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out) +
                       static_cast<long long>(b) * sq * a.heads * d + h * d;
  const long long out_rs = static_cast<long long>(a.heads) * d;
  const int c_tiles = (d + 7) / 8;
  for (int task = warp; task < m_tiles * c_tiles; task += kMmaWarps) {
    const int m0 = task / c_tiles * 16, n0 = task % c_tiles * 8;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < L.skp; k0 += 16) {
      mma_tile<false>(acc, ps + m0 * L.ldp + k0, L.ldp, vs + k0 * L.ldq + n0, L.ldq, lane);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = m0 + g + (e >= 2 ? 8 : 0), c = n0 + t + (e & 1);
      if (i < sq && c < d) out[i * out_rs + c] = __float2bfloat16(acc[e]);
    }
  }
}

template <typename Kernel>
int launch(Kernel kernel, const Args& a, int batch, int threads, size_t smem,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>(batch) * a.heads;
  kernel<<<blocks, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last
// dimension of q, k and v must be contiguous.  The output is a contiguous
// (batch, sq, heads * dim) tensor of the input dtype.  Returns the
// cudaError_t of the launch (0 on success); -1 for arguments outside the
// kernel's limits.
int rgqa_fused_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* out,
    int dtype, int batch, int sq, int skv, int heads, int dim,
    long long q_bs, long long q_rs, long long k_bs, long long k_rs,
    long long v_bs, long long v_rs, float scale, void* stream) {
  if (batch <= 0 || sq <= 0 || skv <= 0 || heads <= 0 || dim <= 0 ||
      sq > kMaxSeq || skv > kMaxSeq || dim > kMaxDim) {
    return -1;
  }
  Args a{q, k, v, static_cast<const float*>(bias), out, sq, skv, heads, dim,
         q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch(fused_attention_f32, a, batch, kF32Threads, f32_smem_bytes(sq, skv, dim), s);
  }
  if (dtype == 1) {
    return launch(fused_attention_bf16, a, batch, kMmaThreads, mma_layout(sq, skv, dim).bytes, s);
  }
  return -1;
}

const char* rgqa_cuda_error_string(int err) {
  return err < 0 ? "argument outside the kernel's limits"
                 : cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
