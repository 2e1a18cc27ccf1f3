// The paired cross-attention experiment (experiments/xfuse_exp.py): two
// attentions of an LXMERT cross-modal layer in one launch, in two forms.
//
// - dual_pair replaces the Pallas TPU kernel _dual_kernel (launched by
//   experiments/xfuse_exp.py:dual_pair): two independent attentions,
//   problem a (qa (B, Sa, E), ka / va (B, Ska, E), bias (B, Ska)) and
//   problem b (its own lengths), in one grid.  The first B * H blocks run
//   problem a, the next B * H problem b; each runs the short kernel's body
//   (attention_common.cuh fwd_short_body / fwd_f32_body, as in
//   fused_attention.cu) on its own Args.  The question it asks on this
//   card: do two problems of different lengths share the SMs better in one
//   grid than in two launches, and does a launch saved matter where the
//   host bounds the layer (small batches)?
// - cat_call replaces _cat_kernel (experiments/xfuse_exp.py:cat_call):
//   one attention over the concatenated stream (B, S, E), S = Sa + Sb <=
//   64, with the bias (B, S) plus a structural term computed from the row
//   and column indices: mode 0 ("xor") lets query rows i < split see only
//   keys j >= split and the rest only keys j < split (the two cross
//   directions), mode 1 ("diag") only keys of their own block (the two
//   self-attentions).  The term is -1e9, so exp gives exactly 0 in f32 and
//   each row's softmax spans only its visible keys, as two separate calls
//   compute it; no mask tensor exists in device memory.  It is the short
//   kernel's body with the term added to the scores.
//
// Numerics are the short kernel's: products of input-dtype operands with
// f32 accumulation, softmax in f32, P rounded to the input dtype before
// PV; bf16 on the tensor cores (mma.sync m16n8k16), f32 on the CUDA cores.
//
// What bounds them on an H100: bytes, as for the short kernel (either pair
// of LXMERT's 20- and 36-token streams moves 132 MB at batch 384, 39 us
// at 3.35 TB/s, against 1.7-2.0 GFLOP); the cat form also does the masked
// quadrants' products, (Sa + Sb)^2 scores against Sa Skb + Sb Ska.
//
// Limits: every length <= 64, D <= 64; f32 and bf16; (B, S) f32 biases.

#include "attention_common.cuh"

namespace {

struct CatMask {
  static constexpr bool kOn = true;
  int split;
  int mode;  // 0 = xor (the cross pair), 1 = diag (the self pair)
  __device__ __forceinline__ float operator()(int i, int j) const {
    const bool row = i < split, col = j < split;
    return (mode == 0 ? row != col : row == col) ? 0.f : -1e9f;
  }
};

// kNT per problem (fwd_short_nt): the same instantiation of the body as
// the one-problem kernel runs, so each half is bit for bit its #1 call.
template <int kNTa, int kNTb>
__global__ void __launch_bounds__(kFwdMaxThreads, kFwdMinBlocks)
    dual_pair_bf16(Args a, Args b, unsigned blocks_a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (blockIdx.x < blocks_a) {
    fwd_short_body<false, kNTa>(a, blockIdx.x, smem_raw);
  } else {
    fwd_short_body<false, kNTb>(b, blockIdx.x - blocks_a, smem_raw);
  }
}

__global__ void __launch_bounds__(kF32Threads) dual_pair_f32(Args a, Args b, unsigned blocks_a) {
  extern __shared__ float smem[];
  if (blockIdx.x < blocks_a) {
    fwd_f32_body<2, kF32Threads>(a, blockIdx.x, smem);
  } else {
    fwd_f32_body<2, kF32Threads>(b, blockIdx.x - blocks_a, smem);
  }
}

template <int kNT>
__global__ void __launch_bounds__(kFwdMaxThreads, kFwdMinBlocks) cat_bf16(Args a, CatMask m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  fwd_short_body<false, kNT>(a, blockIdx.x, smem_raw, m);
}

__global__ void __launch_bounds__(kF32Threads) cat_f32(Args a, CatMask m) {
  extern __shared__ float smem[];
  fwd_f32_body<2, kF32Threads>(a, blockIdx.x, smem, m);
}

// The bf16 dual launch: one block size for both problems (the larger).
template <int kNTa, int kNTb>
int launch_dual_bf16(const Args& a, const Args& b, unsigned blocks_a, cudaStream_t s) {
  const auto kernel = dual_pair_bf16<kNTa, kNTb>;
  const size_t sa = fwd_short_layout(a.sq, a.skv, a.dim).bytes;
  const size_t sb = fwd_short_layout(b.sq, b.skv, b.dim).bytes;
  const size_t smem = sa > sb ? sa : sb;
  if (const int err = allow_smem(kernel, smem)) return err;
  const int threads = max(fwd_short_threads(a.sq), fwd_short_threads(b.sq));
  kernel<<<2 * blocks_a, threads, smem, s>>>(a, b, blocks_a);
  return static_cast<int>(cudaGetLastError());
}

template <int kNTa>
int launch_dual_bf16_b(const Args& a, const Args& b, unsigned blocks_a, cudaStream_t s) {
  switch (fwd_short_nt(b.skv)) {
    case 4: return launch_dual_bf16<kNTa, 4>(a, b, blocks_a, s);
    case 6: return launch_dual_bf16<kNTa, 6>(a, b, blocks_a, s);
    default: return launch_dual_bf16<kNTa, 8>(a, b, blocks_a, s);
  }
}

template <int kNT>
int launch_cat_bf16(const Args& a, const CatMask& m, unsigned blocks, cudaStream_t s) {
  const auto kernel = cat_bf16<kNT>;
  const size_t smem = fwd_short_layout(a.sq, a.skv, a.dim).bytes;
  if (const int err = allow_smem(kernel, smem)) return err;
  kernel<<<blocks, fwd_short_threads(a.sq), smem, s>>>(a, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Each problem: q, k, v with element
// strides (batch, row), the last dimension contiguous; a contiguous (batch,
// skv) f32 bias; a contiguous (batch, sq, heads * dim) output.  Returns
// the cudaError_t of the launch (0 on success); -1 for arguments outside
// the kernel's limits.
int rgqa_dual_pair(
    const void* qa, const void* ka, const void* va, const void* ma, void* oa,
    const void* qb, const void* kb, const void* vb, const void* mb, void* ob,
    int dtype, int batch, int heads, int dim, float scale,
    int sqa, int skva, long long qa_bs, long long qa_rs, long long ka_bs, long long ka_rs,
    long long va_bs, long long va_rs,
    int sqb, int skvb, long long qb_bs, long long qb_rs, long long kb_bs, long long kb_rs,
    long long vb_bs, long long vb_rs, void* stream) {
  if (!within_limits(batch, sqa, skva, heads, dim) || !within_limits(batch, sqb, skvb, heads, dim) ||
      (dtype != 0 && dtype != 1)) {
    return -1;
  }
  Args a = make_args(qa, ka, va, ma, sqa, skva, heads, dim, qa_bs, qa_rs, ka_bs, ka_rs, va_bs,
                     va_rs, scale);
  a.out = oa;
  Args b = make_args(qb, kb, vb, mb, sqb, skvb, heads, dim, qb_bs, qb_rs, kb_bs, kb_rs, vb_bs,
                     vb_rs, scale);
  b.out = ob;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks_a = static_cast<unsigned>(batch) * heads;
  if (dtype == 1) {
    switch (fwd_short_nt(a.skv)) {
      case 4: return launch_dual_bf16_b<4>(a, b, blocks_a, s);
      case 6: return launch_dual_bf16_b<6>(a, b, blocks_a, s);
      default: return launch_dual_bf16_b<8>(a, b, blocks_a, s);
    }
  }
  const size_t sa = fwd_f32_smem_bytes(tile_rows(a.sq), a.skv, a.dim);
  const size_t sb = fwd_f32_smem_bytes(tile_rows(b.sq), b.skv, b.dim);
  const size_t smem = sa > sb ? sa : sb;
  if (const int err = allow_smem(dual_pair_f32, smem)) return err;
  dual_pair_f32<<<2 * blocks_a, kF32Threads, smem, s>>>(a, b, blocks_a);
  return static_cast<int>(cudaGetLastError());
}

// One attention over the (batch, s, heads * dim) stream with the
// structural term of mode (0 = xor, 1 = diag) around split; the other
// arguments as rgqa_fused_attention_fwd's (fused_attention.cu).
int rgqa_cat_call(
    const void* q, const void* k, const void* v, const void* bias, void* out,
    int dtype, int batch, int s, int heads, int dim,
    long long q_bs, long long q_rs, long long k_bs, long long k_rs,
    long long v_bs, long long v_rs, float scale, int split, int mode, void* stream) {
  if (!within_limits(batch, s, s, heads, dim) || split <= 0 || split >= s ||
      (mode != 0 && mode != 1) || (dtype != 0 && dtype != 1)) {
    return -1;
  }
  Args a = make_args(q, k, v, bias, s, s, heads, dim, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, scale);
  a.out = out;
  const CatMask m{split, mode};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>(batch) * heads;
  if (dtype == 1) {
    switch (fwd_short_nt(s)) {
      case 4: return launch_cat_bf16<4>(a, m, blocks, st);
      case 6: return launch_cat_bf16<6>(a, m, blocks, st);
      default: return launch_cat_bf16<8>(a, m, blocks, st);
    }
  }
  const size_t smem = fwd_f32_smem_bytes(tile_rows(a.sq), a.skv, a.dim);
  if (const int err = allow_smem(cat_f32, smem)) return err;
  cat_f32<<<blocks, kF32Threads, smem, st>>>(a, m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

RGQA_CUDA_ERROR_STRING
