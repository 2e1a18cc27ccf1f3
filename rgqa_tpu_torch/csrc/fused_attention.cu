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
// a few hundred KFLOP, so the work is bound by moving bytes (about 1 us
// of flops at batch 256 against 9-17 us of bytes at 3.35 TB/s): global
// loads of q/k/v, and shared-memory traffic of the products.  The design
// keeps everything for one pair in shared memory (Q, K, V, the bias row,
// the score and probability tiles), reads q/k/v straight out of the
// projection outputs by stride (no transposes in device memory, no
// (B, H, Sq, Skv) mask), and writes the output once.
//
// Two bodies (attention_common.cuh, fused_attention_f32 / _bf16 with
// kDrop = false), one block per (batch row, head):
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

#include "attention_common.cuh"

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
  if (!within_limits(batch, sq, skv, heads, dim)) return -1;
  Args a = make_args(q, k, v, bias, sq, skv, heads, dim, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs,
                     scale);
  a.out = out;
  return launch_fwd<false>(a, dtype, batch, static_cast<cudaStream_t>(stream));
}

}  // extern "C"

RGQA_CUDA_ERROR_STRING
