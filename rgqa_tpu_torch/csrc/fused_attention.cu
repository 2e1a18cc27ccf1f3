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
// What bounds it on an H100: bytes.  At LXMERT's shapes (20 or 36
// tokens, 12 heads of 64) one (row, head) pair moves a few KB of operands
// and does a few hundred KFLOP: 9.4 / 16.9 / 13.2 / 13.2 us of bytes at
// 20x20 / 36x36 / 20x36 / 36x20, batch 256, bf16, at 3.35 TB/s, against
// about 1 us of products.  q/k/v are read straight out of the projection
// outputs by stride (no transposes in device memory, no (B, H, Sq, Skv)
// mask), and the output is written once.
//
// Two bodies (attention_common.cuh, kDrop = false):
// - bf16 (fused_attention_fwd_short_bf16): one pass in registers.  Q, K
//   and V are staged in shared memory by cp.async behind one barrier; a
//   warp owns 16 query rows of a head, S = Q K^T and O = P V run on the
//   tensor cores (mma.sync m16n8k16, fragments by ldmatrix), the row
//   softmax in the accumulators by quad shuffles, and P goes from the
//   accumulators into the A fragments of P V without touching shared
//   memory.  A first design kept S in f32 and P in bf16 in
//   shared memory behind three barriers, one warp per row for the
//   softmax with lanes across keys, and reloaded fragments for every
//   8-column tile: 4.5-5.7x the bound (PERF.md section 6).
// - f32 (fused_attention_fwd_short_f32): both products on the CUDA cores
//   in exact f32 (fmaf, no TF32), each output one fmaf chain in the plain
//   order, so the outputs are bit for bit those of one thread per output
//   (the first f32 body, which the experiments keep as fwd_f32_body).  One block per (row, head); each thread owns
//   4 x 4 tiles of S and of O in registers and reads its operands as
//   float4, 8 FMAs a shared-memory load where one thread per output does
//   0.5; V lands by cp.async while S = Q K^T runs.  Up to 32 keys the
//   softmax takes one key a lane (the same bits).  On an H100: 1.8-2.5x
//   faster than one thread per output at LXMERT's shapes and CLIP's 50 x
//   50, 2.0-2.8x the bound at batch 256 (PERF.md section 6).
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
