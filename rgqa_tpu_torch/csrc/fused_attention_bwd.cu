// Fused multi-head attention backward on the natural (B, S, H*D) layout.
//
// Replaces the Pallas TPU kernel rgqa_tpu/ops/attention.py:_fused_bwd_kernel
// (launched by _fused_bwd_pallas_raw from the _fused custom_vjp).  Per
// (batch row, head), for the output gradient g, it recomputes P and then
//
//     dP = g V^T,  dV = P^T g                   (f32, on the CUDA cores)
//     dS = P (dP - rowsum(dP P))
//     dQ = (dS/sqrt(D)) K,  dK = (dS/sqrt(D))^T Q   (dS in the input dtype)
//     dbias[b, j] = sum over heads h and query rows i of dS[h, i, j]
//
// in the TPU kernel's dtype contract: dq, dk, dv in the input dtype and
// dbias in f32.  The plain version is
// rgqa_tpu_torch.ops.attention.attention_bwd_ref.
//
// What bounds it on an H100: like the forward it moves bytes (q, k, v,
// g in; dq, dk, dv out: 99 MB at 36 x 36, batch 256, bf16, about 30 us at
// 3.35 TB/s) against a few microseconds of flops.  One block per (row,
// head) keeps the pair's whole problem in shared memory and writes each
// gradient once.  dbias sums across heads, i.e. across blocks: on the TPU
// the head loop inside one kernel carried the sum; here every block writes
// its head's column sums to a (B, H, Skv) scratch and a second small
// kernel adds them in head order, so two runs give identical gradients
// (no float atomics).
//
// Bodies (attention_common.cuh, kDrop = false): f32 runs every product
// on the CUDA cores in f32; bf16 runs QK^T, dS K and dS^T Q with mma.sync
// (bf16 in, f32 accumulate) and dP, dV in f32 on the CUDA cores, as the
// TPU kernel does.  A fully masked row (bias -10000 everywhere) has a
// uniform P and finite gradients.  Multi-head blocks, cp.async / TMA and
// wgmma are later work.

#include "attention_common.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  q/k/v strides are in elements, their
// last dimension contiguous; g, dq, dk, dv are contiguous (B, S, heads *
// dim) in the input dtype, dbias_part a (B, heads, Skv) f32 scratch and
// dbias the (B, Skv) f32 result.  Returns the cudaError_t of the launches
// (0 on success); -1 for arguments outside the kernel's limits.
int rgqa_fused_attention_bwd(
    const void* q, const void* k, const void* v, const void* bias, const void* g,
    void* dq, void* dk, void* dv, void* dbias_part, void* dbias,
    int dtype, int batch, int sq, int skv, int heads, int dim,
    long long q_bs, long long q_rs, long long k_bs, long long k_rs,
    long long v_bs, long long v_rs, float scale, void* stream) {
  if (!within_limits(batch, sq, skv, heads, dim)) return -1;
  Args a = make_args(q, k, v, bias, sq, skv, heads, dim, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs,
                     scale);
  a.g = g;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.dbias_part = static_cast<float*>(dbias_part);
  return launch_bwd<false>(a, static_cast<float*>(dbias), dtype, batch,
                           static_cast<cudaStream_t>(stream));
}

}  // extern "C"

RGQA_CUDA_ERROR_STRING
