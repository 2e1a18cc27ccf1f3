// Fused multi-head attention backward on the natural (B, S, H*D) layout,
// Sq, Skv <= 64 (LXMERT's 20- and 36-token streams).
//
// Replaces the Pallas TPU kernel rgqa_tpu/ops/attention.py:_fused_bwd_kernel
// (launched by _fused_bwd_pallas_raw from the _fused custom_vjp).  Per
// (batch row, head), for the output gradient g, it recomputes P and then
//
//     dP = g V^T,  dV = P^T g
//     dS = P (dP - rowsum(dP P))
//     dQ = (dS/sqrt(D)) K,  dK = (dS/sqrt(D))^T Q   (dS in the input dtype)
//     dbias[b, j] = sum over heads h and query rows i of dS[h, i, j]
//
// in the TPU kernel's dtype contract: dq, dk, dv in the input dtype and
// dbias in f32.  The plain version is
// rgqa_tpu_torch.ops.attention.attention_bwd_ref.  q, k and v may be
// strided column views (the fused QKV product, row stride 3E); g is
// contiguous.
//
// What bounds it on an H100 (chip_smoke.py's _bound_ms): bytes, q, k, v, g
// in and dq, dk, dv out, 16.4 / 29.6 / 24.0 / 22.1 us at LXMERT's 20x20 /
// 36x36 / 20x36 / 36x20, batch 256, bf16, against a few microseconds of
// products. At these lengths one block sees every query row and every key
// of its (row, head), so the bf16 body (attention_common.cuh,
// fused_attention_bwd_short_bf16) forms S, P, dP and dS once, in
// registers, with every product on the tensor cores: five products per
// score, the count the bound takes, two phases (warps over query rows,
// then over keys) and three barriers per head, Q, g, K and V staged once
// in bf16 by cp.async. A block takes two heads of its row, the second's
// tiles in flight while the first computes, at 128 registers a thread;
// measured on an H100 (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6)
// against one, three, four and twelve heads per block and other register
// caps, it was within 3% of the fastest variant at LXMERT's shapes at
// batch 256 and 64 but for 20x20 at batch 64 (one head per block 17%
// faster): 44-73 us at batch 256, 2.5-2.7x the bound, 3.0-4.6x faster than
// a first design that ran dP and dV on the CUDA cores from f32 copies of g
// and V behind eight barriers.
//
// dbias sums across heads: a block writes its heads' column sums of dS,
// summed in head order, into a (B, head pairs, Skv) scratch that
// fused_attention_dbias_sum adds in pair order.  No float atomics, so
// two runs give identical gradients.  The f32 body
// (fused_attention_bwd_short_f32) runs every product on the CUDA cores in
// exact f32 (fmaf, no TF32), each output one fmaf chain in the plain
// order, so its outputs are bit for bit those of one thread per output:
// one block per (row, head) in two phases (query rows: S, dP, softmax, D,
// dS; then keys: dV, dK; dQ beside dK), each thread a 4 x 4 register
// tile of each product with float4 operand reads (8 FMAs a shared-memory
// load where one thread per output does 0.5), its dbias partials per head
// (fused_attention_dbias_sum adds them in head order); on an H100 1.7-2.9x
// faster than one thread per output (PERF.md section 6).  A fully masked
// row (bias -10000 everywhere) has a uniform P and finite gradients.

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
