// Fused multi-head attention with dropout on the attention probabilities,
// forward and backward, on the natural (B, S, H*D) layout.
//
// Replaces the Pallas TPU kernels rgqa_tpu/ops/attention.py:
// _fused_drop_kernel (forward) and _fused_drop_bwd_kernel (backward),
// launched by _drop_call from the _fused_drop custom_vjp, up to 64 tokens
// (longer streams: 4L / 5L, in fused_attention_long.cu and
// fused_attention_long_bwd.cu, with the same mask).  The forward is
// fused_attention.cu's with P_drop = keep ? P * 256/(256-t) : 0 in place
// of P; the backward is fused_attention_bwd.cu's with the forward's mask
// replayed: dV = P_drop^T g, dP = keep ? (g V^T) * 256/(256-t) : 0, then
// dS, dQ, dK and dbias as there.  Plain versions:
// rgqa_tpu_torch.ops.attention.attention_dropout_ref / _bwd_ref.
//
// The mask.  The TPU drew its bits from its hardware generator, keyed per
// (16-row sub-block, head group) with one byte per head, only because its
// forward and backward ran at different block sizes.  Here keep(b, h, i,
// j) is a pure function of the 64-bit seed and the element: byte j % 16 of
// Philox4x32-10 at counter (j / 16, i, h, b), kept iff byte >= t with
// t = round(rate * 256).  The backward replays the mask bit for bit
// whatever the launch geometry, and dropout_keep_mask_ref computes the
// same bits with integer tensor ops.  The bits cannot match the TPU's; the
// contract is the quantized rate and exact expectation of
// _attention_dropout_xla.
//
// What bounds it: the bytes of the deterministic kernels (the mask never
// touches device memory), plus the integer work of the generator.  Both
// entries draw the mask once per (query row, 16 keys): one Philox call
// gives the 16 keep bits of 16 keys (one call per key would run the
// generator 16 times over), drawn while the tiles are in flight.  The
// forward runs fused_attention.cu's one-pass body (attention_common.cuh,
// fused_attention_fwd_short_bf16) with the bits in registers: the four
// lanes of a quad hold two query rows, split the 2 x ceil(Skv / 16) calls
// between them and pass the words round by shuffles, so each lane keeps
// the bits of its own scores.  The backward runs fused_attention_bwd.cu's
// one-pass body (fused_attention_bwd_short_bf16) with the bits in a bit
// array in shared memory, Sq x max(2, ceil(Skv / 16)) calls over its
// threads, from which each lane reads the bits of the scores it holds.
// In f32 both entries run the short f32 bodies (fused_attention_fwd_short_f32,
// fused_attention_bwd_short_f32) with the same per-16-key bits, drawn
// into shared memory while the tiles are in flight.  At rate 0 (t = 0,
// scale 1) both entries compute bit for bit what fused_attention.cu and
// fused_attention_bwd.cu compute: the bodies are the same templates
// (attention_common.cuh).

#include "attention_common.cuh"

extern "C" {

// As rgqa_fused_attention_fwd, plus the dropout: seed (64 bits),
// threshold t in [0, 255] and keep_scale = 256 / (256 - t).
int rgqa_fused_attention_dropout_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* out,
    int dtype, int batch, int sq, int skv, int heads, int dim,
    long long q_bs, long long q_rs, long long k_bs, long long k_rs,
    long long v_bs, long long v_rs, float scale,
    unsigned long long seed, int threshold, float keep_scale, void* stream) {
  if (!within_limits(batch, sq, skv, heads, dim) || threshold < 0 || threshold > 255) {
    return -1;
  }
  Args a = make_args(q, k, v, bias, sq, skv, heads, dim, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs,
                     scale);
  a.out = out;
  a.seed = seed;
  a.threshold = threshold;
  a.keep_scale = keep_scale;
  return launch_fwd<true>(a, dtype, batch, static_cast<cudaStream_t>(stream));
}

// As rgqa_fused_attention_bwd, plus the forward's dropout arguments.
int rgqa_fused_attention_dropout_bwd(
    const void* q, const void* k, const void* v, const void* bias, const void* g,
    void* dq, void* dk, void* dv, void* dbias_part, void* dbias,
    int dtype, int batch, int sq, int skv, int heads, int dim,
    long long q_bs, long long q_rs, long long k_bs, long long k_rs,
    long long v_bs, long long v_rs, float scale,
    unsigned long long seed, int threshold, float keep_scale, void* stream) {
  if (!within_limits(batch, sq, skv, heads, dim) || threshold < 0 || threshold > 255) {
    return -1;
  }
  Args a = make_args(q, k, v, bias, sq, skv, heads, dim, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs,
                     scale);
  a.g = g;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.dbias_part = static_cast<float*>(dbias_part);
  a.seed = seed;
  a.threshold = threshold;
  a.keep_scale = keep_scale;
  return launch_bwd<true>(a, static_cast<float*>(dbias), dtype, batch,
                          static_cast<cudaStream_t>(stream));
}

}  // extern "C"

RGQA_CUDA_ERROR_STRING
