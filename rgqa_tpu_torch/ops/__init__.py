"""Attention kernels, their plain versions, and dropout sites."""

from rgqa_tpu_torch.ops.attention import (
    attention_bwd_ref,
    attention_dropout_bwd_ref,
    attention_dropout_ref,
    attention_natural_ref,
    bias_vector,
    dropout_keep_mask_ref,
    fused_attention,
    fused_attention_bwd_cuda,
    fused_attention_cuda,
    fused_attention_dropout,
    fused_attention_dropout_bwd_cuda,
    fused_attention_dropout_cuda,
    fused_attention_long_cuda,
    forward_kernel,
)
from rgqa_tpu_torch.ops.dropout import DropoutRng, HiddenDropout, cheap_dropout

__all__ = [
    "attention_bwd_ref",
    "attention_dropout_bwd_ref",
    "attention_dropout_ref",
    "attention_natural_ref",
    "bias_vector",
    "dropout_keep_mask_ref",
    "fused_attention",
    "fused_attention_bwd_cuda",
    "fused_attention_cuda",
    "fused_attention_dropout",
    "fused_attention_dropout_bwd_cuda",
    "fused_attention_dropout_cuda",
    "fused_attention_long_cuda",
    "forward_kernel",
    "DropoutRng",
    "HiddenDropout",
    "cheap_dropout",
]
