"""Attention kernel, its plain version, and dropout sites."""

from rgqa_tpu_torch.ops.attention import (
    attention_natural_ref,
    bias_vector,
    fused_attention,
    fused_attention_cuda,
)
from rgqa_tpu_torch.ops.dropout import HiddenDropout

__all__ = [
    "attention_natural_ref",
    "bias_vector",
    "fused_attention",
    "fused_attention_cuda",
    "HiddenDropout",
]
