"""BERT-style transformer blocks (port of ``rgqa_tpu/models/transformer.py``).

Inference forward of the blocks the LXMERT stack uses.  Numerics follow
the JAX package: LayerNorm eps 1e-12 with f32 statistics, erf-form GELU,
additive ``-10000`` masks in the model dtype, fused QKV / KV projections
feeding the attention kernel on the natural (B, S, H*D) layout.

Parameter names follow the flax tree (``query``/``key``/``value``/``out``/
``out_ln``, ``inter``/``out``), so the checkpoint converter
(``rgqa_tpu_torch.checkpoint.convert``) is a plain rename plus the
(in, out) -> (out, in) kernel transpose.  The attention-probs output, the
adversarial input deltas and training dropout are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from rgqa_tpu.config import EncoderConfig
from rgqa_tpu_torch.ops.attention import fused_attention
from rgqa_tpu_torch.ops.dropout import HiddenDropout

__all__ = [
    "NEG_INF_MASK",
    "gelu",
    "mask_to_bias",
    "LayerNorm",
    "TextEmbeddings",
    "AttentionBlock",
    "MLPBlock",
    "EncoderLayer",
    "CrossModalLayer",
    "Pooler",
]

NEG_INF_MASK = -10000.0  # the reference's additive mask value


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf-form GELU."""
    return F.gelu(x, approximate="none")


def mask_to_bias(mask: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, S) {0,1} mask -> (B, 1, 1, S) additive bias in ``dtype``."""
    return ((1.0 - mask.to(torch.float32)) * NEG_INF_MASK).to(dtype)[:, None, None, :]


class LayerNorm(nn.Module):
    """BERT LayerNorm: eps 1e-12, f32 statistics, cast back to input dtype
    (``weight``/``bias`` are flax's ``scale``/``bias``)."""

    def __init__(self, dim: int, eps: float = 1e-12):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # PyTorch's layer_norm accumulates bf16 inputs in f32 and rounds
        # only its output, so no f32 copy of x is needed.
        return F.layer_norm(
            x, x.shape[-1:], self.weight.to(x.dtype), self.bias.to(x.dtype), self.eps
        )


class TextEmbeddings(nn.Module):
    """Word + position + token-type embeddings, LayerNorm, dropout."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size
        )
        self.token_type_embeddings = nn.Embedding(
            cfg.type_vocab_size, cfg.hidden_size
        )
        self.layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.dropout = HiddenDropout(cfg.hidden_dropout)

    def forward(self, input_ids, token_type_ids=None):
        input_ids = input_ids.long()
        seq_len = input_ids.shape[-1]
        pos = torch.arange(seq_len, device=input_ids.device)[None, :]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (
            self.word_embeddings(input_ids)
            + self.position_embeddings(pos)
            + self.token_type_embeddings(token_type_ids.long())
        )
        return self.dropout(self.layer_norm(x))


class AttentionBlock(nn.Module):
    """Multi-head attention + output projection + residual LayerNorm, for
    self-attention (``kv`` None) and cross-attention.

    Self-attention runs one fused (E, 3E) QKV product and cross-attention
    one (E, 2E) KV product; their column slices go to the kernel as
    strided views, without copies.  ``use_fused``: None or True runs
    :func:`fused_attention` (the kernel on CUDA), False its plain version.
    """

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        e = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.query = nn.Linear(e, e)
        self.key = nn.Linear(e, e)
        self.value = nn.Linear(e, e)
        self.out = nn.Linear(e, e)
        self.out_ln = LayerNorm(e, cfg.layer_norm_eps)
        self.dropout = HiddenDropout(cfg.hidden_dropout)

    def forward(
        self, x, kv=None, bias=None, *, use_fused: Optional[bool] = None
    ) -> torch.Tensor:
        e = x.shape[-1]
        if kv is None:
            w = torch.cat([self.query.weight, self.key.weight, self.value.weight])
            b = torch.cat([self.query.bias, self.key.bias, self.value.bias])
            q, k, v = F.linear(x, w, b).split(e, dim=-1)
        else:
            q = self.query(x)
            w = torch.cat([self.key.weight, self.value.weight])
            b = torch.cat([self.key.bias, self.value.bias])
            k, v = F.linear(kv, w, b).split(e, dim=-1)
        ctx = fused_attention(
            q, k, v, bias, num_heads=self.num_heads,
            force_xla=use_fused is False,
        )
        out = self.dropout(self.out(ctx))
        return self.out_ln(out + x)


class MLPBlock(nn.Module):
    """GELU MLP + residual LayerNorm."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.inter = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.out = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.out_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.dropout = HiddenDropout(cfg.hidden_dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.dropout(self.out(gelu(self.inter(x))))
        return self.out_ln(h + x)


class EncoderLayer(nn.Module):
    """Standard BERT layer: self-attention + FFN."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.att = AttentionBlock(cfg)
        self.mlp = MLPBlock(cfg)

    def forward(self, x, bias=None, *, use_fused: Optional[bool] = None):
        return self.mlp(self.att(x, bias=bias, use_fused=use_fused))


class CrossModalLayer(nn.Module):
    """LXMERT cross-modal block: one ``cross_att`` shared by both
    directions, then per-modality self-attention and FFN."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cross_att = AttentionBlock(cfg)
        self.lang_self = AttentionBlock(cfg)
        self.visn_self = AttentionBlock(cfg)
        self.lang_mlp = MLPBlock(cfg)
        self.visn_mlp = MLPBlock(cfg)

    def forward(
        self, lang, lang_bias, visn, visn_bias, *, use_fused: Optional[bool] = None
    ):
        lang_x = self.cross_att(lang, kv=visn, bias=visn_bias, use_fused=use_fused)
        visn_x = self.cross_att(visn, kv=lang, bias=lang_bias, use_fused=use_fused)
        lang_x = self.lang_self(lang_x, bias=lang_bias, use_fused=use_fused)
        visn_x = self.visn_self(visn_x, bias=visn_bias, use_fused=use_fused)
        return self.lang_mlp(lang_x), self.visn_mlp(visn_x)


class Pooler(nn.Module):
    """CLS-token pooler: dense + tanh."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.dense(hidden[:, 0]))
