"""BERT-style transformer blocks (port of ``rgqa_tpu/models/transformer.py``).

The blocks the LXMERT stack uses, for inference and training.  Numerics
follow the JAX package: LayerNorm eps 1e-12 with f32 statistics, erf-form
GELU, additive ``-10000`` masks in the compute dtype, fused QKV / KV
projections feeding the attention kernels on the natural (B, S, H*D)
layout.

Every block takes a compute ``dtype``, as flax's ``dtype=``: weights keep
their own dtype (f32 masters in training, bf16 for serving) and each
product and embedding casts its operands to the compute dtype at use.
In training mode, attention with a nonzero ``attention_dropout`` runs the
dropout kernels and the hidden-dropout sites draw from the ``rng``
(:class:`rgqa_tpu_torch.ops.dropout.DropoutRng`) each forward is given.

Parameter names follow the flax tree (``query``/``key``/``value``/``out``/
``out_ln``, ``inter``/``out``), so the checkpoint converter
(``rgqa_tpu_torch.checkpoint.convert``) is a plain rename plus the
(in, out) -> (out, in) kernel transpose.  ``output_probs`` (LXMERT's
cross-attention maps, for ``dump_attention``) computes the probabilities
explicitly through the plain product, as the JAX package does; every
other call keeps the kernels.  The adversarial input deltas are not
ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from rgqa_tpu_torch.config import EncoderConfig
from rgqa_tpu_torch.ops.attention import attention_probs, fused_attention, fused_attention_dropout
from rgqa_tpu_torch.ops.dropout import DropoutRng, HiddenDropout

__all__ = [
    "NEG_INF_MASK",
    "gelu",
    "mask_to_bias",
    "Dense",
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


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``dtype``: input, weight and bias are
    cast to it at use (flax ``nn.Dense(dtype=...)``)."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype = torch.float32,
                 *, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), None if self.bias is None else self.bias.to(dt))


class LayerNorm(nn.Module):
    """BERT LayerNorm: eps 1e-12, f32 statistics, cast back to input dtype
    (``weight``/``bias`` are flax's ``scale``/``bias``)."""

    def __init__(self, dim: int, eps: float = 1e-12):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight.dtype == x.dtype:
            # PyTorch's layer_norm accumulates bf16 inputs in f32 and
            # rounds only its output, so no f32 copy of x is needed.
            return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, self.eps)
        # Weights of another dtype (f32 masters under bf16 compute): the
        # statistics and the affine step in f32, then the input dtype.
        return F.layer_norm(
            x.float(), x.shape[-1:], self.weight.float(), self.bias.float(), self.eps
        ).to(x.dtype)


class TextEmbeddings(nn.Module):
    """Word + position + token-type embeddings, LayerNorm, dropout."""

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size
        )
        self.token_type_embeddings = nn.Embedding(
            cfg.type_vocab_size, cfg.hidden_size
        )
        self.layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.dropout = HiddenDropout(cfg.hidden_dropout)

    def forward(self, input_ids, token_type_ids=None, *, delta: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRng] = None):
        """``delta`` (B, T, H), VILLA's text perturbation, is added to the
        summed embeddings before the LayerNorm, in the compute dtype."""
        dt = self.compute_dtype
        input_ids = input_ids.long()
        seq_len = input_ids.shape[-1]
        pos = torch.arange(seq_len, device=input_ids.device)[None, :]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        # A lookup then a cast is the cast table's lookup, at a fraction
        # of the bytes.
        x = (
            self.word_embeddings(input_ids).to(dt)
            + self.position_embeddings(pos).to(dt)
            + self.token_type_embeddings(token_type_ids.long()).to(dt)
        )
        if delta is not None:
            x = x + delta.to(dt)
        return self.dropout(self.layer_norm(x), rng)


class AttentionBlock(nn.Module):
    """Multi-head attention + output projection + residual LayerNorm, for
    self-attention (``kv`` None) and cross-attention.

    Self-attention runs one fused (E, 3E) QKV product and cross-attention
    one (E, 2E) KV product; their column slices go to the kernels as
    strided views, without copies.  In training mode with a nonzero
    attention dropout the call goes to :func:`fused_attention_dropout`,
    seeded from ``rng.host``; otherwise to :func:`fused_attention`.
    ``use_fused``: None or True runs the kernels on CUDA, False their
    plain versions.  ``output_probs`` (eval mode only) computes the
    (B, H, Sq, Skv) probabilities explicitly, in the compute dtype, and
    returns ``(out, probs)``.
    """

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        e = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.attention_dropout = cfg.attention_dropout
        self.compute_dtype = dtype
        self.query = Dense(e, e, dtype)
        self.key = Dense(e, e, dtype)
        self.value = Dense(e, e, dtype)
        self.out = Dense(e, e, dtype)
        self.out_ln = LayerNorm(e, cfg.layer_norm_eps)
        self.dropout = HiddenDropout(cfg.hidden_dropout)

    def forward(
        self, x, kv=None, bias=None, *, use_fused: Optional[bool] = None,
        rng: Optional[DropoutRng] = None, output_probs: bool = False,
    ):
        e = x.shape[-1]
        dt = self.compute_dtype
        if kv is None:
            w = torch.cat([self.query.weight, self.key.weight, self.value.weight]).to(dt)
            b = torch.cat([self.query.bias, self.key.bias, self.value.bias]).to(dt)
            q, k, v = F.linear(x.to(dt), w, b).split(e, dim=-1)
        else:
            q = self.query(x)
            w = torch.cat([self.key.weight, self.value.weight]).to(dt)
            b = torch.cat([self.key.bias, self.value.bias]).to(dt)
            k, v = F.linear(kv.to(dt), w, b).split(e, dim=-1)
        force_xla = use_fused is False
        probs = None
        if output_probs:
            if self.training and self.attention_dropout > 0.0:
                raise NotImplementedError("output_probs with attention dropout (training mode)")
            b, sq, skv, h = x.shape[0], x.shape[1], k.shape[1], self.num_heads
            probs = attention_probs(q, k, bias, h).to(dt)
            ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v.reshape(b, skv, h, e // h))
            ctx = ctx.reshape(b, sq, e)
        elif self.training and self.attention_dropout > 0.0:
            seed = (rng or DropoutRng()).seed()
            ctx = fused_attention_dropout(
                q, k, v, bias, num_heads=self.num_heads,
                rate=self.attention_dropout, seed=seed, force_xla=force_xla,
            )
        else:
            ctx = fused_attention(
                q, k, v, bias, num_heads=self.num_heads, force_xla=force_xla
            )
        out = self.out_ln(self.dropout(self.out(ctx), rng) + x)
        return (out, probs) if output_probs else out


class MLPBlock(nn.Module):
    """GELU MLP + residual LayerNorm."""

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.inter = Dense(cfg.hidden_size, cfg.intermediate_size, dtype)
        self.out = Dense(cfg.intermediate_size, cfg.hidden_size, dtype)
        self.out_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.dropout = HiddenDropout(cfg.hidden_dropout)

    def forward(self, x: torch.Tensor, *, rng: Optional[DropoutRng] = None) -> torch.Tensor:
        h = self.dropout(self.out(gelu(self.inter(x))), rng)
        return self.out_ln(h + x)


class EncoderLayer(nn.Module):
    """Standard BERT layer: self-attention + FFN."""

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.att = AttentionBlock(cfg, dtype)
        self.mlp = MLPBlock(cfg, dtype)

    def forward(self, x, bias=None, *, use_fused: Optional[bool] = None, rng=None):
        return self.mlp(self.att(x, bias=bias, use_fused=use_fused, rng=rng), rng=rng)


class CrossModalLayer(nn.Module):
    """LXMERT cross-modal block: one ``cross_att`` shared by both
    directions, then per-modality self-attention and FFN."""

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cross_att = AttentionBlock(cfg, dtype)
        self.lang_self = AttentionBlock(cfg, dtype)
        self.visn_self = AttentionBlock(cfg, dtype)
        self.lang_mlp = MLPBlock(cfg, dtype)
        self.visn_mlp = MLPBlock(cfg, dtype)

    def forward(
        self, lang, lang_bias, visn, visn_bias, *, use_fused: Optional[bool] = None,
        rng: Optional[DropoutRng] = None, output_probs: bool = False,
    ):
        """``(lang, visn)``; with ``output_probs`` also the cross
        attention's ``(lang <- visn, visn <- lang)`` probabilities."""
        kw = dict(use_fused=use_fused, rng=rng)
        cross = dict(kw, output_probs=output_probs)
        lang_x = self.cross_att(lang, kv=visn, bias=visn_bias, **cross)
        visn_x = self.cross_att(visn, kv=lang, bias=lang_bias, **cross)
        if output_probs:
            (lang_x, l_probs), (visn_x, v_probs) = lang_x, visn_x
        lang_x = self.lang_self(lang_x, bias=lang_bias, **kw)
        visn_x = self.visn_self(visn_x, bias=visn_bias, **kw)
        out = self.lang_mlp(lang_x, rng=rng), self.visn_mlp(visn_x, rng=rng)
        return (*out, (l_probs, v_probs)) if output_probs else out


class Pooler(nn.Module):
    """CLS-token pooler: dense + tanh."""

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dense = Dense(cfg.hidden_size, cfg.hidden_size, dtype)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.dense(hidden[:, 0]))
