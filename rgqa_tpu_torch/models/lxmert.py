"""LXMERT encoder + GQA answer head (port of ``rgqa_tpu/models/lxmert.py``).

9 language, 5 object-relation (vision self-attention) and 5 cross-modal
layers over (text tokens, 36 RoI features).  Every attention call goes
through :func:`rgqa_tpu_torch.ops.attention.fused_attention`: 34 per
forward at the default depths (9 + 5 + 4 per cross layer).

Not ported yet: the branched confidence heads, the pretraining heads and
the attention-probs output (``output_probs``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from rgqa_tpu.config import EncoderConfig
from rgqa_tpu_torch.models.transformer import (
    CrossModalLayer,
    EncoderLayer,
    LayerNorm,
    Pooler,
    TextEmbeddings,
    gelu,
    mask_to_bias,
)
from rgqa_tpu_torch.ops.dropout import HiddenDropout

__all__ = ["VisualFeatEncoder", "LxmertModel", "AnswerHead", "LxmertForGQA"]


class VisualFeatEncoder(nn.Module):
    """RoI-feature + box projections, each LayerNormed, averaged: ``(x + y) / 2``."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        e = cfg.hidden_size
        self.feat_proj = nn.Linear(cfg.visual_feat_dim, e)
        self.feat_ln = LayerNorm(e, cfg.layer_norm_eps)
        self.box_proj = nn.Linear(cfg.visual_pos_dim, e)
        self.box_ln = LayerNorm(e, cfg.layer_norm_eps)
        self.dropout = HiddenDropout(cfg.hidden_dropout)

    def forward(self, feats: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        dt = self.feat_proj.weight.dtype
        x = self.feat_ln(self.feat_proj(feats.to(dt)))
        y = self.box_ln(self.box_proj(boxes.to(dt)))
        return self.dropout((x + y) / 2)


class LxmertModel(nn.Module):
    """The language / vision / cross encoder, returning
    ``{"lang", "visn", "pooled"}``."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.embeddings = TextEmbeddings(cfg)
        self.visual = VisualFeatEncoder(cfg)
        self.lang_layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.l_layers))
        self.visn_layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.r_layers))
        self.x_layers = nn.ModuleList(CrossModalLayer(cfg) for _ in range(cfg.x_layers))
        self.pooler = Pooler(cfg)

    def forward(
        self,
        input_ids,
        input_mask,
        segment_ids=None,
        feats=None,
        boxes=None,
        visn_mask=None,
        *,
        use_fused: Optional[bool] = None,
    ) -> dict:
        dt = self.pooler.dense.weight.dtype
        lang_bias = mask_to_bias(input_mask, dt)
        visn_bias = mask_to_bias(visn_mask, dt) if visn_mask is not None else None

        lang = self.embeddings(input_ids, segment_ids)
        visn = self.visual(feats, boxes)
        for layer in self.lang_layers:
            lang = layer(lang, bias=lang_bias, use_fused=use_fused)
        for layer in self.visn_layers:
            visn = layer(visn, bias=visn_bias, use_fused=use_fused)
        for layer in self.x_layers:
            lang, visn = layer(lang, lang_bias, visn, visn_bias, use_fused=use_fused)
        return {"lang": lang, "visn": visn, "pooled": self.pooler(lang)}


class AnswerHead(nn.Module):
    """Dense -> GELU -> LayerNorm -> Dense classifier."""

    def __init__(self, num_answers: int, hidden_size: int = 768):
        super().__init__()
        self.dense = nn.Linear(hidden_size, hidden_size * 2)
        self.ln = LayerNorm(hidden_size * 2)
        self.logits = nn.Linear(hidden_size * 2, num_answers)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        return self.logits(self.ln(gelu(self.dense(pooled))))


class LxmertForGQA(nn.Module):
    """LXMERT + GQA answer head; returns ``{"logits", "pooled"}``."""

    def __init__(self, cfg: EncoderConfig, num_answers: int):
        super().__init__()
        self.lxmert = LxmertModel(cfg)
        self.answer_head = AnswerHead(num_answers, cfg.hidden_size)

    def forward(
        self, input_ids, input_mask, segment_ids, feats, boxes,
        *, use_fused: Optional[bool] = None,
    ) -> dict:
        enc = self.lxmert(
            input_ids, input_mask, segment_ids, feats, boxes, use_fused=use_fused
        )
        return {"logits": self.answer_head(enc["pooled"]), "pooled": enc["pooled"]}
