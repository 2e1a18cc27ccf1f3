"""LXMERT encoder + GQA answer head (port of ``rgqa_tpu/models/lxmert.py``).

9 language, 5 object-relation (vision self-attention) and 5 cross-modal
layers over (text tokens, 36 RoI features).  Every attention call goes
through :func:`rgqa_tpu_torch.ops.attention.fused_attention` (or, in
training with attention dropout, ``fused_attention_dropout``): 34 per
forward at the default depths (9 + 5 + 4 per cross layer).  ``dtype`` is
the compute dtype of every block; the weights keep their own.

``output_probs`` returns the cross layers' attention maps as
``x_attention_probs`` (``dump_attention``'s), computed through the plain
product for those calls alone.  Not ported yet: the pretraining heads.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from rgqa_tpu_torch.config import EncoderConfig
from rgqa_tpu_torch.models.transformer import (
    CrossModalLayer,
    Dense,
    EncoderLayer,
    LayerNorm,
    Pooler,
    TextEmbeddings,
    gelu,
    mask_to_bias,
)
from rgqa_tpu_torch.ops.dropout import DropoutRng, HiddenDropout

__all__ = ["VisualFeatEncoder", "LxmertModel", "AnswerHead", "LxmertForGQA"]


class VisualFeatEncoder(nn.Module):
    """RoI-feature + box projections, each LayerNormed, averaged: ``(x + y) / 2``."""

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        e = cfg.hidden_size
        self.feat_proj = Dense(cfg.visual_feat_dim, e, dtype)
        self.feat_ln = LayerNorm(e, cfg.layer_norm_eps)
        self.box_proj = Dense(cfg.visual_pos_dim, e, dtype)
        self.box_ln = LayerNorm(e, cfg.layer_norm_eps)
        self.dropout = HiddenDropout(cfg.hidden_dropout)

    def forward(self, feats, boxes, *, rng: Optional[DropoutRng] = None) -> torch.Tensor:
        x = self.feat_ln(self.feat_proj(feats))
        y = self.box_ln(self.box_proj(boxes))
        return self.dropout((x + y) / 2, rng)


class LxmertModel(nn.Module):
    """The language / vision / cross encoder, returning ``{"lang",
    "visn", "pooled", "lang_layers"}``; ``lang_layers`` holds the
    language output of each cross layer (the taps of ``--branched_layer``).
    ``output_probs`` adds ``x_attention_probs``: per cross layer the
    (lang <- visn, visn <- lang) probabilities, each (B, H, Sq, Skv)."""

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.embeddings = TextEmbeddings(cfg, dtype)
        self.visual = VisualFeatEncoder(cfg, dtype)
        self.lang_layers = nn.ModuleList(EncoderLayer(cfg, dtype) for _ in range(cfg.l_layers))
        self.visn_layers = nn.ModuleList(EncoderLayer(cfg, dtype) for _ in range(cfg.r_layers))
        self.x_layers = nn.ModuleList(CrossModalLayer(cfg, dtype) for _ in range(cfg.x_layers))
        self.pooler = Pooler(cfg, dtype)

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
        rng: Optional[DropoutRng] = None,
        output_probs: bool = False,
    ) -> dict:
        dt = self.compute_dtype
        lang_bias = mask_to_bias(input_mask, dt)
        visn_bias = mask_to_bias(visn_mask, dt) if visn_mask is not None else None
        kw = dict(use_fused=use_fused, rng=rng)

        lang = self.embeddings(input_ids, segment_ids, rng=rng)
        visn = self.visual(feats, boxes, rng=rng)
        for layer in self.lang_layers:
            lang = layer(lang, bias=lang_bias, **kw)
        for layer in self.visn_layers:
            visn = layer(visn, bias=visn_bias, **kw)
        lang_layers, all_probs = [], []
        for layer in self.x_layers:
            if output_probs:
                lang, visn, probs = layer(lang, lang_bias, visn, visn_bias, output_probs=True, **kw)
                all_probs.append(probs)
            else:
                lang, visn = layer(lang, lang_bias, visn, visn_bias, **kw)
            lang_layers.append(lang)
        out = {"lang": lang, "visn": visn, "pooled": self.pooler(lang), "lang_layers": lang_layers}
        if output_probs:
            out["x_attention_probs"] = all_probs
        return out


class AnswerHead(nn.Module):
    """Dense -> GELU -> LayerNorm -> Dense classifier."""

    def __init__(self, num_answers: int, hidden_size: int = 768, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dense = Dense(hidden_size, hidden_size * 2, dtype)
        self.ln = LayerNorm(hidden_size * 2)
        self.logits = Dense(hidden_size * 2, num_answers, dtype)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        return self.logits(self.ln(gelu(self.dense(pooled))))


class LxmertForGQA(nn.Module):
    """LXMERT + GQA answer head; returns ``{"logits", "pooled"[,
    "conf"]}`` (``rgqa_tpu/models/lxmert.py:189-226``).

    ``branched``: ``conf`` is a one-logit ``AnswerHead`` on the pooled
    output (``gqa_model_branched.py:28-51``).  ``branched_layers``: each
    cross layer's language CLS goes through its own ``Dense(E,
    project_size)`` and tanh, and ``layer_conf`` maps their concatenation
    to one logit (``gqa_branched_layer.py:48-60``); it wins when both are
    set, as in the JAX model."""

    def __init__(
        self, cfg: EncoderConfig, num_answers: int, dtype: torch.dtype = torch.float32,
        *, branched: bool = False, branched_layers: bool = False, project_size: int = 128,
    ):
        super().__init__()
        self.lxmert = LxmertModel(cfg, dtype)
        self.answer_head = AnswerHead(num_answers, cfg.hidden_size, dtype)
        self.conf_head = AnswerHead(1, cfg.hidden_size, dtype) if branched else None
        self.projectors = self.layer_conf = None
        if branched_layers:
            self.projectors = nn.ModuleList(
                Dense(cfg.hidden_size, project_size, dtype) for _ in range(cfg.x_layers)
            )
            self.layer_conf = Dense(project_size * cfg.x_layers, 1, dtype)

    def forward(
        self, input_ids, input_mask, segment_ids, feats, boxes,
        *, use_fused: Optional[bool] = None, rng: Optional[DropoutRng] = None,
        output_probs: bool = False,
    ) -> dict:
        enc = self.lxmert(
            input_ids, input_mask, segment_ids, feats, boxes, use_fused=use_fused, rng=rng,
            output_probs=output_probs,
        )
        out = {"logits": self.answer_head(enc["pooled"]), "pooled": enc["pooled"]}
        if self.conf_head is not None:
            out["conf"] = self.conf_head(enc["pooled"])[:, 0]
        if self.projectors is not None:
            taps = [torch.tanh(proj(lang[:, 0])) for proj, lang in zip(self.projectors, enc["lang_layers"])]
            out["conf"] = self.layer_conf(torch.cat(taps, dim=-1))[:, 0]
        if output_probs:
            out["x_attention_probs"] = enc["x_attention_probs"]
        return out
