"""LXMERT encoder + GQA answer head (port of ``rgqa_tpu/models/lxmert.py``).

9 language, 5 object-relation (vision self-attention) and 5 cross-modal
layers over (text tokens, 36 RoI features).  Every attention call goes
through :func:`rgqa_tpu_torch.ops.attention.fused_attention` (or, in
training with attention dropout, ``fused_attention_dropout``): 34 per
forward at the default depths (9 + 5 + 4 per cross layer).  ``dtype`` is
the compute dtype of every block; the weights keep their own.

``output_probs`` returns the cross layers' attention maps as
``x_attention_probs`` (``dump_attention``'s), computed through the plain
product for those calls alone.

:class:`LxmertPretraining` is the encoder with the pretraining heads
(reference ``modeling.py:889-1002``): the masked-LM head decoding onto the
tied word table, the visual heads, the matched head and the 9500-answer
QA head.  Its matched head backs the LXMERT match rejection scorer
(``match_score``).  The heads keep the reference ``model_LXRT.pth`` names
(``cls.predictions.*``, ``cls.seq_relationship``, ``obj_predict_head.*``,
``answer_head.logit_fc.*``); the encoder is the port's ``lxmert.*``, as in
:class:`LxmertForGQA`.
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

__all__ = ["VisualFeatEncoder", "LxmertModel", "AnswerHead", "LxmertForGQA", "MLMHead", "VisualObjHead",
           "LxmertPretraining"]


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
    (lang <- visn, visn <- lang) probabilities, each (B, H, Sq, Skv).
    VILLA's perturbations (the reference's ``src/lxrt_adv`` fork):
    ``txt_delta`` (B, T, H) is added to the summed word embeddings before
    their LayerNorm, ``img_delta`` (B, K, F) to the RoI features."""

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
        txt_delta: Optional[torch.Tensor] = None,
        img_delta: Optional[torch.Tensor] = None,
    ) -> dict:
        dt = self.compute_dtype
        lang_bias = mask_to_bias(input_mask, dt)
        visn_bias = mask_to_bias(visn_mask, dt) if visn_mask is not None else None
        kw = dict(use_fused=use_fused, rng=rng)

        lang = self.embeddings(input_ids, segment_ids, delta=txt_delta, rng=rng)
        if img_delta is not None:
            feats = feats + img_delta.to(feats.dtype)
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
        output_probs: bool = False, txt_delta: Optional[torch.Tensor] = None,
        img_delta: Optional[torch.Tensor] = None,
    ) -> dict:
        enc = self.lxmert(
            input_ids, input_mask, segment_ids, feats, boxes, use_fused=use_fused, rng=rng,
            output_probs=output_probs, txt_delta=txt_delta, img_delta=img_delta,
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


class _HeadTransform(nn.Module):
    """Dense -> GELU -> LayerNorm (reference ``BertPredictionHeadTransform``)."""

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype):
        super().__init__()
        self.dense = Dense(cfg.hidden_size, cfg.hidden_size, dtype)
        self.LayerNorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(gelu(self.dense(x)))


class MLMHead(nn.Module):
    """Masked-LM head (``cls.predictions``; reference
    ``BertLMPredictionHead``, ``modeling.py:601-625``): the transform, then
    the decoder that shares the word-embedding matrix, plus a free bias."""

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.transform = _HeadTransform(cfg, dtype)
        self.bias = nn.Parameter(torch.zeros(cfg.vocab_size))

    def forward(self, hidden: torch.Tensor, word_table: torch.Tensor) -> torch.Tensor:
        h = self.transform(hidden)
        return h @ word_table.T.to(h.dtype) + self.bias


class _PretrainingHeads(nn.Module):
    """``cls``: the masked-LM head and the matched head."""

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype):
        super().__init__()
        self.predictions = MLMHead(cfg, dtype)
        self.seq_relationship = Dense(cfg.hidden_size, 2, dtype)


class VisualObjHead(nn.Module):
    """Masked-object heads (``obj_predict_head``; reference
    ``BertVisualObjHead``, ``modeling.py:628-650``): the shared transform,
    one decoder per visual loss."""

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.transform = _HeadTransform(cfg, dtype)
        self.decoder_dict = nn.ModuleDict({
            "obj": Dense(cfg.hidden_size, cfg.obj_vocab_size, dtype),
            "attr": Dense(cfg.hidden_size, cfg.attr_vocab_size, dtype),
            "feat": Dense(cfg.hidden_size, cfg.visual_feat_dim, dtype),
        })

    def forward(self, hidden: torch.Tensor) -> dict:
        h = self.transform(hidden)
        return {name: dec(h) for name, dec in self.decoder_dict.items()}


class _GeLU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu(x)


class _QAHead(nn.Module):
    """``answer_head.logit_fc``: Linear, GeLU, LayerNorm, Linear (the
    reference ``BertVisualAnswerHead``), indices 0, 2, 3 holding weights."""

    def __init__(self, cfg: EncoderConfig, num_answers: int, dtype: torch.dtype):
        super().__init__()
        e = cfg.hidden_size
        self.logit_fc = nn.Sequential(
            Dense(e, 2 * e, dtype), _GeLU(), LayerNorm(2 * e, cfg.layer_norm_eps),
            Dense(2 * e, num_answers, dtype),
        )

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        return self.logit_fc(pooled)


class LxmertPretraining(nn.Module):
    """LXMERT with the pretraining heads (``rgqa_tpu/models/lxmert.py:285``);
    returns ``{"mlm", "visn", "matched", "qa", "pooled"}`` of raw logits
    (``visn``: ``{"obj", "attr", "feat"}``)."""

    def __init__(self, cfg: EncoderConfig, num_answers: int = 9500, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.lxmert = LxmertModel(cfg, dtype)
        self.cls = _PretrainingHeads(cfg, dtype)
        self.obj_predict_head = VisualObjHead(cfg, dtype)
        self.answer_head = _QAHead(cfg, num_answers, dtype)

    def forward(
        self, input_ids, input_mask, segment_ids, feats, boxes, *, use_fused: Optional[bool] = None,
        rng: Optional[DropoutRng] = None,
    ) -> dict:
        enc = self.lxmert(input_ids, input_mask, segment_ids, feats, boxes, use_fused=use_fused, rng=rng)
        return {
            "mlm": self.cls.predictions(enc["lang"], self.lxmert.embeddings.word_embeddings.weight),
            "visn": self.obj_predict_head(enc["visn"]),
            "matched": self.cls.seq_relationship(enc["pooled"]),
            "qa": self.answer_head(enc["pooled"]),
            "pooled": enc["pooled"],
        }

    def match_score(self, input_ids, input_mask, segment_ids, feats, boxes, **kw) -> torch.Tensor:
        """Cross-modal match probability, ``softmax(matched)[:, 1]`` in f32
        (the ``lxrcap`` rejection scorer, ``gqa_lxrcap.py:98-120``)."""
        out = self(input_ids, input_mask, segment_ids, feats, boxes, **kw)
        return torch.softmax(out["matched"].float(), dim=-1)[:, 1]
