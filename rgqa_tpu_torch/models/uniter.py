"""UNITER: the single-stream text + image encoder and its GQA answer head
(port of ``rgqa_tpu/models/uniter.py``).

Text embeddings and RoI-feature embeddings (with UNITER's 7-d box
transform) are concatenated into one stream of ``max_text_len`` +
``num_objects`` tokens (20 + 36 = 56 at full width) through ``num_layers``
of the port's :class:`~rgqa_tpu_torch.models.transformer.EncoderLayer`;
the pooled CLS feeds :class:`~rgqa_tpu_torch.models.lxmert.AnswerHead`.
Every attention call is a self-attention over the whole stream, through
:func:`rgqa_tpu_torch.ops.attention.fused_attention` (or, in training
with attention dropout, ``fused_attention_dropout``): ``num_layers`` per
forward, 12 at full width.  The text pads sit in the middle of the keys,
between the question and the image tokens.  ``dtype`` is the compute
dtype of every block; the weights keep their own.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from rgqa_tpu_torch.config import EncoderConfig
from rgqa_tpu_torch.models.lxmert import AnswerHead
from rgqa_tpu_torch.models.transformer import (
    Dense,
    EncoderLayer,
    LayerNorm,
    Pooler,
    TextEmbeddings,
    mask_to_bias,
)
from rgqa_tpu_torch.ops.dropout import DropoutRng, HiddenDropout

__all__ = ["UNITER_POS_DIM", "uniter_box_transform", "UniterImageEmbeddings", "UniterModel",
           "UniterForGQA"]

UNITER_POS_DIM = 7  # the box transform's columns


def uniter_box_transform(boxes: np.ndarray) -> np.ndarray:
    """(x1, y1, x2, y2) RoI boxes -> UNITER's 7-d position feature.

    As the reference's ``_uniterBoxes`` (``gqa_data.py:240-250``), quirks
    included: the columns are (y1, x1, y2, x2, w, h, w*h), with w = x2 -
    x1 and h = y2 - y1, and it takes *unnormalised pixel* boxes (the
    division by the image size runs on the other backbones' branch only).
    """
    boxes = np.asarray(boxes, dtype=np.float32)
    out = np.zeros(boxes.shape[:-1] + (UNITER_POS_DIM,), dtype=np.float32)
    out[..., 0] = boxes[..., 1]  # y1
    out[..., 1] = boxes[..., 0]  # x1
    out[..., 2] = boxes[..., 3]  # y2
    out[..., 3] = boxes[..., 2]  # x2
    out[..., 4] = out[..., 3] - out[..., 1]  # width  (x2 - x1)
    out[..., 5] = out[..., 2] - out[..., 0]  # height (y2 - y1)
    out[..., 6] = out[..., 4] * out[..., 5]  # area
    return out


class UniterImageEmbeddings(nn.Module):
    """RoI feature + 7-d position embeddings (``modeling.py:594-612``):
    each projected and LayerNormed, summed with the image token type,
    LayerNormed again, then hidden dropout."""

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        e = cfg.hidden_size
        self.img_linear = Dense(cfg.visual_feat_dim, e, dtype)
        self.img_ln = LayerNorm(e, cfg.layer_norm_eps)
        self.pos_linear = Dense(UNITER_POS_DIM, e, dtype)
        self.pos_ln = LayerNorm(e, cfg.layer_norm_eps)
        self.ln = LayerNorm(e, cfg.layer_norm_eps)
        self.dropout = HiddenDropout(cfg.hidden_dropout)

    def forward(self, img_feat, img_pos, type_embeddings, *, rng: Optional[DropoutRng] = None):
        im = self.img_ln(self.img_linear(img_feat))
        pos = self.pos_ln(self.pos_linear(img_pos))
        return self.dropout(self.ln(im + pos + type_embeddings), rng)


class UniterModel(nn.Module):
    """The single-stream encoder, returning ``{"stream", "pooled"}``."""

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.embeddings = TextEmbeddings(cfg, dtype)
        self.img_embeddings = UniterImageEmbeddings(cfg, dtype)
        self.layers = nn.ModuleList(EncoderLayer(cfg, dtype) for _ in range(cfg.num_layers))
        self.pooler = Pooler(cfg, dtype)

    def forward(
        self, input_ids, input_mask, segment_ids, img_feats, img_pos, img_mask=None,
        *, use_fused: Optional[bool] = None, rng: Optional[DropoutRng] = None,
    ) -> dict:
        dt = self.compute_dtype
        b, n_obj = img_feats.shape[:2]
        if img_mask is None:
            img_mask = torch.ones((b, n_obj), dtype=input_mask.dtype, device=input_mask.device)
        text = self.embeddings(input_ids, segment_ids, rng=rng)
        # Image tokens take token type 1 through the *text* embeddings'
        # type table (reference ``modeling.py:621-623``).
        img_types = torch.ones((b, n_obj), dtype=torch.long, device=input_ids.device)
        type_emb = self.embeddings.token_type_embeddings(img_types).to(dt)
        img = self.img_embeddings(img_feats, img_pos, type_emb, rng=rng)
        stream = torch.cat([text, img], dim=1)
        bias = mask_to_bias(torch.cat([input_mask, img_mask.to(input_mask.dtype)], dim=1), dt)
        for layer in self.layers:
            stream = layer(stream, bias=bias, use_fused=use_fused, rng=rng)
        return {"stream": stream, "pooled": self.pooler(stream)}


class UniterForGQA(nn.Module):
    """UNITER + the GQA answer head (reference ``uniter.py:15-75``);
    returns ``{"logits", "pooled"}``.  It has no branched confidence head
    (nor has the JAX package's UNITER)."""

    def __init__(self, cfg: EncoderConfig, num_answers: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.uniter = UniterModel(cfg, dtype)
        self.answer_head = AnswerHead(num_answers, cfg.hidden_size, dtype)

    def forward(
        self, input_ids, input_mask, segment_ids, img_feats, img_pos,
        *, use_fused: Optional[bool] = None, rng: Optional[DropoutRng] = None,
    ) -> dict:
        enc = self.uniter(
            input_ids, input_mask, segment_ids, img_feats, img_pos, use_fused=use_fused, rng=rng
        )
        return {"logits": self.answer_head(enc["pooled"]), "pooled": enc["pooled"]}
