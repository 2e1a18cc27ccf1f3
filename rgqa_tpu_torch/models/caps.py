"""The caption-question matcher, the Q-C rejection scorer's model (port of
``rgqa_tpu/models/caps.py``).

A text-only BERT over the pair ``[CLS] caption [SEP] question [SEP]``
(reference ``src/caps/caps.py:14-65``) on the port's
:class:`~rgqa_tpu_torch.models.transformer.TextEmbeddings`,
:class:`~rgqa_tpu_torch.models.transformer.EncoderLayer` and
:class:`~rgqa_tpu_torch.models.transformer.Pooler`: ``num_layers``
self-attentions a forward over ``max_text_len`` tokens (12 at 20 x 20
at full width), through :func:`~rgqa_tpu_torch.ops.attention.fused_attention`
or, in training with attention dropout, ``fused_attention_dropout``;
the pair's pads sit at the end of the keys.  The match head reads the
*raw* CLS hidden state, not the tanh pooler's output
(``caps.py:58-64``): dense 2h -> GELU -> LayerNorm -> dense 1, one match
logit a row.  ``pooled`` stays the BERT pooler's output.  ``dtype`` is
the compute dtype of every block; the weights keep their own.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from rgqa_tpu_torch.config import EncoderConfig
from rgqa_tpu_torch.models.lxmert import AnswerHead
from rgqa_tpu_torch.models.transformer import EncoderLayer, Pooler, TextEmbeddings, mask_to_bias
from rgqa_tpu_torch.ops.dropout import DropoutRng

__all__ = ["MatchHead", "CaptionMatcher"]


class MatchHead(AnswerHead):
    """The reference ``logit_fc``: Linear(h, 2h) -> GeLU -> BertLayerNorm ->
    Linear(2h, 1) (``caps.py:23-28``), LXMERT's answer head with one
    output."""

    def __init__(self, hidden_size: int, dtype: torch.dtype = torch.float32):
        super().__init__(1, hidden_size, dtype)


class CaptionMatcher(nn.Module):
    """Single-stream text-pair encoder with a one-logit match head;
    returns ``{"logits": (B,), "pooled": (B, hidden)}``."""

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.embeddings = TextEmbeddings(cfg, dtype)
        self.layers = nn.ModuleList(EncoderLayer(cfg, dtype) for _ in range(cfg.num_layers))
        self.pooler = Pooler(cfg, dtype)
        self.match_head = MatchHead(cfg.hidden_size, dtype)

    def forward(
        self, input_ids, input_mask, segment_ids, *, use_fused: Optional[bool] = None,
        rng: Optional[DropoutRng] = None,
    ) -> dict:
        bias = mask_to_bias(input_mask, self.compute_dtype)
        x = self.embeddings(input_ids, segment_ids, rng=rng)
        for layer in self.layers:
            x = layer(x, bias=bias, use_fused=use_fused, rng=rng)
        return {"logits": self.match_head(x[:, 0])[:, 0], "pooled": self.pooler(x)}
