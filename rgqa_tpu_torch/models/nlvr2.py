"""NLVR2: the two-image reasoning model (port of ``rgqa_tpu/models/nlvr2.py``;
reference ``src/tasks/nlvr2_model.py``).

Each example pairs one sentence with two images.  The sentence is
repeated once per image (``repeat_interleave``: row 2i holds image 0 of
pair i, row 2i + 1 image 1, as ``feats.reshape(2B, K, F)`` lays them),
both (sentence, image) pairs run through the shared LXMERT encoder as one
batch of 2B, the two pooled vectors concatenate to a 2H feature, and
``fc1`` (2H), GELU, LayerNorm and ``fc2`` give 2 logits
(``nlvr2_model.py:18-52``).  Its attention runs the 20 / 36-token
kernels, at batch 2B.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from rgqa_tpu_torch.config import EncoderConfig
from rgqa_tpu_torch.models.lxmert import LxmertModel
from rgqa_tpu_torch.models.transformer import Dense, LayerNorm, gelu
from rgqa_tpu_torch.ops.dropout import DropoutRng

__all__ = ["Nlvr2Model"]


class Nlvr2Model(nn.Module):
    """Returns ``{"logits": (B, 2), "pooled": (B, 2H)}``."""

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.lxmert = LxmertModel(cfg, dtype)
        h2 = cfg.hidden_size * 2
        self.fc1 = Dense(h2, h2, dtype)
        self.ln = LayerNorm(h2, cfg.layer_norm_eps)
        self.fc2 = Dense(h2, 2, dtype)

    def forward(self, input_ids, input_mask, segment_ids, feats, boxes, *,
                use_fused: Optional[bool] = None, rng: Optional[DropoutRng] = None) -> dict:
        b, img_num, k, f = feats.shape
        if img_num != 2:
            raise ValueError(f"NLVR2 pairs two images with each sentence; feats hold {img_num}")

        def dup(x):
            return torch.repeat_interleave(x, 2, dim=0)

        enc = self.lxmert(dup(input_ids), dup(input_mask), dup(segment_ids), feats.reshape(b * 2, k, f),
                          boxes.reshape(b * 2, k, -1), use_fused=use_fused, rng=rng)
        pooled = enc["pooled"].reshape(b, -1)
        logits = self.fc2(self.ln(gelu(self.fc1(pooled))))
        return {"logits": logits, "pooled": pooled}
