"""Training losses (port of ``rgqa_tpu/train/losses.py``; BCE so far).

The reference's loss is ``nn.BCEWithLogitsLoss()(logit, target) *
logit.size(1)`` (``gqa_conf.py:197-199``): the mean over rows of the
per-row sum over answers.  The softmax-CE (``--mceLoss``), energy,
branched and weighted losses are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["optax_sigmoid_bce", "bce_answer_loss"]


def optax_sigmoid_bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Stable element-wise BCE-with-logits:
    ``max(x, 0) - x z + log(1 + exp(-|x|))``."""
    return torch.clamp(logits, min=0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def bce_answer_loss(
    logits: torch.Tensor, targets: torch.Tensor, row_mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Per-answer binary CE, scaled by the answer count; ``row_mask``
    averages over the selected rows only."""
    per_row = optax_sigmoid_bce(logits, targets).mean(dim=-1)
    if row_mask is None:
        mean = per_row.mean()
    else:
        mask = row_mask.to(per_row.dtype)
        mean = (per_row * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return mean * logits.shape[-1]
