"""Training losses (port of ``rgqa_tpu/train/losses.py``; BCE so far, and
the binary loss of the JAX train step).

The reference's loss is ``nn.BCEWithLogitsLoss()(logit, target) *
logit.size(1)`` (``gqa_conf.py:197-199``): the mean over rows of the
per-row sum over answers.  The softmax-CE (``--mceLoss``), energy,
branched and weighted losses are not ported yet.  :func:`binary_loss` is
the JAX train step's ``binary`` branch (``rgqa_tpu/train/step.py:410-416``):
a separate detector's or the caption matcher's one logit against the
is-answerable indicator.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["optax_sigmoid_bce", "bce_answer_loss", "binary_loss"]


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


def binary_loss(logit: torch.Tensor, id_mask: torch.Tensor) -> torch.Tensor:
    """Sigmoid BCE of one logit a row (B,) against ``id_mask`` (1 for an
    answerable row), the mean over rows (``gqa_separate.py:117-157``,
    ``gqa_caption.py:112-121``)."""
    return optax_sigmoid_bce(logit, id_mask.to(torch.float32)).mean()
