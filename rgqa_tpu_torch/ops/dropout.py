"""Hidden-activation dropout sites (port of ``rgqa_tpu/ops/dropout.py``).

Only inference is ported: ``HiddenDropout`` is the identity in eval mode
or at rate 0.  The JAX package's training dropout compares one random
byte per element against a 1/256-quantized threshold
(``cheap_dropout``); that contract arrives with the training slice, and
until then a module in training mode with a nonzero rate raises rather
than drop with other semantics.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["HiddenDropout"]


class HiddenDropout(nn.Module):
    """Parameter-free dropout site; identity at inference."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        raise NotImplementedError(
            "training-mode dropout is not ported yet; call .eval() for inference"
        )
