"""Hidden-activation dropout (port of ``rgqa_tpu/ops/dropout.py``).

``cheap_dropout`` keeps the JAX package's contract: one random byte per
element, kept iff ``byte >= t`` with ``t = round(rate * 256)``, kept
values scaled by ``256 / (256 - t)``, so ``E[out] = x`` holds exactly at
the 1/256-quantized rate (BERT's 0.1 becomes 26/256).  ``t <= 0`` is the
identity and ``t >= 256`` gives zeros.  The bytes come from a
``torch.Generator`` on the tensor's device; they cannot match the TPU's
bits, so the tests hold the contract, not the stream.  It is plain
PyTorch: an elementwise pass needs no hand-written kernel.

``DropoutRng`` carries the two generators a training forward draws from:
``device`` for the hidden-dropout bytes (drawn where the activations
live) and ``host``, a CPU generator, for the attention kernels' seeds and
the RP shift, so that no draw waits on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

__all__ = ["DropoutRng", "keep_threshold", "cheap_dropout", "HiddenDropout"]

_SEED_HIGH = 2**63 - 1  # seeds are drawn in [0, 2^63): one int64, no sign games


@dataclasses.dataclass
class DropoutRng:
    """Generators of one training run.  ``None`` uses PyTorch's default
    generator of the device in question."""

    device: Optional[torch.Generator] = None
    host: Optional[torch.Generator] = None

    def seed(self) -> int:
        """A 63-bit seed for one attention-dropout call, from the host
        generator (no device sync)."""
        return int(torch.randint(0, _SEED_HIGH, (), generator=self.host))

    def shift(self, b: int) -> int:
        """The RP roll in [1, b - 1], from the host generator."""
        return int(torch.randint(1, b, (), generator=self.host))

    def state(self) -> dict:
        return {
            "device": None if self.device is None else self.device.get_state(),
            "host": None if self.host is None else self.host.get_state(),
        }

    def load_state(self, state: dict) -> None:
        for name in ("device", "host"):
            gen = getattr(self, name)
            if gen is not None and state.get(name) is not None:
                gen.set_state(state[name])


def keep_threshold(rate: float) -> tuple[int, float]:
    """``(t, keep_p)`` with ``P(byte >= t) = keep_p`` exactly
    (``_keep_threshold`` in the JAX package's attention module)."""
    t = int(round(min(max(float(rate), 0.0), 1.0) * 256.0))
    return t, (256 - t) / 256.0


def cheap_dropout(
    x: torch.Tensor, rate: float, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """Inverted dropout at the 1/256-quantized rate, exact expectation."""
    t = int(round(float(rate) * 256.0))
    if t <= 0:
        return x
    if t >= 256:
        return torch.zeros_like(x)
    keep_p = (256 - t) / 256.0
    byte = torch.randint(
        0, 256, x.shape, dtype=torch.uint8, device=x.device, generator=generator
    )
    return torch.where(byte >= t, x * (1.0 / keep_p), torch.zeros_like(x))


class HiddenDropout(nn.Module):
    """Parameter-free dropout site: identity at inference or rate 0,
    :func:`cheap_dropout` in training mode."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, rng: Optional[DropoutRng] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        return cheap_dropout(x, self.rate, rng.device if rng is not None else None)
