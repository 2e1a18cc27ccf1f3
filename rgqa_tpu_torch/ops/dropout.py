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

Under N data-parallel ranks (:meth:`DropoutRng.for_rank`) the draws split
in two streams.  What is drawn for the global batch (the shuffle, the RP
shift, the mixup and TreeMix draws, the pretraining masks) comes from
``host``, seeded alike on every rank.  The dropout itself is per rank:
the attention kernels key their mask on ``(seed, b, h, i, j)`` with
``b`` the rank's *local* row, so equal seeds would drop the same
positions of row ``b`` on every rank.  So ``device`` is seeded from
(seed, rank), and each attention seed is the shared draw mixed with the
rank (``salt``): the shared stream stays the one-process stream, dropout
or not, and the masks differ across ranks.  On one rank both streams are
the ones a one-process run has always drawn.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

__all__ = ["DropoutRng", "mix_seed", "keep_threshold", "cheap_dropout", "HiddenDropout"]

_SEED_HIGH = 2**63 - 1  # seeds are drawn in [0, 2^63): one int64, no sign games
_MASK64 = 2**64 - 1


def mix_seed(seed: int, salt: int) -> int:
    """A 63-bit seed from ``seed`` and ``salt`` (splitmix64's finalizer):
    distinct salts give unrelated seeds."""
    z = (seed + (salt + 1) * 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & _SEED_HIGH


@dataclasses.dataclass
class DropoutRng:
    """Generators of one training run.  ``None`` uses PyTorch's default
    generator of the device in question.  ``salt`` (a rank's, under
    several ranks) is mixed into every attention seed."""

    device: Optional[torch.Generator] = None
    host: Optional[torch.Generator] = None
    salt: Optional[int] = None

    @classmethod
    def for_rank(cls, seed: int, device, *, rank: int = 0, world: int = 1) -> "DropoutRng":
        """The generators of rank ``rank`` of ``world`` in a run seeded with
        ``seed``: ``host`` seeded with ``seed`` on every rank; on one rank
        ``device`` too and no salt (a one-process run's streams), else
        ``device`` from (seed, rank) and the rank as the salt."""
        salt = None if world == 1 else rank
        device_seed = seed if salt is None else mix_seed(seed, salt)
        return cls(device=torch.Generator(device=device).manual_seed(device_seed),
                   host=torch.Generator().manual_seed(seed), salt=salt)

    def seed(self) -> int:
        """A 63-bit seed for one attention-dropout call, from the host
        generator (no device sync), mixed with ``salt`` when there is
        one."""
        seed = int(torch.randint(0, _SEED_HIGH, (), generator=self.host))
        return seed if self.salt is None else mix_seed(seed, self.salt)

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
