"""Where the port runs: the card unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[torch.device | str] = None) -> torch.device:
    """``device`` or, when None, CUDA.  Raises when CUDA is asked for (or
    defaulted to) and no card is present: the entry points never carry on
    on the CPU unless told to."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "rgqa_tpu_torch runs on a CUDA card and torch.cuda.is_available() "
            "is false; pass device='cpu' (--device cpu on the CLIs) to run on "
            "the CPU"
        )
    return device
