"""Where the port runs (the card unless the caller asks for the CPU), and
at what f32 precision where it must match the JAX package's f32."""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

__all__ = ["resolve_device", "exact_f32"]


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


@contextlib.contextmanager
def exact_f32():
    """f32 products at full precision inside the block: no TF32 in cuBLAS
    (PyTorch's default already) nor in cuDNN (PyTorch's default allows
    it, e.g. for a GRU).  The caller's settings are restored after it."""
    cudnn, precision = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.set_float32_matmul_precision(precision)
