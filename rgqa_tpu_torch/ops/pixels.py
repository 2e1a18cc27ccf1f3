"""On-device pixel normalization for the uint8 pixel wire (port of
``rgqa_tpu/ops/pixels.py``).

The image backbones take pixels as uint8 rows plus the real-pixel
rectangle (``--pixel_wire u8``, the default) and normalize on the
device, in f32, with the JAX package's expressions; eager, they agree
with it bit for bit (``tests/test_torch_vilt.py``).  Plain tensor code:
the JAX package runs these under XLA, outside Pallas.

- :func:`pixelbert_normalize` -- ViLT's inception normalize
  ``(x/255 - 0.5)/0.5`` with the pad region re-zeroed from the rect (a
  uint8 cannot carry the post-normalize 0.0 of a pad pixel).

CLIP's normalize waits for the slice that ports a CLIP backbone.
"""

from __future__ import annotations

import torch

__all__ = ["pixelbert_normalize"]


def pixelbert_normalize(u8: torch.Tensor, rect: torch.Tensor) -> torch.Tensor:
    """(B, S, S, 3) uint8 + (B, 4) ``(top, left, h, w)`` rects -> f32
    pixels in [-1, 1] on the same device, exactly 0.0 outside each rect."""
    x = (u8.to(torch.float32) / 255.0 - 0.5) / 0.5
    coord = torch.arange(u8.shape[-3], device=u8.device)[None, :]
    top, left, h, w = (rect[:, i : i + 1] for i in range(4))
    rows = (coord >= top) & (coord < top + h)  # (B, S)
    cols = (coord >= left) & (coord < left + w)
    inside = rows[:, :, None] & cols[:, None, :]  # (B, S, S)
    return x * inside[..., None].to(torch.float32)

