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
- :func:`clip_normalize` -- CLIP's mean / std normalize of the
  center-cropped rows (no pad region), the device-side twin of
  ``scorers.clip.clip_normalize``.
"""

from __future__ import annotations

import torch

__all__ = ["pixelbert_normalize", "clip_normalize", "CLIP_MEAN", "CLIP_STD"]

# HF CLIPImageProcessor's constants (OPENAI_CLIP_MEAN / STD).
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


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



def clip_normalize(u8: torch.Tensor) -> torch.Tensor:
    """(B, S, S, 3) uint8 -> f32 CLIP-normalized pixels on the same device:
    ``(x / 255 - mean) / std`` in f32."""
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=u8.device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=u8.device)
    return (u8.to(torch.float32) / 255.0 - mean) / std
