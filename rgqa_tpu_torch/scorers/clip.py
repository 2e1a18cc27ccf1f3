"""CLIP image-question similarity (port of ``rgqa_tpu/scorers/clip.py``).

The CLIP rejection score (``src/tasks/gqa_clip.py:76-110``:
``logits_per_image / logit_scale.exp()``, the cosine similarity of the
image and question embeddings) from a local HF CLIP checkpoint directory
(``config.json``, ``pytorch_model.bin``, ``vocab.json``, ``merges.txt``),
run by the port's :class:`~rgqa_tpu_torch.models.clip.ClipModel` on the
card unless the caller asks for the CPU.  Nothing is downloaded.

Pixels cross to the device as uint8 rows (the resize-and-crop output)
and are normalized there (:func:`rgqa_tpu_torch.ops.pixels.clip_normalize`,
the f32 expression of :func:`clip_normalize` here).  The JAX scorer pads
every batch to its jitted shape; the port needs no static shapes, and
padding changes no score, so it pads nothing.

Copies of the JAX module's image functions: :func:`clip_resize_crop`
(needs PIL, imported inside: the machine with the card has none, and
feeds CLIP from a pixel pack), :func:`clip_normalize`,
:func:`clip_preprocess` and :func:`clip_loss_weights`.  Not ported: the
``transformers`` fallback (``backend="torch"``).  A directory with the
JAX package's orbax ``jax_params/`` tree loads the ``pytorch_model.bin``
that ``orbax_to_pth.py`` writes beside it (where the JAX package loads
``jax_params/``); without it the directory is refused, naming the
command.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from rgqa_tpu_torch.checkpoint.convert import load_clip_state_dict, orbax_refusal
from rgqa_tpu_torch.data.clip_tokenizer import ClipBPETokenizer
from rgqa_tpu_torch.device import resolve_device
from rgqa_tpu_torch.models.clip import ClipModel, clip_config_from_hf
from rgqa_tpu_torch.ops import pixels

__all__ = [
    "ClipScorer",
    "clip_preprocess",
    "clip_resize_crop",
    "clip_normalize",
    "clip_loss_weights",
]

CLIP_MEAN = np.asarray(pixels.CLIP_MEAN, np.float32)
CLIP_STD = np.asarray(pixels.CLIP_STD, np.float32)


def clip_resize_crop(image, size: int = 224) -> np.ndarray:
    """PIL image -> (size, size, 3) uint8: the decode-side half of
    :func:`clip_preprocess` (bicubic shortest-edge resize + center crop)."""
    from PIL import Image

    image = image.convert("RGB")
    w, h = image.size
    if w <= h:
        new_w, new_h = size, int(size * h / w)
    else:
        new_w, new_h = int(size * w / h), size
    image = image.resize((new_w, new_h), Image.BICUBIC)
    arr = np.asarray(image, np.uint8)
    top = (new_h - size) // 2
    left = (new_w - size) // 2
    return arr[top : top + size, left : left + size]


def clip_normalize(arr_u8: np.ndarray) -> np.ndarray:
    """uint8 pixels -> float32: rescale 1/255, CLIP mean/std normalize."""
    return (np.asarray(arr_u8, np.float32) / 255.0 - CLIP_MEAN) / CLIP_STD


def clip_preprocess(image, size: int = 224) -> np.ndarray:
    """PIL image -> (size, size, 3) float32, matching HF
    ``CLIPImageProcessor``: bicubic resize of the shortest edge to
    ``size``, center crop, rescale 1/255, mean/std normalize;
    channels-last."""
    return clip_normalize(clip_resize_crop(image, size))


class ClipScorer:
    """Image-text similarity from a local HF CLIP checkpoint directory.

    ``batch_size`` questions per forward; ``use_bf16`` computes in bf16
    (default f32, as the JAX CLI builds it); ``device`` defaults to the
    card.  ``use_fused`` is the attention kernel's switch (None or True:
    kernel #1 on the card; False: its plain version)."""

    def __init__(
        self,
        model_path: str = "openai/clip-vit-base-patch32",
        batch_size: int = 32,
        use_bf16: bool = False,
        device: Optional[torch.device | str] = None,
        use_fused: Optional[bool] = None,
    ):
        if os.path.isdir(os.path.join(model_path, "jax_params")) and not os.path.isfile(
                os.path.join(model_path, "pytorch_model.bin")):
            # The JAX export writes no .bin beside jax_params/: one there is
            # orbax_to_pth.py's export of it, which is loaded in its place.
            raise orbax_refusal("--clip_path", os.path.join(model_path, "jax_params"),
                                os.path.join(model_path, "pytorch_model.bin"))
        self.model_path = model_path
        self.batch_size = batch_size
        self.use_fused = use_fused
        self.device = resolve_device(device)
        with open(os.path.join(model_path, "config.json")) as f:
            self.cfg = clip_config_from_hf(json.load(f))
        self.tokenizer = ClipBPETokenizer.from_dir(model_path)
        with torch.device(self.device):
            self.model = ClipModel(self.cfg, torch.bfloat16 if use_bf16 else torch.float32)
        missing, _ = self.model.load_state_dict(load_clip_state_dict(model_path), strict=False)
        if missing:
            raise ValueError(f"CLIP checkpoint {model_path!r} is missing keys: {missing[:5]}")
        self.model.eval()
        self.logit_scale = float(torch.exp(self.model.logit_scale.detach().float()))

    @property
    def image_size(self) -> int:
        """The pixel edge the scorer consumes: a CLIP :class:`PixelPack`
        of this size can stand in for the decoded images."""
        return self.cfg.image_size

    @property
    def consumes_uint8_rows(self) -> bool:
        """``scores`` takes pre-resized uint8 (image_size, image_size, 3)
        rows in place of PIL images; pack detection keys on this flag."""
        return True

    def _pixels(self, images) -> np.ndarray:
        """Images -> uint8 (B, S, S, 3); decoded uint8 rows pass as they are."""
        return np.stack([
            im if isinstance(im, np.ndarray) and im.dtype == np.uint8
            else clip_resize_crop(im, self.cfg.image_size)
            for im in images
        ])

    def _tokens(self, texts: Sequence[str]):
        return self.tokenizer.encode_batch(list(texts), self.cfg.max_text_len)

    def _batches(self, *arrays):
        """Device tensors of each ``batch_size`` chunk of ``arrays``."""
        for s in range(0, len(arrays[0]), self.batch_size):
            yield [torch.from_numpy(np.ascontiguousarray(a[s : s + self.batch_size])).to(self.device)
                   for a in arrays]

    @torch.inference_mode()
    def scores(self, images, texts: Sequence[str]) -> np.ndarray:
        """Cosine similarity per (image, text) pair (``gqa_clip.py:96-104``)."""
        ids, mask = self._tokens(texts)
        out = [self.model.cosine(i, m, pixels.clip_normalize(px), use_fused=self.use_fused)
               for i, m, px in self._batches(ids, mask, self._pixels(images))]
        return torch.cat(out).cpu().numpy() if out else np.zeros(0, np.float32)

    def weight_similarity(self, images, texts: Sequence[str]) -> np.ndarray:
        """Scaled similarity for the weight strategy (``gqa_weight.py:184-186``:
        the embedding inner product times ``logit_scale.exp()``)."""
        return self.scores(images, texts) * self.logit_scale

    @torch.inference_mode()
    def image_embeds(self, images) -> np.ndarray:
        """L2-normalized projected image embeddings."""
        out = [self.model.image_features(pixels.clip_normalize(px), use_fused=self.use_fused).float()
               for (px,) in self._batches(self._pixels(images))]
        emb = torch.cat(out).cpu().numpy()
        return emb / np.linalg.norm(emb, axis=-1, keepdims=True)

    @torch.inference_mode()
    def text_embeds(self, texts: Sequence[str]) -> np.ndarray:
        """L2-normalized projected text embeddings."""
        out = [self.model.text_features(i, m).float() for i, m in self._batches(*self._tokens(texts))]
        emb = torch.cat(out).cpu().numpy()
        return emb / np.linalg.norm(emb, axis=-1, keepdims=True)


def clip_loss_weights(similarities: np.ndarray, temperature: float = 1.0) -> np.ndarray:
    """Per-sample loss weights from CLIP similarity (``gqa_weight.py``):
    softmax-normalized within the batch, scaled so the mean weight is 1."""
    s = np.asarray(similarities, np.float64) / temperature
    e = np.exp(s - s.max())
    w = e / e.sum()
    return (w * len(w)).astype(np.float32)
