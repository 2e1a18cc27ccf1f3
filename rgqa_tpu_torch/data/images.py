"""Raw-image feed for ViLT: a numpy-only copy of ``rgqa_tpu/data/images.py``.

A copy, because importing anything under ``rgqa_tpu.data`` runs its
``__init__``, which imports jax and flax.  The functions and classes
here compute what their originals compute (``tests/test_torch_vilt.py``
holds them to each other):

- :func:`randaug`: the train-time photometric RandAugment (the
  reference ``pixelbert_randaug``), two ops drawn from a
  ``np.random.Generator``;
- :func:`pixelbert_u8` / :func:`pixelbert_transform`: a PIL image ->
  uint8 ``(size, size, 3)`` + the real-pixel rect ``(top, left, h, w)``,
  or f32 in [-1, 1]; ``mode="pad"`` (longer side -> size, centered on a
  zero canvas) or ``"crop"`` (shorter side -> size, center crop); given
  an ``rng``, :func:`randaug` runs before the resize;
- :func:`pixelbert_normalize`: uint8 + rect -> f32, pad pixels 0.0;
- :func:`rect_patch_mask`: rects -> the (B, n_patches) validity mask;
- :class:`GQAImageSource` (JPEGs under an image root) and
  :class:`PixelPack` (pre-decoded uint8 rows on a memory map), with
  :func:`load_image_batch` / :func:`load_image_batch_u8`;
- :func:`pack_pixels`: every JPEG under an image root decoded once into a
  pixelbert or CLIP :class:`PixelPack` (``prepare_data --pack_pixels
  [--pixel_transform clip]``).

PIL is imported only inside the functions that decode JPEGs, as in the
original: the machine with the card has no PIL, and the port's synthetic
data (``data/synthetic.py``) writes a :class:`PixelPack` directly
(:func:`write_pixel_pack`).  :func:`pack_matches` is the port's check
that a pack found under a data root may stand in for its images: the
same source root, and also the same size, mode and transform, which the
JAX runner's auto-detection (``rgqa_tpu/runner.py:287-295``) does not
check.  A CLIP pack (``transform="clip"``: CLIP's shortest-edge bicubic
resize and center crop, ``scorers.clip.clip_resize_crop``, mode None, full
rects) lives in ``pixels_clip_<size>/`` and feeds the CLIP scorer.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np

__all__ = [
    "pixelbert_transform",
    "pixelbert_u8",
    "randaug",
    "pixelbert_normalize",
    "rect_patch_mask",
    "load_image_batch",
    "load_image_batch_u8",
    "GQAImageSource",
    "PixelPack",
    "pack_matches",
    "pack_pixels",
    "write_pixel_pack",
]


def _resize_keep_ratio(img, size: int, *, by: str = "longer"):
    from PIL import Image

    w, h = img.size
    scale = size / (max(w, h) if by == "longer" else min(w, h))
    return img.resize(
        (max(1, int(round(w * scale))), max(1, int(round(h * scale)))),
        Image.BICUBIC,
    )


def randaug(img, rng: np.random.Generator, n_ops: int = 2):
    """Light RandAugment over photometric PIL ops: ``n_ops`` times, an op
    of {identity, rotate, brightness, contrast, sharpness, posterize}
    drawn from ``rng``, then its magnitude."""
    from PIL import ImageEnhance, ImageOps

    ops = [
        lambda im, m: im,
        lambda im, m: im.rotate(m * 10 - 5),
        lambda im, m: ImageEnhance.Brightness(im).enhance(0.7 + 0.6 * m),
        lambda im, m: ImageEnhance.Contrast(im).enhance(0.7 + 0.6 * m),
        lambda im, m: ImageEnhance.Sharpness(im).enhance(0.7 + 0.6 * m),
        lambda im, m: ImageOps.posterize(im, 4 + int(m * 4)),
    ]
    for _ in range(n_ops):
        op = ops[int(rng.integers(len(ops)))]
        img = op(img, float(rng.random()))
    return img


def pixelbert_u8(img, size: int = 384, *, rng=None, mode: str = "pad") -> tuple[np.ndarray, np.ndarray]:
    """PIL image -> ``(u8 (size, size, 3), rect (4,) int32)``: resize
    (after :func:`randaug` when given an ``rng``) without normalizing;
    ``rect = (top, left, h, w)`` marks the real pixels (pad bytes are
    zero, but only the normalize can zero them)."""
    img = img.convert("RGB")
    if rng is not None:
        img = randaug(img, rng)
    if mode not in ("pad", "crop"):
        raise ValueError(f"mode must be pad|crop, got {mode!r}")
    img = _resize_keep_ratio(img, size, by="longer" if mode == "pad" else "shorter")
    arr = np.asarray(img, np.uint8)
    h, w = arr.shape[:2]
    if mode == "crop":
        top, left = (h - size) // 2, (w - size) // 2
        out = arr[top : top + size, left : left + size]
        return out, np.asarray([0, 0, size, size], np.int32)
    out = np.zeros((size, size, 3), np.uint8)
    top, left = (size - h) // 2, (size - w) // 2
    out[top : top + h, left : left + w] = arr
    return out, np.asarray([top, left, h, w], np.int32)


def pixelbert_normalize(u8: np.ndarray, rect: np.ndarray) -> np.ndarray:
    """uint8 + rect -> float32 in [-1, 1], pad pixels exactly 0.0:
    ``(u8/255 - 0.5)/0.5`` in f32, as ``ops.pixels.pixelbert_normalize``
    computes it on the device."""
    arr = (np.asarray(u8, np.float32) / 255.0 - 0.5) / 0.5
    size = arr.shape[-3]
    top, left, h, w = (int(v) for v in rect)
    if (top, left, h, w) != (0, 0, size, size):
        mask = np.zeros(arr.shape[:-1] + (1,), np.float32)
        mask[..., top : top + h, left : left + w, :] = 1.0
        arr = arr * mask
    return arr


def pixelbert_transform(img, size: int = 384, *, rng=None, mode: str = "pad") -> np.ndarray:
    """PIL image -> (size, size, 3) float32 in [-1, 1]."""
    return pixelbert_normalize(*pixelbert_u8(img, size, rng=rng, mode=mode))


def rect_patch_mask(rects: np.ndarray, size: int, patch_size: int) -> np.ndarray:
    """(B, 4) rects -> (B, n_patches) uint8 patch-validity mask: a patch
    is valid iff it intersects the real-pixel rect (the model's content
    rule, from geometry)."""
    rects = np.asarray(rects, np.int64).reshape(-1, 4)
    n = size // patch_size
    grid = np.arange(n) * patch_size  # patch start coordinates
    top, left, h, w = rects[:, 0:1], rects[:, 1:2], rects[:, 2:3], rects[:, 3:4]
    # patch [g, g+p) intersects [a, a+l) iff g < a+l and g+p > a
    rows = (grid[None, :] < top + h) & (grid[None, :] + patch_size > top)
    cols = (grid[None, :] < left + w) & (grid[None, :] + patch_size > left)
    return (rows[:, :, None] & cols[:, None, :]).reshape(len(rects), n * n).astype(np.uint8)


class GQAImageSource:
    """JPEGs keyed by img_id under ``img_root`` (decoded with PIL)."""

    def __init__(self, img_root: str, size: int = 384, mode: str = "pad"):
        self.img_root = img_root
        self.size = size
        self.mode = mode

    def path(self, img_id: str) -> str:
        return os.path.join(self.img_root, f"{img_id}.jpg")

    def __contains__(self, img_id: str) -> bool:
        return os.path.exists(self.path(img_id))

    def load(self, img_id: str, *, rng=None) -> np.ndarray:
        from PIL import Image

        with Image.open(self.path(img_id)) as img:
            return pixelbert_transform(img, self.size, rng=rng, mode=self.mode)

    def load_u8(self, img_id: str, *, rng=None):
        from PIL import Image

        with Image.open(self.path(img_id)) as img:
            return pixelbert_u8(img, self.size, rng=rng, mode=self.mode)


class PixelPack:
    """Pre-decoded uint8 pixel rows (``pixels_u8.bin``, ``rects.bin`` and
    ``meta.json`` in one directory), read off a memory map; the same
    ``load`` / ``load_u8`` / ``in`` surface as :class:`GQAImageSource`."""

    def __init__(self, pack_dir: str):
        self.dir = pack_dir
        with open(os.path.join(pack_dir, "meta.json")) as f:
            meta = json.load(f)
        self.size = int(meta["size"])
        self.mode = meta["mode"]  # None for transforms without a mode (clip)
        self.transform = meta.get("transform", "pixelbert")
        self.img_root = meta.get("img_root")  # absolute source root
        self.img_ids = meta["img_ids"]
        self.index = {g: i for i, g in enumerate(self.img_ids)}
        n = len(self.img_ids)
        self.pixels = np.memmap(
            os.path.join(pack_dir, "pixels_u8.bin"), np.uint8, "r",
            shape=(n, self.size, self.size, 3),
        )
        self.rects = np.memmap(os.path.join(pack_dir, "rects.bin"), np.int32, "r", shape=(n, 4))

    def matches_source(self, image_root: str) -> bool:
        """True iff this pack was built from ``image_root``."""
        return self.img_root is not None and os.path.abspath(image_root) == self.img_root

    def __contains__(self, img_id: str) -> bool:
        return img_id in self.index

    def load_u8(self, img_id: str, *, rng=None):
        if rng is not None:
            raise ValueError(
                "PixelPack rows are pre-resized; train-time randaug needs "
                "a GQAImageSource over raw images"
            )
        row = self.index[img_id]
        return self.pixels[row], self.rects[row]

    def load(self, img_id: str, *, rng=None) -> np.ndarray:
        if self.transform != "pixelbert":
            raise ValueError(
                f"{self.transform!r} pack rows use their consumer's normalize; "
                "pixelbert_normalize does not apply"
            )
        return pixelbert_normalize(*self.load_u8(img_id, rng=rng))


def pack_matches(pack: PixelPack, img_root: str, size: int, mode: str) -> bool:
    """Whether ``pack`` may stand in for decoding ``img_root`` at ``size``
    and ``mode`` with the pixelbert transform: the same source root, size,
    mode and transform (a pack that differs in any of them holds other
    pixels)."""
    return (
        pack.matches_source(img_root)
        and pack.size == size
        and pack.mode == mode
        and pack.transform == "pixelbert"
    )


def _write_meta(out_dir: str, img_root: str, img_ids: list, *, size: int, mode: Optional[str],
                transform: str) -> PixelPack:
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(
            {"size": size, "mode": mode, "transform": transform,
             "img_root": os.path.abspath(img_root), "img_ids": img_ids},
            f,
        )
    return PixelPack(out_dir)


def _require_pil(what: str) -> None:
    try:
        import PIL.Image  # noqa: F401
    except ImportError as e:
        raise RuntimeError(f"{what} decodes JPEGs with PIL, which is not installed here") from e


def write_pixel_pack(
    out_dir: str, img_root: str, img_ids: Sequence[str], pixels: np.ndarray,
    rects: np.ndarray, *, size: int, mode: Optional[str], transform: str = "pixelbert",
) -> PixelPack:
    """Write uint8 ``pixels`` (N, size, size, 3) and ``rects`` (N, 4) as a
    :class:`PixelPack` of ``img_ids`` (pixelbert or clip rows), recorded as
    built from ``img_root``; the layout :func:`pack_pixels` writes."""
    img_ids = list(img_ids)
    if pixels.shape != (len(img_ids), size, size, 3) or rects.shape != (len(img_ids), 4):
        raise ValueError(f"pixels {pixels.shape} / rects {rects.shape} do not fit {len(img_ids)} images")
    os.makedirs(out_dir, exist_ok=True)
    np.ascontiguousarray(pixels, np.uint8).tofile(os.path.join(out_dir, "pixels_u8.bin"))
    np.ascontiguousarray(rects, np.int32).tofile(os.path.join(out_dir, "rects.bin"))
    return _write_meta(out_dir, img_root, img_ids, size=size, mode=mode, transform=transform)


def pack_pixels(
    img_root: str,
    out_dir: str,
    *,
    size: int = 384,
    mode: Optional[str] = "pad",
    transform: str = "pixelbert",
    img_ids: Optional[Sequence[str]] = None,
) -> PixelPack:
    """Decode every JPEG under ``img_root`` (or ``img_ids`` of them) once
    into a :class:`PixelPack`, one image at a time into the pack's memory
    maps: ``transform="pixelbert"`` ViLT rows (pad / crop + rect),
    ``"clip"`` CLIP rows (shortest-edge bicubic resize + center crop at
    ``size``, HF ``CLIPImageProcessor``'s geometry; mode None, full
    rects).  Needs PIL."""
    if transform == "clip":
        from rgqa_tpu_torch.scorers.clip import clip_resize_crop

        mode = None  # one geometry: shortest edge + center crop
        full = np.asarray([0, 0, size, size], np.int32)

        def load_u8(img_id):
            from PIL import Image

            with Image.open(os.path.join(img_root, f"{img_id}.jpg")) as im:
                return clip_resize_crop(im, size), full
    elif transform == "pixelbert":
        load_u8 = GQAImageSource(img_root, size=size, mode=mode).load_u8
    else:
        raise ValueError(f"transform must be pixelbert|clip, got {transform!r}")
    _require_pil(f"pack_pixels(transform={transform!r})")
    if img_ids is None:
        img_ids = sorted(
            os.path.splitext(f)[0] for f in os.listdir(img_root) if f.lower().endswith(".jpg")
        )
    img_ids = list(img_ids)
    os.makedirs(out_dir, exist_ok=True)
    n = len(img_ids)
    px = np.memmap(os.path.join(out_dir, "pixels_u8.bin"), np.uint8, "w+", shape=(n, size, size, 3))
    rects = np.memmap(os.path.join(out_dir, "rects.bin"), np.int32, "w+", shape=(n, 4))
    for i, img_id in enumerate(img_ids):
        px[i], rects[i] = load_u8(img_id)
    px.flush()
    rects.flush()
    del px, rects
    return _write_meta(out_dir, img_root, img_ids, size=size, mode=mode, transform=transform)


def load_image_batch(source, img_ids: Sequence[str], *, rng=None) -> np.ndarray:
    return np.stack([source.load(i, rng=rng) for i in img_ids])


def load_image_batch_u8(source, img_ids: Sequence[str], *, rng=None) -> tuple[np.ndarray, np.ndarray]:
    """(pixels uint8 (B, S, S, 3), rects (B, 4)): the u8 wire's batch."""
    pairs = [source.load_u8(i, rng=rng) for i in img_ids]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])
