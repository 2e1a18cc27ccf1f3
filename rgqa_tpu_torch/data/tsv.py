"""Object-feature TSVs and their packs: a numpy-only copy of
``rgqa_tpu/data/tsv.py``.

A copy, because importing anything under ``rgqa_tpu.data`` runs its
``__init__``, which imports jax and flax, and the port runs where they
are absent.  The bottom-up-attention TSV holds rows of ``[img_id, img_h,
img_w, objects_id, objects_conf, attrs_id, attrs_conf, num_boxes, boxes,
features]`` with base64 numpy payloads (reference ``src/utils.py:12-54``).
:func:`pack_obj_tsv` decodes it once, through the numpy decoder
(:func:`iter_obj_tsv`), into contiguous ``.npy`` arrays (``python -m
rgqa_tpu_torch.cli.prepare_data``); :class:`PackedFeatures` memory-maps
the pack; :func:`write_obj_tsv` writes rows in the TSV's layout.  Only
the f32 pack is written and read: the int8 pack (``--int8``) is not
ported, and neither is the JAX package's g++ decoder.
"""

from __future__ import annotations

import base64
import csv
import json
import os
import sys
import time
from typing import Iterator

import numpy as np

__all__ = ["OBJ_TSV_FIELDS", "PackedFeatures", "iter_obj_tsv", "load_obj_tsv", "pack_obj_tsv",
           "write_obj_tsv"]

OBJ_TSV_FIELDS = [
    "img_id",
    "img_h",
    "img_w",
    "objects_id",
    "objects_conf",
    "attrs_id",
    "attrs_conf",
    "num_boxes",
    "boxes",
    "features",
]

_B64_SPECS = {
    # field -> (dtype, per-box width; None = scalar per box)
    "objects_id": (np.int64, None),
    "objects_conf": (np.float32, None),
    "attrs_id": (np.int64, None),
    "attrs_conf": (np.float32, None),
    "boxes": (np.float32, 4),
    "features": (np.float32, -1),  # -1: infer feature dim from payload
}
_INT8_REFUSAL = (
    "int8 feature packs (prepare_data --int8) are not ported; the port writes and reads f32 packs"
)


def _decode_row(row: dict) -> dict:
    n = int(row["num_boxes"])
    out = {
        "img_id": row["img_id"],
        "img_h": int(row["img_h"]),
        "img_w": int(row["img_w"]),
        "num_boxes": n,
    }
    for field, (dtype, width) in _B64_SPECS.items():
        buf = np.frombuffer(base64.b64decode(row[field]), dtype=dtype)
        if width is None:
            arr = buf.reshape(n)
        elif width == -1:
            arr = buf.reshape(n, -1)
        else:
            arr = buf.reshape(n, width)
        arr = np.array(arr)  # writable copy
        arr.setflags(write=False)
        out[field] = arr
    return out


def iter_obj_tsv(path: str) -> Iterator[dict]:
    """Stream decoded rows from a bottom-up-attention TSV file."""
    csv.field_size_limit(sys.maxsize)
    with open(path, newline="") as f:
        for row in csv.DictReader(f, OBJ_TSV_FIELDS, delimiter="\t"):
            yield _decode_row(row)


def load_obj_tsv(path: str, topk: int | None = None) -> list[dict]:
    """Load (up to ``topk``) decoded rows; mirrors ``src/utils.py:16-54``."""
    start = time.time()
    data = []
    for row in iter_obj_tsv(path):
        data.append(row)
        if topk is not None and len(data) >= topk:
            break
    print(f"Loaded {len(data)} images from {path} in {time.time() - start:.1f}s", flush=True)
    return data


class PackedFeatures:
    """Memory-mapped packed object features keyed by image id.

    Directory layout: ``features.npy`` (N, num_boxes, feat_dim) f32,
    ``boxes.npy`` (N, num_boxes, 4) f32 in pixels, ``objects_id.npy`` /
    ``objects_conf.npy`` / ``attrs_id.npy`` / ``attrs_conf.npy``
    (N, num_boxes), ``sizes.npy`` (N, 2) int32 (img_h, img_w) and
    ``img_ids.json`` (row order).
    """

    ARRAYS = ("features", "boxes", "objects_id", "objects_conf", "attrs_id", "attrs_conf", "sizes")

    def __init__(self, directory: str):
        self.directory = directory
        if not os.path.exists(os.path.join(directory, "features.npy")):
            raise FileNotFoundError(f"no features.npy under {directory!r} ({_INT8_REFUSAL})")
        with open(os.path.join(directory, "img_ids.json")) as f:
            self.img_ids: list[str] = json.load(f)
        self.index = {img_id: i for i, img_id in enumerate(self.img_ids)}
        for name in self.ARRAYS:
            setattr(
                self,
                name,
                np.load(os.path.join(directory, f"{name}.npy"), mmap_mode="r"),
            )

    def __len__(self) -> int:
        return len(self.img_ids)

    def __contains__(self, img_id: str) -> bool:
        return img_id in self.index

    def truncate(self, topk: int) -> "PackedFeatures":
        """A view over the first ``topk`` images (``--tiny`` 512 /
        ``--fast`` 5000)."""
        if topk >= len(self.img_ids):
            return self
        view = object.__new__(PackedFeatures)
        view.directory = self.directory
        view.img_ids = self.img_ids[:topk]
        view.index = {img_id: i for i, img_id in enumerate(view.img_ids)}
        for name in self.ARRAYS:
            setattr(view, name, getattr(self, name)[:topk])
        return view


def pack_obj_tsv(
    tsv_path: str,
    out_dir: str,
    topk: int | None = None,
    num_boxes: int = 36,
    int8: bool = False,
) -> PackedFeatures:
    """One-time TSV -> packed-array conversion (the offline converter).

    Rows with another box count than ``num_boxes`` are zero-padded or
    truncated to it (the RGQA pipeline uses 36 RoIs).  Writes the same
    bytes as the JAX packer, with either of its decoders.  ``int8``
    raises ``NotImplementedError``: the int8 pack is not ported."""
    if int8:
        raise NotImplementedError(_INT8_REFUSAL)
    rows = []
    for row in iter_obj_tsv(tsv_path):
        rows.append(row)
        if topk is not None and len(rows) >= topk:
            break
    if not rows:
        raise ValueError(f"no rows decoded from {tsv_path}")

    n = len(rows)
    feat_dim = rows[0]["features"].shape[1]
    arrays = {
        "features": np.zeros((n, num_boxes, feat_dim), np.float32),
        "boxes": np.zeros((n, num_boxes, 4), np.float32),
        "objects_id": np.zeros((n, num_boxes), np.int64),
        "objects_conf": np.zeros((n, num_boxes), np.float32),
        "attrs_id": np.zeros((n, num_boxes), np.int64),
        "attrs_conf": np.zeros((n, num_boxes), np.float32),
        "sizes": np.zeros((n, 2), np.int32),
    }
    for i, row in enumerate(rows):
        k = min(row["num_boxes"], num_boxes)
        for name in ("features", "boxes", "objects_id", "objects_conf", "attrs_id", "attrs_conf"):
            arrays[name][i, :k] = row[name][:k]
        arrays["sizes"][i] = (row["img_h"], row["img_w"])

    os.makedirs(out_dir, exist_ok=True)
    for stale in ("features_q.npy", "features_scale.npy"):  # an int8 pack's, as the JAX packer drops them
        if os.path.exists(os.path.join(out_dir, stale)):
            os.remove(os.path.join(out_dir, stale))
    for name in PackedFeatures.ARRAYS:
        np.save(os.path.join(out_dir, f"{name}.npy"), arrays[name])
    with open(os.path.join(out_dir, "img_ids.json"), "w") as f:
        json.dump([row["img_id"] for row in rows], f)
    return PackedFeatures(out_dir)


def write_obj_tsv(path: str, rows) -> int:
    """Write rows in the bottom-up-attention TSV's layout, the inverse of
    :func:`iter_obj_tsv`: dicts of ``img_id``, ``img_h``, ``img_w`` and the
    numpy payloads ``objects_id`` (i64), ``objects_conf``, ``attrs_id``
    (i64), ``attrs_conf``, ``boxes`` (n, 4) and ``features`` (n, d), f32;
    ``num_boxes`` is the payloads' n.  Returns the bytes written."""
    def b64(a, dtype):
        return base64.b64encode(np.ascontiguousarray(a, dtype).tobytes()).decode()

    with open(path, "w") as f:
        for r in rows:
            f.write("\t".join([
                r["img_id"], str(int(r["img_h"])), str(int(r["img_w"])),
                b64(r["objects_id"], np.int64), b64(r["objects_conf"], np.float32),
                b64(r["attrs_id"], np.int64), b64(r["attrs_conf"], np.float32),
                str(len(r["boxes"])), b64(r["boxes"], np.float32), b64(r["features"], np.float32),
            ]) + "\n")
    return os.path.getsize(path)
