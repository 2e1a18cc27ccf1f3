"""Packed object features: a numpy-only copy of ``PackedFeatures`` from
``rgqa_tpu/data/tsv.py``.

A copy, because importing anything under ``rgqa_tpu.data`` runs its
``__init__``, which imports jax and flax, and the port runs where they
are absent.  Only the f32 pack is read: the int8 pack and the TSV
decoder/packer are not ported (packs are built offline by
``python -m rgqa_tpu.cli.prepare_data``).
"""

from __future__ import annotations

import json
import os

import numpy as np

__all__ = ["PackedFeatures"]


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
            raise FileNotFoundError(
                f"no features.npy under {directory!r} (int8 feature packs "
                "are not ported yet)"
            )
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
