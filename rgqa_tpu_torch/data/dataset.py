"""GQA / RGQA question splits and encoded arrays: a numpy-only copy of
``GQADataset`` and ``EncodedGQA`` from ``rgqa_tpu/data/dataset.py``.

A copy, because ``rgqa_tpu/data/dataset.py`` imports flax (through
``models.uniter`` for UNITER's box transform) and ``rgqa_tpu.data``'s
``__init__`` imports jax; the port runs where they are absent.  Three branches
are here: lxmert (questions tokenized once into (N, T) int32 arrays,
boxes normalized to [0, 1], ``norm4``), uniter (the same questions, the
pixel boxes through UNITER's 7-d transform, ``uniter7``) and vilt (the same questions;
pixels per batch from an image source, on the ``u8`` wire as uint8 rows
+ rects + the rect-derived pad-patch mask, on the ``f32`` wire as
normalized f32 pixels, augmented by ``randaug`` when the runner sets
``image_augment_rng`` on a train split), butd (each question front-
padded into (N, 40) word indices, ``token_ids``, through BUTD's own
dictionary; ``norm4`` boxes) and the caption branch (given
``image2caps``: the first caption of each question's image paired with
the question, ``[CLS] caption [SEP] question [SEP]``; no RoI inputs).
Rows that carry a constituency ``parse`` get TreeMix's candidate spans
(``data.parse.encode_parse_spans``) once, at encode time, on every
backbone but BUTD and the caption branch.
"""

from __future__ import annotations

import json
import os
from typing import Mapping, Optional, Sequence

import numpy as np

from rgqa_tpu_torch.data.images import load_image_batch, load_image_batch_u8, rect_patch_mask
from rgqa_tpu_torch.data.parse import encode_parse_spans
from rgqa_tpu_torch.data.tokenizer import WordPieceTokenizer
from rgqa_tpu_torch.data.tsv import PackedFeatures
from rgqa_tpu_torch.models.butd import tokenize_front_padded
from rgqa_tpu_torch.models.uniter import uniter_box_transform

__all__ = ["GQADataset", "EncodedGQA", "build_targets", "UQ_ANSWER", "MAX_LABELS"]

UQ_ANSWER = "UQ"
MAX_LABELS = 8


class GQADataset:
    """Question splits + answer vocabulary.

    ``splits`` is a comma-separated list; each resolves to
    ``<root>/<split>.json`` holding rows
    ``{img_id, question_id, sent[, label: {ans: score}]}``.  ``add_uq``
    appends the ``'UQ'`` answer as the last class.
    """

    def __init__(self, root: str, splits: str, *, add_uq: bool = False):
        self.name = splits
        self.splits = splits.split(",")
        self.data: list[dict] = []
        for split in self.splits:
            with open(os.path.join(root, f"{split}.json")) as f:
                self.data.extend(json.load(f))
        self.id2datum = {d["question_id"]: d for d in self.data}

        with open(os.path.join(root, "trainval_ans2label.json")) as f:
            self.ans2label: dict[str, int] = json.load(f)
        with open(os.path.join(root, "trainval_label2ans.json")) as f:
            self.label2ans: list[str] = json.load(f)
        if len(self.ans2label) != len(self.label2ans):
            raise ValueError(f"answer vocab files under {root!r} disagree in length")

        if add_uq and UQ_ANSWER not in self.ans2label:
            self.ans2label = dict(self.ans2label)
            self.ans2label[UQ_ANSWER] = len(self.ans2label)
            self.label2ans = list(self.label2ans) + [UQ_ANSWER]
        self.num_answers = len(self.ans2label)

    @classmethod
    def from_rows(
        cls, rows: list[dict], *, ans2label: dict, label2ans: list, name: str = "in_memory",
    ) -> "GQADataset":
        """An in-memory dataset over already-loaded rows (reference
        ``GQADataset_v2``, ``gqa_data.py:70-108``): the serving waves."""
        ds = cls.__new__(cls)
        ds.name = name
        ds.splits = [name]
        ds.data = list(rows)
        ds.id2datum = {d["question_id"]: d for d in ds.data}
        ds.ans2label = dict(ans2label)
        ds.label2ans = list(label2ans)
        ds.num_answers = len(ds.ans2label)
        return ds

    def __len__(self) -> int:
        return len(self.data)

    @property
    def qid2label(self) -> dict:
        return {d["question_id"]: d.get("label", {}) for d in self.data}


def build_targets(
    label_idx: np.ndarray,
    label_score: np.ndarray,
    num_answers: int,
) -> np.ndarray:
    """Scatter sparse (B, MAX_LABELS) labels into a dense (B, A) target."""
    b = label_idx.shape[0]
    target = np.zeros((b, num_answers), np.float32)
    rows = np.repeat(np.arange(b), label_idx.shape[1])
    cols = label_idx.reshape(-1)
    vals = label_score.reshape(-1)
    keep = cols >= 0
    target[rows[keep], cols[keep]] = vals[keep]
    return target


class EncodedGQA:
    """A dataset encoded into fixed-shape arrays (lxmert, uniter, vilt,
    butd and caps inputs).

    Fields: ``question_ids`` (list[str]); ``input_ids / input_mask /
    segment_ids`` (N, T) int32, or for ``backbone="butd"`` ``token_ids``
    (N, 40) int32 from ``butd_word2idx``; ``img_row`` (N,) int32 into the feature
    pack; ``label_idx`` (N, MAX_LABELS) int32 (-1 = empty) and
    ``label_score`` (N, MAX_LABELS) f32; ``img_boxes`` (images, K, 4)
    f32, boxes normalized by image size and clipped to [0, 1], or for
    ``backbone="uniter"`` (images, K, 7), UNITER's transform of the pixel
    boxes.  Either is computed once per feature pack and kept on it by
    kind (``features._box_cache["norm4" | "uniter7"]``), shared by every
    split of that kind encoded over the pack.

    ``backbone="vilt"`` takes pixels from ``image_source`` (a
    ``data.images.GQAImageSource`` or ``PixelPack``) on ``pixel_wire``
    ``"u8"`` or ``"f32"``; ``pixel_patch_size`` sizes the pad-patch mask.
    ``image_augment_rng`` (None: deterministic pixels, every eval split)
    is the ``np.random.Generator`` that the runner sets on a train split
    for train-time randaug; each batch's image loads draw from it.

    ``image2caps`` (``{img_id: [caption, ...]}``, the caption matcher's)
    pair-encodes each question after its image's first caption (an
    image without one pairs with the empty caption); the batches then
    carry the text fields alone.

    ``parse_spans`` (N, K, 2), ``parse_span_words`` (N, K) and
    ``parse_n_words`` (N,) int32 are TreeMix's candidate subtrees in
    wordpiece coordinates (``data.parse.encode_parse_spans``), or None:
    they exist when the backbone is not BUTD (its front-padded word
    indices have other coordinates), there are no captions and some row
    carries a ``parse``; the batches then carry them too.
    ``keep_uq_target`` (``--uq_as_class``) keeps the UQ column as a
    target like any answer.
    """

    def __init__(
        self,
        dataset: GQADataset,
        features: PackedFeatures,
        *,
        tokenizer: WordPieceTokenizer,
        max_text_len: int = 20,
        backbone: str = "lxmert",
        image_source=None,
        pixel_wire: str = "f32",
        pixel_patch_size: int = 32,
        butd_word2idx: Optional[Mapping[str, int]] = None,
        image2caps: Optional[Mapping[str, Sequence[str]]] = None,
        keep_uq_target: bool = False,
    ):
        if backbone not in ("lxmert", "uniter", "vilt", "butd", "caps"):
            raise ValueError(f"unknown backbone {backbone!r}")
        if backbone == "butd" and butd_word2idx is None:
            raise ValueError("the butd branch needs butd_word2idx (the runner's dictionary)")
        if pixel_wire not in ("f32", "u8"):
            raise ValueError(f"pixel_wire must be f32|u8, got {pixel_wire!r}")
        if backbone == "vilt" and image_source is None:
            raise ValueError("the vilt branch needs an image_source")
        self.backbone = backbone
        self.captions = image2caps is not None
        self.keep_uq_target = keep_uq_target
        self.image_source = image_source
        self.image_augment_rng = None
        self.pixel_wire = pixel_wire
        self.pixel_patch_size = pixel_patch_size
        self.dataset = dataset
        self.features = features
        self.num_answers = dataset.num_answers

        # Questions whose image is not in the pack are dropped.
        data = [d for d in dataset.data if d["img_id"] in features]
        n = len(data)
        self.question_ids = [d["question_id"] for d in data]
        sents = [d.get("sent") or d.get("question", "") for d in data]
        if backbone == "butd":
            self.token_ids = tokenize_front_padded(sents, butd_word2idx)
        elif self.captions:
            # Q-C caption matching (reference GQACaptionDataset,
            # gqa_data.py:402-491): pair-encode (caption, question).
            caps = [" ".join(image2caps.get(d["img_id"], [""])[:1]) for d in data]
            self.input_ids, self.input_mask, self.segment_ids = tokenizer.encode_batch(
                caps, max_text_len, text_pairs=sents
            )
        else:
            self.input_ids, self.input_mask, self.segment_ids = tokenizer.encode_batch(
                sents, max_text_len
            )
        self.parse_spans = self.parse_span_words = self.parse_n_words = None
        if backbone != "butd" and not self.captions and any(d.get("parse") for d in data):
            self.parse_spans, self.parse_span_words, self.parse_n_words = encode_parse_spans(
                [d.get("parse") for d in data], sents, tokenizer, max_text_len
            )
        self.img_row = np.asarray(
            [features.index[d["img_id"]] for d in data], np.int32
        )
        self.label_idx = np.full((n, MAX_LABELS), -1, np.int32)
        self.label_score = np.zeros((n, MAX_LABELS), np.float32)
        for i, d in enumerate(data):
            j = 0
            for ans, score in (d.get("label") or {}).items():
                if ans in dataset.ans2label and j < MAX_LABELS:
                    self.label_idx[i, j] = dataset.ans2label[ans]
                    self.label_score[i, j] = score
                    j += 1

        # The position features, computed once per pack and kind and
        # shared by every split of that kind encoded over it.
        kind = "uniter7" if backbone == "uniter" else "norm4"
        cache = getattr(features, "_box_cache", None)
        if cache is None:
            cache = features._box_cache = {}
        if kind not in cache:
            if kind == "uniter7":
                cache[kind] = uniter_box_transform(np.asarray(features.boxes))
            else:
                sizes = np.asarray(features.sizes, np.float32)  # (N, 2) h, w
                boxes = np.asarray(features.boxes, np.float32).copy()
                boxes[:, :, (0, 2)] /= sizes[:, None, 1:2]
                boxes[:, :, (1, 3)] /= sizes[:, None, 0:1]
                cache[kind] = np.clip(boxes, 0.0, 1.0)
        self.img_boxes = cache[kind]

    def __len__(self) -> int:
        return len(self.question_ids)

    def gather_batch(self, idx: np.ndarray, *, with_target: bool = False) -> dict:
        """A dense host batch for row indices ``idx``.  ``with_target``
        adds the training targets: ``target``, the answer scores with the
        appended UQ column sliced off, and ``id_mask`` (B,), 1 for
        answerable rows (UQ score zero); a vocabulary without UQ, or
        ``keep_uq_target``, keeps every column and marks every row
        answerable."""
        rows = self.img_row[idx]
        if self.backbone == "butd":
            batch = {"token_ids": self.token_ids[idx]}
        else:
            batch = {
                "input_ids": self.input_ids[idx],
                "input_mask": self.input_mask[idx],
                "segment_ids": self.segment_ids[idx],
            }
        if self.parse_spans is not None:
            batch["parse_spans"] = self.parse_spans[idx]
            batch["parse_span_words"] = self.parse_span_words[idx]
            batch["parse_n_words"] = self.parse_n_words[idx]
        if self.backbone == "vilt":
            ids = [self.features.img_ids[r] for r in rows]
            aug_rng = self.image_augment_rng
            if self.pixel_wire == "u8":
                # uint8 rows + rects; the model's adapter normalizes on the
                # device, and the pad-patch mask ships as geometry.
                u8, rects = load_image_batch_u8(self.image_source, ids, rng=aug_rng)
                batch["pixels_u8"] = u8
                batch["pixel_rect"] = rects
                batch["pixel_mask"] = rect_patch_mask(
                    rects, self.image_source.size, self.pixel_patch_size
                )
            else:
                batch["pixels"] = load_image_batch(self.image_source, ids, rng=aug_rng)
        elif not self.captions:  # the caption matcher reads the text pair alone
            batch["feats"] = np.asarray(self.features.features[rows], np.float32)
            batch["boxes"] = self.img_boxes[rows]
        if with_target:
            target = build_targets(self.label_idx[idx], self.label_score[idx], self.num_answers)
            if (not self.keep_uq_target and self.dataset.label2ans
                    and self.dataset.label2ans[-1] == UQ_ANSWER):
                batch["target"] = target[:, :-1]
                batch["id_mask"] = (target[:, -1] == 0).astype(np.float32)
            else:
                batch["target"] = target
                batch["id_mask"] = np.ones((len(idx),), np.float32)
        return batch
