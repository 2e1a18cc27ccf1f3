"""Synthetic GQA/RGQA data: a numpy-only copy of ``make_synthetic_gqa``
from ``rgqa_tpu/data/synthetic.py``.

A copy, because importing anything under ``rgqa_tpu.data`` runs its
``__init__``, which imports jax and flax, and the port runs where they
are absent.  It makes the same draws in the same order, so a root made
here holds the same question splits, answer vocab, feature pack and
``vocab.txt`` as one made by the JAX package (``tests/test_torch_data.py``).
Left out: the raw JPEGs (ViLT/CLIP paths), ``image2caps.json`` (caption
matcher), ``objects_vocab.txt`` (FRCNN-coverage scorer) and the VQA
generator, none of which the port reads yet.  They are drawn last, so
leaving them out changes no other array.

Questions are template-generated over a small object/attribute lexicon;
each image's "dominant answer" dimension is boosted in its features, so
a model has something learnable.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from rgqa_tpu_torch.data.tokenizer import PAD, UNK, CLS, SEP, MASK

__all__ = ["make_synthetic_gqa", "SyntheticSpec"]

_OBJECTS = [
    "apple", "ball", "car", "dog", "elephant", "fork", "guitar", "hat",
    "island", "jacket", "kite", "lamp", "mirror", "notebook", "orange",
    "piano", "quilt", "rose", "spoon", "table", "umbrella", "violin",
    "wheel", "xylophone", "yacht", "zebra",
]
_ATTRIBUTES = ["red", "blue", "green", "small", "large", "old", "new", "shiny"]
_TEMPLATES = [
    "what is the {attr} object near the {obj} ?",
    "is there a {obj} in the picture ?",
    "what color is the {obj} ?",
    "how many {obj} can you see ?",
    "where is the {attr} {obj} ?",
]


class SyntheticSpec:
    def __init__(
        self,
        n_images: int = 64,
        n_train: int = 256,
        n_valid: int = 64,
        n_testdev: int = 64,
        uq_fraction: float = 0.5,
        num_boxes: int = 36,
        feat_dim: int = 2048,
        seed: int = 0,
    ):
        self.n_images = n_images
        self.n_train = n_train
        self.n_valid = n_valid
        self.n_testdev = n_testdev
        self.uq_fraction = uq_fraction
        self.num_boxes = num_boxes
        self.feat_dim = feat_dim
        self.seed = seed


def _answers() -> list[str]:
    return sorted(set(_OBJECTS + _ATTRIBUTES + ["yes", "no", "1", "2", "3"]))


def _parse_for(sent: str) -> str:
    """A synthetic PTB-style constituency parse for a template question.

    Real GQA rows ship benepar parses (reference ``gqa_data.py:203-228``);
    for the synthetic data a simple chunking grammar suffices: words are
    grouped into 2-word NP constituents under a flat S — enough structure
    to exercise the TreeMix subtree machinery.
    """
    words = sent.split()
    chunks = []
    i = 0
    while i < len(words):
        if words[i] == "?":
            chunks.append("(. ?)")
            i += 1
        elif i + 1 < len(words) and words[i + 1] != "?":
            chunks.append(f"(NP (W {words[i]}) (W {words[i + 1]}))")
            i += 2
        else:
            chunks.append(f"(W {words[i]})")
            i += 1
    return f"(ROOT (S {' '.join(chunks)}))"


def _make_questions(
    rng, n, img_ids, answers, *, uq_fraction=0.0, prefix="q", img2answer=None,
    with_parse=False,
):
    rows = []
    for i in range(n):
        img_idx = rng.integers(len(img_ids))
        img_id = img_ids[img_idx]
        obj = _OBJECTS[rng.integers(len(_OBJECTS))]
        attr = _ATTRIBUTES[rng.integers(len(_ATTRIBUTES))]
        tmpl = _TEMPLATES[rng.integers(len(_TEMPLATES))]
        sent = tmpl.format(obj=obj, attr=attr)
        if rng.random() < uq_fraction:
            label = {"UQ": 1.0}
        elif img2answer is not None:
            # Learnable: the answer is determined by the image's dominant
            # feature dimension (boosted in the packed features below).
            label = {img2answer[img_idx]: 1.0}
        else:
            label = {answers[rng.integers(len(answers))]: 1.0}
        row = {
            "img_id": img_id,
            "question_id": f"{prefix}{i:06d}",
            "sent": sent,
            "label": label,
        }
        if with_parse:
            row["parse"] = _parse_for(sent)
        rows.append(row)
    return rows


def make_synthetic_gqa(
    root: str, spec: Optional[SyntheticSpec] = None
) -> dict:
    """Write a full synthetic GQA tree under ``root``; returns paths."""
    spec = spec or SyntheticSpec()
    rng = np.random.default_rng(spec.seed)
    os.makedirs(root, exist_ok=True)

    img_ids = [f"img{i:05d}" for i in range(spec.n_images)]
    answers = _answers()
    ans2label = {a: i for i, a in enumerate(answers)}
    # Each image gets a dominant answer, realized in its features below.
    dominant = rng.integers(0, len(answers), spec.n_images)
    img2answer = [answers[d] for d in dominant]

    # Question splits.
    splits = {
        "train": _make_questions(
            rng, spec.n_train, img_ids, answers, prefix="tr",
            img2answer=img2answer, with_parse=True,
        ),
        "valid": _make_questions(
            rng, spec.n_valid, img_ids, answers, prefix="va",
            img2answer=img2answer,
        ),
        # RGQA-style testdev: AQ + UQ mixture, like GQAUQ_testdev_ClipEasy.
        "testdev": _make_questions(
            rng,
            spec.n_testdev,
            img_ids,
            answers,
            uq_fraction=spec.uq_fraction,
            prefix="td",
            img2answer=img2answer,
        ),
    }
    # UQ training split (train_neg for RP-style strategies): same questions,
    # paired with a different image, labeled UQ.
    uq_rows = []
    for i, row in enumerate(splits["train"][: spec.n_train // 2]):
        other = img_ids[(img_ids.index(row["img_id"]) + 1) % len(img_ids)]
        uq_rows.append(
            {
                "img_id": other,
                "question_id": f"uq{i:06d}",
                "sent": row["sent"],
                "label": {"UQ": 1.0},
            }
        )
    splits["train_uq"] = uq_rows

    # Reference split names (scripts/*/train/*.sh, scripts/*/test/*.sh use
    # GQAUQ_* split files) aliased onto the synthetic splits so every
    # recipe script runs against a synthetic root unmodified.
    splits["GQAUQ_train_questions_unsup"] = splits["train"]
    splits["GQAUQ_valid_questions_unsup"] = splits["valid"]
    splits["GQAUQ_train_questions_unsup_hard"] = splits["train"] + uq_rows
    splits["GQAUQ_valid_questions_unsup_hard"] = splits["valid"]
    quarter = max(len(splits["testdev"]) // 4, 1)
    for i, subset in enumerate(("ClipEasy", "ClipHard", "PTEasy", "PTHard")):
        rows = splits["testdev"][i * quarter:(i + 1) * quarter]
        splits[f"GQAUQ_testdev_questions_{subset}"] = rows or splits["testdev"][:1]

    for name, rows in splits.items():
        with open(os.path.join(root, f"{name}.json"), "w") as f:
            json.dump(rows, f)
    with open(os.path.join(root, "trainval_ans2label.json"), "w") as f:
        json.dump(ans2label, f)
    with open(os.path.join(root, "trainval_label2ans.json"), "w") as f:
        json.dump(answers, f)

    # Packed features: feature block [0:len(answers)] carries a learnable
    # signal — the per-image "dominant answer" dimension is boosted.
    feat_dir = os.path.join(root, "features")
    os.makedirs(feat_dir, exist_ok=True)
    n, k, d = spec.n_images, spec.num_boxes, spec.feat_dim
    feats = rng.standard_normal((n, k, d), dtype=np.float32) * 0.1
    feats[np.arange(n), :, dominant] += 2.0
    sizes = np.full((n, 2), 512, np.int32)
    boxes = np.zeros((n, k, 4), np.float32)
    x1 = rng.random((n, k), dtype=np.float32) * 400
    y1 = rng.random((n, k), dtype=np.float32) * 400
    boxes[..., 0] = x1
    boxes[..., 1] = y1
    boxes[..., 2] = x1 + 10 + rng.random((n, k), dtype=np.float32) * 100
    boxes[..., 3] = y1 + 10 + rng.random((n, k), dtype=np.float32) * 100
    arrays = {
        "features": feats,
        "boxes": boxes,
        "objects_id": rng.integers(0, 1600, (n, k)).astype(np.int64),
        "objects_conf": rng.random((n, k), dtype=np.float32),
        "attrs_id": rng.integers(0, 400, (n, k)).astype(np.int64),
        "attrs_conf": rng.random((n, k), dtype=np.float32),
        "sizes": sizes,
    }
    # Each image's first box detects its dominant object (when that is
    # an object), as in the JAX package's pack.
    obj2idx = {o: i for i, o in enumerate(_OBJECTS)}
    for i in range(n):
        ans = img2answer[i]
        if ans in obj2idx:
            arrays["objects_id"][i, 0] = obj2idx[ans]

    for name, arr in arrays.items():
        np.save(os.path.join(feat_dir, f"{name}.npy"), arr)
    with open(os.path.join(feat_dir, "img_ids.json"), "w") as f:
        json.dump(img_ids, f)

    # WordPiece vocab covering the question lexicon.
    words = sorted(
        set(
            w
            for tmpl in _TEMPLATES
            for w in tmpl.replace("{obj}", "").replace("{attr}", "").split()
        )
        | set(_OBJECTS)
        | set(_ATTRIBUTES)
    )
    vocab_path = os.path.join(root, "vocab.txt")
    with open(vocab_path, "w") as f:
        for tok in [PAD, UNK, CLS, SEP, MASK]:
            f.write(tok + "\n")
        for ch in sorted(set("".join(words))):
            f.write(ch + "\n")
            f.write("##" + ch + "\n")
        for w in words:
            f.write(w + "\n")

    return {
        "root": root,
        "features": feat_dir,
        "vocab": vocab_path,
        "splits": sorted(splits),
        "num_answers": len(answers),
    }
