"""Synthetic GQA/RGQA data: a numpy-only copy of ``make_synthetic_gqa``
from ``rgqa_tpu/data/synthetic.py``.

A copy, because importing anything under ``rgqa_tpu.data`` runs its
``__init__``, which imports jax and flax, and the port runs where they
are absent.  It makes the same draws in the same order, so a root made
here holds the same question splits, answer vocab, feature pack and
``vocab.txt`` as one made by the JAX package (``tests/test_torch_data.py``).

Images for ViLT.  The JAX generator draws a 32 x 32 uint8 base image per
image id after every other array and writes it as a 64 x 64 JPEG
(bicubic), which its image source decodes and resizes to 384 (bicubic
again).  The machine with the card has no PIL, so the port neither
writes nor decodes JPEGs: it makes the same base-image draws in the same
order (so nothing else moves), keeps them in ``synthetic_images_u8.npy``
and :func:`make_synthetic_pixel_pack` writes them, upsampled by nearest
neighbour, straight into a pixel pack ``pixels_<size>_<mode>/`` recorded
as built from ``<root>/images``, which the JAX package's ``PixelPack``
and runner read unchanged.  The CLIP scorer's pack,
``pixels_clip_<size>/``, is written from the same base images the same
way.  These pixels are therefore not the JAX generator's
JPEG-then-bicubic ones: a parity test feeds both packages from one pack.
The images are square, so every rect is the whole image in every mode.

``objects_vocab.txt`` (the FRCNN coverage scorer's detector classes:
the lexicon's object names, then ``thing0000`` ... up to 1600 rows) and
``image2caps.json`` (the caption matcher's captions, one per image) are
written as by the JAX package.  :func:`make_synthetic_vqa`, the VQA-v2
tree (integer question ids, soft scores, no images), is the JAX
function's source unchanged.

Questions are template-generated over a small object/attribute lexicon;
each image's "dominant answer" dimension is boosted in its features, so
a model has something learnable.

Beyond the JAX module: :func:`random_obj_rows` (seeded rows for a test
TSV, see ``data.tsv.write_obj_tsv``) and :func:`serve_records` (a split's
rows as JSONL records for ``cli.serve``).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from rgqa_tpu_torch.data.tokenizer import PAD, UNK, CLS, SEP, MASK

__all__ = ["make_synthetic_gqa", "make_synthetic_vqa", "make_synthetic_pixel_pack", "SyntheticSpec",
           "BASE_IMAGES"]

# The 32 x 32 base images, (n_images, 32, 32, 3) uint8, under the root.
BASE_IMAGES = "synthetic_images_u8.npy"

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
    # The detector's class names for the FRCNN coverage scorer (reference
    # data/vg_gqa_imgfeat/objects_vocab.txt): the lexicon's objects, then
    # filler classes.  Each image's first box detects its dominant object
    # (when that is an object), so coverage carries signal.
    obj_vocab = list(_OBJECTS) + [f"thing{i:04d}" for i in range(1600 - len(_OBJECTS))]
    with open(os.path.join(root, "objects_vocab.txt"), "w") as f:
        f.write("\n".join(obj_vocab) + "\n")
    obj2idx = {o: i for i, o in enumerate(_OBJECTS)}
    for i in range(n):
        ans = img2answer[i]
        if ans in obj2idx:
            arrays["objects_id"][i, 0] = obj2idx[ans]

    for name, arr in arrays.items():
        np.save(os.path.join(feat_dir, f"{name}.npy"), arr)
    with open(os.path.join(feat_dir, "img_ids.json"), "w") as f:
        json.dump(img_ids, f)

    # Base images for the ViLT path: mean colour encodes the dominant
    # answer (the JAX generator's draws, before its JPEG step).
    base = np.empty((n, 32, 32, 3), np.uint8)
    for i in range(n):
        img = rng.integers(0, 60, (32, 32, 3)).astype(np.uint8)
        hue = (dominant[i] * 37) % 256
        img[..., 0] = np.clip(img[..., 0] + hue, 0, 255)
        base[i] = img
    np.save(os.path.join(root, BASE_IMAGES), base)

    # Captions for the Q-C matcher (reference data/gqa/image2caps.json).
    image2caps = {
        img_id: [f"a photo of the {img2answer[i]}"]
        for i, img_id in enumerate(img_ids)
    }
    with open(os.path.join(root, "image2caps.json"), "w") as f:
        json.dump(image2caps, f)

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


def make_synthetic_pixel_pack(root: str, size: int = 384, mode: Optional[str] = "pad",
                              transform: str = "pixelbert"):
    """Write ``<root>/pixels_<size>_<mode>/``, a pixelbert pixel pack of the
    synthetic root's base images upsampled to ``size`` by nearest
    neighbour, recorded as built from ``<root>/images``; returns it as a
    :class:`~rgqa_tpu_torch.data.images.PixelPack`.  ``transform="clip"``
    writes the same rows as CLIP's pack, ``<root>/pixels_clip_<size>/``
    (mode None: the images are square, so CLIP's center crop keeps them
    whole)."""
    from rgqa_tpu_torch.data.images import write_pixel_pack

    if transform == "clip":
        mode, out_dir = None, os.path.join(root, f"pixels_clip_{size}")
    elif mode in ("pad", "crop"):
        out_dir = os.path.join(root, f"pixels_{size}_{mode}")
    else:
        raise ValueError(f"mode must be pad|crop, got {mode!r}")
    base = np.load(os.path.join(root, BASE_IMAGES))
    with open(os.path.join(root, "features", "img_ids.json")) as f:
        img_ids = json.load(f)
    src = np.arange(size) * base.shape[1] // size  # nearest source row/column
    pixels = base[:, src][:, :, src]
    rects = np.tile(np.asarray([0, 0, size, size], np.int32), (len(img_ids), 1))
    return write_pixel_pack(
        out_dir, os.path.join(root, "images"), img_ids, pixels, rects, size=size, mode=mode,
        transform=transform,
    )


def make_synthetic_vqa(root: str, spec: Optional[SyntheticSpec] = None) -> dict:
    """Write a synthetic VQA-v2-format tree under ``root``.

    Mirrors the reference's on-disk contract (``src/tasks/vqa_data.py``):

    - ``<split>.json`` rows ``{answer_type, img_id, label: {ans: score},
      question_id: int, question_type, sent}`` — note **integer**
      question ids and 10-annotator soft scores in {0.3, 0.6, 0.9, 1.0}
      (``vqa_data.py:34-45``); the ``test`` split carries no labels
      (``vqa_data.py:143-150``);
    - ``trainval_ans2label.json`` / ``trainval_label2ans.json``;
    - the same packed-feature layout as GQA (MSCOCO obj36 in the
      reference, ``vqa_data.py:75-80``) and a WordPiece ``vocab.txt``.
    """
    spec = spec or SyntheticSpec()
    rng = np.random.default_rng(spec.seed + 7)
    os.makedirs(root, exist_ok=True)

    img_ids = [f"COCO_synth_{i:012d}" for i in range(spec.n_images)]
    answers = _answers()
    ans2label = {a: i for i, a in enumerate(answers)}
    dominant = rng.integers(0, len(answers), spec.n_images)
    img2answer = [answers[d] for d in dominant]
    qtypes = ["what is the", "is there a", "how many"]

    def vqa_rows(n, prefix_base, *, with_labels=True):
        rows = []
        for i in range(n):
            img_idx = int(rng.integers(len(img_ids)))
            obj = _OBJECTS[rng.integers(len(_OBJECTS))]
            attr = _ATTRIBUTES[rng.integers(len(_ATTRIBUTES))]
            tmpl = _TEMPLATES[rng.integers(len(_TEMPLATES))]
            row = {
                "answer_type": "other",
                "img_id": img_ids[img_idx],
                "question_id": prefix_base + i,
                "question_type": qtypes[int(rng.integers(len(qtypes)))],
                "sent": tmpl.format(obj=obj, attr=attr),
            }
            if with_labels:
                # Annotator agreement: dominant answer near 1.0, sometimes
                # a runner-up at a lower soft score.
                label = {img2answer[img_idx]: float(rng.choice([0.9, 1.0]))}
                if rng.random() < 0.3:
                    alt = answers[int(rng.integers(len(answers)))]
                    if alt not in label:
                        label[alt] = float(rng.choice([0.3, 0.6]))
                row["label"] = label
            rows.append(row)
        return rows

    splits = {
        "train": vqa_rows(spec.n_train, 1_000_000),
        "minival": vqa_rows(spec.n_valid, 2_000_000),
        "nominival": vqa_rows(spec.n_valid, 3_000_000),
        "test": vqa_rows(spec.n_testdev, 4_000_000, with_labels=False),
    }
    for name, rows in splits.items():
        with open(os.path.join(root, f"{name}.json"), "w") as f:
            json.dump(rows, f)
    with open(os.path.join(root, "trainval_ans2label.json"), "w") as f:
        json.dump(ans2label, f)
    with open(os.path.join(root, "trainval_label2ans.json"), "w") as f:
        json.dump(answers, f)

    # Feature pack: same learnable dominant-dimension signal as GQA.
    feat_dir = os.path.join(root, "features")
    os.makedirs(feat_dir, exist_ok=True)
    n, k, d = spec.n_images, spec.num_boxes, spec.feat_dim
    feats = rng.standard_normal((n, k, d), dtype=np.float32) * 0.1
    feats[np.arange(n), :, dominant] += 2.0
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
        "sizes": np.full((n, 2), 512, np.int32),
    }
    for name, arr in arrays.items():
        np.save(os.path.join(feat_dir, f"{name}.npy"), arr)
    with open(os.path.join(feat_dir, "img_ids.json"), "w") as f:
        json.dump(img_ids, f)

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


def random_obj_rows(boxes, *, feat_dim: int = 2048, seed: int = 0):
    """Seeded rows for :func:`~rgqa_tpu_torch.data.tsv.write_obj_tsv`, one
    per entry of ``boxes`` with that many RoIs (ids ``img000000``, ...)."""
    rng = np.random.default_rng(seed)
    for i, n in enumerate(boxes):
        yield {
            "img_id": f"img{i:06d}", "img_h": int(rng.integers(200, 800)), "img_w": int(rng.integers(200, 800)),
            "objects_id": rng.integers(0, 1600, n), "objects_conf": rng.random(n),
            "attrs_id": rng.integers(0, 400, n), "attrs_conf": rng.random(n),
            "boxes": rng.random((n, 4)) * 500,
            "features": rng.standard_normal((n, feat_dim), dtype=np.float32),
        }


def serve_records(rows: list, n: int) -> list:
    """``n`` JSONL records for ``cli.serve``: the split rows ``rows`` over
    and over, each record with its own question id."""
    return [json.dumps({"question_id": f"s{i:06d}", "sent": rows[i % len(rows)]["sent"],
                        "img_id": rows[i % len(rows)]["img_id"]}) for i in range(n)]
