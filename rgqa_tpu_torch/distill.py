"""Dataset-cartography distillation (port of ``rgqa_tpu/distill.py``;
reference ``src/tasks/gqa_distill.py`` and ``gqa_ensemble_distill.py``).

Re-paired (image, question-from-another-image) candidates are scored by a
teacher over several passes, each question's mean confidence and
variability over the passes (its cartography statistics) select:

- pseudo-AQ: confidence > tau_aq_c and variability < tau_aq_v, labeled
  with the teacher's majority answer at its mean confidence;
- pseudo-UQ: confidence < tau_uq_c and variability < tau_uq_v, labeled UQ;
- optionally AQ / UQ balanced to within 1.25x (``filter_data_for_distill``).

Output rows use the reference's ``question_id = img_id + '+' + orig_qid``
convention and the split-JSON schema, so a student trains on them through
the train CLI's ``--train``.

:func:`sample_repaired`, :func:`stats_from_charts`,
:func:`cartography_stats` and :func:`select_distill` are copies of the JAX
module's, held to them bit for bit (``tests/test_torch_port_rules.py``).
:func:`build_distill_split` scores with MC-dropout passes through the
port's :func:`~rgqa_tpu_torch.scorers.core.make_dropout_scorer` (kernel #4
on the card, pass i seeded ``seed + i``): its dropout bits are the port's,
not JAX's ``rbg`` stream, so it holds JAX's contract, not its stream (at
dropout 0 every pass is MSP and the split equals JAX's row for row).
:func:`build_ensemble_distill_split` multiplies the teachers' sigmoid
vectors (f32, as the JAX package's numpy does) from ``.pth`` checkpoints;
an orbax snapshot directory is read through its ``orbax_to_pth.py``
export and refused, naming the command, without it.

Both split functions run on every rank of a data-parallel runner (its
``mesh``): the candidates come from the shared host stream, every rank
scores its rows of each global batch and gets every rank's outputs
(``_map_eval``), each MC-dropout pass draws from the rank's own stream
(so at dropout 0 N ranks give one process's rows), rank 0 writes the
split and every rank returns its rows after a barrier.  The chart
pickles that :func:`stats_from_charts` reads are written by rank 0 of a
training run before its barrier (``GQARunner._epoch_end``).
"""

from __future__ import annotations

import json
import os
from collections import Counter
from typing import Mapping, Optional, Sequence

import numpy as np

from rgqa_tpu_torch.checkpoint.convert import orbax_refusal
from rgqa_tpu_torch.data.dataset import GQADataset
from rgqa_tpu_torch.parallel import on_main
from rgqa_tpu_torch.scorers.core import make_dropout_scorer, make_msp_scorer

__all__ = [
    "sample_repaired",
    "stats_from_charts",
    "cartography_stats",
    "select_distill",
    "build_distill_split",
    "build_ensemble_distill_split",
    "teacher_pth",
]


def sample_repaired(
    data: Sequence[Mapping],
    rng: np.random.Generator,
    n: int,
) -> list[dict]:
    """Re-pair questions with other images (``gqa_distill.py:190-227``)."""
    img_ids = sorted({d["img_id"] for d in data})
    out = []
    for i in range(n):
        q = data[int(rng.integers(len(data)))]
        img = img_ids[int(rng.integers(len(img_ids)))]
        while img == q["img_id"] and len(img_ids) > 1:
            img = img_ids[int(rng.integers(len(img_ids)))]
        out.append(
            {
                "img_id": img,
                "sent": q["sent"],
                "original_question_id": q["question_id"],
                "question_id": f"cand{i:07d}",
            }
        )
    return out


def stats_from_charts(chart_dir: str) -> dict[str, dict]:
    """Cartography statistics from training chart pickles.

    The reference's offline pipeline consumes per-epoch ``--chart`` dumps
    (``gqa_distill.py:37-42``; chart rows are ``{qid: (max-score, gold
    label, pred)}`` written by the trainer).  Mean confidence +
    variability over epochs, majority answer over predictions.
    """
    import glob
    import pickle

    passes = []
    for path in sorted(glob.glob(os.path.join(chart_dir, "epoch_*.pkl"))):
        with open(path, "rb") as f:
            chart = pickle.load(f)
        passes.append(
            {qid: (pred, float(score)) for qid, (score, _gold, pred) in chart.items()}
        )
    if not passes:
        raise FileNotFoundError(f"no epoch_*.pkl charts under {chart_dir}")
    common = set(passes[0])
    for p in passes[1:]:
        common &= set(p)
    passes = [{q: p[q] for q in common} for p in passes]
    return cartography_stats(passes)


def cartography_stats(
    passes: Sequence[Mapping[str, tuple[str, float]]],
) -> dict[str, dict]:
    """Per-question mean confidence, variability, majority answer
    (``gqa_distill.py:252-259``)."""
    out: dict[str, dict] = {}
    qids = passes[0].keys()
    for qid in qids:
        confs = np.asarray([p[qid][1] for p in passes], np.float64)
        answers = [p[qid][0] for p in passes]
        mean = float(confs.mean())
        out[qid] = {
            "confidence": mean,
            "variability": float(np.sqrt(((confs - mean) ** 2).mean())),
            "answer": Counter(answers).most_common(1)[0][0],
        }
    return out


def select_distill(
    candidates: Sequence[Mapping],
    stats: Mapping[str, dict],
    *,
    tau_aq_c: float = 0.5,
    tau_aq_v: float = 0.15,
    tau_uq_c: float = 0.1,
    tau_uq_v: float = 0.05,
    balance: bool = False,
    n_original: int = 0,
    rng: Optional[np.random.Generator] = None,
) -> tuple[list[dict], list[dict]]:
    """Threshold + balance selection (``filter_data_for_distill``)."""
    rng = rng or np.random.default_rng(0)
    aq, uq = [], []
    for cand in candidates:
        # Candidates whose image was dropped by the feature filter
        # (--tiny/--fast or missing rows) have no teacher scores — skip.
        if cand["question_id"] not in stats:
            continue
        s = stats[cand["question_id"]]
        row = {
            "img_id": cand["img_id"],
            "sent": cand["sent"],
            "question_id": cand["img_id"] + "+" + cand["original_question_id"],
        }
        if s["confidence"] < tau_uq_c and s["variability"] < tau_uq_v:
            row["label"] = {"UQ": 1}
            uq.append(row)
        elif s["confidence"] > tau_aq_c and s["variability"] < tau_aq_v:
            row["label"] = {s["answer"]: float(s["confidence"])}
            aq.append(row)
    rng.shuffle(uq)
    rng.shuffle(aq)
    if balance:
        n_uq, n_aq = len(uq), len(aq)
        if n_aq + n_original > n_uq * 1.25:
            aq = aq[: max(int(n_uq * 1.25 - n_original), 0)]
        elif n_uq > (n_aq + n_original) * 1.25:
            uq = uq[: int((n_aq + n_original) * 1.25)]
    return aq, uq


def build_distill_split(
    runner,
    *,
    n_candidates: int,
    passes: int = 3,
    out_path: str,
    seed: int = 0,
    balance: bool = True,
    **taus,
) -> list[dict]:
    """End to end: sample candidates, score them with ``passes`` MC-dropout
    passes of ``runner`` (a :class:`rgqa_tpu_torch.runner.GQARunner`, the
    teacher; pass i seeded ``seed + i``), select, and write the student
    split JSON to ``out_path``; returns its rows."""
    rng = np.random.default_rng(seed)
    cands = sample_repaired(runner.dataset.data, rng, n_candidates)
    tmp = GQADataset.from_rows(
        cands, ans2label=runner.dataset.ans2label, label2ans=runner.dataset.label2ans,
        name="distill_candidates",
    )
    encoded = runner._encode(tmp)
    pass_results = [
        runner.score_split(encoded, scorer=make_dropout_scorer(runner.forward, seed_list=(seed + i,),
                                                               mesh=runner.mesh))
        for i in range(passes)
    ]
    stats = cartography_stats(pass_results)
    aq, uq = select_distill(
        cands, stats, balance=balance, n_original=len(runner.dataset.data), rng=rng, **taus,
    )
    rows = aq + uq
    on_main(runner.mesh, _write_json, rows, out_path)
    return rows


def _write_json(obj, path: str) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)


def teacher_pth(path: str) -> str:
    """A teacher checkpoint as a ``.pth`` file: ``path``, or ``path +
    '.pth'`` when ``path`` is missing (a run's ``BEST`` / ``LAST``
    name, or the export of an orbax snapshot directory ``path``); an
    orbax snapshot directory without its export is refused, naming the
    command that writes it."""
    if not os.path.isfile(path) and os.path.isfile(path + ".pth"):
        return path + ".pth"
    if os.path.isdir(path):
        raise orbax_refusal("--teacher_path", path, path + ".pth")
    return path


def build_ensemble_distill_split(
    runner,
    ckpt_paths: Sequence[str],
    *,
    splits: str,
    out_path: str,
) -> list[dict]:
    """Ensemble-teacher pseudo-labeling (``gqa_ensemble_distill.py:85-139``):
    each ``.pth`` of ``ckpt_paths`` is loaded into ``runner`` in turn, the
    MSP sigmoid vectors of ``splits``' questions multiply across teachers
    (f32), and the student split ``{img_id, question_id, sent, label:
    {argmax answer: ensemble score}}`` is written to ``out_path``.  UQ
    rows keep the reference's ``unanswerable_reason+question_id`` ids
    (``:91-100``)."""
    paths = [teacher_pth(p) for p in ckpt_paths]
    data: dict[str, dict] = {}
    for d in GQADataset(runner.cfg.data.data_root, splits, add_uq=True).data:
        label = d.get("label") or {}
        if "UQ" in label and d.get("unanswerable_reason"):
            qid = f"{d['unanswerable_reason']}+{d['question_id']}"
        else:
            qid = d["question_id"]
        data[qid] = {**d, "question_id": qid}
    tmp = GQADataset.from_rows(
        list(data.values()), ans2label=runner.dataset.ans2label, label2ans=runner.dataset.label2ans,
        name="ensemble_distill",
    )
    encoded = runner._encode(tmp)

    msp = make_msp_scorer(runner.forward)
    quesid2conf: dict[str, np.ndarray] = {}
    for path in paths:
        runner.load(path)
        for qids, out, real in runner._map_eval(encoded, msp, ("probs",)):
            for qid, p in zip(qids, out["probs"][:real].astype(np.float32)):
                quesid2conf[qid] = quesid2conf[qid] * p if qid in quesid2conf else p

    final = []
    label2ans = runner.label2ans
    for qid, score in quesid2conf.items():
        label = int(np.argmax(score))
        final.append({
            "img_id": data[qid]["img_id"],
            "question_id": data[qid]["question_id"],
            "sent": data[qid]["sent"],
            "label": {label2ans[label]: float(score[label])},
        })
    on_main(runner.mesh, _write_json, final, out_path)
    return final
