"""End-to-end RGQA evaluators and the prediction-JSON contract.

Behavioral equivalents of the reference evaluators:

- ``ClosedSetEvaluator`` — soft-accuracy GQA scoring + challenge dump
  (reference ``src/tasks/gqa_data.py:494-528``).
- ``RGQAEvaluator`` — the OOD evaluator over ``{questionId, prediction,
  confidence}`` records (reference ``compute_accfpr/compute_accfpr.py:13-68``
  and ``src/tasks/gqa_data.py:531-605``).
- ``dump_predictions`` — emits the exact JSON format the reference's
  standalone ``compute_accfpr`` CLI consumes
  (reference ``src/tasks/gqa_data.py:583-605``).

Labels are soft-answer dicts ``{answer: weight}``; a question is
unanswerable iff ``'UQ'`` is a key of its label dict.
"""

from __future__ import annotations

import json
from typing import Iterable, Mapping

import numpy as np

from rgqa_tpu_torch.metrics.ood import accfpr_metrics, f1_binary, ood_performance

__all__ = [
    "REJECT_LABEL",
    "ClosedSetEvaluator",
    "RGQAEvaluator",
    "ood_evaluate",
    "dump_predictions",
]

REJECT_LABEL = "UQ"


def dump_predictions(quesid2ans: Mapping[str, tuple[str, float]], path: str) -> None:
    """Write predictions in the reference's submittable JSON format.

    One record per question: ``{"questionId": id, "prediction": answer,
    "confidence": round(conf, 4)}``, serialized with ``indent=4`` and sorted
    keys — byte-compatible with ``gqa_data.py:583-605`` so the reference
    ``compute_accfpr`` CLI runs on the output unmodified.
    """
    records = [
        {
            "questionId": qid,
            "prediction": ans,
            "confidence": round(float(conf), 4),
        }
        for qid, (ans, conf) in quesid2ans.items()
    ]
    with open(path, "w") as f:
        json.dump(records, f, indent=4, sort_keys=True)


class ClosedSetEvaluator:
    """Soft-accuracy scoring for closed-set GQA (``gqa_data.py:494-528``)."""

    def __init__(self, qid2label: Mapping[str, Mapping[str, float]]):
        self.qid2label = dict(qid2label)

    def evaluate(self, quesid2ans: Mapping[str, str]) -> float:
        score = 0.0
        for qid, ans in quesid2ans.items():
            label = self.qid2label[qid]
            score += label.get(ans, 0.0)
        return score / max(len(quesid2ans), 1)

    def dump_result(self, quesid2ans: Mapping[str, str], path: str) -> None:
        records = [
            {"questionId": qid, "prediction": ans}
            for qid, ans in quesid2ans.items()
        ]
        with open(path, "w") as f:
            json.dump(records, f, indent=4, sort_keys=True)


class RGQAEvaluator:
    """RVQA rejection evaluator (``compute_accfpr.py:13-68``).

    Consumes a list of prediction records ``{'questionId', 'prediction',
    'confidence'}`` and gold labels ``{qid: {answer: weight}}`` where
    unanswerable questions carry the ``'UQ'`` key.  Produces the full RGQA
    metric dict: AUAF / FF95 / FACC, AUROC, AUPR in/out, FPR@{95, 81.4}TPR,
    detection error, accept/overall/in-domain accuracies, and binary F1 at
    the acceptance threshold ``tau``.
    """

    def __init__(
        self,
        qid2label: Mapping[str, Mapping[str, float]],
        tau: float = 0.5,
        target_acc_ratio: float = 0.95,
    ):
        self.qid2label = dict(qid2label)
        self.tau = tau
        self.target_acc_ratio = target_acc_ratio

    def evaluate(self, predictions: Iterable[Mapping]) -> dict:
        predictions = list(predictions)
        n = len(predictions)

        scores = np.empty(n, dtype=np.float64)
        is_answerable = np.empty(n, dtype=np.float64)
        soft_correct = np.empty(n, dtype=np.float64)
        preds = np.empty(n, dtype=object)
        golds = np.empty(n, dtype=object)

        for i, rec in enumerate(predictions):
            label = self.qid2label[rec["questionId"]]
            ans = rec["prediction"]
            scores[i] = rec["confidence"]
            is_answerable[i] = float(REJECT_LABEL not in label)
            soft_correct[i] = label.get(ans, 0.0)
            preds[i] = ans
            # The reference keys metrics on the first (only) gold answer.
            golds[i] = next(iter(label))

        accepted = scores > self.tau
        results = dict(
            accfpr_metrics(
                scores,
                preds.astype(str),
                golds.astype(str),
                REJECT_LABEL,
                self.target_acc_ratio,
            )
        )

        n_accepted = int(accepted.sum())
        if n_accepted < n:
            results.update(ood_performance(is_answerable, scores))
            results["accuracy_accept"] = (
                float(soft_correct[accepted].sum()) / n_accepted
                if n_accepted > 0
                else 0.0
            )
            results["accuracy"] = float(soft_correct.sum()) / n
            results["f1"] = f1_binary(is_answerable, accepted)

        n_id = float(is_answerable.sum())
        results["accuracy_indomain"] = (
            float(soft_correct[is_answerable == 1].sum()) / n_id
            if n_id > 0
            else float("nan")
        )
        return results

    def evaluate_quesid2ans(
        self, quesid2ans: Mapping[str, tuple[str, float]]
    ) -> dict:
        """Evaluate the driver-internal ``{qid: (answer, confidence)}`` form."""
        return self.evaluate(
            {
                "questionId": qid,
                "prediction": ans,
                "confidence": float(conf),
            }
            for qid, (ans, conf) in quesid2ans.items()
        )

    def dump_result(self, quesid2ans, path: str) -> None:
        dump_predictions(quesid2ans, path)


def ood_evaluate(qid2label, predictions, tau: float = 0.5) -> dict:
    """One-shot evaluation, mirroring ``compute_accfpr.py:71-74``."""
    return RGQAEvaluator(qid2label, tau=tau).evaluate(predictions)
