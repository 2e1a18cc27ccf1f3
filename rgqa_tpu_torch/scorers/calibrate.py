"""Threshold calibration from the acc-fpr curve (port of
``rgqa_tpu/scorers/calibrate.py``, on the port's own metrics).

``gqa_conf.predict_with_thresh`` (``gqa_conf.py:262-295``): pick the
confidence threshold tau whose cumulative accuracy on a labeled split
equals ``target_acc``, by linear interpolation on the acc-fpr curve;
predictions scoring below tau become 'UQ'.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from rgqa_tpu_torch.metrics import accfpr_curve

__all__ = ["calibrate_tau", "apply_tau"]


def calibrate_tau(
    targets: Sequence[str],
    preds: Sequence[str],
    scores: Sequence[float],
    target_acc: float,
    *,
    neg_label: str = "UQ",
) -> float:
    """Interpolated tau achieving ``target_acc`` (``gqa_conf.py:286-288``)."""
    targets = np.asarray(targets, dtype=str)
    preds = np.asarray(preds, dtype=str)
    scores = np.asarray(scores, dtype=float)
    _, acc, thresh = accfpr_curve(targets, preds, scores, neg_label)
    if not target_acc < acc[-1]:
        raise ValueError(f"target_acc {target_acc} not reachable (max acc {acc[-1]:.4f})")
    return float(np.interp(target_acc, acc, thresh))


def apply_tau(quesid2ans: dict, tau: float, *, neg_label: str = "UQ") -> dict:
    """Replace predictions scoring below tau with the reject label."""
    out = {}
    for qid, value in quesid2ans.items():
        ans, score, *rest = tuple(value)
        out[qid] = (neg_label if score < tau else ans, score, *rest)
    return out
