"""OOD-rejection summary metrics.

Pure-numpy equivalents of the reference metric bundle
(``src/ood_metrics.py`` / ``compute_accfpr/ood_metrics.py``):

- ``auroc`` / ``aupr`` — areas under ROC and precision-recall curves.
- ``fpr_at_tpr`` — FPR at a minimum TPR (FPR95 and friends),
  reference ``ood_metrics.py:54-74``.
- ``detection_error`` — min misclassification probability at TPR >= 0.95,
  reference ``ood_metrics.py:76-100``.
- ``ood_performance`` — the standard bundle, reference ``ood_metrics.py:103``.
- ``accfpr_metrics`` — AUAF / FPR@target-acc / full accuracy over the
  acc-fpr curve, reference ``ood_metrics.py:118-151``.
"""

from __future__ import annotations

import numpy as np

from rgqa_tpu_torch.metrics.curves import (
    accfpr_curve,
    auc,
    precision_recall_curve,
    roc_curve,
)

__all__ = [
    "auroc",
    "aupr",
    "fpr_at_tpr",
    "detection_error",
    "ood_performance",
    "accfpr_metrics",
    "f1_binary",
]


def auroc(scores, labels) -> float:
    """Area under the ROC curve; ``labels`` binary with 1 = in-domain."""
    fpr, tpr, _ = roc_curve(labels, scores)
    return auc(fpr, tpr)


def aupr(scores, labels) -> float:
    """Area under the precision-recall curve (positive class = 1)."""
    precision, recall, _ = precision_recall_curve(labels, scores)
    return auc(recall, precision)


def fpr_at_tpr(scores, labels, min_tpr: float = 0.95) -> float:
    """FPR at the smallest threshold achieving ``tpr >= min_tpr``.

    Mirrors the reference edge cases (``ood_metrics.py:54-74``): returns 0
    when no threshold reaches the target TPR, the minimum FPR among
    qualifying points when all do, and a linear interpolation otherwise.
    """
    fpr, tpr, _ = roc_curve(labels, scores)
    above = tpr >= min_tpr
    if not above.any():
        return 0.0
    if above.all():
        return float(fpr[above].min())
    return float(np.interp(min_tpr, tpr, fpr))


def detection_error(scores, labels, min_tpr: float = 0.95) -> float:
    """Minimum weighted misclassification probability at ``tpr >= min_tpr``.

    Follows the reference convention (``ood_metrics.py:76-100``) where the
    class labelled 1 weights the miss rate: the error at a threshold is
    ``P(label==1) * (1 - tpr) + P(label==0) * fpr``.
    """
    labels = np.asarray(labels, dtype=np.float64).ravel()
    fpr, tpr, _ = roc_curve(labels, scores)
    w1 = float((labels == 1).sum()) / labels.size
    w0 = 1.0 - w1
    qual = tpr >= min_tpr
    if not qual.any():
        raise ValueError(f"no threshold reaches tpr >= {min_tpr}")
    return float(np.min(w1 * (1.0 - tpr[qual]) + w0 * fpr[qual]))


def ood_performance(gts, scores) -> dict:
    """The reference's standard OOD metric bundle (``ood_metrics.py:103``).

    ``gts`` binary with 1 = in-domain (answerable); ``scores`` acceptance
    confidences.
    """
    gts = np.asarray(gts, dtype=np.float64).ravel()
    scores = np.asarray(scores, dtype=np.float64).ravel()
    measures = {
        "fpr95": fpr_at_tpr(scores, gts, 0.95),
        "fpr81.4": fpr_at_tpr(scores, gts, 0.814),
        "fpr88.9": fpr_at_tpr(scores, gts, 0.889),
        "auroc": auroc(scores, gts),
        "aupr_in": aupr(scores, gts),
        "aupr_out": aupr(-scores, 1.0 - gts),
    }
    try:
        measures["detection_error"] = detection_error(scores, gts)
    except (ValueError, ZeroDivisionError):
        measures["detection_error"] = float("nan")
    return measures


def accfpr_metrics(
    scores,
    preds,
    labels,
    reject_label,
    target_acc_ratio: float = 0.95,
) -> dict:
    """AUAF + FPR at a target fraction of full accuracy + full accuracy.

    The headline RGQA triple (reference ``ood_metrics.py:118-151``):

    - ``auaf``: area under the acc-fpr curve;
    - ``fpr@{r}acc`` (FF95 at r=0.95): the lowest FPR at which accuracy is
      at least ``r`` times the accuracy when accepting everything —
      interpolated along the curve when no swept threshold lands there;
    - ``full_acc`` (FACC): accuracy when accepting everything.
    """
    fpr, acc, _ = accfpr_curve(labels, preds, scores, reject_label)
    target_acc = acc[-1] * target_acc_ratio
    key = f"fpr@{target_acc_ratio:.2f}acc"
    reach = acc >= target_acc
    if reach.all():
        fpr_at_target = float(fpr[reach].min())
    else:
        fpr_at_target = float(np.interp(target_acc, acc, fpr))
    return {
        "auaf": auc(fpr, acc),
        key: fpr_at_target,
        "full_acc": float(acc[-1]),
    }


def f1_binary(y_true, y_pred) -> float:
    """Binary F1 with positive class 1 (sklearn ``f1_score`` default)."""
    y_true = np.asarray(y_true, dtype=np.float64).ravel()
    y_pred = np.asarray(y_pred, dtype=np.float64).ravel()
    tp = float(np.sum((y_true == 1) & (y_pred == 1)))
    fp = float(np.sum((y_true == 0) & (y_pred == 1)))
    fn = float(np.sum((y_true == 1) & (y_pred == 0)))
    denom = 2 * tp + fp + fn
    return 2 * tp / denom if denom > 0 else 0.0
