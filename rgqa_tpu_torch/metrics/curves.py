"""Threshold-sweep curves in pure numpy.

Self-contained equivalents of the curve primitives the reference builds on
sklearn (``roc_curve``, ``precision_recall_curve``, ``auc``) plus the RGQA
acc-fpr curve (reference ``accfpr/accfpr.py:16-167``).  All functions follow
the same threshold semantics as sklearn so downstream numbers match the
reference evaluator exactly: scores are swept in decreasing order, curve
points are taken at distinct score values, and collinear interior points may
be dropped (they never change the area under the curve).
"""

from __future__ import annotations

import warnings

import numpy as np

__all__ = ["auc", "accfpr_curve", "roc_curve", "precision_recall_curve"]


def auc(x: np.ndarray, y: np.ndarray) -> float:
    """Trapezoidal area under a curve given by monotonic ``x`` and ``y``.

    Accepts ``x`` sorted in either direction (like ``sklearn.metrics.auc``):
    a decreasing ``x`` contributes positive area measured right-to-left.
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if x.size < 2:
        raise ValueError("auc requires at least 2 points, got %d" % x.size)
    dx = np.diff(x)
    if np.any(dx < 0):
        if np.all(dx <= 0):
            direction = -1.0
        else:
            raise ValueError("x is neither increasing nor decreasing")
    else:
        direction = 1.0
    return float(direction * np.trapezoid(y, x))


def _sweep(
    scores: np.ndarray, *stats: np.ndarray
) -> tuple[np.ndarray, ...]:
    """Sort by score descending and cumulate ``stats`` at distinct scores.

    Returns ``(thresholds, cum_stat_0, cum_stat_1, ...)`` where each
    cumulative statistic is evaluated at the *last* index of each group of
    tied scores — i.e. the count of samples with ``score >= threshold``.
    """
    order = np.argsort(-scores, kind="stable")
    s = scores[order]
    # Boundary index of each distinct score value (end of each tie group).
    cut = np.r_[np.nonzero(np.diff(s))[0], s.size - 1]
    out = [s[cut]]
    for stat in stats:
        out.append(np.cumsum(stat[order].astype(np.float64))[cut])
    return tuple(out)


def _drop_collinear(*arrays: np.ndarray) -> tuple[np.ndarray, ...]:
    """Drop interior points collinear in the first two arrays (fps, tps).

    Collinear interior points never change the trapezoidal area; dropping
    them keeps the curve light (mirrors sklearn's ``drop_intermediate``).
    """
    a, b = arrays[0], arrays[1]
    if len(a) <= 2:
        return arrays
    keep = np.r_[True, np.logical_or(np.diff(a, 2), np.diff(b, 2)), True]
    return tuple(arr[keep] for arr in arrays)


def accfpr_curve(
    y_true: np.ndarray,
    y_pred: np.ndarray,
    y_score: np.ndarray,
    reject_label,
    *,
    sample_weight: np.ndarray | None = None,
    drop_intermediate: bool = True,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The RGQA selective-classification curve (reference ``accfpr.py:87``).

    At each confidence threshold tau (swept from high to low):

    - ``acc(tau)``  = (# answerable samples accepted AND answered correctly)
                      / (# answerable samples total)
    - ``fpr(tau)``  = (# reject-label samples accepted)
                      / (# reject-label samples total)

    Rejected answerable samples count as wrong, so accuracy increases
    monotonically as the threshold drops and more samples are accepted,
    while fpr rises with it.  A leading ``(fpr=0, acc=0)`` point anchors
    the curve at "reject everything".

    Parameters mirror the reference: ``y_true`` are gold labels (strings or
    ints, including ``reject_label`` rows), ``y_pred`` model predictions,
    ``y_score`` acceptance confidences, ``reject_label`` the unanswerable
    marker (``'UQ'`` for RGQA).

    Returns ``(fpr, acc, thresholds)`` with ``thresholds[0]`` set to
    ``max(score) + 1`` (the reject-everything point).
    """
    y_true = np.asarray(y_true).ravel()
    y_pred = np.asarray(y_pred).ravel()
    y_score = np.asarray(y_score, dtype=np.float64).ravel()
    if not (y_true.shape == y_pred.shape == y_score.shape):
        raise ValueError("y_true, y_pred, y_score must have the same length")
    if not np.all(np.isfinite(y_score)):
        raise ValueError("y_score contains non-finite values")
    if reject_label is None:
        raise ValueError("reject_label must be specified")

    weight = (
        np.ones_like(y_score)
        if sample_weight is None
        else np.asarray(sample_weight, dtype=np.float64).ravel()
    )
    if sample_weight is not None:
        nz = weight != 0
        y_true, y_pred, y_score, weight = (
            y_true[nz],
            y_pred[nz],
            y_score[nz],
            weight[nz],
        )

    correct = np.logical_and(y_true != reject_label, y_true == y_pred)
    is_reject = y_true == reject_label

    thresholds, accs, fps = _sweep(y_score, correct * weight, is_reject * weight)

    if drop_intermediate:
        fps, accs, thresholds = _drop_collinear(fps, accs, thresholds)

    # Anchor the curve at (0, 0): threshold above every score.
    accs = np.r_[0.0, accs]
    fps = np.r_[0.0, fps]
    thresholds = np.r_[thresholds[0] + 1, thresholds]

    total_neg = fps[-1]
    if total_neg <= 0:
        warnings.warn("no reject-label samples; fpr is undefined")
        fpr = np.full_like(fps, np.nan)
    else:
        fpr = fps / total_neg

    num_pos = float((y_true != reject_label).sum())
    if num_pos <= 0:
        warnings.warn("no answerable samples; accuracy is undefined")
        acc = np.full_like(accs, np.nan)
    else:
        acc = accs / num_pos

    return fpr, acc, thresholds


def roc_curve(
    y_true: np.ndarray,
    y_score: np.ndarray,
    *,
    drop_intermediate: bool = True,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Binary ROC curve with sklearn threshold semantics.

    ``y_true`` must be in {0, 1} with 1 the positive class.  Returns
    ``(fpr, tpr, thresholds)``; both rates start at 0 with an initial
    ``inf`` threshold.
    """
    y_true = np.asarray(y_true).ravel().astype(np.float64)
    y_score = np.asarray(y_score, dtype=np.float64).ravel()

    thresholds, tps, fps = _sweep(y_score, y_true, 1.0 - y_true)
    if drop_intermediate and len(fps) > 2:
        fps, tps, thresholds = _drop_collinear(fps, tps, thresholds)

    tps = np.r_[0.0, tps]
    fps = np.r_[0.0, fps]
    thresholds = np.r_[np.inf, thresholds]

    fpr = fps / fps[-1] if fps[-1] > 0 else np.full_like(fps, np.nan)
    tpr = tps / tps[-1] if tps[-1] > 0 else np.full_like(tps, np.nan)
    return fpr, tpr, thresholds


def precision_recall_curve(
    y_true: np.ndarray, y_score: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Binary precision-recall curve with sklearn semantics.

    Returns ``(precision, recall, thresholds)`` with recall decreasing
    (thresholds increasing) and a final ``(precision=1, recall=0)`` anchor.
    """
    y_true = np.asarray(y_true).ravel().astype(np.float64)
    y_score = np.asarray(y_score, dtype=np.float64).ravel()

    thresholds, tps, fps = _sweep(y_score, y_true, 1.0 - y_true)

    ps = tps + fps
    precision = np.zeros_like(tps)
    np.divide(tps, ps, out=precision, where=ps != 0)
    if tps[-1] == 0:
        warnings.warn("no positive samples; recall is undefined")
        recall = np.ones_like(tps)
    else:
        recall = tps / tps[-1]

    return (
        np.r_[precision[::-1], 1.0],
        np.r_[recall[::-1], 0.0],
        thresholds[::-1],
    )
