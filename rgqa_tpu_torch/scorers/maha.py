"""Mahalanobis rejection scorer: estimator and scorer (port of
``rgqa_tpu/scorers/maha.py``).

- :func:`fit_estimator`: per-class feature means and one shared
  precision.  One streaming pass accumulates per-class sums, counts and
  one second-moment matrix on the device in f32 (with TF32 off: the
  matrix is inverted); the covariance and its ``pinvh`` are computed on
  the host in the JAX package's numpy dtypes and order.
- :func:`make_maha_scorer`: per-class Gaussian scores of the pooled
  feature, with an optional input perturbation against the top-class
  Gaussian loss (``torch.autograd.grad`` with respect to the RoI feats
  and boxes, as ODIN), then a rescore.

The products here are plain ``torch.matmul``: the JAX package computes
them outside any Pallas kernel too.
"""

from __future__ import annotations

from typing import Callable, Iterable, NamedTuple, Optional

import numpy as np
import torch

from rgqa_tpu_torch.device import exact_f32
from rgqa_tpu_torch.scorers.core import roi_input_grad, require_roi_inputs, sign01

__all__ = [
    "MahaEstimator",
    "accumulate_moments",
    "estimator_from_moments",
    "estimator_from_numpy",
    "fit_estimator",
    "make_maha_scorer",
]


class MahaEstimator(NamedTuple):
    class_mean: torch.Tensor  # (C, D) f32
    precision: torch.Tensor  # (D, D) f32


def accumulate_moments(
    feature_batches: Iterable[tuple[torch.Tensor, torch.Tensor]],
    num_classes: int,
    feat_dim: int,
    *,
    device: Optional[torch.device | str] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fit's pass over the data, on the device in f32: per-class
    feature sums (C, D), class counts (C,) and the multiplicity-weighted
    second moment (D, D).  ``targets`` are the multi-hot answer matrices
    (the UQ column dropped); a feature counts for class c wherever
    ``target[:, c] > 0``, as the reference's row replication
    (``gqa_maha.py:155-168``).  Batches are tensors or arrays;
    ``device`` defaults to the first batch's."""
    sums = counts = second = None
    with exact_f32():
        for feats, targets in feature_batches:
            f = torch.as_tensor(feats, device=device).to(torch.float32)
            t = (torch.as_tensor(targets, device=f.device) > 0).to(torch.float32)  # (B, C)
            if sums is None:
                sums = torch.zeros((num_classes, feat_dim), dtype=torch.float32, device=f.device)
                counts = torch.zeros((num_classes,), dtype=torch.float32, device=f.device)
                second = torch.zeros((feat_dim, feat_dim), dtype=torch.float32, device=f.device)
            sums += t.T @ f
            counts += t.sum(dim=0)
            w = t.sum(dim=1)  # each row's total class multiplicity
            second += (f * w[:, None]).T @ f
    if sums is None:
        raise ValueError("fit_estimator got no batches")
    return sums, counts, second


def estimator_from_moments(sums: torch.Tensor, counts: torch.Tensor, second: torch.Tensor) -> MahaEstimator:
    """Class means and the shared precision from the accumulated moments,
    on the host in the JAX package's numpy dtypes and order.  The
    covariance is sklearn ``EmpiricalCovariance``'s (MLE, denominator N)
    over the per-class-centred features:
    ``(1/N) (sum_ic w_ic f_i f_i^T - sum_c n_c mu_c mu_c^T)``."""
    counts_np = counts.cpu().numpy()
    n_total = float(counts_np.sum())
    safe = np.maximum(counts_np, 1.0)
    mean = sums.cpu().numpy() / safe[:, None]
    cov = (second.cpu().numpy() - (counts_np[:, None] * mean).T @ mean) / max(n_total, 1.0)
    try:
        from scipy.linalg import pinvh

        precision = pinvh(cov)
    except ImportError:
        precision = np.linalg.pinv(cov, hermitian=True)
    return estimator_from_numpy(mean, precision, sums.device)


def fit_estimator(
    feature_batches: Iterable[tuple[torch.Tensor, torch.Tensor]],
    num_classes: int,
    feat_dim: int,
    *,
    device: Optional[torch.device | str] = None,
) -> MahaEstimator:
    """Per-class means and the shared precision from ``(features,
    targets)`` batches: :func:`accumulate_moments` on the device, then
    :func:`estimator_from_moments` on the host."""
    return estimator_from_moments(
        *accumulate_moments(feature_batches, num_classes, feat_dim, device=device)
    )


def estimator_from_numpy(mean, precision, device) -> MahaEstimator:
    """A :class:`MahaEstimator` of f32 tensors on ``device`` from numpy
    arrays (the ``sample_estimates.pkl`` layout)."""
    return MahaEstimator(
        torch.from_numpy(np.array(mean, np.float32)).to(device),
        torch.from_numpy(np.array(precision, np.float32)).to(device),
    )


def _gaussian_scores(outputs: torch.Tensor, mean: torch.Tensor, precision: torch.Tensor) -> torch.Tensor:
    """(B, C) scores ``-0.5 (f - mu_c)^T P (f - mu_c)`` in the expanded
    form ``fPf - 2 fP mu + mu P mu``, with features and means centred on
    the mean of the class means first: uncentred, the three terms dwarf
    their difference and f32 cancels (``rgqa_tpu/scorers/maha.py:87``)."""
    mu_bar = mean.mean(dim=0)
    f = outputs - mu_bar[None, :]
    m = mean - mu_bar[None, :]
    fp = f @ precision
    quad_f = (fp * f).sum(dim=-1)
    cross = fp @ m.T
    quad_m = ((m @ precision) * m).sum(dim=-1)
    return -0.5 * (quad_f[:, None] - 2.0 * cross + quad_m[None, :])


def make_maha_scorer(forward, estimator: MahaEstimator, *, noise: float = 0.0) -> Callable[[dict], dict]:
    """Mahalanobis scorer (``gqa_maha.py:191-274``): label and score are
    the argmax and max of the per-class Gaussian scores of the pooled
    feature; with ``noise`` the RoI inputs first move by ``-noise *
    sign01(g)``, g the gradient of the mean top-class Gaussian loss."""
    mean, precision = estimator.class_mean, estimator.precision

    def top_gaussian_loss(feats, boxes, batch):
        out = forward(dict(batch, feats=feats, boxes=boxes), deterministic=True)
        pooled = out["pooled"].to(torch.float32)
        scores = _gaussian_scores(pooled, mean, precision)
        pred = torch.argmax(scores.detach(), dim=-1)
        zero_f = pooled - mean[pred]
        pure_gau = -0.5 * ((zero_f @ precision) * zero_f).sum(dim=-1)
        return (-pure_gau).mean()

    def score_fn(batch: dict) -> dict:
        require_roi_inputs(batch, "maha")
        with exact_f32():
            feats = batch["feats"].to(torch.float32)
            boxes = batch["boxes"].to(torch.float32)
            if noise:
                feats, boxes, g_feats, g_boxes = roi_input_grad(
                    lambda f, b: top_gaussian_loss(f, b, batch), batch
                )
                feats = feats - noise * sign01(g_feats)
                boxes = boxes - noise * sign01(g_boxes)
            with torch.no_grad():
                out = forward(dict(batch, feats=feats, boxes=boxes), deterministic=True)
                scores = _gaussian_scores(out["pooled"].to(torch.float32), mean, precision)
                return {"label": torch.argmax(scores, dim=-1), "score": torch.amax(scores, dim=-1)}

    score_fn.needs_f32_inputs = True
    return score_fn
