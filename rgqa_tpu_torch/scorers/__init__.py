"""Rejection scorer registry (port of ``rgqa_tpu/scorers/__init__.py``).

Every scorer is ``score_fn(batch) -> {"label", "score"[, "probs"]}``
built from a backbone's forward adapter: msp, energy, odin, dropout
(MC-dropout), branched and maha; ``ensemble_merge`` merges per-model
sigmoid vectors, and ``calibrate_tau`` / ``apply_tau`` set the
``--target_acc`` threshold.  ``make_match_scorer`` (the LXMERT match
scorer, from a pretraining model's forward) and ``scorers.clip``
(``ClipScorer``, the CLIP image-question cosine) back the evaluate CLI's
``--scorer match`` and ``clip``, and ``coverage_scores`` /
``load_object_vocab`` (the FRCNN object-coverage scorer, host-side, on
the port's Porter stemmer) back ``--scorer frcnn``; ``make_scorer``
builds none of these three, as in the JAX package.
"""

from rgqa_tpu_torch.parallel.mesh import SINGLE
from rgqa_tpu_torch.scorers.calibrate import apply_tau, calibrate_tau
from rgqa_tpu_torch.scorers.core import (
    ensemble_merge,
    majority_vote,
    make_branched_scorer,
    make_dropout_scorer,
    make_match_scorer,
    make_energy_scorer,
    make_msp_scorer,
    make_odin_scorer,
)
from rgqa_tpu_torch.scorers.coverage import coverage_scores, load_object_vocab, noun_tokens
from rgqa_tpu_torch.scorers.maha import MahaEstimator, fit_estimator, make_maha_scorer

__all__ = [
    "make_msp_scorer",
    "make_energy_scorer",
    "make_odin_scorer",
    "make_dropout_scorer",
    "make_branched_scorer",
    "make_match_scorer",
    "majority_vote",
    "ensemble_merge",
    "MahaEstimator",
    "fit_estimator",
    "make_maha_scorer",
    "calibrate_tau",
    "apply_tau",
    "coverage_scores",
    "load_object_vocab",
    "noun_tokens",
    "make_scorer",
]


def make_scorer(name: str, forward, **opts):
    """Build a scorer by name (the ``--scorer`` flag), with the JAX
    package's defaults: topk 2, temperature 1e5, noise 1e-4, seed list
    (0, 1, 2, 3, 4); ``maha`` needs ``estimator``; ``mesh`` gives
    MC-dropout a data-parallel rank's streams."""
    name = name.lower()
    if name == "msp":
        return make_msp_scorer(forward)
    if name == "energy":
        return make_energy_scorer(forward, topk=opts.get("topk", 2))
    if name == "odin":
        return make_odin_scorer(
            forward, temperature=opts.get("temperature", 1e5), noise=opts.get("noise", 1e-4)
        )
    if name == "dropout":
        return make_dropout_scorer(forward, opts.get("seed_list", (0, 1, 2, 3, 4)), mesh=opts.get("mesh", SINGLE))
    if name == "branched":
        return make_branched_scorer(forward, mix=opts.get("mix", False))
    if name == "maha":
        return make_maha_scorer(forward, opts["estimator"], noise=opts.get("noise", 0.0))
    raise ValueError(f"unknown scorer {name!r}")
