"""Prediction and rejection scoring over a split (port of
``rgqa_tpu/eval.py``: ``predict``, ``evaluate``, ``make_scorer``,
``score_split``, ``ood_evaluate``, ``gated_ood_evaluate``,
``ensemble_ood_evaluate``, ``fit_maha_estimator``, ``get_pseudo_labels``
and ``predict_with_thresh``).

``ScoringMixin`` expects the host class to provide ``cfg``, ``device``,
``model``, ``forward``, ``model_cfg``, ``label2ans``, ``train_set``, ``output``,
``_encode`` and ``load``, i.e. :class:`rgqa_tpu_torch.runner.GQARunner`.
The metrics and the prediction-JSON dump are ``rgqa_tpu_torch.metrics``,
the port's copy of the JAX package's.  ``predict`` stands in for the JAX
package's ``train/step.py::make_eval_step`` as well (through
``make_msp_scorer``).

The feed hands every scorer exact f32 RoI feats (the models cast them to
their compute dtype inside the first product).  The JAX feed casts them
to bf16 on the host for a bf16 model unless a scorer carries
``needs_f32_inputs`` (ODIN, Mahalanobis and its fit); the port keeps the
flag on those scorers and never casts.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Iterator, Optional

import numpy as np
import torch

from rgqa_tpu_torch.metrics import ClosedSetEvaluator, RGQAEvaluator, dump_predictions
from rgqa_tpu_torch.data.batching import batch_iterator, device_prefetch
from rgqa_tpu_torch.data.dataset import EncodedGQA, GQADataset
from rgqa_tpu_torch.scorers import (
    apply_tau,
    calibrate_tau,
    ensemble_merge,
    fit_estimator,
    make_msp_scorer,
    make_scorer,
)
from rgqa_tpu_torch.scorers.maha import MahaEstimator, estimator_from_numpy

__all__ = ["ScoringMixin"]


class ScoringMixin:
    """Closed-set prediction, rejection scoring and calibrated-threshold
    evaluation."""

    def _map_eval(
        self, encoded: EncodedGQA, step_fn, select: tuple[str, ...]
    ) -> Iterator[tuple[list, dict, int]]:
        """Run ``step_fn(batch)`` over a split; yield ``(qids, {key:
        numpy array}, real)``.  Outputs are fetched one batch behind the
        dispatch front, so the host's copy of batch i overlaps the
        device's work on batch i+1."""
        batches = device_prefetch(
            batch_iterator(encoded, self.cfg.train.batch_size), self.device
        )
        pending = None
        for qids, batch, real in batches:
            out = step_fn(batch)
            current = (qids, {k: out[k] for k in select}, real)
            if pending is not None:
                yield _fetch(pending)
            pending = current
        if pending is not None:
            yield _fetch(pending)

    def make_scorer(self, name: Optional[str] = None):
        """The configured scorer (``--scorer`` and the ``cfg.ood``
        options), built once per name and runner; ``maha`` fits (or
        reads) its estimator first."""
        ocfg = self.cfg.ood
        name = name or ocfg.scorer or "msp"
        cache = self.__dict__.setdefault("_scorer_cache", {})
        if name not in cache:
            opts = dict(
                temperature=ocfg.temperature,
                noise=ocfg.noise,
                topk=2,
                seed_list=ocfg.seed_list or (0, 1, 2, 3, 4),
                mix=ocfg.mix_branched_score,
            )
            if name == "maha":
                opts["estimator"] = self.fit_maha_estimator()
            cache[name] = make_scorer(name, self.forward, **opts)
        return cache[name]

    def predict(self, encoded: EncodedGQA, dump: Optional[str] = None) -> dict:
        """Closed-set predictions ``{qid: answer}``."""
        quesid2ans = {}
        for qids, out, real in self._map_eval(encoded, self.make_scorer("msp"), ("label",)):
            for qid, label in zip(qids, out["label"][:real]):
                quesid2ans[qid] = self.label2ans[int(label)]
        if dump:
            ClosedSetEvaluator(encoded.dataset.qid2label).dump_result(quesid2ans, dump)
        return quesid2ans

    def evaluate(self, encoded: EncodedGQA) -> float:
        """Closed-set soft accuracy on a labeled split."""
        return ClosedSetEvaluator(encoded.dataset.qid2label).evaluate(self.predict(encoded))

    def score_split(self, encoded: EncodedGQA, scorer=None) -> dict:
        """``{qid: (answer, confidence)}`` over a split."""
        scorer = scorer or self.make_scorer()
        quesid2ans = {}
        for qids, out, real in self._map_eval(encoded, scorer, ("label", "score")):
            for qid, label, score in zip(qids, out["label"][:real], out["score"][:real]):
                quesid2ans[qid] = (self.label2ans[int(label)], float(score))
        return quesid2ans

    def _rejection_results(self, encoded: EncodedGQA, quesid2ans: dict, dump: Optional[str]) -> dict:
        results = RGQAEvaluator(encoded.dataset.qid2label, tau=self.cfg.ood.tau).evaluate_quesid2ans(
            quesid2ans
        )
        if dump:
            dump_predictions(quesid2ans, dump)
        return results

    def ood_evaluate(
        self, encoded: EncodedGQA, dump: Optional[str] = None, scorer=None
    ) -> dict:
        """Rejection evaluation with the configured scorer
        (``gqa_conf.py:297-333``): AUAF / FF95 / FACC and the rest of the
        RGQA metric dict; ``dump`` writes the prediction JSON."""
        return self._rejection_results(encoded, self.score_split(encoded, scorer=scorer), dump)

    def gated_ood_evaluate(self, encoded: EncodedGQA, answerer, dump: Optional[str] = None) -> dict:
        """Separate-detector evaluation (``gqa_separate.py:200-234``):
        this runner's one-logit model scores answerability (its sigmoid);
        ``answerer``, a runner with a GQA model, gives the answers."""
        answers = answerer.predict(answerer._encode(encoded.dataset))
        quesid2ans = {}
        for qids, out, real in self._map_eval(encoded, self.make_scorer("msp"), ("score",)):
            for qid, score in zip(qids, out["score"][:real]):
                quesid2ans[qid] = (answers[qid], float(score))
        return self._rejection_results(encoded, quesid2ans, dump)

    def ensemble_ood_evaluate(
        self, encoded: EncodedGQA, ckpt_paths: list[str], dump: Optional[str] = None,
    ) -> dict:
        """Mean / product ensemble over checkpoints (``gqa_ensemble.py``;
        ``--ensemble_method``): each ``.pth`` is loaded into this runner's
        model in turn and scored with MSP; the sigmoid vectors merge on
        the host's copy."""
        msp = make_msp_scorer(self.forward)
        all_qids: list[str] = []
        prob_sets = []
        for path in ckpt_paths:
            self.load(path)
            probs, qids_seen = [], []
            for qids, out, real in self._map_eval(encoded, msp, ("probs",)):
                probs.append(out["probs"][:real])
                qids_seen.extend(qids[:real])
            prob_sets.append(np.concatenate(probs, 0))
            all_qids = qids_seen
        merged = ensemble_merge(
            [torch.from_numpy(p) for p in prob_sets], self.cfg.ood.ensemble_method
        )
        quesid2ans = {
            qid: (self.label2ans[int(label)], float(score))
            for qid, label, score in zip(all_qids, merged["label"].numpy(), merged["score"].numpy())
        }
        return self._rejection_results(encoded, quesid2ans, dump)

    def fit_maha_estimator(self) -> MahaEstimator:
        """Per-class means and the shared precision over the train split
        (``gqa_maha.py:120-189``; an evaluation runner encodes it here),
        cached in ``<output>/sample_estimates.pkl``
        as the JAX package writes it (numpy ``{"mean", "precision"}``), so
        a cache from either package loads in the other.  The pooled
        features come from deterministic forwards (eval mode) on exact
        f32 feats and f32 weights (under bf16 compute a runner built with
        ``f32_weights=True`` keeps them, as the JAX evaluate CLI's
        training runner does): every later run reads the cache, so a fit
        from bf16 serving weights is refused."""
        cache = os.path.join(self.output, "sample_estimates.pkl")
        if os.path.exists(cache):
            with open(cache, "rb") as f:
                data = pickle.load(f)
            return estimator_from_numpy(data["mean"], data["precision"], self.device)
        dtypes = {p.dtype for p in self.model.parameters()}
        if dtypes != {torch.float32}:
            raise RuntimeError(
                f"the Mahalanobis fit is cached for later runs and needs f32 weights, this model's "
                f"are {sorted(map(str, dtypes))}: build the runner with f32_weights=True (bf16 "
                "compute on f32 weights), as the evaluate CLI does for --scorer maha"
            )
        train_set = self.train_set
        if train_set is None:  # an evaluation runner encodes the split for the fit alone
            data = self.cfg.data
            train_set = self._encode(GQADataset(data.data_root, data.train_splits, add_uq=True))

        def batches():
            # Pooled features and targets stay on the device: the fit's
            # sums run behind the forwards, with no sync until its end.
            items = batch_iterator(train_set, self.cfg.train.batch_size, with_target=True)
            for _, batch, real in device_prefetch(items, self.device):
                with torch.no_grad():
                    pooled = self.forward(batch, deterministic=True)["pooled"]
                yield pooled[:real], batch["target"][:real]

        est = fit_estimator(
            batches(), num_classes=self.model_cfg.num_answers,
            feat_dim=self.model_cfg.encoder.hidden_size, device=self.device,
        )
        with open(cache, "wb") as f:
            pickle.dump(
                {"mean": est.class_mean.cpu().numpy(), "precision": est.precision.cpu().numpy()},
                f, protocol=pickle.HIGHEST_PROTOCOL,
            )
        return est

    def get_pseudo_labels(self, encoded: EncodedGQA, dump: Optional[str] = None) -> list[dict]:
        """Teacher-label a split: each row's label becomes the scorer's
        answer with its confidence (``gqa_conf.py:335-353``)."""
        quesid2ans = self.score_split(encoded)
        rows = []
        for qid in encoded.question_ids:
            datum = dict(encoded.dataset.id2datum[qid])
            ans, score = quesid2ans[qid]
            datum["label"] = {ans: float(score)}
            rows.append(datum)
        if dump:
            with open(dump, "w") as f:
                json.dump(rows, f)
            print(f"{len(rows)} pseudo data have been saved in {dump}.")
        return rows

    def predict_with_thresh(self, encoded: EncodedGQA, dump: Optional[str] = None) -> dict:
        """Calibrate tau at ``--target_acc`` on a labeled split, then
        threshold (``gqa_conf.py:262-295``).  The dump holds ``{qid:
        [answer, confidence]}`` at full precision, as the reference
        writes it; the JAX package rounds it to 4 dp, a fault the port
        does not copy."""
        if self.cfg.ood.target_acc is None:
            raise ValueError("predict_with_thresh needs --target_acc")
        quesid2ans = self.score_split(encoded)
        targets, preds, scores = [], [], []
        for qid, (ans, score) in quesid2ans.items():
            label = encoded.dataset.id2datum[qid].get("label") or {}
            targets.append(next(iter(label), "UQ"))
            preds.append(ans)
            scores.append(score)
        tau = calibrate_tau(targets, preds, scores, self.cfg.ood.target_acc)
        out = apply_tau(quesid2ans, tau)
        if dump:
            with open(dump, "w") as f:
                json.dump({q: [ans, float(score)] for q, (ans, score) in out.items()}, f)
        return {"tau": tau, "quesid2ans": out}


def _fetch(item):
    qids, out, real = item
    return qids, {k: v.cpu().numpy() for k, v in out.items()}, real
