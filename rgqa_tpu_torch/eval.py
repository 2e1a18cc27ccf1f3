"""Prediction and rejection scoring over a split (port of
``rgqa_tpu/eval.py``: ``predict``, ``evaluate``, ``score_split``,
``ood_evaluate``).

``ScoringMixin`` expects the host class to provide ``cfg``, ``device``,
``forward`` and ``label2ans``, i.e. :class:`rgqa_tpu_torch.runner.GQARunner`.
The metrics and the prediction-JSON dump are ``rgqa_tpu_torch.metrics``,
the port's copy of the JAX package's.
"""

from __future__ import annotations

from typing import Iterator, Optional

from rgqa_tpu_torch.metrics import ClosedSetEvaluator, RGQAEvaluator, dump_predictions
from rgqa_tpu_torch.data.batching import batch_iterator, device_prefetch
from rgqa_tpu_torch.data.dataset import EncodedGQA
from rgqa_tpu_torch.scorers.core import make_msp_scorer

__all__ = ["ScoringMixin"]


class ScoringMixin:
    """Closed-set prediction and rejection evaluation."""

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
        name = name or self.cfg.ood.scorer or "msp"
        if name != "msp":
            raise NotImplementedError(
                f"scorer {name!r} is not ported yet; the port has msp"
            )
        return make_msp_scorer(self.forward)

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

    def ood_evaluate(
        self, encoded: EncodedGQA, dump: Optional[str] = None, scorer=None
    ) -> dict:
        """Rejection evaluation: AUAF / FF95 / FACC and the rest of the
        RGQA metric dict; ``dump`` writes the prediction JSON."""
        quesid2ans = self.score_split(encoded, scorer=scorer)
        evaluator = RGQAEvaluator(encoded.dataset.qid2label, tau=self.cfg.ood.tau)
        results = evaluator.evaluate_quesid2ans(quesid2ans)
        if dump:
            dump_predictions(quesid2ans, dump)
        return results


def _fetch(item):
    qids, out, real = item
    return qids, {k: v.cpu().numpy() for k, v in out.items()}, real
