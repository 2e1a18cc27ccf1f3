"""Standalone RGQA metric CLI (a copy of ``rgqa_tpu/metrics/compute_accfpr.py``).

Drop-in equivalent of the reference ``compute_accfpr/compute_accfpr.py``:
given an RGQA dataset JSON (rows ``{img_id, question_id, sent, label}``) and
a prediction JSON (rows ``{questionId, prediction, confidence}``), print the
full metric dict.

Usage::

    python -m rgqa_tpu_torch.metrics.compute_accfpr DATASET.json PREDICT.json
"""

from __future__ import annotations

import argparse
import json

from rgqa_tpu_torch.metrics.evaluator import ood_evaluate


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("dataset", help="RGQA dataset JSON (gold labels)")
    parser.add_argument("predictions", help="prediction JSON")
    parser.add_argument("--tau", type=float, default=0.5)
    args = parser.parse_args(argv)

    with open(args.dataset) as f:
        rows = json.load(f)
    with open(args.predictions) as f:
        predictions = json.load(f)

    qid2label = {row["question_id"]: row["label"] for row in rows}
    result = ood_evaluate(qid2label, predictions, tau=args.tau)
    # The reference ships two ood_metrics copies that differ: the public
    # CLI's (compute_accfpr/ood_metrics.py:103-114) omits fpr88.9 while the
    # in-repo evaluator's (src/ood_metrics.py:108) includes it.  Match the
    # public CLI contract here.
    result.pop("fpr88.9", None)
    print(result)
    return result


if __name__ == "__main__":
    main()
