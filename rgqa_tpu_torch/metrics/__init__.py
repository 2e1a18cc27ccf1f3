"""RGQA metrics: a numpy-only copy of the JAX package's ``rgqa_tpu.metrics``.

``curves.py``, ``ood.py`` and ``evaluator.py`` are copies of their
counterparts, kept so that the port imports nothing of the JAX package.
``tests/test_torch_port_rules.py`` holds each copy to its original: equal
metric dicts and byte-equal prediction dumps.
"""

from rgqa_tpu_torch.metrics.curves import (
    accfpr_curve,
    auc,
    precision_recall_curve,
    roc_curve,
)
from rgqa_tpu_torch.metrics.evaluator import (
    ClosedSetEvaluator,
    RGQAEvaluator,
    dump_predictions,
    ood_evaluate,
)
from rgqa_tpu_torch.metrics.ood import (
    accfpr_metrics,
    aupr,
    auroc,
    detection_error,
    f1_binary,
    fpr_at_tpr,
    ood_performance,
)

__all__ = [
    "auc",
    "accfpr_curve",
    "roc_curve",
    "precision_recall_curve",
    "auroc",
    "aupr",
    "fpr_at_tpr",
    "detection_error",
    "ood_performance",
    "accfpr_metrics",
    "f1_binary",
    "RGQAEvaluator",
    "ClosedSetEvaluator",
    "ood_evaluate",
    "dump_predictions",
]
