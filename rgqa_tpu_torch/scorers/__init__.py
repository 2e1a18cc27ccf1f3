"""Rejection scorers (msp so far)."""

from rgqa_tpu_torch.scorers.core import make_msp_scorer

__all__ = ["make_msp_scorer"]
