"""Rejection scorers (port of ``rgqa_tpu/scorers/core.py``; msp so far).

A scorer is a factory taking the backbone's ``forward`` adapter and
returning ``score_fn(batch) -> {"label", "score", "probs"}`` of tensors
on the batch's device.  Energy, ODIN, MC-dropout, branched and ensemble
scoring are not ported yet.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["make_msp_scorer"]


def make_msp_scorer(forward) -> Callable[[dict], dict]:
    """Max sigmoid probability: label = argmax, score = max of
    ``sigmoid(logits.float())``."""

    def score_fn(batch: dict) -> dict:
        with torch.inference_mode():
            logits = forward(batch)["logits"].to(torch.float32)
            if logits.dim() == 1:  # single-logit heads
                logits = logits[:, None]
            probs = torch.sigmoid(logits)
            return {
                "label": torch.argmax(probs, dim=-1),
                "score": torch.amax(probs, dim=-1),
                "probs": probs,
            }

    return score_fn
