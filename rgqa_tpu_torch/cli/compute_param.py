"""Trainable-parameter counter (port of ``rgqa_tpu/cli/compute_param.py``;
reference ``src/compute_param.py:38-61``).

Usage: ``python -m rgqa_tpu_torch.cli.compute_param [backbone ...]``
Prints the parameter count per backbone (default: every one) at RGQA
shapes, ``ModelConfig(backbone=...)``'s defaults.  The models are built
on the ``meta`` device: shapes only, nothing allocated, no card needed.
Launched as N ranks (``torchrun``), rank 0 alone counts and prints; the
others return an empty dict.
"""

from __future__ import annotations

import os
import sys

from rgqa_tpu_torch.config import ModelConfig
from rgqa_tpu_torch.models.zoo import build_model

BACKBONES = ("butd", "caps", "lxmert", "uniter", "vilt")


def count_params(backbone: str) -> int:
    model, _ = build_model(ModelConfig(backbone=backbone), device="meta")
    return sum(p.numel() for p in model.parameters() if p.requires_grad)


def main(argv=None) -> dict:
    names = list(sys.argv[1:] if argv is None else argv) or list(BACKBONES)
    counts = {}
    if int(os.environ.get("RANK", "0") or 0) > 0:
        return counts
    for name in names:
        counts[name] = count_params(name)
        print(f"{name}: {counts[name]:,} trainable parameters")
    return counts


if __name__ == "__main__":
    main()
