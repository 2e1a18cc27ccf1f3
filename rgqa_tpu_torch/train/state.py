"""Checkpoints of a training run (the port's stand-in for
``rgqa_tpu/checkpoint/orbax_io.py``).

- ``<name>.pth``: the weights in the reference GQA ``.pth`` format
  (``lxrt_encoder.model.bert.*`` + ``logit_fc.*``), which the port's
  ``--load`` and the JAX package's ``import_lxmert_gqa`` both read.
- ``<name>.state.pt``: beside it, what a resume needs besides the
  weights: the optimizer state (moments and step count), the step, and
  the generator states.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from rgqa_tpu_torch.checkpoint.convert import to_reference_state_dict
from rgqa_tpu_torch.config import EncoderConfig

__all__ = ["save_reference_pth", "save_train_state", "load_train_state"]


def save_reference_pth(model: nn.Module, enc: EncoderConfig, path: str) -> str:
    """Write the model's weights as a reference GQA ``.pth``."""
    sd = to_reference_state_dict(
        model.state_dict(), l_layers=enc.l_layers, x_layers=enc.x_layers, r_layers=enc.r_layers
    )
    torch.save(sd, path)
    return path


def save_train_state(path: str, *, optimizer, step: int, rng_state: dict,
                     shuffle: np.random.Generator) -> str:
    torch.save(
        {
            "optimizer": optimizer.state_dict(),
            "step": int(step),
            "rng": rng_state,
            "shuffle": shuffle.bit_generator.state,
        },
        path,
    )
    return path


def load_train_state(path: str) -> dict:
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no training state at {path!r} to resume from")
    return torch.load(path, map_location="cpu", weights_only=True)
