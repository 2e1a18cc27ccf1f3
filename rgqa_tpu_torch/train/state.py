"""Checkpoints of a training run (the port's stand-in for
``rgqa_tpu/checkpoint/orbax_io.py``).

- ``<name>.pth``: the weights in the reference GQA ``.pth`` format
  (GQA-LXMERT's ``lxrt_encoder.model.bert.*`` + ``logit_fc.*``,
  GQA-UNITER's ``encoder.model.uniter.*`` + ``logit_fc.*``, GQAViLT's
  ``transformer.*`` ... with fused ``attn.qkv``, GQA-BUTD's
  ``w_emb.emb.weight``, ``q_enc.rnn.*_l0`` and ``weight_g`` /
  ``weight_v`` pairs, or the trained GQABERT matcher's ``encoder.*`` +
  ``logit_fc.*``), which the port's ``--load`` and the JAX package's
  ``import_lxmert_gqa`` / ``import_uniter_gqa`` / ``import_vilt_gqa`` /
  ``import_butd_gqa`` / ``import_bert_caps`` read.
- ``<name>.state.pt``: beside it, what a resume needs besides the
  weights: the optimizer state (moments and step count), the step, and
  the generator states.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from rgqa_tpu_torch.checkpoint.convert import to_reference_state_dict
from rgqa_tpu_torch.config import ModelConfig

__all__ = ["save_reference_pth", "save_train_state", "load_train_state"]


def save_reference_pth(model: nn.Module, cfg: ModelConfig, path: str) -> str:
    """Write the weights of a model built from ``cfg`` (its backbone and
    depths) as a reference GQA ``.pth``."""
    enc = cfg.encoder
    sd = to_reference_state_dict(
        model.state_dict(), backbone=cfg.backbone, l_layers=enc.l_layers,
        x_layers=enc.x_layers, r_layers=enc.r_layers, num_layers=enc.num_layers,
    )
    torch.save(sd, path)
    return path


def save_train_state(path: str, *, optimizer, step: int, rng_state: dict,
                     shuffle: np.random.Generator, rng_ranks: Optional[list] = None) -> str:
    """``rng_ranks``: every rank's generator states, under several ranks."""
    state = {
        "optimizer": optimizer.state_dict(),
        "step": int(step),
        "rng": rng_state,
        "shuffle": shuffle.bit_generator.state,
    }
    if rng_ranks is not None:
        state["rng_ranks"] = rng_ranks
    torch.save(state, path)
    return path


def load_train_state(path: str) -> dict:
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no training state at {path!r} to resume from")
    return torch.load(path, map_location="cpu", weights_only=True)
