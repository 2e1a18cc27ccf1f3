"""One training step of each of the train CLI's strategies that take their
own step: ``adv`` (VILLA), ``resampling`` / ``woods`` (the dual-loader
min-max; ``poem`` is ``resampling``'s step), ``distill_online``,
``weight`` (CLIP-weighted RP) and ``weight_model`` (``weight
--update_weight_model``: the joint step that trains CLIP beside the
answerer), on device batches the caller gives, for
``tools/profile_forward.py --train --strategy`` and ``chip_smoke.py``.

:func:`strategy_inputs` turns a list of batches into each step's
arguments, with every host draw made up front from a seeded numpy
generator (the negatives' rows, the distillation's mixup draws, the
weighted pairs' roll and weights), so two runs of the same inputs (the
kernels and the plain versions) take the same steps.
:func:`make_strategy_step` builds ``step(*args) -> aux``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from rgqa_tpu_torch.ops.dropout import DropoutRng
from rgqa_tpu_torch.train.adversarial import AdvConfig, make_adv_train_step
from rgqa_tpu_torch.train.dual_loader import NegativeWeights, make_minmax_step
from rgqa_tpu_torch.train.online_distill import make_online_distill_step
from rgqa_tpu_torch.train.optimizer import OptaxAdam
from rgqa_tpu_torch.train.step import draw_mixup, make_train_step, make_weighted_clip_train_step

__all__ = ["STRATEGIES", "N_NEGATIVES", "strategy_inputs", "make_strategy_step", "with_clip_inputs"]

# The steps that need only the answerer's model; ``weight_model`` also
# takes a CLIP model (``make_strategy_step(..., clip_model=)``).
STRATEGIES = ("adv", "resampling", "woods", "distill_online", "weight")
# The negative set the min-max steps weight (the synthetic root's hard
# split is 384 rows; the reference's, GQA's unanswerable train questions).
N_NEGATIVES = 1024


def strategy_inputs(name: str, batches: list, seed: int = 0) -> list:
    """Each step's arguments for ``name`` over ``batches`` (dicts of
    device tensors with ``target`` and ``id_mask``): ``adv`` ``(batch,)``;
    the min-max steps ``(pos, neg, wids)``, the next batch as the
    negatives and ``wids`` their rows among ``N_NEGATIVES``;
    ``distill_online`` ``(batch, draws)``, ``mixup_v1``'s host draws at
    Beta(1, 1) (the script's defaults); ``weight`` ``(batch, shift,
    neg_weights)``, the roll in [1, B) and normalized weights
    ``exp(s - max s)`` of standard-normal similarities; ``weight_model``
    ``(batch, shift)``, each batch carrying its CLIP inputs
    (:func:`with_clip_inputs`)."""
    rng = np.random.default_rng(seed)
    host = torch.Generator().manual_seed(seed)
    out = []
    for i, batch in enumerate(batches):
        b = batch["target"].shape[0]
        dev = batch["target"].device
        if name == "adv":
            out.append((batch,))
        elif name in ("resampling", "woods"):
            wids = torch.from_numpy(rng.choice(N_NEGATIVES, b, replace=True)).to(dev)
            out.append((batch, batches[(i + 1) % len(batches)], wids))
        elif name == "distill_online":
            out.append((batch, draw_mixup(batch, "mixup_v1", 1.0, 1.0, host)))
        elif name == "weight":
            sims = rng.standard_normal(b).astype(np.float32)
            w = np.exp(sims - sims.max())
            out.append((batch, int(rng.integers(1, b)), torch.from_numpy((w / w.sum()).astype(np.float32)).to(dev)))
        elif name == "weight_model":
            out.append((batch, int(rng.integers(1, b))))
        else:
            raise ValueError(f"unknown strategy {name!r}; have {STRATEGIES} and weight_model")
    return out


def with_clip_inputs(batch: dict, clip_cfg, seed: int = 0) -> dict:
    """``batch`` with the joint step's CLIP inputs at ``clip_cfg``'s shapes
    (:func:`rgqa_tpu_torch.models.clip.example_inputs`): ``clip_ids`` /
    ``clip_mask`` and uint8 ``clip_pixels``, on the batch's device."""
    from rgqa_tpu_torch.models.clip import example_inputs

    dev = batch["target"].device
    ids, mask, pixels = example_inputs(clip_cfg, batch["target"].shape[0], seed=seed)
    return dict(batch, **{k: torch.from_numpy(v).to(dev) for k, v in
                          (("clip_ids", ids), ("clip_mask", mask), ("clip_pixels", pixels))})


def make_strategy_step(
    name: str, forward: Callable, optimizer: torch.optim.Optimizer, *, rng: DropoutRng,
    use_fused: Optional[bool] = None, teacher_forward: Optional[Callable] = None, hidden: int = 768,
    clip_model=None,
) -> Callable:
    """``step(*args) -> aux`` of ``name`` with the runner's settings (the
    scripts' flags: VILLA's 3 inner passes at lr 1e-3, KL weight 1.5;
    ``--lr_w`` 0.1; ``--lam`` 0.5 and ``mixup_v1``), ``args`` one of
    :func:`strategy_inputs`' tuples.  The min-max steps keep their
    negative weights and apply their gradients; ``distill_online`` needs
    ``teacher_forward``, ``weight_model`` ``clip_model`` (a
    :class:`~rgqa_tpu_torch.models.clip.ClipModel`, trained by a fresh
    :class:`OptaxAdam` at 1e-5, as the runner's)."""
    if name == "adv":
        return make_adv_train_step(forward, optimizer, lambda b: (*b["input_ids"].shape, hidden), AdvConfig(),
                                   rng=rng, use_fused=use_fused)
    if name in ("resampling", "woods"):
        weighted = name != "woods"
        inner = make_minmax_step(forward, optimizer, weighted=weighted, rng=rng, use_fused=use_fused)
        device = next(p for g in optimizer.param_groups for p in g["params"]).device
        weights = NegativeWeights(N_NEGATIVES, 0.1, device=device)

        def minmax(pos, neg, wids):
            w_grads, aux = inner(weights.values, pos, neg, wids)
            if weighted:
                weights.apply(w_grads)
            return aux

        return minmax
    if name == "distill_online":
        return make_online_distill_step(forward, teacher_forward, optimizer, lam=0.5, mixup_mode="mixup_v1",
                                        rng=rng, use_fused=use_fused)
    if name == "weight":
        inner = make_train_step(forward, optimizer, weighted_rp=True, rng=rng, use_fused=use_fused)
        return lambda batch, shift, neg_weights: inner(batch, shift=shift, neg_weights=neg_weights)
    if name == "weight_model":
        return make_weighted_clip_train_step(forward, clip_model, optimizer, OptaxAdam(clip_model.parameters(), 1e-5),
                                             rng=rng, use_fused=use_fused)
    raise ValueError(f"unknown strategy {name!r}; have {STRATEGIES} and weight_model")
