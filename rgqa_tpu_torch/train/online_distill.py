"""Online distillation (port of ``rgqa_tpu/train/online_distill.py``;
reference ``src/tasks/gqa_distill_online.py``).

A student trains on mixup / weighted-sum pseudo rows whose targets are
blended with a frozen teacher's sigmoid predictions:

    outdom = rows with target mass < 1 (the appended pseudo rows)
    target[outdom] = lam * sigmoid(teacher(x)) + (1 - lam) * target[outdom]
    loss = BCE(student(x), target) * K      (``:208-216``)

The augmentation is the train step's: :func:`~rgqa_tpu_torch.train.step.
draw_mixup` on the host, :func:`~rgqa_tpu_torch.train.step.mixup_apply`
on the batch's device.  The teacher's forward runs in eval mode without
gradients (on the card through #1), the student's in training mode
(#4 / #5 at a nonzero dropout).

Data parallel (``mesh``): the draws are the global batch's, each rank
applies its rows (the partner roll crosses ranks), and the student's
gradient is averaged over the ranks before the clip.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

from rgqa_tpu_torch.ops.dropout import DropoutRng
from rgqa_tpu_torch.parallel.mesh import SINGLE, Mesh, reduce_gradients
from rgqa_tpu_torch.train.losses import optax_sigmoid_bce

__all__ = ["blend_targets", "make_online_distill_step"]


def blend_targets(target: torch.Tensor, teacher_logits: torch.Tensor, lam: float) -> torch.Tensor:
    """The rows whose target mass is below 1 take ``lam x sigmoid(teacher)
    + (1 - lam) x target``; the others keep their target."""
    outdom = (torch.sum(target, dim=-1) < 1.0)[:, None]
    soft = torch.sigmoid(teacher_logits.float())
    return torch.where(outdom, lam * soft + (1.0 - lam) * target, target)


def make_online_distill_step(
    student_forward: Callable,
    teacher_forward: Callable,
    optimizer: torch.optim.Optimizer,
    *,
    lam: float = 0.5,
    mixup_mode: Optional[str] = "mixup_v1",
    mixup_alpha: float = 1.0,
    mixup_beta: float = 1.0,
    lam1: float = 0.5,
    lam2: float = 0.05,
    grad_clip: float = 5.0,
    rng: Optional[DropoutRng] = None,
    use_fused: Optional[bool] = None,
    mesh: Mesh = SINGLE,
):
    """``step(batch, draws=None) -> {"loss", "score", "label"}`` for a
    student in training mode whose parameters ``optimizer`` holds (JAX
    ``make_online_distill_step``).  ``draws`` overrides the host's
    :func:`draw_mixup` draws (the tests hand it JAX's); ``mixup_mode``
    None or ``"none"`` trains on the batch as it is.  ``mesh``: data
    parallel, ``batch`` this rank's rows, ``draws`` the global batch's."""
    from rgqa_tpu_torch.train.step import draw_mixup, global_norm_clip, local_draws, mixup_apply

    rng = rng or DropoutRng()
    params = [p for group in optimizer.param_groups for p in group["params"]]
    precision = getattr(student_forward, "precision", contextlib.nullcontext)
    mixing = bool(mixup_mode) and mixup_mode != "none"

    def step(batch: dict, draws: Optional[dict] = None) -> dict:
        if mixing:
            if draws is None:
                rows = batch["input_ids"].shape[0] * mesh.world
                draws = draw_mixup(batch, mixup_mode, mixup_alpha, mixup_beta, rng.host, rows=rows)
            batch = mixup_apply(batch, local_draws(draws, mesh), mixup_mode, lam1=lam1, lam2=lam2, mesh=mesh)
        with torch.no_grad():
            teacher_logits = teacher_forward(batch, deterministic=True, use_fused=use_fused)["logits"]
        target = blend_targets(batch["target"], teacher_logits, lam)
        with precision():
            logits = student_forward(batch, rng=rng, use_fused=use_fused)["logits"].float()
            loss = torch.mean(optax_sigmoid_bce(logits, target)) * logits.shape[-1]
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
        (loss,) = reduce_gradients(mesh, params, [loss])
        if grad_clip and grad_clip > 0:
            global_norm_clip(params, grad_clip)
        optimizer.step()
        probs = torch.sigmoid(logits.detach())
        return {"loss": loss, "score": torch.amax(probs, dim=-1), "label": torch.argmax(probs, dim=-1)}

    return step
