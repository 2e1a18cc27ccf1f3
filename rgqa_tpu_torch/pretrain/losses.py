"""Multi-task pretraining losses (port of ``rgqa_tpu/pretrain/losses.py``;
reference ``modeling.py:922-989``).

Every loss reads f32 logits: the masked-LM log-softmax over the 30522
words is taken in f32, as the JAX package casts before it.

Data parallel (``mesh``): :func:`masked_ce` divides by the global batch's
count of valid labels and scales the rank's sum by the world size, so
that the ranks' mean is the global loss and their averaged gradient the
global loss's; the visual losses are means over every RoI already.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rgqa_tpu_torch.parallel.mesh import SINGLE, Mesh, all_sum

__all__ = ["VISUAL_LOSS_CONFIG", "pretrain_loss", "masked_ce", "smooth_l1"]

# key -> (loss kind, weight): the reference VisualConfig.visual_loss_config
# (modeling.py:158-162), weight 1 / 0.15 for all three.
VISUAL_LOSS_CONFIG = {
    "obj": ("ce", 1 / 0.15),
    "attr": ("ce", 1 / 0.15),
    "feat": ("l2", 1 / 0.15),
}


def masked_ce(logits: torch.Tensor, labels: torch.Tensor, mesh: Mesh = SINGLE) -> torch.Tensor:
    """CrossEntropy(ignore_index=-1): the summed NLL of the valid entries
    over ``max(n_valid, 1)`` (``n_valid`` the global batch's under several
    ranks)."""
    flat = logits.reshape(-1, logits.shape[-1]).float()
    labels = labels.reshape(-1).long()
    nll = F.cross_entropy(flat, labels, ignore_index=-1, reduction="sum")
    return nll * mesh.world / torch.clamp(all_sum(mesh, (labels >= 0).sum()), min=1)


def smooth_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Element-wise SmoothL1, beta 1."""
    return F.smooth_l1_loss(pred, target, reduction="none", beta=1.0)


def _per_roi_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(B, K) CE, no ignore index (labels clamped at 0, as in JAX)."""
    b, k, c = logits.shape
    ce = F.cross_entropy(logits.reshape(-1, c).float(), labels.reshape(-1).long().clamp(min=0),
                         reduction="none")
    return ce.reshape(b, k)


def pretrain_loss(
    outputs: dict,
    *,
    lm_labels=None,
    matched=None,
    obj_labels=None,
    attr_labels=None,
    feat_target=None,
    feat_mask=None,
    ans=None,
    tasks=("mask_lm", "matched", "obj", "attr", "feat", "qa"),
    mesh: Mesh = SINGLE,
) -> tuple[torch.Tensor, dict]:
    """(total, {task: loss}) over the active tasks, in JAX's order and
    names.  ``outputs`` is ``LxmertPretraining``'s dict; the visual losses
    weight each RoI by ``feat_mask`` and scale by 1 / 0.15
    (``modeling.py:954-974``)."""
    parts = {}
    if "mask_lm" in tasks and lm_labels is not None:
        parts["mask_lm"] = masked_ce(outputs["mlm"], lm_labels, mesh)
    if "matched" in tasks and matched is not None:
        parts["matched"] = masked_ce(outputs["matched"], matched, mesh)
    if feat_mask is not None:
        visn = outputs["visn"]
        for name, labels in (("obj", obj_labels), ("attr", attr_labels)):
            if name in tasks and labels is not None:
                ce = _per_roi_ce(visn[name], labels)
                parts[name] = torch.mean(ce * feat_mask) * VISUAL_LOSS_CONFIG[name][1]
        if "feat" in tasks and feat_target is not None:
            l2 = torch.mean(smooth_l1(visn["feat"].float(), feat_target), dim=-1)
            parts["feat"] = torch.mean(l2 * feat_mask) * VISUAL_LOSS_CONFIG["feat"][1]
    if "qa" in tasks and ans is not None:
        parts["qa"] = masked_ce(outputs["qa"], ans, mesh)
    total = 0.0
    for v in parts.values():
        total = total + v
    return total, parts
