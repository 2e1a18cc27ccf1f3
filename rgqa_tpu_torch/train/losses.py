"""Training losses (port of ``rgqa_tpu/train/losses.py``: BCE, softmax CE,
the energy regularizer and the branched loss, and the binary loss of the
JAX train step).

The reference's loss is ``nn.BCEWithLogitsLoss()(logit, target) *
logit.size(1)`` (``gqa_conf.py:197-199``): the mean over rows of the
per-row sum over answers; ``--mceLoss`` swaps in softmax CE against the
argmax target, scaled the same way.  Every loss takes the f32 logits the
step casts (the energy's softplus sums over every answer, which bf16
would round past the hinge).  :func:`binary_loss` is
the JAX train step's ``binary`` branch (``rgqa_tpu/train/step.py:410-416``):
a separate detector's or the caption matcher's one logit against the
is-answerable indicator.

The means over a subset of rows (``row_mask``, the energy hinge's
answerable and other rows) take ``mesh``, a data-parallel
:class:`~rgqa_tpu_torch.parallel.Mesh`: under several ranks the count of
selected rows is the global batch's, and the rank's sum is scaled by the
world size, so that the ranks' mean is the global batch's loss
(:mod:`rgqa_tpu_torch.parallel.mesh`).
"""

from __future__ import annotations

from typing import Optional

import torch

from rgqa_tpu_torch.parallel.mesh import SINGLE, Mesh, all_sum

__all__ = [
    "optax_sigmoid_bce",
    "bce_answer_loss",
    "mce_answer_loss",
    "energy_of_logits",
    "energy_regularizer",
    "branched_loss",
    "binary_loss",
]


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor] = None, mesh: Mesh = SINGLE) -> torch.Tensor:
    if mask is None:
        return x.mean()
    mask = mask.to(x.dtype)
    return (x * mask).sum() * mesh.world / torch.clamp(all_sum(mesh, mask.sum()), min=1.0)


def optax_sigmoid_bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Stable element-wise BCE-with-logits:
    ``max(x, 0) - x z + log(1 + exp(-|x|))``."""
    return torch.clamp(logits, min=0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def bce_answer_loss(
    logits: torch.Tensor, targets: torch.Tensor, row_mask: Optional[torch.Tensor] = None, mesh: Mesh = SINGLE
) -> torch.Tensor:
    """Per-answer binary CE, scaled by the answer count; ``row_mask``
    averages over the selected rows only."""
    per_row = optax_sigmoid_bce(logits, targets).mean(dim=-1)
    return _masked_mean(per_row, row_mask, mesh) * logits.shape[-1]


def mce_answer_loss(
    logits: torch.Tensor, targets: torch.Tensor, row_mask: Optional[torch.Tensor] = None, mesh: Mesh = SINGLE
) -> torch.Tensor:
    """Softmax CE against the argmax target (the first of tied maxima; a
    zero row's is answer 0), scaled by the answer count (``--mceLoss``,
    ``gqa_conf.py:194-196``)."""
    labels = torch.argmax(targets, dim=-1)
    per_row = -torch.log_softmax(logits, dim=-1).gather(-1, labels[:, None])[:, 0]
    return _masked_mean(per_row, row_mask, mesh) * logits.shape[-1]


def energy_of_logits(logits: torch.Tensor, mce: bool = False) -> torch.Tensor:
    """The free energy ``E_f`` (``gqa_energy.py:129-135``): logsumexp over
    the answers under the MCE loss, else the sum of softplus."""
    if mce:
        return torch.logsumexp(logits, dim=-1)
    return torch.logaddexp(logits, torch.zeros_like(logits)).sum(dim=-1)


def energy_regularizer(
    logits: torch.Tensor, id_mask: torch.Tensor, m_in: float, m_out: float, mce: bool = False, mesh: Mesh = SINGLE
) -> torch.Tensor:
    """The energy hinge (``gqa_energy.py:137-138``): ``0.1 * (mean over
    answerable rows of relu(-E - m_in)^2 + mean over the others of
    relu(m_out + E)^2)``, ``id_mask`` 1 on the answerable rows."""
    e = energy_of_logits(logits, mce=mce)
    id_mask = id_mask.to(e.dtype)
    id_term = _masked_mean(torch.square(torch.relu(-e - m_in)), id_mask, mesh)
    ood_term = _masked_mean(torch.square(torch.relu(m_out + e)), 1.0 - id_mask, mesh)
    return 0.1 * (id_term + ood_term)


def branched_loss(
    logits: torch.Tensor, conf_logit: torch.Tensor, targets: torch.Tensor, id_mask: torch.Tensor,
    mce: bool = False,
    mesh: Mesh = SINGLE,
) -> torch.Tensor:
    """The two-headed loss (``gqa_branched.py:130-143``): the answer loss
    over the answerable rows plus the mean BCE of the confidence logit
    (B,) against ``id_mask`` over every row."""
    answer = (mce_answer_loss if mce else bce_answer_loss)(logits, targets, row_mask=id_mask, mesh=mesh)
    return answer + optax_sigmoid_bce(conf_logit, id_mask.to(conf_logit.dtype)).mean()


def binary_loss(logit: torch.Tensor, id_mask: torch.Tensor) -> torch.Tensor:
    """Sigmoid BCE of one logit a row (B,) against ``id_mask`` (1 for an
    answerable row), the mean over rows (``gqa_separate.py:117-157``,
    ``gqa_caption.py:112-121``)."""
    return optax_sigmoid_bce(logit, id_mask.to(torch.float32)).mean()
