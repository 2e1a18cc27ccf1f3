"""The dual-loader min-max trainers: resampling (Yi et al.), POEM and WOODS
(port of ``rgqa_tpu/train/dual_loader.py``; reference
``src/tasks/gqa_resampling.py`` / ``gqa_poem.py``, identical in the
reference, and ``gqa_woods.py``).

- A learnable weight per pseudo-UQ (negative) training row; each epoch
  samples the negative batches by ``softplus(w) ** 0.5``
  (``gqa_resampling.py:162-164``), on the host with numpy
  (:func:`sample_negative_indices`, the JAX package's function as it is,
  so the indices are the same).
- Per step: ``loss = loss_pos + <normalized w, per-row negative loss>``
  minimized over the model's parameters; ``loss_w = -loss_neg`` ascended
  over the weights by SGD with momentum 0.9 (``:184-215``).

In the reference both ``loss.backward()`` and ``loss_w.backward()``
accumulate into the weight gradient, so the two cancel and its weight
update is a no-op.  The JAX package realizes the intended min-max (the
model's gradient from ``loss``, the weights' from ``loss_w``), and so
does the port.  JAX computes the weight gradient from a second pair of
forwards at the same key and the pre-update parameters, whose
per-element BCE is the first pair's; the port takes it from the first
pair's per-element BCE, detached: the same gradient at half the
launches.

WOODS (``gqa_woods.py:94-157``) is plain unweighted BCE over the pos and
neg batches (``weighted=False``), with zero weight gradients.

Data parallel (``mesh``): each rank takes its rows of the global
positive batch and of the global negative draw (made from the shared
generator), the weights are replicated on every rank, and the model's
gradient and the weight gradient are averaged over the ranks in one
all-reduce.  Every loss here is a mean over rows (the negative term's
``sum / B`` at the rank's B), and the weights' normalizers are means
over the whole weight vector, so no batch statistic crosses the ranks
otherwise.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import numpy as np
import torch

from rgqa_tpu_torch.ops.dropout import DropoutRng
from rgqa_tpu_torch.parallel.mesh import SINGLE, Mesh, reduce_gradients
from rgqa_tpu_torch.train.losses import optax_sigmoid_bce

__all__ = ["NegativeWeights", "make_minmax_step", "sample_negative_indices", "softplus"]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it
    (``logaddexp(x, 0)``; PyTorch's ``softplus`` switches to ``x`` past
    its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


class NegativeWeights:
    """Learnable per-negative weights (f32, on ``device``) and their
    SGD with momentum 0.9 (``optax.sgd(lr_w, momentum=0.9)``: ``t = g +
    0.9 t``, ``w -= lr_w t``)."""

    def __init__(self, n: int, lr_w: float = 0.1, device=None):
        self.values = torch.zeros(n, dtype=torch.float32, device=device)
        self.trace = torch.zeros_like(self.values)
        self.lr_w = lr_w

    def sampling_weights(self) -> np.ndarray:
        """Per-epoch sampler weights: ``softplus(w) ** 0.5`` (the one read
        of the weights on the host an epoch)."""
        return softplus(self.values).cpu().numpy() ** 0.5

    @torch.no_grad()
    def apply(self, grads: torch.Tensor) -> None:
        self.trace.mul_(0.9).add_(grads)
        self.values.add_(self.trace * -self.lr_w)


def sample_negative_indices(rng: np.random.Generator, weights: np.ndarray, size: int) -> np.ndarray:
    p = weights / weights.sum()
    return rng.choice(len(weights), size=size, replace=True, p=p)


def make_minmax_step(
    forward: Callable,
    optimizer: torch.optim.Optimizer,
    *,
    weighted: bool = True,
    grad_clip: float = 5.0,
    rng: Optional[DropoutRng] = None,
    use_fused: Optional[bool] = None,
    mesh: Mesh = SINGLE,
):
    """``step(w_values, pos, neg, wids) -> (w_grads, aux)`` over a
    positive batch, a negative batch and the negatives' rows ``wids``
    (a (B,) index tensor into ``w_values``), for a model in training mode
    whose parameters ``optimizer`` holds (JAX ``make_minmax_step``; the
    caller owns the weights' optimizer, :class:`NegativeWeights`).
    ``aux``: ``loss`` (= ``loss_pos + loss_neg``), ``loss_pos``,
    ``loss_neg``, and ``score`` / ``label`` of the positive rows.
    ``use_fused=False`` runs the attention's plain versions.  ``mesh``:
    data parallel, ``pos`` / ``neg`` / ``wids`` this rank's rows; the
    returned losses and weight gradient are the global batch's."""
    from rgqa_tpu_torch.train.step import global_norm_clip

    rng = rng or DropoutRng()
    params = [p for group in optimizer.param_groups for p in group["params"]]
    precision = getattr(forward, "precision", contextlib.nullcontext)

    def neg_row_weights(w_values: torch.Tensor, wids: torch.Tensor) -> torch.Tensor:
        w = softplus(w_values)
        scale = torch.mean(torch.sqrt(w)) / torch.sqrt(torch.mean(w))
        return scale * torch.sqrt(w[wids] / torch.mean(w))

    def step(w_values: torch.Tensor, pos: dict, neg: dict, wids: torch.Tensor):
        with precision():
            lp = forward(pos, rng=rng, use_fused=use_fused)["logits"].float()
            ln = forward(neg, rng=rng, use_fused=use_fused)["logits"].float()
            k = lp.shape[-1]
            loss_pos = torch.mean(optax_sigmoid_bce(lp, pos["target"])) * k
            per_elem = optax_sigmoid_bce(ln, neg["target"])  # (B, K)
            if weighted:
                row_w = neg_row_weights(w_values, wids)
                loss_neg = torch.sum(row_w[:, None] * per_elem) / ln.shape[0]
            else:
                loss_neg = torch.mean(per_elem) * k
            optimizer.zero_grad(set_to_none=True)
            (loss_pos + loss_neg).backward()
        if weighted:
            # d(-loss_neg)/dw at the pre-update parameters: the detached BCE.
            w = w_values.detach().requires_grad_(True)
            loss_w = -torch.sum(neg_row_weights(w, wids)[:, None] * per_elem.detach()) / ln.shape[0]
            (w_grads,) = torch.autograd.grad(loss_w, w)
        else:
            w_grads = torch.zeros_like(w_values)
        loss_pos, loss_neg, w_grads = reduce_gradients(mesh, params, [loss_pos, loss_neg, w_grads])
        if grad_clip and grad_clip > 0:
            global_norm_clip(params, grad_clip)
        optimizer.step()
        probs = torch.sigmoid(lp.detach())
        aux = {
            "loss": loss_pos + loss_neg,
            "loss_pos": loss_pos,
            "loss_neg": loss_neg,
            "label": torch.argmax(probs, dim=-1),
            "score": torch.amax(probs, dim=-1),
        }
        return w_grads, aux

    return step

