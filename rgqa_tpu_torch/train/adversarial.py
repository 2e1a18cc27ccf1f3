"""VILLA-style adversarial training (port of ``rgqa_tpu/train/adversarial.py``;
reference ``src/tasks/gqa_adv.py``).

PGD in embedding space: a text delta added to the summed word embeddings
before their LayerNorm and an image delta added to the RoI features (the
``txt_delta`` / ``img_delta`` arguments of LXMERT's forward).  One step:

1. a clean forward in eval mode, without gradients and without dropout
   (no mask is drawn), gives the reference logits;
2. ``steps`` inner forward-and-backward passes in training mode (dropout
   on), the deltas leaf tensors with ``requires_grad``: loss = (BCE +
   ``kl_weight`` x symmetric softmax KL to the clean logits) / ``steps``;
   the parameters' ``.grad`` is zeroed once and accumulates across the
   passes; after each pass but the last, each delta takes an ascent step
   along its l2- or linf-normalized gradient and is projected
   (``gqa_adv.py:138-218``);
3. one global clip-by-norm and one optimizer step.

Data parallel (``mesh``): the deltas stay per row and on their rank; the
model's gradient is averaged over the ranks before the clip (the losses
are means over rows), and the returned loss is the global batch's.

On the card the clean forward runs the attention kernel #1 and the inner
passes #4 / #5 (at dropout 0: #1 / #3).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from rgqa_tpu_torch.ops.dropout import DropoutRng
from rgqa_tpu_torch.parallel.mesh import SINGLE, Mesh, reduce_gradients
from rgqa_tpu_torch.train.losses import bce_answer_loss

__all__ = ["AdvConfig", "make_adv_train_step", "normalize_step", "project", "symmetric_kl"]


class AdvConfig(NamedTuple):
    steps: int = 3
    lr_txt: float = 1e-3
    lr_img: float = 1e-3
    max_norm: float = 0.0
    kl_weight: float = 1.5
    norm_type: str = "l2"  # l2 | linf


def _per_row(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, *([1] * (like.dim() - 1)))


def normalize_step(grad: torch.Tensor, lr: float, norm_type: str) -> torch.Tensor:
    """``lr x grad`` over each row's l2 norm (``l2``) or largest magnitude
    (``linf``), floored at 1e-8."""
    flat = grad.reshape(grad.shape[0], -1)
    if norm_type == "l2":
        denorm = torch.clamp(torch.linalg.vector_norm(flat, dim=1), min=1e-8)
    else:
        denorm = torch.clamp(flat.abs().amax(dim=1), min=1e-8)
    return lr * grad / _per_row(denorm, grad)


def project(delta: torch.Tensor, max_norm: float, norm_type: str) -> torch.Tensor:
    """Each row of ``delta`` into the ``max_norm`` ball (none when
    ``max_norm`` <= 0): clipped elementwise (``linf``) or rescaled to the
    norm where its l2 norm exceeds it."""
    if max_norm <= 0:
        return delta
    if norm_type == "linf":
        return torch.clamp(delta, -max_norm, max_norm)
    norm = torch.linalg.vector_norm(delta.reshape(delta.shape[0], -1), dim=1)
    scale = torch.where(norm > max_norm, max_norm / torch.clamp(norm, min=1e-8), torch.ones_like(norm))
    return delta * _per_row(scale, delta)


def symmetric_kl(logits: torch.Tensor, gt_logits: torch.Tensor) -> torch.Tensor:
    """``KL(p || q) + KL(q || p)`` of the softmaxes, the mean over every
    element times the answer count."""
    logp = torch.log_softmax(gt_logits, dim=-1)
    logq = torch.log_softmax(logits, dim=-1)
    p, q = logp.exp(), logq.exp()
    return torch.mean(p * (logp - logq) + q * (logq - logp)) * logits.shape[-1]


def make_adv_train_step(
    forward: Callable,
    optimizer: torch.optim.Optimizer,
    txt_delta_shape_of: Callable[[dict], tuple],
    cfg: AdvConfig = AdvConfig(),
    *,
    grad_clip: float = 5.0,
    rng: Optional[DropoutRng] = None,
    use_fused: Optional[bool] = None,
    mesh: Mesh = SINGLE,
):
    """``step(batch) -> {"loss", "score", "label"}`` (the clean BCE, and
    the clean logits' top sigmoid and its answer), for LXMERT's forward
    adapter and the ``optimizer`` over its parameters (JAX
    ``make_adv_train_step``).  ``txt_delta_shape_of(batch)`` gives the
    (B, T, H) text delta's shape.  ``use_fused=False`` runs the
    attention's plain versions.  ``mesh``: data parallel, ``batch`` this
    rank's rows of the global batch."""
    from rgqa_tpu_torch.train.step import global_norm_clip

    rng = rng or DropoutRng()
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def step(batch: dict) -> dict:
        target = batch["target"]
        with torch.no_grad():
            gt_logits = forward(batch, deterministic=True, use_fused=use_fused)["logits"].float()
        d_txt = torch.zeros(txt_delta_shape_of(batch), dtype=torch.float32, device=target.device)
        d_img = torch.zeros(batch["feats"].shape, dtype=torch.float32, device=target.device)
        optimizer.zero_grad(set_to_none=True)
        for i in range(cfg.steps):
            last = i == cfg.steps - 1
            # The last pass feeds no delta update: its deltas take no gradient.
            d_txt.requires_grad_(not last)
            d_img.requires_grad_(not last)
            out = forward(batch, deterministic=False, rng=rng, use_fused=use_fused, txt_delta=d_txt,
                          img_delta=d_img)
            logits = out["logits"].float()
            loss = (bce_answer_loss(logits, target) + cfg.kl_weight * symmetric_kl(logits, gt_logits)) / cfg.steps
            loss.backward()
            if not last:
                with torch.no_grad():
                    d_txt = project(d_txt + normalize_step(d_txt.grad, cfg.lr_txt, cfg.norm_type),
                                    cfg.max_norm, cfg.norm_type)
                    d_img = project(d_img + normalize_step(d_img.grad, cfg.lr_img, cfg.norm_type),
                                    cfg.max_norm, cfg.norm_type)
        (clean,) = reduce_gradients(mesh, params, [bce_answer_loss(gt_logits, target)])
        if grad_clip and grad_clip > 0:
            global_norm_clip(params, grad_clip)
        optimizer.step()
        probs = torch.sigmoid(gt_logits)
        return {
            "loss": clean,
            "score": torch.amax(probs, dim=-1),
            "label": torch.argmax(probs, dim=-1),
        }

    return step
