"""Rejection scorers: MSP, energy, ODIN, MC-dropout, branched, ensemble
(port of ``rgqa_tpu/scorers/core.py``).

A scorer is a factory taking the backbone's ``forward`` adapter and
returning ``score_fn(batch) -> {"label", "score"[, "probs"]}`` of
tensors on the batch's device.  Every forward goes through the adapter's
``deterministic`` keyword: True runs the module in eval mode, False in
training mode (MC-dropout's stochastic passes), and the module's own mode
is restored after the call.

ODIN (and the Mahalanobis scorer in ``maha.py``) take the gradient of a
pseudo-loss with respect to the RoI ``feats`` and ``boxes`` at eval
(``torch.autograd.grad`` with those two as its only inputs, so autograd
runs the backward of the attentions on a path from them to the pooled
output and no other), perturb them by ``-noise * sign01(g)`` and score
again.  They read ``feats`` / ``boxes``: on ViLT, which has none, they
raise.  Their ``needs_f32_inputs`` flag says the feed must hand them
exact f32 feats (the port's feed always does; the JAX feed casts to bf16
otherwise).

The LXMERT match scorer (:func:`make_match_scorer`) reads the matched
head of ``LxmertPretraining``, an f32 model: its ``bf16_feed`` flag says
that under ``--bf16`` it takes the JAX feed's bf16-rounded feats, which
the scoring loop rounds on the device.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from rgqa_tpu_torch.ops.dropout import DropoutRng
from rgqa_tpu_torch.parallel.mesh import SINGLE, Mesh
from rgqa_tpu_torch.train.losses import optax_sigmoid_bce

__all__ = [
    "make_msp_scorer",
    "make_energy_scorer",
    "make_odin_scorer",
    "make_dropout_scorer",
    "make_branched_scorer",
    "make_match_scorer",
    "majority_vote",
    "ensemble_merge",
    "sign01",
    "require_roi_inputs",
    "roi_input_grad",
]


def _logits(out: dict) -> torch.Tensor:
    logits = out["logits"].to(torch.float32)
    return logits[:, None] if logits.dim() == 1 else logits  # single-logit heads


def sign01(g: torch.Tensor) -> torch.Tensor:
    """``torch.ge(g, 0)`` mapped to {-1, +1}: a zero gradient counts as +1."""
    return torch.where(g >= 0, 1.0, -1.0).to(g.dtype)


def require_roi_inputs(batch: dict, scorer: str) -> None:
    """Raise for a batch without RoI ``feats`` / ``boxes`` (ViLT's)."""
    if "feats" not in batch or "boxes" not in batch:
        raise NotImplementedError(
            f"--scorer {scorer} perturbs the RoI feats and boxes; this backbone's batch has "
            "none (ViLT reads pixels), and the JAX package cannot run it there either"
        )


def make_msp_scorer(forward) -> Callable[[dict], dict]:
    """Max sigmoid probability (``gqa_conf.py:326``): label = argmax,
    score = max of ``sigmoid(logits.float())``.  It stands in for the JAX
    package's ``train/step.py::make_eval_step`` too."""

    def score_fn(batch: dict) -> dict:
        with torch.inference_mode():
            probs = torch.sigmoid(_logits(forward(batch, deterministic=True)))
            return {
                "label": torch.argmax(probs, dim=-1),
                "score": torch.amax(probs, dim=-1),
                "probs": probs,
            }

    return score_fn


def make_energy_scorer(forward, *, topk: int = 2) -> Callable[[dict], dict]:
    """Energy of the top-k logits (``gqa_energy.py:204-206``): label =
    argmax of the logits, score = sum of softplus over the top-k f32
    logits."""

    def score_fn(batch: dict) -> dict:
        with torch.inference_mode():
            logits = _logits(forward(batch, deterministic=True))
            top = torch.topk(logits, topk, dim=-1).values
            return {
                "label": torch.argmax(logits, dim=-1),
                # softplus as jax.nn.softplus: log(1 + e^x), no threshold.
                "score": torch.logaddexp(top, torch.zeros_like(top)).sum(dim=-1),
            }

    return score_fn


def roi_input_grad(loss_fn, batch: dict) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(feats, boxes) as exact f32 leaves and the gradient of
    ``loss_fn(feats, boxes)`` with respect to them alone."""
    with torch.enable_grad():
        feats = batch["feats"].detach().to(torch.float32).requires_grad_(True)
        boxes = batch["boxes"].detach().to(torch.float32).requires_grad_(True)
        g_feats, g_boxes = torch.autograd.grad(loss_fn(feats, boxes), (feats, boxes))
    return feats.detach(), boxes.detach(), g_feats, g_boxes


def make_odin_scorer(
    forward, *, temperature: float = 1e5, noise: float = 1e-4
) -> Callable[[dict], dict]:
    """ODIN (``gqa_odin.py:93-135``): BCE toward the thresholded
    pseudo-labels ``sigmoid(logits / T) >= 0.5`` (held constant), the
    per-row loss at the argmax column averaged; sign-gradient perturbation
    ``x - noise * sign01(g)`` of (feats, boxes); rescore with
    ``sigmoid(logits / T)``."""

    def pseudo_loss(feats, boxes, batch):
        logits = _logits(forward(dict(batch, feats=feats, boxes=boxes), deterministic=True))
        preds = torch.sigmoid(logits / temperature)
        labels = (preds >= 0.5).to(torch.float32).detach()
        loss = optax_sigmoid_bce(logits, labels)
        idx = torch.argmax(preds, dim=-1)
        return loss.gather(-1, idx[:, None])[:, 0].mean()

    def score_fn(batch: dict) -> dict:
        require_roi_inputs(batch, "odin")
        feats, boxes, g_feats, g_boxes = roi_input_grad(
            lambda f, b: pseudo_loss(f, b, batch), batch
        )
        with torch.no_grad():
            perturbed = dict(
                batch, feats=feats - noise * sign01(g_feats), boxes=boxes - noise * sign01(g_boxes)
            )
            probs = torch.sigmoid(_logits(forward(perturbed, deterministic=True)) / temperature)
            return {"label": torch.argmax(probs, dim=-1), "score": torch.amax(probs, dim=-1)}

    score_fn.needs_f32_inputs = True
    return score_fn


def majority_vote(labels: torch.Tensor) -> torch.Tensor:
    """(S, B) per-pass labels -> (B,) the majority label, ties to the
    first pass's answer, then to the lower class index: the JAX package's
    exact integer tally (``rgqa_tpu/scorers/core.py:155-171``)."""
    labels = labels.to(torch.int64)
    eq = labels[:, None, :] == labels[None, :, :]  # (S, S, B)
    # x2 so the first-pass half-bonus stays integral.
    tally2 = 2 * eq.to(torch.int64).sum(dim=0) + (labels == labels[0][None, :]).to(torch.int64)
    combined = tally2 * (1 << 20) - labels  # lexicographic (tally, -label)
    best = torch.argmax(combined, dim=0)
    return labels.gather(0, best[None, :])[0]


def make_dropout_scorer(forward, seed_list: Sequence[int], mesh: Mesh = SINGLE) -> Callable[[dict], dict]:
    """MC-dropout (``gqa_dropout.py:92-118``): S = ``len(seed_list)``
    stochastic passes at the configured dropout, label = the majority
    vote of the per-pass argmaxes (:func:`majority_vote`), score = the
    mean of the per-pass max sigmoid.

    Pass i draws from a :class:`DropoutRng` seeded with ``seed_list[i]``
    on every batch (the JAX scorer folds the same pass keys into every
    batch too).  The bits cannot match JAX's ``rbg`` stream, so the port
    holds the contract, not the stream.  The module runs in training
    mode for the passes only (the adapter's ``deterministic=False``),
    under ``no_grad``: on LXMERT every attention call then goes to the
    dropout kernel (#4), none to #1.  Under several ranks (``mesh``) each
    rank draws from its own stream of each pass
    (:meth:`DropoutRng.for_rank`)."""
    rank, world = mesh.rank, mesh.world
    seeds = [int(s) for s in seed_list]

    def score_fn(batch: dict) -> dict:
        device = next(iter(batch.values())).device
        labels, maxp = [], []
        with torch.no_grad():
            for seed in seeds:
                rng = DropoutRng.for_rank(seed, device, rank=rank, world=world)
                probs = torch.sigmoid(_logits(forward(batch, deterministic=False, rng=rng)))
                labels.append(torch.argmax(probs, dim=-1))
                maxp.append(torch.amax(probs, dim=-1))
            return {
                "label": majority_vote(torch.stack(labels)),
                "score": torch.stack(maxp).mean(dim=0),
            }

    return score_fn


def make_branched_scorer(forward, *, mix: bool = False) -> Callable[[dict], dict]:
    """Branched confidence head (``gqa_branched.py:200-215``): score =
    ``sigmoid(conf)``, or MSP x ``sigmoid(conf)`` with
    ``--mix_branched_score``."""

    def score_fn(batch: dict) -> dict:
        with torch.inference_mode():
            out = forward(batch, deterministic=True)
            if "conf" not in out:
                raise ValueError("--scorer branched needs a model built with --branched or --branched_layer")
            probs = torch.sigmoid(_logits(out))
            conf = torch.sigmoid(out["conf"].to(torch.float32))
            msp = torch.amax(probs, dim=-1)
            return {"label": torch.argmax(probs, dim=-1), "score": msp * conf if mix else conf}

    return score_fn


def make_match_scorer(forward, answer_forward=None) -> Callable[[dict], dict]:
    """LXMERT cross-modal match score (``gqa_lxrcap.py:98-120``):
    ``softmax(matched)[:, 1]`` in f32 from the pretraining model's
    ``forward``; the label from ``answer_forward`` (a fine-tuned GQA
    model) when given, else from the pretraining QA head."""

    def score_fn(batch: dict) -> dict:
        with torch.inference_mode():
            out = forward(batch, deterministic=True)
            score = torch.softmax(out["matched"].to(torch.float32), dim=-1)[:, 1]
            answers = answer_forward(batch, deterministic=True) if answer_forward else {"logits": out["qa"]}
            logits = _logits(answers)
            return {"label": torch.argmax(logits, dim=-1), "score": score}

    score_fn.bf16_feed = True
    return score_fn


def ensemble_merge(prob_list, method: str = "mean") -> dict:
    """Merge per-model sigmoid vectors (``gqa_ensemble.py:158-176``):
    their mean, or their product (``multiply`` / ``product``)."""
    stack = torch.stack([torch.as_tensor(p) for p in prob_list])  # (M, B, A)
    if method == "mean":
        merged = stack.mean(dim=0)
    elif method in ("multiply", "product"):
        merged = stack.prod(dim=0)
    else:
        raise ValueError(f"unknown ensemble method {method!r}")
    return {
        "label": torch.argmax(merged, dim=-1),
        "score": torch.amax(merged, dim=-1),
        "probs": merged,
    }
