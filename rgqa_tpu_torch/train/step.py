"""The train step (port of ``rgqa_tpu/train/step.py``: ``global_norm_clip``,
``rp_augment`` and ``make_train_step`` for the BCE loss and the binary
loss of ``--strategy separate`` / ``caption``).

One step: RP augmentation (``--sample_pair``) -> forward in training mode
-> BCE x answers (or the binary loss) -> backward (through the attention
kernels' backward on CUDA) -> global clip-by-norm -> BertAdam.  A forward
adapter with a ``precision`` context (BUTD's f32 products without TF32)
has the forward and the backward run inside it.  The RP shift and every
attention-dropout seed come from a host (CPU) generator, so no draw waits
on the device; nothing in a step reads a value back to the host.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

from rgqa_tpu_torch.ops.dropout import DropoutRng
from rgqa_tpu_torch.train.losses import bce_answer_loss, binary_loss

__all__ = ["global_norm_clip", "rp_augment", "make_train_step"]

TEXT_KEYS = ("input_ids", "input_mask", "segment_ids", "token_ids")  # token_ids: BUTD's
# LXMERT's RoI fields and ViLT's pixel fields (both wires, with the
# pad-patch geometry): each image stays in its row.
VISION_KEYS = ("feats", "boxes", "pixels", "pixels_u8", "pixel_rect", "pixel_mask")


def global_norm_clip(params, max_norm: float) -> torch.Tensor:
    """Scale the gradients of ``params`` in place by ``min(1, max_norm /
    (norm + 1e-6))``, ``norm`` their global L2 norm (the reference's
    ``clip_grad_norm_(params, 5.)``, ``gqa_conf.py:201``; PyTorch's has
    this exact form).  Returns the norm."""
    return torch.nn.utils.clip_grad_norm_(params, max_norm)


def rp_augment(batch: dict, shift: int) -> dict:
    """Random-pairing pseudo-UQ negatives (``gqa_conf.py:155-170``): the
    text fields rolled by ``shift`` rows (a different row is a different
    image with probability ~1 for shuffled batches), the vision fields
    kept, appended below the batch with zero targets and ``id_mask``."""
    out = dict(batch)
    for k in TEXT_KEYS:
        if k in batch:
            out[k] = torch.cat([batch[k], torch.roll(batch[k], shift, dims=0)], 0)
    for k in VISION_KEYS:
        if k in batch:
            out[k] = torch.cat([batch[k], batch[k]], 0)
    out["target"] = torch.cat([batch["target"], torch.zeros_like(batch["target"])], 0)
    if "id_mask" in batch:
        out["id_mask"] = torch.cat([batch["id_mask"], torch.zeros_like(batch["id_mask"])], 0)
    return out


def make_train_step(
    forward: Callable,
    optimizer: torch.optim.Optimizer,
    *,
    loss: str = "bce",
    sample_pair: bool = False,
    binary: bool = False,
    grad_clip: float = 5.0,
    rng: Optional[DropoutRng] = None,
    use_fused: Optional[bool] = None,
):
    """``step(batch, shift=None) -> {"loss", "score", "label"}``, tensors
    on the batch's device, for a model in training mode whose parameters
    ``optimizer`` holds.  ``shift`` overrides the RP roll (drawn from
    ``rng.host`` otherwise); ``use_fused=False`` runs the attention's
    plain versions.  ``binary`` trains a one-logit head (a separate
    detector, the caption matcher) with :func:`binary_loss` against the
    batch's ``id_mask``; (B,) logits count as (B, 1), as in the JAX
    step."""
    if loss != "bce":
        raise NotImplementedError(f"loss {loss!r} (--mceLoss) is not ported yet; the port has bce")
    rng = rng or DropoutRng()
    params = [p for group in optimizer.param_groups for p in group["params"]]
    precision = getattr(forward, "precision", contextlib.nullcontext)

    def step(batch: dict, shift: Optional[int] = None) -> dict:
        if sample_pair:
            b = next(batch[k] for k in TEXT_KEYS if k in batch).shape[0]
            batch = rp_augment(batch, rng.shift(b) if shift is None else shift)
        with precision():
            out = forward(batch, rng=rng, use_fused=use_fused)
            logits = out["logits"].to(torch.float32)
            if logits.dim() == 1:  # one-logit heads (the caption matcher)
                logits = logits[:, None]
            if binary:
                total = binary_loss(logits[:, 0], batch["id_mask"])
            else:
                total = bce_answer_loss(logits, batch["target"])
            optimizer.zero_grad(set_to_none=True)
            total.backward()
        if grad_clip and grad_clip > 0:
            global_norm_clip(params, grad_clip)
        optimizer.step()
        probs = torch.sigmoid(logits.detach())
        return {
            "loss": total.detach(),
            "score": torch.amax(probs, dim=-1),
            "label": torch.argmax(probs, dim=-1),
        }

    return step
