"""The train step (port of ``rgqa_tpu/train/step.py``: ``global_norm_clip``,
``rp_augment``, ``mixup_augment`` with the TreeMix splice,
``make_train_step`` for the BCE, MCE, branched, energy and binary
losses and the CLIP-weighted RP loss, and
``make_weighted_clip_train_step``, the joint step of ``--strategy weight
--update_weight_model``).

One step: augmentation (RP pairs with ``--sample_pair``, else the mixup
or TreeMix pseudo-UQ rows of ``--mixup_mode``) -> forward in training
mode -> the loss (BCE or ``--mceLoss`` x answers, the branched loss, or
the binary loss; plus the energy hinge) -> backward (through the
attention kernels' backward on CUDA) -> global clip-by-norm -> BertAdam.
A forward adapter with a ``precision`` context (BUTD's f32 products
without TF32) has the forward and the backward run inside it.

Every random draw of a step comes from the host: the RP shift, the
attention-dropout seeds, and each augmentation's draws
(:func:`draw_mixup`: Beta proportions from a numpy generator seeded from
the host generator, rank uniforms, the partner roll, window positions,
Gumbel picks, ``treemix_both``'s coin).  :func:`mixup_apply` then applies
them to the batch where it lies: gathers, selects and targets.  So no
draw waits on the device, nothing in a step reads a value back to the
host, and the tests hand the JAX key chain's draws to the apply step.

Data parallel (``mesh``, a :class:`~rgqa_tpu_torch.parallel.Mesh` of N
ranks, each with its rows of the global batch): every draw is made for
the global batch from the stream the ranks share, and each rank applies
its rows of it (:func:`local_draws`); the rolls are of the global batch
(:func:`~rgqa_tpu_torch.parallel.roll_rows`: a row's partner may lie on
another rank); the weighted means take global sums; and the gradients
are averaged over the ranks before the global clip
(:func:`~rgqa_tpu_torch.parallel.reduce_gradients`), the step's loss
values riding in the same all-reduce.  Each step then means what the
one-process step means at the same global batch.  On one rank all of it
is the one-process step.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import numpy as np
import torch

from rgqa_tpu_torch.device import exact_f32
from rgqa_tpu_torch.ops.dropout import DropoutRng
from rgqa_tpu_torch.ops.pixels import clip_normalize
from rgqa_tpu_torch.parallel.mesh import SINGLE, Mesh, all_sum, gather_rows, reduce_gradients, roll_rows
from rgqa_tpu_torch.train.losses import (
    bce_answer_loss,
    binary_loss,
    branched_loss,
    energy_regularizer,
    mce_answer_loss,
    optax_sigmoid_bce,
)

__all__ = ["global_norm_clip", "rp_augment", "draw_mixup", "local_draws", "mixup_apply", "make_train_step",
           "make_weighted_clip_train_step"]

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


def rp_augment(batch: dict, shift: int, mesh: Mesh = SINGLE) -> dict:
    """Random-pairing pseudo-UQ negatives (``gqa_conf.py:155-170``): the
    text fields rolled by ``shift`` rows (a different row is a different
    image with probability ~1 for shuffled batches), the vision fields
    kept, appended below the batch with zero targets and ``id_mask``.
    Under several ranks the roll is the global batch's."""
    out = dict(batch)
    for k in TEXT_KEYS:
        if k in batch:
            out[k] = torch.cat([batch[k], roll_rows(mesh, batch[k], shift)], 0)
    for k in VISION_KEYS:
        if k in batch:
            out[k] = torch.cat([batch[k], batch[k]], 0)
    out["target"] = torch.cat([batch["target"], torch.zeros_like(batch["target"])], 0)
    if "id_mask" in batch:
        out["id_mask"] = torch.cat([batch["id_mask"], torch.zeros_like(batch["id_mask"])], 0)
    return out


def _host_beta(host: Optional[torch.Generator], alpha: float, beta: float, n: int) -> torch.Tensor:
    """``n`` f32 draws of Beta(alpha, beta) on the host: numpy's Beta from
    a generator seeded by one draw of ``host`` (``torch.distributions``
    takes no generator)."""
    seed = int(torch.randint(0, 2**63 - 1, (), generator=host))
    return torch.from_numpy(np.random.default_rng(seed).beta(alpha, beta, n).astype(np.float32))


def _host_gumbel(host: Optional[torch.Generator], shape) -> torch.Tensor:
    return -torch.log(torch.empty(shape).exponential_(generator=host))


def draw_mixup(batch: dict, mode: str, alpha: float, beta: float,
               host: Optional[torch.Generator] = None, rows: Optional[int] = None) -> dict:
    """The host draws of one :func:`mixup_apply` call on ``batch`` (B rows,
    or ``rows``, the global batch's, under several ranks; N RoIs, T
    tokens, K parse spans), as CPU tensors and Python scalars:

    - ``treemix_both``: ``coin`` (True: the TreeMix splice as
      ``treemix_v2``, False: ``mixup_v2``), then that mode's draws;
    - ``treemix*``: ``prop`` (B,) Beta, ``pos_u`` (B,) uniforms (the
      fallback window's start), ``shift`` the partner roll in [1, B - 1],
      and with parse spans ``gumbel_a`` / ``gumbel_p`` (B, K);
    - ``perturb``: ``perm`` (N,), a permutation of the RoI slots;
    - ``weighted_sum*``: ``prop`` and ``shift``;
    - the RoI swap (``mixup_v1`` / ``v2`` / ``v3`` / ``vis``): ``prop``,
      ``u`` (B, N) uniforms, ranked into the kept subset, and ``shift``.
    """
    if mode == "treemix_both":
        coin = bool(torch.randint(0, 2, (), generator=host))
        return {"coin": coin, **draw_mixup(batch, "treemix_v2" if coin else "mixup_v2", alpha, beta, host)}
    if mode == "perturb":
        return {"perm": torch.randperm(batch["feats"].shape[1], generator=host)}
    text = next(batch[k] for k in ("input_ids", "token_ids") if k in batch)
    b = rows or text.shape[0]
    draws = {"prop": _host_beta(host, alpha, beta, b)}
    if mode.startswith("treemix"):
        draws["pos_u"] = torch.rand(b, generator=host)
    elif not mode.startswith("weighted_sum"):
        draws["u"] = torch.rand(b, _roi_fields(batch)[0].shape[1], generator=host)
    draws["shift"] = int(torch.randint(1, b, (), generator=host))
    if mode.startswith("treemix") and "parse_spans" in batch:
        k = batch["parse_spans"].shape[1]
        draws["gumbel_a"], draws["gumbel_p"] = _host_gumbel(host, (b, k)), _host_gumbel(host, (b, k))
    return draws


ROW_DRAWS = ("prop", "pos_u", "u", "gumbel_a", "gumbel_p")  # one entry per row of the global batch


def local_draws(draws: dict, mesh: Mesh = SINGLE) -> dict:
    """This rank's rows of the per-row draws of the global batch (the
    shift, the coin and the RoI permutation are the batch's, whole)."""
    if mesh.world == 1:
        return draws
    rows = mesh.rows(len(draws["prop"])) if "prop" in draws else None
    return {k: v[rows] if k in ROW_DRAWS else v for k, v in draws.items()}


def _roi_fields(batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    if "feats" not in batch:
        raise ValueError("the mixup modes but treemix swap RoI features; this batch has none "
                         "(ViLT and the caption matcher read no RoIs)")
    return batch["feats"], batch["boxes"]


def _appended(batch: dict, out: dict, pet_target: torch.Tensor) -> dict:
    """The pseudo-UQ rows' targets appended, and zero ``id_mask`` rows:
    they are not answerable rows."""
    out["target"] = torch.cat([batch["target"], pet_target], 0)
    if "id_mask" in batch:
        out["id_mask"] = torch.cat([batch["id_mask"], torch.zeros_like(batch["id_mask"])], 0)
    return out


def _treemix_apply(batch: dict, draws: dict, mode: str, lam1: float, lam2: float, mesh: Mesh = SINGLE) -> dict:
    """The constituency splice (reference ``gqa_mixup_both.py``, JAX
    ``_treemix_augment``): with parse spans, a Gumbel-picked anchor
    subtree whose word ratio lies in (lam2, lam1) is replaced by a
    Gumbel-picked partner subtree, the partner's ratio measured against
    the anchor's length (the reference's quirk, ``:58-61``); rows without
    a usable parse, and batches without spans (BUTD's front-padded
    words), splice a Beta-wide window at the same place on both sides.
    ``input_mask`` is rebuilt from the new length; targets zero, or for
    ``treemix_v1`` the anchor's scaled by the kept word fraction."""
    out = dict(batch)
    text_keys = [k for k in ("input_ids", "segment_ids", "token_ids") if k in batch]
    ids = batch[text_keys[0]]
    b, t = ids.shape
    dev = ids.device
    shift = draws["shift"]
    pos = torch.arange(t, device=dev)[None, :]
    prop = draws["prop"].to(dev)
    span_f = torch.floor(prop * (t - 2)).to(torch.int32)
    start_f = 1 + (draws["pos_u"].to(dev) * torch.clamp(t - 2 - span_f, min=1).float()).to(torch.int32)
    s1, l1, s2, l2 = start_f, span_f, start_f, span_f
    lab = 1.0 - prop
    if "parse_spans" in batch:
        spans = batch["parse_spans"].long()  # (B, K, 2)
        sw = batch["parse_span_words"].float()
        nw = batch["parse_n_words"].float()
        p_spans, p_sw = roll_rows(mesh, spans, shift), roll_rows(mesh, sw, shift)
        nw_safe = torch.clamp(nw, min=1.0)[:, None]
        lo, hi = (torch.tensor(x, dtype=torch.float32, device=dev) for x in (lam2, lam1))

        def pick(valid, gumbel):
            return torch.argmax(torch.where(valid, gumbel.to(dev), -torch.inf), dim=1)

        ratio_a, ratio_p = sw / nw_safe, p_sw / nw_safe
        valid_a = (spans[..., 0] >= 0) & (ratio_a > lo) & (ratio_a < hi)
        valid_p = (p_spans[..., 0] >= 0) & (ratio_p > lo) & (ratio_p < hi)
        ka, kp = pick(valid_a, draws["gumbel_a"]), pick(valid_p, draws["gumbel_p"])
        ok = valid_a.any(1) & valid_p.any(1) & (nw > 0)
        sa, ea = spans[torch.arange(b, device=dev), ka].to(torch.int32).unbind(-1)
        sp, ep = p_spans[torch.arange(b, device=dev), kp].to(torch.int32).unbind(-1)
        s1, l1 = torch.where(ok, sa, s1), torch.where(ok, ea - sa, l1)
        s2, l2 = torch.where(ok, sp, s2), torch.where(ok, ep - sp, l2)
        # The reference's label (mix_trees:70-76): words kept / new length.
        l1w, l2w = sw.gather(1, ka[:, None])[:, 0], p_sw.gather(1, kp[:, None])[:, 0]
        new_words = torch.clamp(nw - l1w + l2w, min=1.0)
        lab = torch.where(ok, (new_words - l2w) / new_words, lab)

    take_p = (pos >= s1[:, None]) & (pos < (s1 + l2)[:, None])
    take_suffix = pos >= (s1 + l2)[:, None]
    idx_p = torch.clamp(s2[:, None] + pos - s1[:, None], 0, t - 1).long()
    idx_s = torch.clamp(pos - l2[:, None] + l1[:, None], 0, t - 1).long()
    mixed = {}
    for k in text_keys:
        a = batch[k]
        from_p = roll_rows(mesh, a, shift).gather(1, idx_p)
        mixed[k] = torch.where(take_p, from_p, torch.where(take_suffix, a.gather(1, idx_s), a))
    if "input_mask" in batch:
        len_a = batch["input_mask"].to(torch.int32).sum(1)
        new_len = torch.clamp(len_a - l1 + l2, 0, t)
        mixed["input_mask"] = (pos < new_len[:, None]).to(batch["input_mask"].dtype)
    for k, v in mixed.items():
        out[k] = torch.cat([batch[k], v], 0)
    for k in VISION_KEYS:
        if k in batch:
            out[k] = torch.cat([batch[k], batch[k]], 0)
    target = batch["target"]
    pet = target * lab[:, None] if mode.endswith("_v1") else torch.zeros_like(target)
    return _appended(batch, out, pet)


def mixup_apply(batch: dict, draws: dict, mode: str, *, uq_as_class: bool = False,
                lam1: float = 0.5, lam2: float = 0.05, mesh: Mesh = SINGLE) -> dict:
    """Append pseudo-UQ rows to ``batch`` from :func:`draw_mixup`'s
    ``draws`` (JAX ``mixup_augment``; reference ``gqa_mixup_vis.py``,
    ``gqa_mixup_both.py``, ``gqa_ood.py``), on the batch's device:

    - the RoI swap (``mixup_v1`` / ``v2`` / ``v3`` / ``vis``, ``:134-181``):
      keep the bottom ``floor(prop N)`` ranks of the uniforms (ranked as
      ``argsort(argsort(u))``, stable) from the anchor image and take the
      other slots' feats (``mixup_v3``: zeros) and boxes from the rolled
      partner; targets ``prop x target`` (v2: zero; under
      ``uq_as_class`` the real answers scaled by ``prop`` and the UQ
      column ``1 - prop``, or 1 for an anchor already UQ; v2 all UQ);
    - ``perturb`` (``:124-133``): the boxes permuted across the slots,
      zero target;
    - ``weighted_sum`` / ``_v2`` (``gqa_distill_online.py:175-200``): feats
      ``prop x anchor + (1 - prop) x partner``, the anchor's boxes;
      target ``prop x target`` (v2: zero);
    - ``treemix`` / ``_v1`` / ``_v2``: the constituency splice
      (:func:`_treemix_apply`); ``treemix_both``: the splice or
      ``mixup_v2`` by the draws' coin.

    The question text is the anchor's except under TreeMix; the appended
    rows' ``id_mask`` is zero.  Under several ranks (``mesh``) ``draws``
    are this rank's rows (:func:`local_draws`) and the partner roll is
    the global batch's."""
    if mode == "treemix_both":
        mode = "treemix_v2" if draws["coin"] else "mixup_v2"
    if mode.startswith("treemix"):
        return _treemix_apply(batch, draws, mode, lam1, lam2, mesh)
    feats, boxes = _roi_fields(batch)
    target = batch["target"]
    b, n = feats.shape[:2]
    out = dict(batch)
    for k in TEXT_KEYS:
        if k in batch:
            out[k] = torch.cat([batch[k], batch[k]], 0)
    if mode == "perturb":
        out["feats"] = torch.cat([feats, feats], 0)
        out["boxes"] = torch.cat([boxes, boxes[:, draws["perm"].to(boxes.device).long()]], 0)
        return _appended(batch, out, torch.zeros_like(target))
    prop = draws["prop"].to(feats.device)
    shift = draws["shift"]
    if mode.startswith("weighted_sum"):
        p3 = prop[:, None, None]
        out["feats"] = torch.cat([feats, p3 * feats + (1.0 - p3) * roll_rows(mesh, feats, shift)], 0)
        out["boxes"] = torch.cat([boxes, boxes], 0)
        pet = torch.zeros_like(target) if mode == "weighted_sum_v2" else target * prop[:, None]
        return _appended(batch, out, pet)
    u = draws["u"].to(feats.device)
    ranks = torch.argsort(torch.argsort(u, dim=1, stable=True), dim=1, stable=True)
    keep = (ranks < torch.floor(prop[:, None] * n))[..., None]
    neg_feats, neg_boxes = roll_rows(mesh, feats, shift), roll_rows(mesh, boxes, shift)
    base = torch.zeros_like(feats) if mode == "mixup_v3" else neg_feats
    out["feats"] = torch.cat([feats, torch.where(keep, feats, base)], 0)
    out["boxes"] = torch.cat([boxes, torch.where(keep, boxes, neg_boxes)], 0)
    if uq_as_class:
        # The OOD-finetune targets (gqa_ood.py:146-155).
        anchor_uq = target[:, -1:]
        if mode == "mixup_v2":
            pet = torch.cat([torch.zeros_like(target[:, :-1]), torch.ones_like(anchor_uq)], 1)
        else:
            uq_col = torch.where(anchor_uq > 0, 1.0, (1.0 - prop)[:, None])
            pet = torch.cat([target[:, :-1] * prop[:, None], uq_col], 1)
    elif mode == "mixup_v2":
        pet = torch.zeros_like(target)
    else:  # mixup_v1 / mixup_v3 / the legacy 'vis'
        pet = target * prop[:, None]
    return _appended(batch, out, pet)


def make_train_step(
    forward: Callable,
    optimizer: torch.optim.Optimizer,
    *,
    loss: str = "bce",
    sample_pair: bool = False,
    mixup_mode: Optional[str] = None,
    mixup_alpha: float = 1.0,
    mixup_beta: float = 1.0,
    lam1: float = 0.5,
    lam2: float = 0.05,
    energy: bool = False,
    m_in: float = 25.0,
    m_out: float = 0.0,
    branched: bool = False,
    uq_as_class: bool = False,
    binary: bool = False,
    weighted_rp: bool = False,
    grad_clip: float = 5.0,
    rng: Optional[DropoutRng] = None,
    use_fused: Optional[bool] = None,
    mesh: Mesh = SINGLE,
):
    """``step(batch, shift=None, draws=None, neg_weights=None) -> {"loss",
    "score", "label"}``, tensors on the batch's device, for a model in
    training mode whose parameters ``optimizer`` holds (JAX
    ``make_train_step``).

    ``weighted_rp`` (``--strategy weight``, JAX ``weighted_rp_loss``,
    ``gqa_weight.py:130-245``): the loss is ``0.5 x (pos BCE + weighted
    negative BCE)``, the negatives the batch's images under its text
    fields rolled by the host-chosen ``shift``, each negative row's BCE
    against zero targets weighted by ``neg_weights`` (B,) (normalized by
    their sum); two forwards a step.

    Augmentation: RP pairs (``sample_pair``; ``shift`` overrides the roll,
    drawn from ``rng.host`` otherwise), else ``mixup_mode``'s pseudo-UQ
    rows (``draws`` overrides :func:`draw_mixup`'s host draws).  Loss:
    ``binary`` trains a one-logit head (a separate detector, the caption
    matcher) with :func:`binary_loss` against ``id_mask``; ``branched``
    the answer loss over the answerable rows plus the confidence logit's
    BCE (the forward's ``conf``); else BCE or (``loss="mce"``) softmax
    CE x answers.  ``energy`` adds the energy hinge at ``m_in`` /
    ``m_out`` (logsumexp energies under MCE).  ``uq_as_class`` gives the
    mixup rows UQ-column targets.  (B,) logits count as (B, 1), as in
    the JAX step.  ``use_fused=False`` runs the attention's plain
    versions.

    ``mesh``: data parallel over its ranks, ``batch`` this rank's rows of
    the global batch; ``shift`` and ``draws`` are the global batch's (the
    module's docstring), ``neg_weights`` this rank's rows of weights
    normalized over the global batch.  The returned ``loss`` is the
    global batch's, ``score`` / ``label`` this rank's rows'."""
    if loss not in ("bce", "mce"):
        raise ValueError(f"loss {loss!r}: bce or mce")
    mce = loss == "mce"
    rng = rng or DropoutRng()
    params = [p for group in optimizer.param_groups for p in group["params"]]
    precision = getattr(forward, "precision", contextlib.nullcontext)

    def weighted_rp_loss(batch: dict, shift: int, neg_weights: torch.Tensor):
        loss_pos, per_row, lp = _pair_losses(forward, batch, shift, rng, use_fused, mesh)
        return 0.5 * (loss_pos + _weighted_mean(per_row, neg_weights.to(torch.float32), mesh)), lp

    def step(batch: dict, shift: Optional[int] = None, draws: Optional[dict] = None,
             neg_weights: Optional[torch.Tensor] = None) -> dict:
        if weighted_rp:
            with precision():
                total, logits = weighted_rp_loss(batch, shift, neg_weights)
                optimizer.zero_grad(set_to_none=True)
                total.backward()
            return _update(total, logits)
        if sample_pair:
            b = next(batch[k] for k in TEXT_KEYS if k in batch).shape[0] * mesh.world
            batch = rp_augment(batch, rng.shift(b) if shift is None else shift, mesh)
        elif mixup_mode:
            if draws is None:
                b = next(batch[k] for k in ("input_ids", "token_ids") if k in batch).shape[0] * mesh.world
                draws = draw_mixup(batch, mixup_mode, mixup_alpha, mixup_beta, rng.host, rows=b)
            batch = mixup_apply(batch, local_draws(draws, mesh), mixup_mode, uq_as_class=uq_as_class,
                                lam1=lam1, lam2=lam2, mesh=mesh)
        with precision():
            out = forward(batch, rng=rng, use_fused=use_fused)
            logits = out["logits"].to(torch.float32)
            if logits.dim() == 1:  # one-logit heads (the caption matcher)
                logits = logits[:, None]
            target, id_mask = batch["target"], batch.get("id_mask")
            if binary:
                total = binary_loss(logits[:, 0], id_mask)
            elif branched:
                total = branched_loss(logits, out["conf"].to(torch.float32), target, id_mask, mce=mce,
                                      mesh=mesh)
            elif mce:
                total = mce_answer_loss(logits, target)
            else:
                total = bce_answer_loss(logits, target)
            if energy:
                total = total + energy_regularizer(logits, id_mask, m_in, m_out, mce=mce, mesh=mesh)
            optimizer.zero_grad(set_to_none=True)
            total.backward()
        return _update(total, logits)

    def _update(total: torch.Tensor, logits: torch.Tensor) -> dict:
        (total,) = reduce_gradients(mesh, params, [total])
        if grad_clip and grad_clip > 0:
            global_norm_clip(params, grad_clip)
        optimizer.step()
        return _aux(total, logits)

    return step


def _aux(total: torch.Tensor, logits: torch.Tensor) -> dict:
    probs = torch.sigmoid(logits.detach())
    return {"loss": total.detach(), "score": torch.amax(probs, dim=-1), "label": torch.argmax(probs, dim=-1)}


def _pair_losses(forward, batch: dict, shift: int, rng: DropoutRng, use_fused: Optional[bool], mesh: Mesh = SINGLE):
    """The weighted strategies' two forwards (JAX ``weighted_rp_loss``):
    (the positive rows' BCE x answers, each negative row's BCE x answers
    against zero targets, the positive f32 logits); the negatives are the
    batch's images under its text fields rolled by ``shift`` (the global
    batch's roll under several ranks)."""
    lp = forward(batch, rng=rng, use_fused=use_fused)["logits"].to(torch.float32)
    k = lp.shape[-1]
    loss_pos = torch.mean(optax_sigmoid_bce(lp, batch["target"])) * k
    neg = dict(batch)
    for key in TEXT_KEYS:
        if key in batch:
            neg[key] = roll_rows(mesh, batch[key], shift)
    ln = forward(neg, rng=rng, use_fused=use_fused)["logits"].to(torch.float32)
    per_row = torch.mean(optax_sigmoid_bce(ln, torch.zeros_like(ln)), dim=-1) * k
    return loss_pos, per_row, lp


def _weighted_mean(per_row: torch.Tensor, w: torch.Tensor, mesh: Mesh = SINGLE) -> torch.Tensor:
    """``sum(w x l) / sum(w)`` over the global batch; under several ranks
    the rank's share (its sum over the global sum of ``w``, times the
    world size: the ranks' mean is the global mean)."""
    return torch.sum(per_row * w) * mesh.world / torch.clamp(all_sum(mesh, torch.sum(w)), min=1e-8)


def make_weighted_clip_train_step(
    forward: Callable,
    clip_model,
    optimizer: torch.optim.Optimizer,
    clip_optimizer: torch.optim.Optimizer,
    *,
    temperature: float = 1.0,
    grad_clip: float = 5.0,
    clip_grad_clip: float = 5.0,
    rng: Optional[DropoutRng] = None,
    use_fused: Optional[bool] = None,
    mesh: Mesh = SINGLE,
):
    """``step(batch, shift) -> {"loss", "loss_w", "score", "label"}``: the
    joint min-max step of ``--strategy weight --update_weight_model``
    (JAX ``make_weighted_clip_train_step``, ``gqa_weight.py:125-238``).

    The negative-pair weights come from the current CLIP params
    (``clip_model``, a :class:`~rgqa_tpu_torch.models.clip.ClipModel`
    whose parameters ``clip_optimizer`` holds): the anchor pixels
    (``batch["clip_pixels"]``, uint8 rows normalized here, or f32) against
    the anchor questions' CLIP tokens (``clip_ids`` / ``clip_mask``)
    rolled by ``shift``, the model's own negative roll, the cosine times
    the frozen ``exp(logit_scale)``, then a softmax over the batch at
    ``temperature``.  The model minimizes ``0.5 x (pos BCE + weighted
    negative BCE)`` with the weights detached; CLIP maximizes the
    weighted negative loss (``loss_w``) with the per-row losses detached.
    One backward runs over the sum (each objective's gradient with
    respect to the other's parameters is zero), then each side is clipped
    by its global norm (``grad_clip``, ``clip_grad_clip``) and takes its
    optimizer's step.  A CLIP model computing in f32 runs the step, its
    backward included, without TF32 (:func:`~rgqa_tpu_torch.device.
    exact_f32`).  ``use_fused=False`` runs the attention's plain
    versions in both models.

    Under several ranks (``mesh``) the softmax is over the global batch:
    each rank's similarities are gathered, every rank computes the
    weights and CLIP's objective alike, and the model's weighted mean
    takes its rows' weights (the module's docstring)."""
    rng = rng or DropoutRng()
    params = [p for group in optimizer.param_groups for p in group["params"]]
    clip_params = [p for group in clip_optimizer.param_groups for p in group["params"]]
    precision = getattr(forward, "precision", contextlib.nullcontext)
    clip_precision = exact_f32 if clip_model.compute_dtype == torch.float32 else contextlib.nullcontext

    def step(batch: dict, shift: int) -> dict:
        pixels = batch["clip_pixels"]
        if pixels.dtype == torch.uint8:
            pixels = clip_normalize(pixels)
        with clip_precision(), precision():
            cos = clip_model.cosine(roll_rows(mesh, batch["clip_ids"], shift),
                                    roll_rows(mesh, batch["clip_mask"], shift), pixels, use_fused=use_fused)
            sim = cos.to(torch.float32) * torch.exp(clip_model.logit_scale.detach().to(torch.float32))
            w_all = torch.softmax(gather_rows(mesh, sim) / temperature, dim=0)
            w = w_all[mesh.rows(w_all.shape[0])]
            loss_pos, per_row, lp = _pair_losses(forward, batch, shift, rng, use_fused, mesh)
            loss_model = 0.5 * (loss_pos + _weighted_mean(per_row, w.detach(), mesh))
            loss_clip = -_weighted_mean(gather_rows(mesh, per_row.detach()), w_all)
            optimizer.zero_grad(set_to_none=True)
            clip_optimizer.zero_grad(set_to_none=True)
            (loss_model + loss_clip).backward()
        loss_model, loss_clip = reduce_gradients(mesh, params + clip_params, [loss_model, loss_clip])
        if grad_clip and grad_clip > 0:
            global_norm_clip(params, grad_clip)
        if clip_grad_clip and clip_grad_clip > 0:
            global_norm_clip(clip_params, clip_grad_clip)
        optimizer.step()
        clip_optimizer.step()
        return dict(_aux(loss_model, lp), loss_w=-loss_clip)

    return step
