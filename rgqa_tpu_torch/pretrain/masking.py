"""BERT / LXMERT masking for pretraining (port of
``rgqa_tpu/pretrain/masking.py``).

The reference's per-token rates (``lxmert_pretrain.py:71-132``): a
maskable token is selected for prediction at 0.15; a selected token
becomes ``[MASK]`` (80%), a random vocabulary id (10%) or stays (10%); a
RoI is selected at 0.15 too, and a selected
RoI is zeroed (80%), swapped with a random row of the batch's own
``(B * K, D)`` feature pool (10%) or stays (10%).  Unselected positions
carry label -1 (the CE ignores them).  The matched task's negatives roll
the text of about half the rows by one shift in [1, B), images kept.

The JAX package draws these bits with ``jax.random`` inside its jitted
step.  The port splits each of its three functions in two: every random
number of a step is drawn on the host first, from one
``torch.Generator``, by :func:`draw_pretrain_masks` (a dict of CPU
tensors and Python ints), and the functions below apply given draws to
the batch where it lies.  So no draw waits on the device, and the tests
hand the apply step the JAX key chain's own draws.

Data parallel: the draws are made for the global batch (``rows``) from
the stream the ranks share; each rank applies its rows of them
(:func:`local_pretrain_draws`), the matched roll is the global batch's
and the RoI swaps pick from the global batch's pool (``mesh``).
"""

from __future__ import annotations

from typing import Optional

import torch

from rgqa_tpu_torch.parallel.mesh import SINGLE, Mesh, gather_rows, roll_rows

__all__ = ["WORD_MASK_RATE", "OBJ_MASK_RATE", "VISUAL_TASKS", "draw_pretrain_masks", "local_pretrain_draws",
           "mask_words", "mask_objects", "matched_swap"]

# The rates the JAX runner masks at, whatever --wordMaskRate / --objMaskRate
# say (its PretrainRunner never passes them; mask_objects fixes 0.15).
WORD_MASK_RATE = 0.15
OBJ_MASK_RATE = 0.15
VISUAL_TASKS = ("obj", "attr", "feat")


def draw_pretrain_masks(batch: dict, tasks, *, vocab_size: int,
                        generator: Optional[torch.Generator] = None, rows: Optional[int] = None) -> dict:
    """The host draws of one pretraining step on ``batch`` (B rows of T
    tokens, K RoIs; B is ``rows``, the global batch's, under several
    ranks), for the ``tasks`` that draw:

    - ``matched``: ``flip`` (B,) bool (Bernoulli 0.5) and ``shift``, an
      int in [1, B);
    - ``mask_lm``: ``word_sel`` and ``word_kind`` (B, T) f32 uniforms and
      ``word_rand`` (B, T) ids in [0, ``vocab_size``);
    - any visual task: ``obj_sel`` and ``obj_kind`` (B, K) f32 uniforms
      and ``obj_pick`` (B, K) rows of the (B * K) pool.
    """
    b, t = batch["input_ids"].shape
    b = rows or b
    k = batch["feats"].shape[1]
    draws = {}
    if "matched" in tasks:
        draws["flip"] = torch.rand(b, generator=generator) < 0.5
        draws["shift"] = int(torch.randint(1, b, (), generator=generator))
    if "mask_lm" in tasks:
        draws["word_sel"] = torch.rand(b, t, generator=generator)
        draws["word_kind"] = torch.rand(b, t, generator=generator)
        draws["word_rand"] = torch.randint(0, vocab_size, (b, t), generator=generator)
    if set(VISUAL_TASKS) & set(tasks):
        draws["obj_sel"] = torch.rand(b, k, generator=generator)
        draws["obj_kind"] = torch.rand(b, k, generator=generator)
        draws["obj_pick"] = torch.randint(0, b * k, (b, k), generator=generator)
    return draws


def local_pretrain_draws(draws: dict, mesh: Mesh = SINGLE) -> dict:
    """This rank's rows of the global batch's draws (``shift`` whole; the
    pool rows ``obj_pick`` stay indices into the global pool)."""
    if mesh.world == 1:
        return draws
    return {k: v if k == "shift" else v[mesh.rows(len(v))] for k, v in draws.items()}


def _on(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x.to(like.device, non_blocking=True)


def mask_words(input_ids: torch.Tensor, maskable: torch.Tensor, draws: dict, *,
               mask_id: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(masked ids, LM labels with -1 where no token was selected).
    ``maskable`` excludes the special tokens and padding (the reference
    masks only inner WordPieces, ``lxmert_pretrain.py:150-160``)."""
    selected = (_on(draws["word_sel"], input_ids) < WORD_MASK_RATE) & maskable.bool()
    kind = _on(draws["word_kind"], input_ids)
    random_ids = _on(draws["word_rand"], input_ids).to(input_ids.dtype)
    replacement = torch.where(kind < 0.8, torch.full_like(input_ids, mask_id),
                              torch.where(kind < 0.9, random_ids, input_ids))
    masked = torch.where(selected, replacement, input_ids)
    labels = torch.where(selected, input_ids, torch.full_like(input_ids, -1))
    return masked, labels


def mask_objects(feats: torch.Tensor, draws: dict, mesh: Mesh = SINGLE) -> tuple[torch.Tensor, torch.Tensor]:
    """(masked feats, f32 ``feat_mask`` (B, K) of the selected RoIs); the
    10% swaps take rows of the batch's own unmasked (B * K, D) pool (the
    global batch's under several ranks)."""
    b, k, d = feats.shape
    selected = _on(draws["obj_sel"], feats) < OBJ_MASK_RATE
    kind = _on(draws["obj_kind"], feats)
    pool = gather_rows(mesh, feats).reshape(-1, d)
    random_feats = pool[_on(draws["obj_pick"], feats).reshape(-1)].reshape(b, k, d)
    zero = (selected & (kind < 0.8))[..., None]
    swap = (selected & (kind >= 0.8) & (kind < 0.9))[..., None]
    masked = torch.where(zero, torch.zeros_like(feats), torch.where(swap, random_feats, feats))
    return masked, selected.to(torch.float32)


def matched_swap(input_ids, input_mask, segment_ids, ans, draws: dict, mesh: Mesh = SINGLE):
    """Cross-modal matching negatives (``lxmert_data.py:171-178``): on the
    ``flip`` rows the text fields are the batch's rolled by ``shift``
    (images stay), ``matched`` 0 and the QA answer -1.  Returns (ids,
    mask, segment ids, matched, ans)."""
    flip = _on(draws["flip"], input_ids)
    shift = draws["shift"]

    def swapped(x):
        return torch.where(flip[:, None], roll_rows(mesh, x, shift), x)

    matched = 1 - flip.to(torch.int64)
    out_ans = torch.where(flip, torch.full_like(ans, -1), ans)
    return swapped(input_ids), swapped(input_mask), swapped(segment_ids), matched, out_ans
