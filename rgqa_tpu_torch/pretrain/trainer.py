"""LXMERT pretraining trainer (port of ``rgqa_tpu/pretrain/trainer.py``;
reference ``src/pretrain/lxmert_pretrain.py``).

One step: the matched task's sentence swap, the word masking (on the
swapped ids and mask), the RoI masking, then ``LxmertPretraining``'s
forward at the run's dropout, :func:`~rgqa_tpu_torch.pretrain.losses.
pretrain_loss`, the backward (through the attention kernels' backward on
the card), the global clip and BertAdam.  The step's random numbers come
from the host (:func:`~rgqa_tpu_torch.pretrain.masking.
draw_pretrain_masks`) and are handed to the step as ``draws``.

:class:`PretrainRunner` keeps the JAX runner's data contract and epoch
loop: comma-joined ``--train`` splits concatenate; the answer-id space is
``<data_root>/all_ans.json`` filtered by ``--qaSets`` when the file is
there, else the GQA vocabulary; each row's pretraining answer id is
computed once (-1 outside the table); ``obj_id`` / ``attr_id`` come from
the feature pack; batches drop the last partial one and shuffle from
``np.random.default_rng(--seed)``.  The eval loss runs with dropout off
on masks drawn from a generator seeded afresh to the same seed for every
batch, as the JAX runner passes ``PRNGKey(0)`` to each, so eval losses
compare across epochs.  Per epoch it prints ``Epoch NN: train {...} |
eval loss X`` and writes ``<output>/EpochNN_LXRT.pth``, and
``<output>/BEST_EVAL_LOSS_LXRT.pth`` on a lower eval loss: reference
``model_LXRT.pth`` files (the JAX runner writes orbax directories of the
same names, less the suffix), which ``--loadLXMERTQA
<output>/BEST_EVAL_LOSS`` reads in the GQA and VQA runners.

Data parallel (``torchrun``, :mod:`rgqa_tpu_torch.parallel`): every rank
reads its rows of each global batch (``--batchSize``, which the world
divides) and draws the global batch's masks from the shared generator;
the masked-LM, matched and QA losses divide by the global count of
valid labels, the gradients are averaged before the clip, and the eval
loss is the global batch's.  Rank 0 alone writes the ``.pth`` files.

The special ids that are never masked are the vocabulary's ``[PAD]``,
``[UNK]``, ``[CLS]``, ``[SEP]`` and ``[MASK]``: the JAX runner keeps its
step's default 0-4, the synthetic vocabulary's (the same ids there), which
in BERT's vocabulary are ``[PAD]`` and four unused tokens.

``--wordMaskRate`` / ``--objMaskRate`` are parsed by the JAX CLI but
never reach its masking (its runner masks words and RoIs at 0.15
whatever they say); the port runs at 0.15 too and refuses any other
value by name rather than ignore it.  ``--train_chunk`` / ``--eval_chunk``
and ``--feed_int8`` are refused as in the GQA runner.
"""

from __future__ import annotations

import os
import weakref
from typing import Optional

import numpy as np
import torch

from rgqa_tpu_torch.checkpoint.convert import to_reference_state_dict
from rgqa_tpu_torch.config import RunConfig
from rgqa_tpu_torch.data.batching import batch_iterator, device_prefetch
from rgqa_tpu_torch.data.dataset import EncodedGQA, GQADataset
from rgqa_tpu_torch.data.synthetic import make_synthetic_gqa
from rgqa_tpu_torch.data.tokenizer import CLS, MASK, PAD, SEP, UNK, WordPieceTokenizer, load_vocab
from rgqa_tpu_torch.data.tsv import PackedFeatures
from rgqa_tpu_torch.device import resolve_device
from rgqa_tpu_torch.models.lxmert import LxmertPretraining
from rgqa_tpu_torch.models.zoo import init_weights, module_mode
from rgqa_tpu_torch.ops.dropout import DropoutRng
from rgqa_tpu_torch.parallel.mesh import (
    SINGLE,
    Mesh,
    all_sum,
    check_batch_size,
    make_mesh,
    on_main,
    reduce_gradients,
    shard_params,
)
from rgqa_tpu_torch.pretrain.answer_table import AnswerTable
from rgqa_tpu_torch.pretrain.losses import pretrain_loss
from rgqa_tpu_torch.pretrain.masking import (
    OBJ_MASK_RATE,
    VISUAL_TASKS,
    WORD_MASK_RATE,
    draw_pretrain_masks,
    local_pretrain_draws,
    mask_objects,
    mask_words,
    matched_swap,
)
from rgqa_tpu_torch.runner import check_ported
from rgqa_tpu_torch.train.optimizer import make_optimizer
from rgqa_tpu_torch.train.step import global_norm_clip

__all__ = ["ALL_TASKS", "apply_pretrain_masks", "make_pretrain_step", "PretrainRunner"]

ALL_TASKS = ("mask_lm", "matched", "obj", "attr", "feat", "qa")
SPECIAL_IDS = (0, 1, 2, 3, 4)  # [PAD] [UNK] [CLS] [SEP] [MASK] of the synthetic vocab: never masked
EVAL_MASK_SEED = 0  # every eval batch's masks: the JAX runner's PRNGKey(0)


def apply_pretrain_masks(batch: dict, draws: dict, tasks=ALL_TASKS, *, mask_id: int = 4,
                         special_ids=SPECIAL_IDS, mesh: Mesh = SINGLE) -> dict:
    """The model inputs and the labels of one step from ``draws``, in the
    JAX step's order: the matched swap, then ``maskable = mask > 0 and not
    a special id`` on the *swapped* ids and mask, the word masking, the
    RoI masking.  Returns ``input_ids``, ``input_mask``, ``segment_ids``,
    ``feats`` (masked), ``ans`` and the labels ``lm_labels``, ``matched``,
    ``feat_mask`` (None where their task is off).  Under several ranks
    (``mesh``) ``batch`` is this rank's rows and ``draws`` the global
    batch's."""
    draws = local_pretrain_draws(draws, mesh)
    ids, mask, seg, ans = batch["input_ids"], batch["input_mask"], batch["segment_ids"], batch["ans"]
    matched = lm_labels = feat_mask = None
    if "matched" in tasks:
        ids, mask, seg, matched, ans = matched_swap(ids, mask, seg, ans, draws, mesh)
    if "mask_lm" in tasks:
        special = torch.tensor(special_ids, dtype=ids.dtype, device=ids.device)
        maskable = (mask > 0) & ~torch.isin(ids, special)
        ids, lm_labels = mask_words(ids, maskable, draws, mask_id=mask_id)
    feats = batch["feats"]
    if set(VISUAL_TASKS) & set(tasks):
        feats, feat_mask = mask_objects(feats, draws, mesh)
    return {"input_ids": ids, "input_mask": mask, "segment_ids": seg, "feats": feats, "ans": ans,
            "lm_labels": lm_labels, "matched": matched, "feat_mask": feat_mask}


def make_pretrain_step(
    model: LxmertPretraining,
    optimizer: torch.optim.Optimizer,
    *,
    tasks=ALL_TASKS,
    mask_id: int = 4,
    special_ids=SPECIAL_IDS,
    grad_clip: float = 5.0,
    rng: Optional[DropoutRng] = None,
    use_fused: Optional[bool] = None,
    mesh: Mesh = SINGLE,
):
    """``(step, eval_loss)`` over dict batches with ``input_ids``,
    ``input_mask``, ``segment_ids``, ``feats``, ``boxes``, ``obj_id``,
    ``attr_id`` and ``ans`` (JAX ``make_pretrain_step``).

    ``step(batch, draws) -> {task: loss}`` (detached) runs the forward in
    training mode (dropout from ``rng``), the backward, the global clip at
    ``grad_clip`` and ``optimizer``'s step; ``eval_loss(batch, draws) ->
    (total, {task: loss})`` the forward alone in eval mode.  ``draws``:
    :func:`~rgqa_tpu_torch.pretrain.masking.draw_pretrain_masks`'s.
    ``use_fused=False`` runs the attention's plain versions.  ``mesh``:
    data parallel, ``batch`` this rank's rows, ``draws`` the global
    batch's; ``step`` returns the global batch's losses, ``eval_loss``
    this rank's share (the ranks' mean is the global loss)."""
    rng = rng or DropoutRng()
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def loss_fn(batch: dict, draws: dict, deterministic: bool):
        m = apply_pretrain_masks(batch, draws, tasks, mask_id=mask_id, special_ids=special_ids, mesh=mesh)
        with module_mode(model, deterministic):
            out = model(m["input_ids"], m["input_mask"], m["segment_ids"], m["feats"], batch["boxes"],
                        rng=rng, use_fused=use_fused)
        return pretrain_loss(
            out, lm_labels=m["lm_labels"], matched=m["matched"], obj_labels=batch.get("obj_id"),
            attr_labels=batch.get("attr_id"), feat_target=batch["feats"].float(), feat_mask=m["feat_mask"],
            ans=m["ans"], tasks=tasks, mesh=mesh,
        )

    def step(batch: dict, draws: dict) -> dict:
        total, parts = loss_fn(batch, draws, False)
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        values = reduce_gradients(mesh, params, list(parts.values()))
        if grad_clip:
            global_norm_clip(params, grad_clip)
        optimizer.step()
        return dict(zip(parts, values))

    @torch.no_grad()
    def eval_loss(batch: dict, draws: dict):
        return loss_fn(batch, draws, True)

    return step, eval_loss


class PretrainRunner:
    """Multi-task LXMERT pretraining over GQA-format splits on one device
    (default: the card).  The reference pretrains on mscoco + vgnococo
    caption / QA data (``lxmert_data.py:18-23``); the data contract here
    is the question-JSON + packed-feature layout, so GQA (or synthetic)
    splits pretrain directly."""

    def __init__(self, cfg: RunConfig, tasks=ALL_TASKS, *, device: Optional[torch.device | str] = None,
                 word_mask_rate: float = WORD_MASK_RATE, obj_mask_rate: float = OBJ_MASK_RATE):
        for flag, rate, fixed in (("--wordMaskRate", word_mask_rate, WORD_MASK_RATE),
                                  ("--objMaskRate", obj_mask_rate, OBJ_MASK_RATE)):
            if rate != fixed:
                raise NotImplementedError(
                    f"{flag} {rate}: the JAX package parses it but masks at {fixed} whatever it says (its "
                    f"PretrainRunner never passes the rate on); the port masks at {fixed} and refuses any "
                    "other value"
                )
        check_ported(cfg, train=True)
        self.cfg = cfg
        self.tasks = tuple(tasks)
        self.device = resolve_device(device)
        self.mesh = make_mesh(self.device, model=cfg.mesh.model_axis)
        check_batch_size(self.mesh, cfg.train.batch_size)
        root = cfg.data.data_root

        def write_root():
            if cfg.data.synthetic and not os.path.exists(os.path.join(root, "trainval_ans2label.json")):
                make_synthetic_gqa(root)

        on_main(self.mesh, write_root)
        self.features = PackedFeatures(os.path.join(root, "features"))
        vocab = load_vocab(os.path.join(root, "vocab.txt"))
        self.tokenizer = WordPieceTokenizer(vocab)
        self.mask_id = vocab[MASK]
        # The vocabulary's own special ids (BERT's: 0, 100-103), where the
        # JAX runner keeps its step's default 0-4, which are the synthetic
        # vocabulary's and would let a real one mask [CLS] and [SEP].
        self.special_ids = tuple(vocab[t] for t in (PAD, UNK, CLS, SEP, MASK))

        # Multi-source semantics (lxmert_data.py:40-57): comma-joined
        # splits concatenate; the answer-id space is all_ans.json filtered
        # by --qaSets (lower-cased and stripped, lxmert_pretrain.py:27-29)
        # when the file is there, else the GQA vocabulary.
        ds = GQADataset(root, cfg.data.train_splits)
        all_ans_path = os.path.join(root, "all_ans.json")
        if os.path.exists(all_ans_path):
            qa_sets = cfg.data.qa_sets
            dsets = set(s.lower().strip() for s in qa_sets.split(",")) if qa_sets else None
            self.answer_table = AnswerTable(dsets, path=all_ans_path)
        else:
            self.answer_table = AnswerTable(answers=ds.label2ans)
        max_len = cfg.model.max_text_len
        self.train_set = EncodedGQA(ds, self.features, tokenizer=self.tokenizer, max_text_len=max_len)
        self.valid_set = EncodedGQA(GQADataset(root, cfg.data.valid_splits), self.features,
                                    tokenizer=self.tokenizer, max_text_len=max_len)

        dtype = torch.bfloat16 if cfg.train.use_bf16 else torch.float32
        with self.device:
            self.model = LxmertPretraining(cfg.model.encoder, num_answers=self.answer_table.num_answers,
                                           dtype=dtype)
        init_weights(self.model, torch.Generator(device=self.device).manual_seed(cfg.train.seed))
        shard_params(self.mesh, self.model)
        self.model.eval()  # train() switches it to training mode for its steps
        # Per-row answer ids, computed once per encoded split.
        self._ans_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        self.output = cfg.output
        os.makedirs(self.output, exist_ok=True)

    def answer_ids(self, encoded: EncodedGQA) -> np.ndarray:
        """Each row's pretraining answer id: its first label's answer
        through ``AnswerTable.convert_ans``, -1 outside the table or for a
        row without a label (the reference looks it up per batch,
        ``lxmert_pretrain.py:239-247``)."""
        ans = self._ans_cache.get(encoded)
        if ans is None:
            ans = np.full((len(encoded),), -1, np.int32)
            for i in range(len(encoded)):
                li = encoded.label_idx[i, 0]
                if li >= 0:
                    key = self.answer_table.convert_ans(encoded.dataset.label2ans[li])
                    if self.answer_table.used(key):
                        ans[i] = self.answer_table.ans2id(key)
            self._ans_cache[encoded] = ans
        return ans

    def host_batch(self, encoded: EncodedGQA, idx: np.ndarray) -> dict:
        """A pretraining host batch: the encoded text and RoIs, the RoIs'
        detected object and attribute ids, the rows' answer ids."""
        batch = encoded.gather_batch(idx, with_target=False)
        rows = encoded.img_row[idx]
        batch["obj_id"] = np.asarray(self.features.objects_id[rows], np.int32)
        batch["attr_id"] = np.asarray(self.features.attrs_id[rows], np.int32)
        batch["ans"] = self.answer_ids(encoded)[idx]
        return batch

    class _FeedView:
        """The ``batch_iterator`` protocol (``question_ids``, ``len``,
        ``gather_batch``) over :meth:`PretrainRunner.host_batch`."""

        def __init__(self, runner: "PretrainRunner", encoded: EncodedGQA):
            self._runner, self._encoded = runner, encoded
            self.question_ids = encoded.question_ids

        def __len__(self) -> int:
            return len(self._encoded)

        def gather_batch(self, idx, with_target=False):
            return self._runner.host_batch(self._encoded, idx)

    def batches(self, encoded: EncodedGQA, batch_size: int, *, shuffle: bool, rng=None):
        """Device batches of ``encoded``, the last partial one dropped
        (this rank's rows of each under several ranks)."""
        items = batch_iterator(self._FeedView(self, encoded), batch_size, shuffle=shuffle, rng=rng,
                               drop_last=True, mesh=self.mesh)
        for _, batch, _ in device_prefetch(items, self.device):
            yield batch

    def train_draws(self, batch: dict, generator: torch.Generator) -> dict:
        """A training step's masks, from the run's host generator (the
        global batch's)."""
        return draw_pretrain_masks(batch, self.tasks, vocab_size=self.cfg.model.encoder.vocab_size,
                                   generator=generator, rows=len(batch["input_ids"]) * self.mesh.world)

    def eval_draws(self, batch: dict) -> dict:
        """An eval batch's masks: the same seed for every batch and epoch."""
        return draw_pretrain_masks(batch, self.tasks, vocab_size=self.cfg.model.encoder.vocab_size,
                                   generator=torch.Generator().manual_seed(EVAL_MASK_SEED),
                                   rows=len(batch["input_ids"]) * self.mesh.world)

    def save(self, name: str) -> str:
        """``<output>/<name>_LXRT.pth``, a reference ``model_LXRT.pth``
        (rank 0 writes it)."""
        enc = self.cfg.model.encoder
        path = os.path.join(self.output, f"{name}_LXRT.pth")
        on_main(self.mesh, lambda: torch.save(to_reference_state_dict(
            self.model.state_dict(), backbone="lxmert_pretrain", l_layers=enc.l_layers, x_layers=enc.x_layers,
            r_layers=enc.r_layers), path))
        return path

    def train(self) -> dict:
        """``--epochs`` of pretraining; returns ``{"train": [the last
        step's losses per epoch], "eval": [the mean eval total per
        epoch]}``."""
        tcfg = self.cfg.train
        n_batches = len(self.train_set) // tcfg.batch_size
        optimizer = make_optimizer(tcfg.optim, self.model.parameters(), max(n_batches * tcfg.epochs, 1))
        rng = DropoutRng.for_rank(tcfg.seed, self.device, rank=self.mesh.rank, world=self.mesh.world)
        step, eval_loss = make_pretrain_step(self.model, optimizer, tasks=self.tasks, mask_id=self.mask_id,
                                             special_ids=self.special_ids, grad_clip=tcfg.optim.grad_clip,
                                             rng=rng, mesh=self.mesh)
        shuffle = np.random.default_rng(tcfg.seed)
        best_eval = float("inf")
        history = {"train": [], "eval": []}
        try:
            for epoch in range(tcfg.epochs):
                parts = {}
                for batch in self.batches(self.train_set, tcfg.batch_size, shuffle=True, rng=shuffle):
                    parts = step(batch, self.train_draws(batch, rng.host))
                train_parts = {k: float(v) for k, v in parts.items()}
                history["train"].append(train_parts)
                # Device scalars collect in a list and are read once at the end.
                totals = [eval_loss(batch, self.eval_draws(batch))[0]
                          for batch in self.batches(self.valid_set, tcfg.batch_size, shuffle=False)]
                if totals and self.mesh.world > 1:  # each rank's share: the global batches' totals
                    totals = (all_sum(self.mesh, torch.stack(totals)) / self.mesh.world).unbind()
                avg = float(np.mean([float(t) for t in totals])) if totals else 0.0
                history["eval"].append(avg)
                if self.mesh.is_main:
                    print(f"Epoch {epoch:02d}: train {train_parts} | eval loss {avg:.4f}", flush=True)
                if avg < best_eval:
                    best_eval = avg
                    self.save("BEST_EVAL_LOSS")
                self.save(f"Epoch{epoch:02d}")
        finally:
            self.model.eval()
        return history
