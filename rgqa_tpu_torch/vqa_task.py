"""VQA v2 task (port of ``rgqa_tpu/vqa_task.py``): fine-tune, predict and
evaluate LXMERT on VQA-format data.

- Rows are ``{answer_type, img_id, label: {ans: score}, question_id: int,
  question_type, sent}`` with 10-annotator soft scores: GQA's contract, so
  :class:`~rgqa_tpu_torch.data.dataset.GQADataset` (no UQ class: VQA's
  vocabulary is closed) and ``EncodedGQA`` (``keep_uq_target``: no UQ
  column to slice off) read them; question ids stay integers.
- The model is LXMERT with the 2-layer answer head (``vqa_model.py:15-33``,
  the GQA head), built by ``models.zoo.build_model`` with f32 weights
  (bf16 compute unless ``--fp32``), as the JAX runner keeps its params.
  LXMERT is the one backbone: every VQA recipe runs it
  (``scripts/vqa/**``); another ``--backbone`` is refused by name.
- Training is BCE-with-logits x answers, the global clip 5.0 and
  ``--optim`` (BertAdam with warmup by default), dropout at
  ``--dropout`` (``vqa.py:63-113``); the train score comes from each
  step's argmax, read a few steps behind the dispatch front.  Each epoch
  validates; ``BEST.pth`` on a better valid score and ``LAST.pth`` at the
  end, reference ``.pth`` files (the JAX runner writes orbax
  directories), and ``log.log`` lines in the reference format.
- :class:`VQAEvaluator` scores ``sum(label.get(ans)) / N`` and dumps the
  VQA-challenge submission ``[{"question_id": int, "answer": str}]`` with
  ``indent=4, sort_keys=True`` (``vqa_data.py:154-188``): the JAX
  class's source.
- Initial weights: ``--load`` a reference VQA / GQA ``.pth`` (an orbax
  directory through its ``orbax_to_pth.py`` export ``<dir>.pth``; refused,
  naming the command, without it), else
  ``--loadLXMERTQA <prefix>`` (``<prefix>_LXRT.pth`` when ``<prefix>``
  lacks ``.pth``): with ``<data_root>/all_ans.json`` the answer rows are
  transplanted by answer string, without it the encoder alone loads
  (``vqa.py:45-51``); or ``--loadLXMERT``, the encoder.
- ``--train_chunk`` / ``--eval_chunk`` > 1 and ``--feed_int8`` are
  refused by name, as in the GQA runner.

Everything runs on the card unless the caller asks for the CPU.  Under
N data-parallel ranks (``torchrun``, :mod:`rgqa_tpu_torch.parallel`) each
rank trains on its rows of every global batch with the gradients
averaged, predictions gather every rank's rows (the train score and the
validation are the whole split's on every rank), and rank 0 alone writes
the ``.pth`` files, ``log.log`` and the submission dumps.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
from typing import Optional

import numpy as np
import torch

from rgqa_tpu_torch.checkpoint.convert import (
    load_lxmert_pretrained,
    load_lxmert_qa,
    load_reference_pth,
    lxrt_path,
    orbax_refusal,
)
from rgqa_tpu_torch.config import RunConfig, dump_run_config
from rgqa_tpu_torch.data.batching import batch_iterator, device_prefetch
from rgqa_tpu_torch.data.dataset import EncodedGQA, GQADataset, build_targets
from rgqa_tpu_torch.data.synthetic import make_synthetic_vqa
from rgqa_tpu_torch.data.tokenizer import WordPieceTokenizer, load_vocab
from rgqa_tpu_torch.data.tsv import PackedFeatures
from rgqa_tpu_torch.device import resolve_device
from rgqa_tpu_torch.models.zoo import build_model
from rgqa_tpu_torch.ops.dropout import DropoutRng
from rgqa_tpu_torch.parallel.mesh import check_batch_size, gather_rows, make_mesh, on_main, shard_params
from rgqa_tpu_torch.pretrain.answer_table import AnswerTable
from rgqa_tpu_torch.runner import check_ported, pth_path
from rgqa_tpu_torch.train.optimizer import make_optimizer
from rgqa_tpu_torch.train.state import save_reference_pth
from rgqa_tpu_torch.train.step import make_train_step

__all__ = ["VQAEvaluator", "VQARunner"]


class VQAEvaluator:
    """Soft-score accuracy + submission dump (``vqa_data.py:154-188``)."""

    def __init__(self, dataset: GQADataset):
        self.dataset = dataset

    def evaluate(self, quesid2ans: dict) -> float:
        score = 0.0
        for quesid, ans in quesid2ans.items():
            datum = self.dataset.id2datum[quesid]
            label = datum.get("label", {})
            if ans in label:
                score += label[ans]
        return score / len(quesid2ans) if quesid2ans else 0.0

    def dump_result(self, quesid2ans: dict, path: str) -> None:
        """VQA online-evaluation submission format — exact reference
        serialization (``vqa_data.py:166-188``)."""
        with open(path, "w") as f:
            result = [
                {"question_id": ques_id, "answer": ans}
                for ques_id, ans in quesid2ans.items()
            ]
            json.dump(result, f, indent=4, sort_keys=True)


class VQARunner:
    """Train / predict / evaluate driver for VQA (reference ``vqa.py:33-214``)
    on one device (default: the card)."""

    def __init__(self, cfg: RunConfig, *, init_train: bool = True,
                 device: Optional[torch.device | str] = None):
        check_ported(cfg, train=init_train, extra={
            f"--backbone {cfg.model.backbone} for VQA (every VQA recipe runs LXMERT)":
                cfg.model.backbone != "lxmert",
        })
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = make_mesh(self.device, model=cfg.mesh.model_axis)
        check_batch_size(self.mesh, cfg.train.batch_size)
        data = cfg.data
        root = data.data_root

        def write_root():
            if data.synthetic and not os.path.exists(os.path.join(root, "trainval_ans2label.json")):
                make_synthetic_vqa(root)

        on_main(self.mesh, write_root)
        self.features = PackedFeatures(os.path.join(root, "features"))
        if data.tiny:
            self.features = self.features.truncate(512)
        elif data.fast:
            self.features = self.features.truncate(5000)
        self.tokenizer = WordPieceTokenizer(load_vocab(os.path.join(root, "vocab.txt")))

        splits = data.train_splits if init_train else (data.test_splits or data.valid_splits)
        self.dataset = GQADataset(root, splits, add_uq=False)
        self.label2ans = self.dataset.label2ans
        self.model_cfg = dataclasses.replace(cfg.model, num_answers=self.dataset.num_answers)
        self.model, self.forward = build_model(
            self.model_cfg, use_bf16=cfg.train.use_bf16, device=self.device,
            generator=torch.Generator(device=self.device).manual_seed(cfg.train.seed), train=True,
        )
        self.model.eval()  # train() switches it to training mode for its epochs
        self._load_initial_weights()
        shard_params(self.mesh, self.model)
        self.output = cfg.output
        os.makedirs(self.output, exist_ok=True)
        on_main(self.mesh, dump_run_config, cfg, self.output)
        self._encoded: dict[str, EncodedGQA] = {}

    def _load_initial_weights(self) -> None:
        """``--load``, else ``--loadLXMERTQA`` or ``--loadLXMERT`` (JAX
        ``_load_initial_weights``, ``vqa_task.py:151-199``)."""
        cfg, enc = self.cfg, self.model_cfg.encoder
        layers = dict(l_layers=enc.l_layers, x_layers=enc.x_layers, r_layers=enc.r_layers)
        if cfg.load:
            self.load(cfg.load)
            return
        if cfg.load_lxmert_qa:
            path = cfg.load_lxmert_qa
            if not path.endswith(".pth") and os.path.exists(path + "_LXRT.pth"):
                path = path + "_LXRT.pth"  # the reference's "%s_LXRT.pth" suffix
            table_path = os.path.join(cfg.data.data_root, "all_ans.json")
            if os.path.exists(table_path):
                table = AnswerTable(path=table_path)
                head = self.model.answer_head.logits
                sd, loaded, zeroed = load_lxmert_qa(
                    path, self.label2ans, head.weight, head.bias, src_ans2id=table.ans2id_map(),
                    convert_ans=table.convert_ans, **layers)
                print(f"Loaded {loaded} answers from LXRTQA pre-training and {zeroed} not")
            else:
                sd, _, _ = load_lxmert_pretrained(path, **layers)
        elif cfg.load_lxmert:
            sd, _, _ = load_lxmert_pretrained(lxrt_path(cfg.load_lxmert), **layers)
        else:
            return
        self.model.load_state_dict(sd, strict=False)

    def encoded(self, split: str) -> EncodedGQA:
        if split not in self._encoded:
            ds = GQADataset(self.cfg.data.data_root, split, add_uq=False)
            self._encoded[split] = EncodedGQA(
                ds, self.features, tokenizer=self.tokenizer, max_text_len=self.cfg.model.max_text_len,
                keep_uq_target=True,  # no UQ column to slice off
            )
        return self._encoded[split]

    def evaluator(self, split: str) -> VQAEvaluator:
        return VQAEvaluator(self.encoded(split).dataset)

    def _batches(self, encoded: EncodedGQA, batch_size: int, **kw):
        return device_prefetch(batch_iterator(encoded, batch_size, mesh=self.mesh, **kw), self.device)

    # ------------------------------------------------------------------

    def train(self, train_split: Optional[str] = None, valid_split: Optional[str] = None) -> dict:
        """``--epochs`` of fine-tuning; returns ``{"loss": [the last step's
        loss per epoch], "train": [train scores], "valid": [valid
        scores]}``."""
        tcfg = self.cfg.train
        train_split = train_split or self.cfg.data.train_splits
        valid_split = valid_split or self.cfg.data.valid_splits
        train_set = self.encoded(train_split)
        evaluator = self.evaluator(train_split)
        n_batches = max(len(train_set) // tcfg.batch_size, 1)
        optimizer = make_optimizer(tcfg.optim, self.model.parameters(), n_batches * tcfg.epochs)
        rng = DropoutRng.for_rank(tcfg.seed, self.device, rank=self.mesh.rank, world=self.mesh.world)
        step = make_train_step(self.forward, optimizer, grad_clip=tcfg.optim.grad_clip, rng=rng, mesh=self.mesh)
        shuffle = np.random.default_rng(tcfg.seed)
        best_valid = 0.0
        history = {"loss": [], "train": [], "valid": []}
        for epoch in range(tcfg.epochs):
            loss = math.nan
            quesid2ans: dict = {}
            # Train-score labels are read a few steps behind the dispatch
            # front, so the copy overlaps the device's work.
            pending: collections.deque = collections.deque()

            def drain(item):
                qids0, labels0, real0 = item
                for qid, label in zip(qids0, labels0[:real0].tolist()):
                    quesid2ans[qid] = self.label2ans[label]

            self.model.train()
            try:
                for qids, batch, real in self._batches(train_set, tcfg.batch_size, shuffle=True, rng=shuffle,
                                                       drop_last=True, with_target=True):
                    aux = step(batch)
                    loss = aux["loss"]
                    pending.append((qids, gather_rows(self.mesh, aux["label"]), real))
                    while len(pending) > 4:
                        drain(pending.popleft())
            finally:
                self.model.eval()
            while pending:
                drain(pending.popleft())
            train_score = evaluator.evaluate(quesid2ans)
            history["loss"].append(float(loss))
            history["train"].append(train_score)
            log_str = f"\nEpoch {epoch}: Train {train_score * 100.0:0.2f}\n"
            if valid_split:
                valid_score = self.evaluate(valid_split)
                history["valid"].append(valid_score)
                if valid_score > best_valid:
                    best_valid = valid_score
                    self.save("BEST")
                log_str += (
                    f"Epoch {epoch}: Valid {valid_score * 100.0:0.2f}\n"
                    f"Epoch {epoch}: Best {best_valid * 100.0:0.2f}\n"
                )
            on_main(self.mesh, self._log, log_str)
        self.save("LAST")
        return history

    def _log(self, log_str: str) -> None:
        print(log_str, end="", flush=True)
        with open(os.path.join(self.output, "log.log"), "a") as f:
            f.write(log_str)

    def predict(self, split: str, dump: Optional[str] = None) -> dict:
        """``{question_id: answer}`` of the argmax logit, at batch
        ``min(len(split), --batchSize)`` (rounded up to a multiple of the
        world under several ranks, which gather their rows); ``dump``
        writes the submission."""
        encoded = self.encoded(split)
        quesid2ans: dict = {}

        def fetch(item):
            qids, labels, real = item
            for qid, label in zip(qids, labels[:real].tolist()):
                quesid2ans[qid] = self.label2ans[label]

        pending = None
        with torch.inference_mode():
            world = self.mesh.world
            size = -(-min(len(encoded), self.cfg.train.batch_size) // world) * world
            for qids, batch, real in self._batches(encoded, size):
                logits = self.forward(batch, deterministic=True)["logits"].float()
                current = (qids, gather_rows(self.mesh, torch.argmax(logits, dim=-1)), real)
                if pending is not None:  # one batch behind the dispatch front
                    fetch(pending)
                pending = current
        if pending is not None:
            fetch(pending)
        if dump is not None:
            on_main(self.mesh, self.evaluator(split).dump_result, quesid2ans, dump)
        return quesid2ans

    def evaluate(self, split: str, dump: Optional[str] = None) -> float:
        return self.evaluator(split).evaluate(self.predict(split, dump))

    def oracle_score(self, split: str) -> float:
        """Upper bound from the targets alone (``vqa.py:160-169``)."""
        encoded = self.encoded(split)
        target = build_targets(encoded.label_idx, encoded.label_score, encoded.num_answers)
        best = np.argmax(target, axis=-1)
        quesid2ans = {qid: self.label2ans[int(l)] for qid, l in zip(encoded.question_ids, best)}
        return self.evaluator(split).evaluate(quesid2ans)

    def save(self, name: str) -> str:
        """``<output>/<name>.pth`` in the reference GQA / VQA layout (rank 0
        writes it)."""
        path = os.path.join(self.output, f"{name}.pth")
        on_main(self.mesh, save_reference_pth, self.model, self.model_cfg, path)
        return path

    def load(self, path: str) -> list[str]:
        """A reference VQAModel (or GQA) ``.pth``: the same key layout
        (``vqa_model.py:15-33``); ``path`` less its ``.pth`` takes the file
        (the recipe scripts' ``--load <run>/BEST``).  Returns the keys it
        lacked."""
        path = pth_path(path)
        if not os.path.isfile(path):
            raise orbax_refusal("--load", path, path + ".pth")
        enc = self.model_cfg.encoder
        sd, missing, unused = load_reference_pth(path, l_layers=enc.l_layers, x_layers=enc.x_layers,
                                                 r_layers=enc.r_layers)
        self.model.load_state_dict(sd, strict=False)
        if missing:
            print(f"Weights not found in ckpt: {missing[:5]}...")
        if unused:
            print(f"Ckpt weights unused: {unused[:5]}...")
        return missing
