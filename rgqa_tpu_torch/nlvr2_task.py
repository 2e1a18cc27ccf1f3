"""NLVR2 task (port of ``rgqa_tpu/nlvr2_task.py``): two-image true / false
reasoning.

Rows are ``{uid, img0, img1, sent, label}`` (and, in the real data, an
``identifier``); the model is the two-image LXMERT
(:class:`~rgqa_tpu_torch.models.nlvr2.Nlvr2Model`) trained with 2-way CE
x 2 and scored by exact accuracy (reference ``nlvr2.py:106-133``).  The
JAX package has no NLVR2 CLI, and neither has the port:
:class:`Nlvr2Runner` is the entry point, on the card unless the caller
asks for the CPU.

Checkpoints: ``<output>/BEST.pth`` on a better valid accuracy and
``LAST.pth`` at the end, in the port's own layout after the reference
NLVR2 model's names (``lxrt_encoder.model.bert.*`` and ``logit_fc.0 / .2
/ .3`` for ``fc1`` / ``ln`` / ``fc2``; ``checkpoint.convert.
nlvr2_key_map``): the JAX package writes orbax directories and reads no
NLVR2 ``.pth``.  ``--train_chunk`` / ``--eval_chunk`` > 1 and
``--feed_int8`` are refused by name, as on the other runners.

Under N data-parallel ranks each rank takes its rows of every global
batch (a row's two images stay together: the 2B-row fold is within the
rank's rows), the gradients are averaged before the clip, predictions
gather every rank's rows, and rank 0 alone writes the ``.pth`` files and
the CSV.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from rgqa_tpu_torch.checkpoint.convert import to_reference_state_dict
from rgqa_tpu_torch.config import RunConfig, dump_run_config
from rgqa_tpu_torch.data.batching import device_prefetch
from rgqa_tpu_torch.data.tokenizer import WordPieceTokenizer, load_vocab
from rgqa_tpu_torch.data.tsv import PackedFeatures
from rgqa_tpu_torch.device import resolve_device
from rgqa_tpu_torch.models.nlvr2 import Nlvr2Model
from rgqa_tpu_torch.models.zoo import init_weights, module_mode
from rgqa_tpu_torch.ops.dropout import DropoutRng
from rgqa_tpu_torch.parallel.mesh import (
    SINGLE,
    Mesh,
    check_batch_size,
    gather_rows,
    make_mesh,
    on_main,
    reduce_gradients,
    shard_params,
)
from rgqa_tpu_torch.runner import check_ported
from rgqa_tpu_torch.train.optimizer import make_optimizer
from rgqa_tpu_torch.train.step import global_norm_clip

__all__ = ["EncodedNLVR2", "Nlvr2Runner"]

PREDICT_BATCH = 32  # predict's batch (the reference's), or the split's size if smaller


class EncodedNLVR2:
    """NLVR2 rows encoded to fixed-shape arrays, two feature rows each;
    rows whose images the pack lacks are dropped.  Boxes are normalized
    by each image's size (x by the width, y by the height) and clipped to
    [0, 1]."""

    def __init__(self, rows, features: PackedFeatures, tokenizer, max_text_len: int = 20):
        rows = [r for r in rows if r["img0"] in features and r["img1"] in features]
        self.rows = rows
        self.features = features
        self.uids = [r["uid"] for r in rows]
        self.input_ids, self.input_mask, self.segment_ids = tokenizer.encode_batch(
            [r["sent"] for r in rows], max_text_len)
        self.img_rows = np.asarray([(features.index[r["img0"]], features.index[r["img1"]]) for r in rows],
                                   np.int32).reshape(-1, 2)
        self.labels = np.asarray([int(r["label"]) for r in rows], np.int32)
        sizes = np.asarray(features.sizes, np.float32)
        boxes = np.asarray(features.boxes, np.float32).copy()
        boxes[:, :, (0, 2)] /= sizes[:, None, 1:2]
        boxes[:, :, (1, 3)] /= sizes[:, None, 0:1]
        self.norm_boxes = np.clip(boxes, 0.0, 1.0)

    def __len__(self) -> int:
        return len(self.rows)

    def gather_batch(self, idx: np.ndarray) -> dict:
        rows = self.img_rows[idx].reshape(-1)  # (2B,): image 0 then 1 of each pair
        feats = np.asarray(self.features.features[rows], np.float32)
        boxes = self.norm_boxes[rows]
        b = len(idx)
        return {
            "input_ids": self.input_ids[idx],
            "input_mask": self.input_mask[idx],
            "segment_ids": self.segment_ids[idx],
            "feats": feats.reshape(b, 2, *feats.shape[1:]),
            "boxes": boxes.reshape(b, 2, *boxes.shape[1:]),
            "label": self.labels[idx],
        }


class Nlvr2Runner:
    """Train / predict / evaluate / dump for NLVR2 over ``rows_by_split``
    (``{split name: rows}``) on one device (default: the card)."""

    def __init__(self, cfg: RunConfig, rows_by_split: dict, *, device: Optional[torch.device | str] = None):
        check_ported(cfg, train=True)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = make_mesh(self.device, model=cfg.mesh.model_axis)
        check_batch_size(self.mesh, cfg.train.batch_size)
        root = cfg.data.data_root
        self.features = PackedFeatures(os.path.join(root, "features"))
        self.tokenizer = WordPieceTokenizer(load_vocab(os.path.join(root, "vocab.txt")))
        self.splits = {name: EncodedNLVR2(rows, self.features, self.tokenizer, cfg.model.max_text_len)
                       for name, rows in rows_by_split.items()}
        dtype = torch.bfloat16 if cfg.train.use_bf16 else torch.float32
        with self.device:
            self.model = Nlvr2Model(cfg.model.encoder, dtype)
        init_weights(self.model, torch.Generator(device=self.device).manual_seed(cfg.train.seed))
        shard_params(self.mesh, self.model)
        self.model.eval()  # train() switches it to training mode for its epochs
        self.output = cfg.output
        os.makedirs(self.output, exist_ok=True)
        on_main(self.mesh, dump_run_config, cfg, self.output)

    def forward(self, batch: dict, *, deterministic: Optional[bool] = None, **kw) -> dict:
        with module_mode(self.model, deterministic):
            return self.model(batch["input_ids"], batch["input_mask"], batch["segment_ids"], batch["feats"],
                              batch["boxes"], **kw)

    def _batches(self, encoded: EncodedNLVR2, batch_size: int, *, shuffle: bool = False, rng=None,
                 drop_last: bool = False):
        """Yield (uids, device batch, real).  A final partial batch is
        padded to ``batch_size`` by repeating its last row (``real``
        counts the rows that are not padding) unless ``drop_last``.  Under
        several ranks the batch holds this rank's rows of the global
        batch (``uids`` and ``real`` the global batch's)."""
        return device_prefetch(self._host_batches(encoded, batch_size, shuffle, rng, drop_last, self.mesh),
                               self.device)

    @staticmethod
    def _host_batches(encoded: EncodedNLVR2, batch_size: int, shuffle: bool, rng, drop_last: bool,
                      mesh: Mesh = SINGLE):
        order = np.arange(len(encoded))
        if shuffle:
            (rng or np.random.default_rng()).shuffle(order)
        for s in range(0, len(order), batch_size):
            idx = order[s: s + batch_size]
            real = len(idx)
            if real < batch_size:
                if drop_last:
                    return
                idx = np.concatenate([idx, np.full(batch_size - real, idx[-1], idx.dtype)])
            rows = idx[mesh.rows(batch_size)]
            yield [encoded.uids[i] for i in idx[:real]], encoded.gather_batch(rows), real

    def save(self, name: str) -> str:
        """``<output>/<name>.pth`` (:func:`~rgqa_tpu_torch.checkpoint.convert.nlvr2_key_map`'s names;
        rank 0 writes it)."""
        enc = self.cfg.model.encoder
        path = os.path.join(self.output, f"{name}.pth")
        on_main(self.mesh, lambda: torch.save(to_reference_state_dict(
            self.model.state_dict(), backbone="nlvr2", l_layers=enc.l_layers, x_layers=enc.x_layers,
            r_layers=enc.r_layers), path))
        return path

    def train(self, train_split: str = "train", valid_split: str = "valid") -> dict:
        """``--epochs`` of training; returns ``{"loss": [the last step's
        loss per epoch], "valid": [accuracies]}``."""
        tcfg = self.cfg.train
        train_set = self.splits[train_split]
        n_batches = len(train_set) // tcfg.batch_size
        optimizer = make_optimizer(tcfg.optim, self.model.parameters(), max(n_batches * tcfg.epochs, 1))
        params = [p for group in optimizer.param_groups for p in group["params"]]
        rng = DropoutRng.for_rank(tcfg.seed, self.device, rank=self.mesh.rank, world=self.mesh.world)

        def step(batch: dict) -> torch.Tensor:
            logits = self.forward(batch, deterministic=False, rng=rng)["logits"].float()
            loss = F.cross_entropy(logits, batch["label"].long()) * 2  # CE x classes (nlvr2.py:77)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            (loss,) = reduce_gradients(self.mesh, params, [loss])
            global_norm_clip(params, tcfg.optim.grad_clip)
            optimizer.step()
            return loss

        shuffle = np.random.default_rng(tcfg.seed)
        best = 0.0
        history = {"loss": [], "valid": []}
        for epoch in range(tcfg.epochs):
            loss = math.nan
            for _, batch, _ in self._batches(train_set, tcfg.batch_size, shuffle=True, rng=shuffle,
                                             drop_last=True):
                loss = step(batch)
            history["loss"].append(float(loss))
            if valid_split in self.splits:
                acc = self.evaluate(valid_split)
                history["valid"].append(acc)
                if acc > best:
                    best = acc
                    self.save("BEST")
        self.save("LAST")
        return history

    def predict(self, split: str) -> dict:
        """``{uid: 0 | 1}``, at batch ``min(len(split), 32)`` (rounded up to
        a multiple of the world under several ranks, which gather their
        rows)."""
        encoded = self.splits[split]
        uid2pred = {}
        world = self.mesh.world
        with torch.inference_mode():
            for uids, batch, real in self._batches(encoded, -(-min(len(encoded), PREDICT_BATCH) // world) * world):
                logits = self.forward(batch, deterministic=True)["logits"].float()
                preds = gather_rows(self.mesh, torch.argmax(logits, dim=-1))
                for uid, p in zip(uids, preds[:real].tolist()):
                    uid2pred[uid] = p
        return uid2pred

    def evaluate(self, split: str) -> float:
        encoded = self.splits[split]
        gold = {u: int(l) for u, l in zip(encoded.uids, encoded.labels)}
        preds = self.predict(split)
        if not preds:
            return 0.0
        return float(np.mean([preds[u] == gold[u] for u in preds]))

    def dump_csv(self, split: str, path: str) -> None:
        """The reference submission: ``identifier,{True|False}`` per row
        (``nlvr2.py:150-156``; the uid where a row has no ``identifier``;
        rank 0 writes it)."""
        uid2row = {r["uid"]: r for r in self.splits[split].rows}
        preds = self.predict(split)

        def write():
            with open(path, "w") as f:
                for uid, p in preds.items():
                    ident = uid2row[uid].get("identifier", uid)
                    f.write(f"{ident},{'True' if p else 'False'}\n")

        on_main(self.mesh, write)
