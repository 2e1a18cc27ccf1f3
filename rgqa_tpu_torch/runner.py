"""GQA runner (port of ``rgqa_tpu/runner.py``: construction, ``load`` and
``train`` for ``--strategy conf``).

It makes the synthetic data when asked and it is missing, loads the
feature pack and the tokenizer, sizes the answer head to the dataset's
answers less the appended ``UQ`` class, initialises the weights from a
``torch.Generator`` seeded with ``--seed`` and loads ``--load <reference
.pth>``.  It runs on the card unless the caller asks for the CPU.

- ``GQARunner(cfg, init_train=True)`` encodes the train and valid splits
  and keeps f32 master weights; with bf16 on (the default; ``--fp32``
  turns it off) every product computes in bf16, as the JAX trainer does.
  :meth:`GQARunner.train` then fine-tunes: BCE x answers, optional RP
  pairing (``--sample_pair``), global clip 5.0, BertAdam with warmup,
  attention and hidden dropout at ``--dropout``; per epoch a validation
  of the closed-set soft accuracy, ``BEST.pth`` on a better one and a
  ``log.log`` line in the reference format; ``LAST.pth`` and
  ``LAST.state.pt`` at the end.
- ``GQARunner(cfg, init_train=False)`` is the evaluation runner: the
  answer vocabulary of the test splits and bf16 weights (the serving
  convention).  With ``f32_weights=True`` it keeps f32 weights under
  bf16 compute, as a training runner does, and takes the evaluation
  flags all the same: the evaluate CLI builds ``--scorer maha``'s runner
  so (the JAX CLI builds a training runner, ``init_train=scorer_name ==
  "maha"``), because the estimator is fitted, and cached for every later
  run, from f32 weights; the fit encodes the train split when it first
  runs and is refused on bf16 weights.  Both runners take the answer
  vocabulary from ``trainval_ans2label.json``, whichever splits they
  encode, so the two agree on it.  The module is in eval mode outside
  :meth:`GQARunner.train`; the scorers' forwards set the mode they need
  and restore it.

Both run lxmert or vilt.  For evaluation LXMERT also takes the branched
confidence heads (``--branched`` / ``--branched_layer``) and, with
``--strategy separate`` (the evaluate CLI's ``--scorer separate``), a
one-logit answerability head.

ViLT reads pixels from a pixel pack ``<data_root>/pixels_<size>_<mode>/``
when one matches this run (built from ``<data_root>/images`` at the
configured ``--vilt_image_size``, ``--vilt_resize`` and the pixelbert
transform; the JAX runner checks only the source), else decodes the
JPEGs under ``<data_root>/images`` (needs PIL).  A synthetic root gets
its pack made when a ViLT run finds none.  The train split follows the
JAX rule (``rgqa_tpu/runner.py:280-325``): with train-time randaug on
(the default) it decodes the JPEGs, which a pack's pre-resized rows
cannot stand in for, and draws the augmentation from
``np.random.default_rng(--seed)``; with ``--no_randaug`` it reads the
pack like the eval splits.  Randaug needs PIL and the JPEGs; without
either the runner raises, naming ``--no_randaug`` (the machine with the
card has no PIL, and the port's synthetic root has a pack but no JPEGs).

Not ported yet, and refused by flag name: training with the other
strategies, mixup, the MCE, energy and branched losses, ``--uq_as_class``,
``--chart``, chunked dispatch, the other optimizers, bf16 moments, orbax
snapshots (reading them needs jax), the ``--loadLXMERT`` /
``--loadLXMERTQA`` initialisations, the caption strategy and every
backbone but lxmert and vilt.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import math
import os
import time
from typing import Optional

import numpy as np
import torch

from rgqa_tpu_torch.checkpoint.convert import load_reference_pth
from rgqa_tpu_torch.config import RunConfig, dump_run_config
from rgqa_tpu_torch.data.batching import batch_iterator, device_prefetch
from rgqa_tpu_torch.data.dataset import EncodedGQA, GQADataset
from rgqa_tpu_torch.data.images import GQAImageSource, PixelPack, pack_matches
from rgqa_tpu_torch.data.synthetic import BASE_IMAGES, make_synthetic_gqa, make_synthetic_pixel_pack
from rgqa_tpu_torch.data.tokenizer import WordPieceTokenizer, load_vocab
from rgqa_tpu_torch.data.tsv import PackedFeatures
from rgqa_tpu_torch.device import resolve_device
from rgqa_tpu_torch.eval import ScoringMixin
from rgqa_tpu_torch.models.zoo import build_model
from rgqa_tpu_torch.ops.dropout import DropoutRng
from rgqa_tpu_torch.train.optimizer import make_optimizer
from rgqa_tpu_torch.train.state import load_train_state, save_reference_pth, save_train_state
from rgqa_tpu_torch.train.step import make_train_step

__all__ = ["GQARunner"]


def _check_ported(cfg: RunConfig, *, train: bool) -> None:
    m, d, t = cfg.model, cfg.data, cfg.train
    unported = {
        f"--backbone {m.backbone}": m.backbone not in ("lxmert", "vilt"),
        "--uq_as_class": m.uq_as_class,
        "--loadLXMERT / --loadLXMERTQA": bool(cfg.load_lxmert or cfg.load_lxmert_qa),
        "--feed_int8": d.feed_int8,
        "--eval_chunk > 1": t.eval_chunk > 1,
        f"--strategy {t.strategy}": t.strategy == "caption",  # the caps backbone
    }
    if train:
        unported.update({
            f"--strategy {t.strategy}": t.strategy != "conf",
            "--branched / --branched_layer (training the branched losses)": bool(
                m.branched or m.branched_layers
            ),
            "--mixup_mode": bool(t.mixup_mode),
            "--mceLoss": t.loss != "bce",
            "--scorer energy with --m_in (energy margins)": (
                cfg.ood.scorer == "energy" and t.m_in != 0
            ),
            "--chart": t.chart,
            "--train_chunk > 1": t.train_chunk > 1,
            f"--optim {t.optim.name}": "bert" not in t.optim.name.lower(),
            "--bf16_moments": t.optim.bf16_moments,
            "--update_weight_model": t.update_weight_model,
            "--teacher_path": bool(cfg.teacher_path),
        })
    named = [flag for flag, used in unported.items() if used]
    if named:
        raise NotImplementedError(f"not ported yet: {', '.join(named)}")


class GQARunner(ScoringMixin):
    """GQA task driver on one device (default: the card)."""

    def __init__(
        self, cfg: RunConfig, *, init_train: bool = True, f32_weights: bool = False,
        device: Optional[torch.device | str] = None,
    ):
        _check_ported(cfg, train=init_train)
        self.cfg = cfg
        self.device = resolve_device(device)
        data = cfg.data
        root = data.data_root

        if data.synthetic and not os.path.exists(
            os.path.join(root, "trainval_ans2label.json")
        ):
            make_synthetic_gqa(root)
        self.image_source = None
        if cfg.model.backbone == "vilt":
            self.image_source = self._image_source()

        self.features = PackedFeatures(os.path.join(root, "features"))
        if data.tiny:
            self.features = self.features.truncate(512)
        elif data.fast:
            self.features = self.features.truncate(5000)
        self.tokenizer = WordPieceTokenizer(load_vocab(os.path.join(root, "vocab.txt")))

        self.train_set: Optional[EncodedGQA] = None
        self.valid_set: Optional[EncodedGQA] = None
        if init_train:
            self.dataset = GQADataset(root, data.train_splits, add_uq=True)
            self.train_set = self._encode(self.dataset, train=True)
            if data.valid_splits:
                self.valid_set = self._encode(GQADataset(root, data.valid_splits, add_uq=True))
        else:
            # Evaluation only: the answer vocab comes from the splits
            # under evaluation.
            self.dataset = GQADataset(root, data.test_splits or data.valid_splits, add_uq=True)
        # The model outputs num_answers - 1 logits; 'UQ' is the appended
        # indicator class.  A separate detector has one logit.
        num_real = 1 if cfg.train.strategy == "separate" else self.dataset.num_answers - 1
        self.model_cfg = dataclasses.replace(cfg.model, num_answers=num_real)
        generator = torch.Generator(device=self.device).manual_seed(cfg.train.seed)
        self.model, self.forward = build_model(
            self.model_cfg, use_bf16=cfg.train.use_bf16,
            device=self.device, generator=generator, train=init_train or f32_weights,
        )
        self.model.eval()  # train() switches it to training mode for its epochs
        self.label2ans = self.dataset.label2ans
        if cfg.load:
            self.load(cfg.load)

        self.output = cfg.output
        os.makedirs(self.output, exist_ok=True)
        dump_run_config(cfg, self.output)

    def _image_source(self):
        """ViLT's pixels: the pack that matches this run, else the JPEGs."""
        cfg = self.cfg
        root, size, mode = cfg.data.data_root, cfg.model.vilt_image_size, cfg.data.vilt_resize
        img_root = os.path.join(root, "images")
        pack_dir = os.path.join(root, f"pixels_{size}_{mode}")
        meta = os.path.join(pack_dir, "meta.json")
        if cfg.data.synthetic and not os.path.isfile(meta) and os.path.isfile(
            os.path.join(root, BASE_IMAGES)
        ):
            make_synthetic_pixel_pack(root, size, mode)
        if os.path.isfile(meta):
            pack = PixelPack(pack_dir)
            if pack_matches(pack, img_root, size, mode):
                return pack
        return GQAImageSource(img_root, size=size, mode=mode)

    def _encode(self, ds: GQADataset, *, train: bool = False) -> EncodedGQA:
        """``ds`` as arrays; for ViLT the train split (``train``) with
        randaug on reads the JPEGs and gets the augment generator."""
        m, cfg = self.cfg.model, self.cfg
        randaug = train and m.backbone == "vilt" and cfg.data.vilt_randaug
        image_source = self.image_source
        if randaug:
            img_root = os.path.join(cfg.data.data_root, "images")
            missing = [what for what, found in (
                ("PIL", importlib.util.find_spec("PIL") is not None),
                (img_root, os.path.isdir(img_root)),
            ) if not found]
            if missing:
                raise RuntimeError(
                    f"ViLT train-time randaug decodes the JPEGs under {img_root} with PIL; "
                    f"missing here: {', '.join(missing)}. --no_randaug trains from the pixel pack"
                )
            image_source = GQAImageSource(img_root, size=m.vilt_image_size, mode=cfg.data.vilt_resize)
        encoded = EncodedGQA(
            ds, self.features, tokenizer=self.tokenizer, max_text_len=m.max_text_len,
            backbone=m.backbone, image_source=image_source,
            pixel_wire=cfg.data.pixel_wire, pixel_patch_size=m.vilt_patch_size,
        )
        if randaug:
            encoded.image_augment_rng = np.random.default_rng(cfg.train.seed)
        return encoded

    # ------------------------------------------------------------------
    # Checkpoints
    # ------------------------------------------------------------------

    def load(self, path: str) -> None:
        """Load a reference GQA-LXMERT or GQAViLT ``.pth`` into the model
        (cast to the model's dtype); keys it lacks stay at their init."""
        if not os.path.isfile(path):
            raise NotImplementedError(
                f"{path!r} is not a .pth file; loading orbax snapshots needs "
                "jax and is not ported yet"
            )
        enc = self.model_cfg.encoder
        sd, missing, unused = load_reference_pth(
            path, backbone=self.model_cfg.backbone, l_layers=enc.l_layers,
            x_layers=enc.x_layers, r_layers=enc.r_layers, num_layers=enc.num_layers,
            branched=self.model_cfg.branched,
        )
        self.model.load_state_dict(sd, strict=False)
        if missing:
            print(f"Weights not found in ckpt: {missing[:5]}...")
        if unused:
            print(f"Ckpt weights unused: {unused[:5]}...")

    def save(self, name: str) -> str:
        """``<output>/<name>.pth`` in the reference GQA format."""
        return save_reference_pth(self.model, self.model_cfg, os.path.join(self.output, f"{name}.pth"))

    # ------------------------------------------------------------------
    # Training (gqa_conf.py:140-243)
    # ------------------------------------------------------------------

    def _validate(self) -> float:
        self.model.eval()
        try:
            return self.evaluate(self.valid_set)
        finally:
            self.model.train()

    def _epoch_end(self, epoch, epoch_start, last_loss, history, best_valid) -> float:
        """History, validation with BEST (and ``--save_all`` EPOCH_n)
        checkpoints, and the reference's log lines (``gqa.py:214-230``).
        Returns the updated best valid score."""
        last_loss = float(last_loss)  # the epoch's one read of a device value
        history["loss"].append(last_loss)
        log_str = (
            f"\nEpoch {epoch}: Train Loss {last_loss:.2f} "
            f"({time.time() - epoch_start:.1f}s)\n"
        )
        if self.valid_set is not None:
            valid = self._validate()
            history["valid"].append(valid)
            if valid > best_valid:
                best_valid = valid
                self.save("BEST")
            log_str += (
                f"Epoch {epoch}: Valid {valid * 100:.2f}\n"
                f"Epoch {epoch}: Best {best_valid * 100:.2f}\n"
            )
        if self.cfg.train.save_all:
            self.save(f"EPOCH_{epoch}")
        print(log_str, end="", flush=True)
        with open(os.path.join(self.output, "log.log"), "a") as f:
            f.write(log_str)
        return best_valid

    def train(self, resume: Optional[str] = None) -> dict:
        """Fine-tune for ``--epochs``; returns ``{"loss": [...], "valid":
        [...]}`` (the last step's loss and the valid accuracy of each
        epoch).  ``resume`` names a checkpoint this runner saved (e.g.
        "LAST"): its weights, optimizer state (step count included) and
        generator states are restored before the epochs run."""
        if self.train_set is None:
            raise RuntimeError("train() needs a runner built with init_train=True")
        tcfg = self.cfg.train
        n_batches = len(self.train_set) // tcfg.batch_size
        t_total = max(n_batches * tcfg.epochs, 1)
        optimizer = make_optimizer(tcfg.optim, self.model.parameters(), t_total)
        rng = DropoutRng(
            device=torch.Generator(device=self.device).manual_seed(tcfg.seed),
            host=torch.Generator().manual_seed(tcfg.seed),
        )
        shuffle = np.random.default_rng(tcfg.seed)
        steps = 0
        if resume:
            self.load(os.path.join(self.output, f"{resume}.pth"))
            state = load_train_state(os.path.join(self.output, f"{resume}.state.pt"))
            # The saved moments and step count; this run's schedule.
            fresh = [{k: v for k, v in g.items() if k not in ("params", "count")}
                     for g in optimizer.param_groups]
            optimizer.load_state_dict(state["optimizer"])
            for group, hyper in zip(optimizer.param_groups, fresh):
                group.update(hyper)
            steps = state["step"]
            rng.load_state(state["rng"])
            shuffle.bit_generator.state = state["shuffle"]

        step = make_train_step(
            self.forward, optimizer, loss=tcfg.loss, sample_pair=tcfg.sample_pair,
            grad_clip=tcfg.optim.grad_clip, rng=rng,
        )
        best_valid = 0.0
        history = {"loss": [], "valid": []}
        self.model.train()
        try:
            for epoch in range(tcfg.epochs):
                last_loss = math.nan
                epoch_start = time.time()
                batches = device_prefetch(
                    batch_iterator(
                        self.train_set, tcfg.batch_size, shuffle=True, rng=shuffle,
                        drop_last=True, with_target=True,
                    ),
                    self.device,
                )
                for _, batch, _ in batches:
                    last_loss = step(batch)["loss"]
                    steps += 1
                best_valid = self._epoch_end(epoch, epoch_start, last_loss, history, best_valid)
        finally:
            self.model.eval()

        self.save("LAST")
        save_train_state(
            os.path.join(self.output, "LAST.state.pt"), optimizer=optimizer, step=steps,
            rng_state=rng.state(), shuffle=shuffle,
        )
        return history
