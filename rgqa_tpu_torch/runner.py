"""GQA runner (port of ``rgqa_tpu/runner.py``: construction, ``load``,
the pretrained starts and ``train`` for every ``--strategy`` of the JAX
train CLI, ``--update_weight_model``'s joint CLIP step among them).

It makes the synthetic data when asked and it is missing, loads the
feature pack and the tokenizer, sizes the answer head to the dataset's
answers less the appended ``UQ`` class, initialises the weights from a
``torch.Generator`` seeded with ``--seed`` and loads ``--load <reference
.pth>``, else a pretrained start: ``--loadLXMERTQA`` (LXMERT: the
encoder and the answer head transplanted by answer string through
``all_ans.json``) or ``--loadLXMERT`` (LXMERT's or UNITER's pretrained
encoder).  It runs on the card unless the caller asks for the CPU.

- ``GQARunner(cfg, init_train=True)`` encodes the train and valid splits
  and keeps f32 master weights; with bf16 on (the default; ``--fp32``
  turns it off) every product computes in bf16, as the JAX trainer does.
  :meth:`GQARunner.train` then fine-tunes: BCE (or ``--mceLoss``'s
  softmax CE) x answers, RP pairing (``--sample_pair``) or mixup /
  TreeMix pseudo-UQ rows (``--mixup_mode`` with ``--mixup_alpha`` /
  ``--mixup_beta`` / ``--lam1`` / ``--lam2``), the branched loss
  (``--branched`` / ``--branched_layer``), the energy hinge (``--scorer
  energy`` with ``--m_in`` nonzero, ``--m_out``), global clip 5.0,
  ``--optim`` (BertAdam with warmup, ``--bf16_moments``; adam, adamw,
  adamax, sgd, rms as optax defines them), attention and hidden dropout
  at ``--dropout``;
  per epoch a validation of the closed-set soft accuracy, ``BEST.pth`` on
  a better one and a ``log.log`` line in the reference format, and with
  ``--chart`` ``<output>/chart/epoch_<n>.pkl``, ``{qid: (score, label,
  predicted answer)}`` of the epoch's steps; ``LAST.pth`` and
  ``LAST.state.pt`` at the end.  ``--uq_as_class`` trains the UQ answer
  as a class of the head (the targets keep their UQ column).  The
  strategies with a step of their own: ``adv`` (VILLA), ``distill_online``
  (``--teacher_path``), ``weight`` (CLIP-weighted RP) and, through
  :meth:`GQARunner.train_minmax`, ``resampling`` / ``poem`` / ``woods``
  (``--train_pos`` / ``--train_neg`` / ``--lr_w``).  ``weight`` with
  ``--update_weight_model`` trains the CLIP weight model beside the
  answerer (:meth:`GQARunner.train_weight_model`).
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

Both run lxmert, uniter, vilt, butd or caps.  For evaluation LXMERT also
takes the branched confidence heads (``--branched`` / ``--branched_layer``)
and BUTD its confidence head (``--branched``).  ``--strategy separate``
and ``caption`` (the evaluate CLI's ``--scorer separate`` / ``caption``)
give any backbone a one-logit answerability head, and train it with the
binary loss: sigmoid BCE of the one logit against ``id_mask``.

BUTD builds its word dictionary over the question splits, cached as
``<data_root>/butd/dictionary.json``, and loads GloVe-300 rows into its
embedding from ``--glove`` (default ``<data_root>/butd/glove.6B.300d.txt``;
absent, the random init stands), the matrix cached as
``<data_root>/butd/glove.npy`` + ``.meta.json``: the JAX runner's files,
so a cache from either package loads in the other.  The caption matcher
(``--backbone caps``) pairs each question with its image's caption from
``<data_root>/image2caps.json``; ``--load_bert`` initialises it from a
local HF BERT (a ``.bin`` or a directory holding ``pytorch_model.bin``).

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

Data parallel: under N ranks (``torchrun``, :mod:`rgqa_tpu_torch.parallel`)
the runner takes the mesh of the process group; ``--batchSize`` is the
global batch (the world must divide it), every rank reads its rows of
each batch, the steps average their gradients (so a step means what the
one-process step means at the same global batch), validation and
scoring gather every rank's rows (every rank takes the same ``BEST``
decision), rank 0 alone writes ``log.log``, the checkpoints and the
caches (the others wait at a barrier), and ``LAST.state.pt`` keeps each
rank's dropout stream for the resume.  ``--model_axis`` other than 1
raises (tensor parallelism is not ported).

Refused by flag name (:func:`check_ported`): chunked dispatch
(``--train_chunk`` / ``--eval_chunk``), ``--feed_int8``, orbax snapshot
directories without the export that ``orbax_to_pth.py`` writes beside
them (the port reads no orbax; the error names the command), and where
the JAX package fails:
``--strategy adv`` off LXMERT and the min-max strategies on the caption
matcher.  An evaluation runner for ``--scorer match`` with ``--load`` takes ``--loadLXMERT`` (the match scorer's
pretraining checkpoint, which the evaluate CLI loads) and leaves it out
of the answerer; without ``--load`` it is refused.
``--loadLXMERT`` with ``--backbone uniter`` loads a pretrained UNITER encoder (``uniter.*`` or
``bert.*`` keys, or a GQA-UNITER ``.pth``'s encoder and head), as the JAX
runner does; keys it lacks, the answer head of a bare encoder among
them, stay at their init.  Where the JAX runner ignores them
(``--loadLXMERTQA`` off LXMERT, ``--loadLXMERT`` on ViLT, BUTD and the
caption matcher), the port does too, and says so.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import math
import os
import pickle
import time
import warnings
from typing import Optional

import numpy as np
import torch

from rgqa_tpu_torch.checkpoint.convert import (
    is_orbax_dir,
    load_clip_state,
    load_lxmert_pretrained,
    load_lxmert_qa,
    load_reference_pth,
    lxrt_path,
    orbax_refusal,
    save_clip_dir,
    save_clip_state,
)
from rgqa_tpu_torch.config import RunConfig, dump_run_config
from rgqa_tpu_torch.data.batching import batch_iterator, device_prefetch, to_device
from rgqa_tpu_torch.data.dataset import EncodedGQA, GQADataset
from rgqa_tpu_torch.data.images import GQAImageSource, PixelPack, pack_matches
from rgqa_tpu_torch.data.synthetic import BASE_IMAGES, make_synthetic_gqa, make_synthetic_pixel_pack
from rgqa_tpu_torch.data.tokenizer import WordPieceTokenizer, load_vocab
from rgqa_tpu_torch.data.tsv import PackedFeatures
from rgqa_tpu_torch.device import resolve_device
from rgqa_tpu_torch.eval import ScoringMixin, _check_decodable, decode_rgb
from rgqa_tpu_torch.models.butd import build_glove_matrix, butd_split
from rgqa_tpu_torch.models.zoo import build_model
from rgqa_tpu_torch.ops.dropout import DropoutRng
from rgqa_tpu_torch.parallel.mesh import (
    check_batch_size,
    gather_objects,
    gather_rows,
    make_mesh,
    on_main,
    shard_params,
)
from rgqa_tpu_torch.pretrain.answer_table import AnswerTable
from rgqa_tpu_torch.scorers.clip import ClipScorer, clip_resize_crop
from rgqa_tpu_torch.train.adversarial import AdvConfig, make_adv_train_step
from rgqa_tpu_torch.train.dual_loader import NegativeWeights, make_minmax_step, sample_negative_indices
from rgqa_tpu_torch.train.online_distill import make_online_distill_step
from rgqa_tpu_torch.train.optimizer import OptaxAdam, make_optimizer
from rgqa_tpu_torch.train.state import load_train_state, save_reference_pth, save_train_state
from rgqa_tpu_torch.train.step import make_train_step, make_weighted_clip_train_step

__all__ = ["GQARunner", "check_ported"]


# The dual-loader min-max strategies (train_minmax).
MINMAX = ("resampling", "poem", "woods")


def check_ported(cfg: RunConfig, *, train: bool, extra: Optional[dict] = None) -> None:
    """Refuse, by flag, what the port does not run: chunked dispatch (not
    to port: one step a launch sequence here), the int8 feed and orbax
    snapshot directories without their ``orbax_to_pth.py`` export (the
    port reads no orbax); and where the JAX package fails:
    ``--strategy adv`` off LXMERT (its delta hooks are LXMERT's), the
    min-max strategies on the caption matcher (its one logit does not
    broadcast with the answer targets in JAX ``train_minmax``); and
    ``--scorer match`` without ``--load``, whose answerer would start
    from the scorer's checkpoint.  ``extra`` maps a caller's own refusals
    (a flag's name) to whether they apply; the pretraining, VQA and NLVR2
    runners share these checks."""
    m, d, t = cfg.model, cfg.data, cfg.train
    unported = {
        "--feed_int8": d.feed_int8,
        "--eval_chunk > 1": t.eval_chunk > 1,
        # --scorer match reads --loadLXMERT as its scorer's checkpoint (the
        # evaluate CLI loads it); without --load the JAX runner would also
        # start the answerer from it.
        "--loadLXMERT as --scorer match's answerer (give the answerer with --load)":
            not train and cfg.ood.scorer == "match" and bool(cfg.load_lxmert) and not cfg.load,
    }
    if train:
        unported.update({
            "--train_chunk > 1": t.train_chunk > 1,
            f"--strategy adv on --backbone {m.backbone} (VILLA's text and RoI deltas are LXMERT's "
            "hooks; the JAX package's UNITER, ViLT, BUTD and caption matcher take none)":
                t.strategy == "adv" and m.backbone != "lxmert",
            f"--strategy {t.strategy} on --backbone caps (the JAX train_minmax fails there: the "
            "matcher's one logit does not broadcast with the answer targets)":
                t.strategy in MINMAX and m.backbone == "caps",
        })
        if t.strategy == "distill_online" and cfg.teacher_path and os.path.isdir(cfg.teacher_path) \
                and not os.path.isfile(cfg.teacher_path + ".pth"):
            raise orbax_refusal("--teacher_path", cfg.teacher_path, cfg.teacher_path + ".pth")
    for flag, path in (("--loadLXMERTQA", cfg.load_lxmert_qa), ("--loadLXMERT", cfg.load_lxmert)):
        if path and m.backbone == "lxmert" and os.path.isdir(lxrt_path(path)):
            raise orbax_refusal(flag, path, path + "_LXRT.pth")
    unported.update(extra or {})
    named = [flag for flag, used in unported.items() if used]
    if named:
        raise NotImplementedError(f"not ported yet: {', '.join(named)}")


def pth_path(path: str) -> str:
    """``path``, or ``<path>.pth`` when ``path`` is not a file and that is
    (the reference loads ``"%s.pth" % path``, and the recipe scripts pass
    ``--load <run>/BEST``)."""
    if not os.path.isfile(path) and os.path.isfile(path + ".pth"):
        return path + ".pth"
    return path


class GQARunner(ScoringMixin):
    """The GQA task on one device (default: the card), or on each rank
    of a data-parallel run."""

    def __init__(
        self, cfg: RunConfig, *, init_train: bool = True, f32_weights: bool = False,
        device: Optional[torch.device | str] = None,
    ):
        check_ported(cfg, train=init_train)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = make_mesh(self.device, model=cfg.mesh.model_axis)
        check_batch_size(self.mesh, cfg.train.batch_size)
        data = cfg.data
        root = data.data_root

        # Rank 0 writes what is missing under the root (the synthetic data,
        # BUTD's dictionary, a pixel pack); the other ranks then read it.
        self._on_main(self._write_root)
        self.butd_word2idx = self._butd_dictionary(root) if cfg.model.backbone == "butd" else None
        self.image2caps = None
        if cfg.model.backbone == "caps":
            with open(os.path.join(root, "image2caps.json")) as f:
                self.image2caps = json.load(f)
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
        # indicator class, unless --uq_as_class trains it as a class.  A
        # separate detector or a caption matcher has one logit.
        num_real = self.dataset.num_answers - (0 if cfg.model.uq_as_class else 1)
        if cfg.train.strategy in ("separate", "caption"):
            num_real = 1
        self.model_cfg = dataclasses.replace(cfg.model, num_answers=num_real)
        if self.butd_word2idx is not None:
            self.model_cfg = dataclasses.replace(self.model_cfg, butd_vocab_size=len(self.butd_word2idx))
        generator = torch.Generator(device=self.device).manual_seed(cfg.train.seed)
        self.model, self.forward = build_model(
            self.model_cfg, use_bf16=cfg.train.use_bf16,
            device=self.device, generator=generator, train=init_train or f32_weights,
        )
        self.model.eval()  # train() switches it to training mode for its epochs
        self.label2ans = self.dataset.label2ans
        if self.butd_word2idx is not None and self.mesh.is_main:
            self._load_glove_embeddings(root)  # shard_params gives the others rank 0's rows
        self._load_initial_weights()
        shard_params(self.mesh, self.model)

        self.output = cfg.output
        os.makedirs(self.output, exist_ok=True)
        self._on_main(dump_run_config, cfg, self.output)

    def _write_root(self) -> None:
        """What the data root lacks and this run writes: the synthetic
        data (``--synthetic``), BUTD's dictionary and ViLT's pixel pack."""
        cfg, root = self.cfg, self.cfg.data.data_root
        if cfg.data.synthetic and not os.path.exists(os.path.join(root, "trainval_ans2label.json")):
            make_synthetic_gqa(root)
        if cfg.model.backbone == "butd":
            self._butd_dictionary(root)
        if cfg.model.backbone == "vilt":
            self._image_source()

    def _on_main(self, write, *args, **kw):
        """``write(*args, **kw)`` on rank 0 alone; every rank then waits
        for it (the others may read what it wrote)."""
        return on_main(self.mesh, write, *args, **kw)

    def _load_initial_weights(self) -> None:
        """``--load``, else the pretrained starts (JAX
        ``_load_initial_weights``, ``rgqa_tpu/runner.py:349-420``):
        ``--loadLXMERTQA`` and ``--loadLXMERT`` on LXMERT, ``--loadLXMERT``
        on UNITER, ``--load_bert`` on the caption matcher.  Elsewhere the
        JAX runner ignores those flags, and so does the port (it says so)."""
        cfg = self.cfg
        backbone = cfg.model.backbone
        if cfg.load:
            self.load(cfg.load)
        elif cfg.load_lxmert_qa and backbone == "lxmert":
            self._load_lxmert_qa(cfg.load_lxmert_qa)
        elif cfg.load_lxmert and backbone == "lxmert":
            enc = self.model_cfg.encoder
            sd, missing, _ = load_lxmert_pretrained(
                lxrt_path(cfg.load_lxmert), l_layers=enc.l_layers, x_layers=enc.x_layers, r_layers=enc.r_layers)
            self.model.load_state_dict(sd, strict=False)
            print(f"Loaded LXMERT encoder ({len(missing)} keys left at init)")
        elif cfg.load_lxmert and backbone == "uniter":
            print(f"Loaded UNITER encoder ({len(self.load(cfg.load_lxmert))} keys left at init)")
        elif cfg.load_bert and backbone == "caps":
            # The matcher's pretrained-BERT start (BertModel.from_pretrained,
            # caps.py:17); the match head stays at its init.
            print(f"Loaded BERT encoder ({len(self.load(cfg.load_bert))} keys left at init)")
        elif cfg.load_lxmert_qa or cfg.load_lxmert:
            flag = "--loadLXMERTQA" if cfg.load_lxmert_qa else "--loadLXMERT"
            print(f"{flag} ignored on --backbone {backbone}, as in the JAX runner")

    def _load_lxmert_qa(self, path: str) -> None:
        """``--loadLXMERTQA``: the reference's ``%s_LXRT.pth`` suffix, the
        answer table from ``<data_root>/all_ans.json`` else
        ``data/lxmert/all_ans.json``, the transplant by answer string
        (:func:`~rgqa_tpu_torch.checkpoint.convert.load_lxmert_qa`); with
        neither table, the encoder and the head's dense + LayerNorm alone."""
        cfg, enc = self.cfg, self.model_cfg.encoder
        layers = dict(l_layers=enc.l_layers, x_layers=enc.x_layers, r_layers=enc.r_layers)
        if not path.endswith(".pth") and os.path.exists(path + "_LXRT.pth"):
            path = path + "_LXRT.pth"  # the reference's "%s_LXRT.pth" suffix
        table = None
        for cand in (os.path.join(cfg.data.data_root, "all_ans.json"), "data/lxmert/all_ans.json"):
            if os.path.exists(cand):
                table = AnswerTable(path=cand)
                break
        if table is None:
            print("WARNING: all_ans.json not found — loading encoder + answer-head transform only, "
                  "no per-answer transplant")
            sd, _, _ = load_lxmert_pretrained(path, **layers)
            self.model.load_state_dict(sd, strict=False)
            return
        head = self.model.answer_head.logits
        sd, loaded, zeroed = load_lxmert_qa(
            path, self.label2ans, head.weight, head.bias, src_ans2id=table.ans2id_map(),
            convert_ans=table.convert_ans, **layers)
        self.model.load_state_dict(sd, strict=False)
        print(f"Loaded {loaded} answers from LXRTQA pre-training and {zeroed} not")

    def _butd_dictionary(self, root: str) -> dict[str, int]:
        """BUTD's word dictionary over the question splits
        (``butd/preprocess.py:54-123``): the configured train / valid /
        test / pos / neg splits and the standard names, each word in
        order of first appearance.  Cached as ``<root>/butd/
        dictionary.json`` keyed on the split names and on which of their
        files exist, in the JAX runner's format."""
        data = self.cfg.data
        names = {"train", "valid", "testdev"}
        for spec in (data.train_splits, data.valid_splits, data.test_splits, data.train_pos,
                     data.train_neg):
            if spec:
                names.update(spec.split(","))
        key = sorted(names)
        found = [n for n in key if os.path.exists(os.path.join(root, f"{n}.json"))]
        cache = os.path.join(root, "butd", "dictionary.json")
        if os.path.exists(cache):
            with open(cache) as f:
                cached = json.load(f)
            if cached.get("splits") == key and cached.get("found", key) == found:
                return dict(cached["words"])
        words: dict[str, int] = {}
        for name in found:
            with open(os.path.join(root, f"{name}.json")) as f:
                for row in json.load(f):
                    for tok in butd_split(row.get("sent", "")):
                        words.setdefault(tok, len(words))
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        with open(cache, "w") as f:
            json.dump({"splits": key, "found": found, "words": words}, f)
        return words

    def _load_glove_embeddings(self, root: str) -> None:
        """GloVe-300 rows into BUTD's word embedding (reference
        ``preprocess.py:100-123``), the matrix cached as ``<root>/butd/
        glove.npy`` with a ``.meta.json`` fingerprint of the GloVe file
        and the dictionary (the JAX runner's).  Without a GloVe file the
        random init stands."""
        dim = self.model_cfg.butd_embed_dim
        path = self.cfg.data.glove_path or os.path.join(root, "butd", "glove.6B.300d.txt")
        if not os.path.exists(path):
            return
        cache = os.path.join(root, "butd", "glove.npy")
        meta_path = cache + ".meta.json"
        st = os.stat(path)
        meta = {
            "glove_path": os.path.abspath(path),
            "glove_mtime": st.st_mtime,
            "glove_size": st.st_size,
            "vocab_fprint": hashlib.md5(
                json.dumps(sorted(self.butd_word2idx.items())).encode()
            ).hexdigest(),
            "dim": dim,
        }
        mat = None
        if os.path.exists(cache) and os.path.exists(meta_path):
            with open(meta_path) as f:
                if json.load(f) == meta:
                    m = np.load(cache)
                    if m.shape == (len(self.butd_word2idx) + 1, dim):
                        mat = m
        if mat is None:
            mat = build_glove_matrix(self.butd_word2idx, path, dim=dim)
            os.makedirs(os.path.dirname(cache), exist_ok=True)
            np.save(cache, mat)
            with open(meta_path, "w") as f:
                json.dump(meta, f)
        emb = self.model.w_emb.weight
        if tuple(emb.shape) != mat.shape:
            print(f"WARNING: GloVe matrix {mat.shape} does not match the BUTD embedding "
                  f"{tuple(emb.shape)}; keeping random init")
            return
        with torch.no_grad():
            emb.copy_(torch.from_numpy(mat))

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
            butd_word2idx=self.butd_word2idx, image2caps=self.image2caps,
            keep_uq_target=m.uq_as_class,
        )
        if randaug:
            # Each rank augments its own rows: a stream of its own.
            seed = cfg.train.seed if self.mesh.world == 1 else [cfg.train.seed, self.mesh.rank]
            encoded.image_augment_rng = np.random.default_rng(seed)
        return encoded

    # ------------------------------------------------------------------
    # Checkpoints
    # ------------------------------------------------------------------

    def load(self, path: str) -> list[str]:
        """Load a reference GQA-LXMERT, UNITER, GQAViLT or GQA-BUTD ``.pth``
        or, for the caption matcher, an HF BERT / trained GQABERT (a file,
        or a directory holding ``pytorch_model.bin``) into the model (cast
        to the model's dtype); keys it lacks stay at their init.  ``path``
        less its ``.pth`` takes the file (:func:`pth_path`).  Returns the
        reference keys it lacked."""
        path = pth_path(path)
        caps_dir = self.model_cfg.backbone == "caps" and os.path.isdir(path) and not is_orbax_dir(path)
        if not os.path.isfile(path) and not caps_dir:
            raise orbax_refusal("--load", path, path + ".pth")
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
        return missing

    def save(self, name: str) -> str:
        """``<output>/<name>.pth`` in the reference GQA format (rank 0
        writes it)."""
        path = os.path.join(self.output, f"{name}.pth")
        self._on_main(save_reference_pth, self.model, self.model_cfg, path)
        return path

    # ------------------------------------------------------------------
    # Training (gqa_conf.py:140-243)
    # ------------------------------------------------------------------

    def _validate(self) -> float:
        self.model.eval()
        try:
            return self.evaluate(self.valid_set)
        finally:
            self.model.train()

    def _chart_rows(self, chart: list) -> dict:
        """``{qid: (score, gold label dict, predicted answer)}`` of an
        epoch's steps (``gqa.py:141-150``): each step's first rows, the
        batch's own questions (the appended pseudo-UQ rows have none)."""
        rows = {}
        for qids, score, label in chart:
            for qid, s, l in zip(qids, score.tolist(), label.tolist()):
                rows[qid] = (float(s), self.dataset.id2datum[qid].get("label"), self.label2ans[int(l)])
        return rows

    def _epoch_end(self, epoch, epoch_start, last_loss, history, best_valid, chart=None,
                   extra_save=None) -> float:
        """History, validation with BEST (and ``--save_all`` EPOCH_n)
        checkpoints, the reference's log lines (``gqa.py:214-230``) and,
        given the epoch's ``chart`` steps, ``chart/epoch_<n>.pkl``.
        ``extra_save(tag)`` writes a strategy's sibling state beside each
        checkpoint it saves.  Returns the updated best valid score."""
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
                self._save_with("BEST", extra_save)
            log_str += (
                f"Epoch {epoch}: Valid {valid * 100:.2f}\n"
                f"Epoch {epoch}: Best {best_valid * 100:.2f}\n"
            )
        if self.cfg.train.save_all:
            self._save_with(f"EPOCH_{epoch}", extra_save)
        self._on_main(self._log, log_str)
        if chart is not None:
            self._on_main(self._write_chart, epoch, chart)
        return best_valid

    def _log(self, log_str: str) -> None:
        print(log_str, end="", flush=True)
        with open(os.path.join(self.output, "log.log"), "a") as f:
            f.write(log_str)

    def _write_chart(self, epoch: int, chart: list) -> None:
        with open(os.path.join(self.output, "chart", f"epoch_{epoch}.pkl"), "wb") as f:
            pickle.dump(self._chart_rows(chart), f, protocol=pickle.HIGHEST_PROTOCOL)

    def _save_with(self, tag: str, extra_save=None) -> None:
        self.save(tag)
        if extra_save is not None:
            extra_save(tag)

    def train(self, resume: Optional[str] = None) -> dict:
        """Fine-tune for ``--epochs`` with ``--strategy``'s step (JAX
        ``train``, ``rgqa_tpu/runner.py:503-645``); returns ``{"loss":
        [...], "valid": [...]}`` (the last step's loss and the valid
        accuracy of each epoch).  ``resume`` names a checkpoint this runner
        saved (e.g. "LAST"): its weights, optimizer state (step count
        included) and generator states are restored before the epochs run.

        ``adv`` takes VILLA's step (:mod:`~rgqa_tpu_torch.train.
        adversarial`), ``distill_online`` the teacher's blended targets
        (:mod:`~rgqa_tpu_torch.train.online_distill`; ``--teacher_path``
        a ``.pth``, built as an evaluation runner of this config), ``weight``
        the CLIP-weighted RP loss with per-batch weights from
        :meth:`_weight_similarity` (with ``--update_weight_model``,
        :meth:`train_weight_model`), the min-max strategies
        :meth:`train_minmax`; every other strategy the train step."""
        if self.train_set is None:
            raise RuntimeError("train() needs a runner built with init_train=True")
        tcfg = self.cfg.train
        if tcfg.update_weight_model and tcfg.strategy != "weight":
            # Before any dispatch: the flag is never dropped in silence.
            warnings.warn(
                f"--update_weight_model only applies with --strategy weight (got --strategy "
                f"{tcfg.strategy}); the CLIP weight model will NOT be trained",
                RuntimeWarning, stacklevel=2,
            )
        if tcfg.strategy in MINMAX:
            if resume:
                raise NotImplementedError(
                    f"resume under --strategy {tcfg.strategy}: the JAX train_minmax takes no resume "
                    "(its negative weights are not checkpointed)"
                )
            return self.train_minmax()
        if tcfg.strategy == "weight" and tcfg.update_weight_model:
            return self.train_weight_model(resume)
        optimizer, rng, shuffle, steps = self._train_state(resume)
        step = self._strategy_step(optimizer, rng)
        similarity = self._weight_similarity() if tcfg.strategy == "weight" else None
        if tcfg.chart:
            os.makedirs(os.path.join(self.output, "chart"), exist_ok=True)
        best_valid = 0.0
        history = {"loss": [], "valid": []}
        self.model.train()
        try:
            for epoch in range(tcfg.epochs):
                last_loss = math.nan
                epoch_start = time.time()
                # --chart: each step's (qids, score, label), read back at the
                # epoch's end, so no step waits on the device.
                chart = [] if tcfg.chart else None
                batches = device_prefetch(
                    batch_iterator(
                        self.train_set, tcfg.batch_size, shuffle=True, rng=shuffle,
                        drop_last=True, with_target=True, mesh=self.mesh,
                    ),
                    self.device,
                )
                for qids, batch, _ in batches:
                    kw = self._negative_weights(qids, similarity, shuffle) if similarity else {}
                    aux = step(batch, **kw)
                    last_loss = aux["loss"]
                    if chart is not None:
                        chart.append(self._chart_step(qids, aux))
                    steps += 1
                best_valid = self._epoch_end(epoch, epoch_start, last_loss, history, best_valid, chart)
        finally:
            self.model.eval()

        self.save("LAST")
        self._save_train_state(optimizer, steps, rng, shuffle)
        return history

    def _chart_step(self, qids: list, aux: dict) -> tuple:
        """A step's chart rows: the global batch's own questions (the
        appended pseudo-UQ rows have none), every rank's rows gathered."""
        n = len(qids)
        return qids, gather_rows(self.mesh, aux["score"][: n // self.mesh.world]), \
            gather_rows(self.mesh, aux["label"][: n // self.mesh.world])

    def _save_train_state(self, optimizer, steps: int, rng: DropoutRng, shuffle) -> None:
        """``LAST.state.pt``: the optimizer state, the step, the shuffle
        and the dropout generators, each rank's (``rng_ranks``; ``rng`` is
        rank 0's, the one-process layout)."""
        states = gather_objects(self.mesh, rng.state())
        self._on_main(save_train_state, os.path.join(self.output, "LAST.state.pt"), optimizer=optimizer,
                      step=steps, rng_state=states[0], shuffle=shuffle,
                      rng_ranks=states if self.mesh.world > 1 else None)

    def _train_state(self, resume: Optional[str]):
        """(the model's optimizer of ``--optim``, the dropout generators, the
        shuffle generator, the step count) of a run; ``resume`` restores
        the checkpoint's weights, moments, step count and generator
        states (this run's schedule)."""
        tcfg = self.cfg.train
        t_total = max(len(self.train_set) // tcfg.batch_size * tcfg.epochs, 1)
        optimizer = make_optimizer(tcfg.optim, self.model.parameters(), t_total)
        rng = DropoutRng.for_rank(tcfg.seed, self.device, rank=self.mesh.rank, world=self.mesh.world)
        shuffle = np.random.default_rng(tcfg.seed)
        steps = 0
        if resume:
            self.load(os.path.join(self.output, f"{resume}.pth"))
            state = load_train_state(os.path.join(self.output, f"{resume}.state.pt"))
            ranks = state.get("rng_ranks")
            if self.mesh.world > 1:
                if not ranks or len(ranks) != self.mesh.world:
                    raise ValueError(
                        f"resume {resume!r} under WORLD_SIZE {self.mesh.world}: the checkpoint keeps the "
                        f"dropout streams of {len(ranks) if ranks else 1} rank(s); resume with that world size"
                    )
                state["rng"] = ranks[self.mesh.rank]
            fresh = [{k: v for k, v in g.items() if k not in ("params", "count")}
                     for g in optimizer.param_groups]
            optimizer.load_state_dict(state["optimizer"])
            for group, hyper in zip(optimizer.param_groups, fresh):
                group.update(hyper)
            steps = state["step"]
            rng.load_state(state["rng"])
            shuffle.bit_generator.state = state["shuffle"]
        return optimizer, rng, shuffle, steps

    def train_weight_model(self, resume: Optional[str] = None) -> dict:
        """CLIP-weighted RP with an adversarially trained weight model
        (``--strategy weight --update_weight_model``, ``gqa_weight.py``;
        JAX ``train_weight_model``, ``rgqa_tpu/runner.py:741-951``): each
        step's negative-pair weights come from the current CLIP params,
        the answerer minimizes ``0.5 x (pos + weighted neg)`` while CLIP
        maximizes the weighted negative loss (Adam at 1e-5, both clipped
        at norm 5.0), one backward a step
        (:func:`~rgqa_tpu_torch.train.step.make_weighted_clip_train_step`).

        CLIP is ``--clip_path`` (an HF checkpoint directory, or an earlier
        run's ``clip_params/``), computing in bf16 over f32 weights unless
        ``--fp32``; its vision tower runs #1 forward and #3 backward on the
        card.  The anchor pixels come from the root's CLIP pack where it
        holds them, else from the JPEGs under ``<data_root>/images`` (PIL;
        decoded once into ``<output>/clip_pixels_u8.npy``, removed at the
        end); with neither the run raises, naming what is missing.  The
        shuffle and each batch's roll come from one
        ``np.random.default_rng(--seed)``, as in the JAX runner.  Every
        model checkpoint gets a ``<tag>_clip.pth`` sibling (CLIP params,
        Adam state, step); ``resume`` restores both sides (without the
        sibling CLIP restarts from ``--clip_path``, with a warning).  At
        the end: ``LAST.pth``, ``LAST.state.pt``, ``LAST_clip.pth`` and
        the trained tower as ``<output>/clip_params/``
        (:meth:`_export_clip_params`)."""
        cfg, tcfg = self.cfg, self.cfg.train
        clip_path = cfg.ood.clip_path
        if not clip_path:
            raise RuntimeError(
                "--update_weight_model needs --clip_path (a local HF CLIP checkpoint directory): the CLIP "
                "towers are trained, so there is no caption-overlap or uniform fallback in this mode "
                "(gqa_weight.py:80-81)"
            )
        scorer = ClipScorer(clip_path, batch_size=tcfg.batch_size, use_bf16=tcfg.use_bf16, device=self.device)
        clip_model = scorer.model
        anchor_pixels, cleanup = self._anchor_pixels(scorer)
        optimizer, rng, shuffle, steps = self._train_state(resume)
        # torch.optim.Adam's defaults in the reference (lr 1e-5,
        # gqa_weight.py:105), as optax.adam.
        clip_optimizer = OptaxAdam(clip_model.parameters(), lr=1e-5)
        if resume:
            clip_file = os.path.join(self.output, f"{resume}_clip.pth")
            if os.path.isfile(clip_file):
                load_clip_state(clip_file, clip_model, clip_optimizer)
            else:
                warnings.warn(
                    f"resume {resume!r}: no {resume}_clip.pth checkpoint - the CLIP weight model restarts "
                    "from --clip_path and the min-max trajectory will diverge from an uninterrupted run",
                    RuntimeWarning, stacklevel=2,
                )
        step = make_weighted_clip_train_step(
            self.forward, clip_model, optimizer, clip_optimizer, temperature=cfg.ood.temperature,
            grad_clip=tcfg.optim.grad_clip, rng=rng, mesh=self.mesh,
        )
        shard_params(self.mesh, clip_model)

        def with_clip_inputs(items):
            for qids, batch, real in items:
                datums = [self.dataset.id2datum[q] for q in qids[self.mesh.rows(len(qids))]]
                ids, mask = scorer.tokenizer.encode_batch([d["sent"] for d in datums], scorer.cfg.max_text_len)
                pixels = anchor_pixels([d["img_id"] for d in datums])
                yield qids, dict(batch, clip_ids=ids, clip_mask=mask, clip_pixels=pixels), real

        def save_clip(tag: str) -> None:
            self._on_main(save_clip_state, os.path.join(self.output, f"{tag}_clip.pth"), clip_model,
                          clip_optimizer, steps)

        if tcfg.chart:
            os.makedirs(os.path.join(self.output, "chart"), exist_ok=True)
        best_valid = 0.0
        history = {"loss": [], "valid": []}
        self.model.train()
        clip_model.train()
        try:
            for epoch in range(tcfg.epochs):
                last_loss = math.nan
                epoch_start = time.time()
                chart = [] if tcfg.chart else None
                batches = device_prefetch(with_clip_inputs(batch_iterator(
                    self.train_set, tcfg.batch_size, shuffle=True, rng=shuffle, drop_last=True,
                    with_target=True, mesh=self.mesh)), self.device)
                for qids, batch, _ in batches:
                    aux = step(batch, int(shuffle.integers(1, len(qids))))
                    last_loss = aux["loss"]
                    if chart is not None:
                        chart.append(self._chart_step(qids, aux))
                    steps += 1
                best_valid = self._epoch_end(epoch, epoch_start, last_loss, history, best_valid, chart,
                                             extra_save=save_clip)
        finally:
            self.model.eval()
            clip_model.eval()
            cleanup()
        self.save("LAST")
        self._save_train_state(optimizer, steps, rng, shuffle)
        save_clip("LAST")
        self._on_main(self._export_clip_params, clip_path, clip_model)
        return history

    def _export_clip_params(self, src_clip_path: str, clip_model) -> str:
        """The trained tower as a reloadable HF checkpoint directory,
        ``<output>/clip_params/`` (:func:`~rgqa_tpu_torch.checkpoint.
        convert.save_clip_dir`): a later ``--strategy weight --clip_path
        <output>/clip_params`` run, or ``--scorer clip``, scores with it,
        in this package or the JAX one."""
        return save_clip_dir(clip_model, src_clip_path, os.path.join(self.output, "clip_params"))

    def _anchor_pixels(self, scorer):
        """(``pixels(img_ids) -> (B, S, S, 3) uint8``, a clean-up) for the
        train split's anchor images at ``scorer``'s size: the root's CLIP
        pack rows (:meth:`_clip_pack`), and for images the pack lacks the
        JPEGs, each decoded once (PIL) into a memmap under ``--output``,
        which the clean-up removes.  Raises before any step when neither
        can give an image, naming the pack and the command that builds
        it."""
        image_root = os.path.join(self.cfg.data.data_root, "images")
        pack, pack_dir = self._clip_pack(scorer, image_root)
        uniq = sorted({self.dataset.id2datum[q]["img_id"] for q in self.train_set.question_ids})
        decode = [i for i in uniq if pack is None or i not in pack]
        if not decode:
            return (lambda img_ids: np.stack([pack.load_u8(i)[0] for i in img_ids])), (lambda: None)
        source = GQAImageSource(image_root)
        _check_decodable(decode, source, image_root, pack_dir, scorer.image_size, what="--update_weight_model")
        size = scorer.image_size
        row = {img_id: i for i, img_id in enumerate(decode)}
        name = "clip_pixels_u8.npy" if self.mesh.world == 1 else f"clip_pixels_u8.rank{self.mesh.rank}.npy"
        cache_path = os.path.join(self.output, name)
        cache = np.lib.format.open_memmap(cache_path, mode="w+", dtype=np.uint8, shape=(len(decode), size, size, 3))
        cached = np.zeros(len(decode), bool)

        def one(img_id: str) -> np.ndarray:
            if img_id not in row:
                return pack.load_u8(img_id)[0]
            r = row[img_id]
            if not cached[r]:
                cache[r] = clip_resize_crop(decode_rgb(source, img_id), size)
                cached[r] = True
            return cache[r]

        def cleanup() -> None:
            nonlocal cache
            del cache
            os.remove(cache_path)

        return (lambda img_ids: np.stack([one(i) for i in img_ids])), cleanup

    def _strategy_step(self, optimizer, rng: DropoutRng):
        """The step of ``--strategy`` (JAX ``runner.py:576-640``)."""
        cfg, tcfg, m = self.cfg, self.cfg.train, self.cfg.model
        if tcfg.strategy == "distill_online":
            teacher = self._teacher()
            return make_online_distill_step(
                self.forward, teacher.forward, optimizer, lam=tcfg.lam,
                mixup_mode=tcfg.mixup_mode or "mixup_v1", mixup_alpha=tcfg.mixup_alpha,
                mixup_beta=tcfg.mixup_beta, lam1=tcfg.lam1, lam2=tcfg.lam2,
                grad_clip=tcfg.optim.grad_clip, rng=rng, mesh=self.mesh,
            )
        if tcfg.strategy == "adv":
            hidden = self.model_cfg.encoder.hidden_size
            adv = AdvConfig(steps=tcfg.adv_steps, lr_txt=tcfg.adv_lr_txt, lr_img=tcfg.adv_lr_img,
                            max_norm=tcfg.adv_max_norm, kl_weight=tcfg.adv_kl_weight,
                            norm_type=tcfg.adv_norm_type)
            return make_adv_train_step(self.forward, optimizer, lambda b: (*b["input_ids"].shape, hidden),
                                       adv, grad_clip=tcfg.optim.grad_clip, rng=rng, mesh=self.mesh)
        return make_train_step(
            self.forward, optimizer, loss=tcfg.loss, sample_pair=tcfg.sample_pair,
            mixup_mode=tcfg.mixup_mode, mixup_alpha=tcfg.mixup_alpha, mixup_beta=tcfg.mixup_beta,
            lam1=tcfg.lam1, lam2=tcfg.lam2,
            energy=cfg.ood.scorer == "energy" and tcfg.m_in != 0, m_in=tcfg.m_in, m_out=tcfg.m_out,
            branched=m.branched or m.branched_layers, uq_as_class=m.uq_as_class,
            binary=tcfg.strategy in ("separate", "caption"), weighted_rp=tcfg.strategy == "weight",
            grad_clip=tcfg.optim.grad_clip, rng=rng, mesh=self.mesh,
        )

    def _teacher(self) -> "GQARunner":
        """``distill_online``'s frozen teacher: an evaluation runner of
        this config (so at the student's precision) loading
        ``--teacher_path`` (a ``.pth``; ``<path>.pth`` when ``<path>``
        is missing, as the strategy script's ``vanilla/BEST`` names a
        run's output)."""
        cfg = self.cfg
        path = cfg.teacher_path
        if not path:
            raise ValueError("--strategy distill_online needs --teacher_path")
        path = pth_path(path)
        return GQARunner(
            dataclasses.replace(cfg, load=path, output=os.path.join(cfg.output, "teacher"),
                                train=dataclasses.replace(cfg.train, strategy="conf")),
            init_train=False, device=self.device,
        )

    def _negative_weights(self, qids: list, similarity, rng: np.random.Generator) -> dict:
        """``--strategy weight``'s per-batch host work (``runner.py:665-676``):
        the roll ``shift`` from the run's shuffle generator, the anchor x
        rolled-question similarities and their weights ``exp((s - max s) /
        --temperature)``, normalized over the global batch (this rank's
        rows of them under several ranks)."""
        shift = int(rng.integers(1, len(qids)))
        neg_qids = qids[-shift:] + qids[:-shift]  # np.roll order
        sims = similarity(qids, neg_qids)
        w = np.exp((sims - sims.max()) / self.cfg.ood.temperature)
        w = (w / w.sum())[self.mesh.rows(len(qids))]
        weights = torch.from_numpy(np.ascontiguousarray(w, np.float32))
        return {"shift": shift, "neg_weights": weights.to(self.device, non_blocking=True)}

    def _weight_similarity(self):
        """Image x question similarity for ``--strategy weight``
        (``runner.py:980-1068``, ``gqa_weight.py``): CLIP's when
        :meth:`_clip_weight_similarity` has a model and pixels, else the
        caption / question word overlap of ``<data_root>/image2caps.json``,
        else zeros (uniform weights: a plain RP run, with a warning)."""
        clip_sim = self._clip_weight_similarity()
        if clip_sim is not None:
            return clip_sim
        caps_path = os.path.join(self.cfg.data.data_root, "image2caps.json")
        image2caps = {}
        if os.path.exists(caps_path):
            with open(caps_path) as f:
                image2caps = json.load(f)

        def overlap_similarity(anchor_qids, neg_qids):
            sims = np.zeros(len(anchor_qids), np.float32)
            for i, (aq, nq) in enumerate(zip(anchor_qids, neg_qids)):
                img_id = self.dataset.id2datum[aq]["img_id"]
                cap = " ".join(image2caps.get(img_id, [""])).lower().split()
                sent = self.dataset.id2datum[nq]["sent"].lower().split()
                if cap and sent:
                    sims[i] = len(set(cap) & set(sent)) / len(set(sent))
            return sims

        if image2caps:
            return overlap_similarity
        warnings.warn(
            "--strategy weight: no CLIP checkpoint (--clip_path) and no "
            f"{caps_path} found - negative-pair weights fall back to "
            "UNIFORM, making this a plain RP run. Provide a local CLIP "
            "checkpoint or an image2caps.json for real similarity "
            "weighting.",
            RuntimeWarning, stacklevel=2,
        )
        return lambda a, n: np.zeros(len(a), np.float32)

    def _clip_weight_similarity(self):
        """CLIP anchor-image x rolled-question similarity
        (``gqa_weight.py:154-186``): the normalized embeddings' inner
        product times ``logit_scale.exp()``, each image embedded once (a
        cache), f32.  Needs ``--clip_path`` and pixels: a matching CLIP
        pixel pack (:meth:`_clip_pack`; a synthetic root writes its own)
        or the JPEGs under ``<data_root>/images`` (the JAX runner reads
        only the JPEGs; the machine with the card has packs, not PIL).
        Returns None without either."""
        clip_path = self.cfg.ood.clip_path
        if not clip_path:
            return None
        image_root = os.path.join(self.cfg.data.data_root, "images")
        scorer = ClipScorer(clip_path, batch_size=min(self.cfg.train.batch_size, 64), device=self.device)
        pack, _ = self._clip_pack(scorer, image_root)
        if pack is None and not os.path.isdir(image_root):
            return None
        source = GQAImageSource(image_root)
        embed_cache: dict[str, np.ndarray] = {}

        def similarity(anchor_qids, neg_qids):
            img_ids = [self.dataset.id2datum[q]["img_id"] for q in anchor_qids]
            sents = [self.dataset.id2datum[q]["sent"] for q in neg_qids]
            fresh = [i for i in dict.fromkeys(img_ids) if i not in embed_cache]
            if fresh:
                imgs = [pack.load_u8(i)[0] if pack is not None and i in pack else decode_rgb(source, i)
                        for i in fresh]
                for img_id, e in zip(fresh, scorer.image_embeds(imgs)):
                    embed_cache[img_id] = e
            txt = scorer.text_embeds(sents)
            img = np.stack([embed_cache[i] for i in img_ids])
            return np.sum(img * txt, -1) * scorer.logit_scale

        return similarity

    def train_minmax(self) -> dict:
        """The dual-loader min-max training of ``--strategy resampling``,
        ``poem`` and ``woods`` (JAX ``train_minmax``, ``runner.py:1071-1141``;
        ``gqa_resampling.py`` / ``gqa_poem.py`` / ``gqa_woods.py``).
        Positive batches stream shuffled from ``--train_pos``; each step's
        negative batch (``--train_neg``'s pseudo-UQ rows) is drawn by the
        learned weights (:class:`~rgqa_tpu_torch.train.dual_loader.
        NegativeWeights`, SGD at ``--lr_w``; WOODS keeps them uniform), both
        from the run's one numpy generator, as in JAX.  Per epoch a
        validation with ``BEST.pth``; ``LAST.pth`` at the end.  Under
        several ranks every rank draws the global negative indices and
        reads its rows of them."""
        cfg, tcfg = self.cfg, self.cfg.train
        root = cfg.data.data_root
        pos_ds = GQADataset(root, cfg.data.train_pos, add_uq=True)
        neg_ds = GQADataset(root, cfg.data.train_neg, add_uq=True)
        pos_set, neg_set = self._encode(pos_ds, train=True), self._encode(neg_ds, train=True)
        self.dataset = pos_ds
        t_total = max(len(pos_set) // tcfg.batch_size * tcfg.epochs, 1)
        optimizer = make_optimizer(tcfg.optim, self.model.parameters(), t_total)
        rng = DropoutRng.for_rank(tcfg.seed, self.device, rank=self.mesh.rank, world=self.mesh.world)
        weighted = tcfg.strategy != "woods"
        step = make_minmax_step(self.forward, optimizer, weighted=weighted, grad_clip=tcfg.optim.grad_clip,
                                rng=rng, mesh=self.mesh)
        weights = NegativeWeights(len(neg_set), tcfg.lr_w, device=self.device)
        shuffle = np.random.default_rng(tcfg.seed)
        best_valid = 0.0
        history = {"loss": [], "valid": []}
        self.model.train()
        try:
            for epoch in range(tcfg.epochs):
                sampling_w = weights.sampling_weights()
                last = math.nan
                for _, pos, _ in batch_iterator(pos_set, tcfg.batch_size, shuffle=True, rng=shuffle,
                                                drop_last=True, with_target=True, mesh=self.mesh):
                    wids = sample_negative_indices(shuffle, sampling_w, tcfg.batch_size)[
                        self.mesh.rows(tcfg.batch_size)]
                    neg = neg_set.gather_batch(wids, with_target=True)
                    w_grads, aux = step(weights.values, to_device(pos, self.device), to_device(neg, self.device),
                                        torch.from_numpy(wids).to(self.device))
                    if weighted:
                        weights.apply(w_grads)
                    last = aux["loss"]
                history["loss"].append(float(last))
                log_str = f"\nEpoch {epoch}: Train Loss {float(last):.2f}\n"
                if self.valid_set is not None:
                    valid = self._validate()
                    history["valid"].append(valid)
                    if valid > best_valid:
                        best_valid = valid
                        self.save("BEST")
                    log_str += f"Epoch {epoch}: Valid {valid * 100:.2f}\n"
                self._on_main(self._log, log_str)
        finally:
            self.model.eval()
        self.save("LAST")
        return history
