"""GQA runner for evaluation (port of ``rgqa_tpu/runner.py``'s
construction path, ``GQARunner.__init__`` and ``load``).

It makes the synthetic data when asked and it is missing, loads the
feature pack and the tokenizer, sizes the answer head to the dataset's
answers less the appended ``UQ`` class, initialises the weights from a
``torch.Generator`` seeded with ``--seed`` and loads ``--load <reference
.pth>``.  In bf16 mode (the default; ``--fp32`` turns it off) the
weights are cast to bf16, the JAX package's serving convention.

Not ported yet: training, orbax snapshots (reading them needs jax), the
``--loadLXMERT`` / ``--loadLXMERTQA`` initialisations and every backbone
but lxmert.  Options that need them raise.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from rgqa_tpu.config import RunConfig, dump_run_config
from rgqa_tpu_torch.checkpoint.convert import load_reference_pth
from rgqa_tpu_torch.data.dataset import EncodedGQA, GQADataset
from rgqa_tpu_torch.data.synthetic import make_synthetic_gqa
from rgqa_tpu_torch.data.tokenizer import WordPieceTokenizer, load_vocab
from rgqa_tpu_torch.data.tsv import PackedFeatures
from rgqa_tpu_torch.eval import ScoringMixin
from rgqa_tpu_torch.models.zoo import build_model

__all__ = ["GQARunner"]


def _check_ported(cfg: RunConfig) -> None:
    m, d = cfg.model, cfg.data
    unported = {
        f"--backbone {m.backbone}": m.backbone != "lxmert",
        "--branched / --branched_layer": m.branched or m.branched_layers,
        "--uq_as_class": m.uq_as_class,
        "--loadLXMERT / --loadLXMERTQA / --load_gqa": bool(
            cfg.load_lxmert or cfg.load_lxmert_qa or cfg.load_gqa
        ),
        "--feed_int8": d.feed_int8,
        "--eval_chunk > 1": cfg.train.eval_chunk > 1,
    }
    named = [flag for flag, used in unported.items() if used]
    if named:
        raise NotImplementedError(f"not ported yet: {', '.join(named)}")


class GQARunner(ScoringMixin):
    """Evaluation-only GQA runner on one device (default: CUDA when a
    card is present, else the CPU)."""

    def __init__(self, cfg: RunConfig, *, device: Optional[torch.device | str] = None):
        _check_ported(cfg)
        self.cfg = cfg
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self.device = torch.device(device)
        data = cfg.data
        root = data.data_root

        if data.synthetic and not os.path.exists(
            os.path.join(root, "trainval_ans2label.json")
        ):
            make_synthetic_gqa(root)

        self.features = PackedFeatures(os.path.join(root, "features"))
        if data.tiny:
            self.features = self.features.truncate(512)
        elif data.fast:
            self.features = self.features.truncate(5000)
        self.tokenizer = WordPieceTokenizer(load_vocab(os.path.join(root, "vocab.txt")))

        # The answer vocab comes from the splits under evaluation; the
        # model outputs num_answers - 1 logits, 'UQ' being the appended
        # indicator class.
        self.dataset = GQADataset(root, data.test_splits or data.valid_splits, add_uq=True)
        self.model_cfg = dataclasses.replace(
            cfg.model, num_answers=self.dataset.num_answers - 1
        )
        generator = torch.Generator(device=self.device).manual_seed(cfg.train.seed)
        self.model, self.forward = build_model(
            self.model_cfg, use_bf16=cfg.train.use_bf16,
            device=self.device, generator=generator,
        )
        self.label2ans = self.dataset.label2ans
        if cfg.load:
            self.load(cfg.load)

        self.output = cfg.output
        os.makedirs(self.output, exist_ok=True)
        dump_run_config(cfg, self.output)

    def _encode(self, ds: GQADataset) -> EncodedGQA:
        return EncodedGQA(
            ds, self.features, tokenizer=self.tokenizer,
            max_text_len=self.cfg.model.max_text_len,
        )

    def load(self, path: str) -> None:
        """Load a reference GQA-LXMERT ``.pth`` into the model (cast to
        the model's dtype); keys it lacks stay at their init."""
        if not os.path.isfile(path):
            raise NotImplementedError(
                f"{path!r} is not a .pth file; loading orbax snapshots needs "
                "jax and is not ported yet"
            )
        enc = self.model_cfg.encoder
        sd, missing, unused = load_reference_pth(
            path, l_layers=enc.l_layers, x_layers=enc.x_layers, r_layers=enc.r_layers
        )
        self.model.load_state_dict(sd, strict=False)
        if missing:
            print(f"Weights not found in ckpt: {missing[:5]}...")
        if unused:
            print(f"Ckpt weights unused: {unused[:5]}...")
