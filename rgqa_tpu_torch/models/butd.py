"""BUTD (bottom-up top-down attention) for GQA (port of
``rgqa_tpu/models/butd.py`` and ``rgqa_tpu/ops/gru.py``).

GloVe-300 word embeddings -> one GRU-1024 layer over 40 front-padded
tokens -> product-fusion attention over the RoIs (features ++ box
geometry, 2048 + 4) -> question x image fusion -> the weight-normed
2 x 1024 ReLU classifier.  The question runs through ``torch.nn.GRU``
(cuDNN on the card): PyTorch's GRU has the r / z / n gates and the two
bias vectors of the JAX package's ``gru_scan``, so no kernel is written
for it.  Every step runs, pads included, and the last step's state is
the question summary: the pads come first, so no packed sequence.

The model keeps f32 weights and computes in f32 whatever the run's
``--bf16`` says, as the JAX package's ``_build_butd`` does (it ignores
the dtype).  On the card its products run without TF32:
:func:`~rgqa_tpu_torch.device.exact_f32` turns TF32 off in cuDNN (the
GRU) and cuBLAS for the forward, and the train step holds it over the
backward too; the switches are restored after each call, so no other
model is touched.

Dropout (0.2 on the attention's joint, 0.5 after the classifier's first
layer) is flax's ``nn.Dropout``: keep with probability ``1 - rate``
exactly, kept values over ``1 - rate``; the draws come from the
forward's :class:`~rgqa_tpu_torch.ops.dropout.DropoutRng`.

Also here, framework-free copies of the JAX module's helpers:
:func:`butd_split`, :func:`tokenize_front_padded` and
:func:`build_glove_matrix` (``tests/test_torch_port_rules.py`` holds
them to their originals).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rgqa_tpu_torch.device import exact_f32
from rgqa_tpu_torch.ops.dropout import DropoutRng

__all__ = [
    "MAX_GQA_LENGTH",
    "WeightNormDense",
    "ProductFusionAttention",
    "ButdForGQA",
    "init_butd_weights",
    "butd_split",
    "tokenize_front_padded",
    "build_glove_matrix",
]

MAX_GQA_LENGTH = 40  # reference butd.py:6


def _dropout(x: torch.Tensor, rate: float, training: bool, rng: Optional[DropoutRng]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability ``1 - rate``, scale by
    ``1 / (1 - rate)``."""
    if not training or rate == 0.0:
        return x
    keep_p = 1.0 - rate
    u = torch.rand(x.shape, device=x.device, generator=rng.device if rng is not None else None)
    return torch.where(u < keep_p, x / keep_p, torch.zeros_like(x))


class WeightNormDense(nn.Module):
    """Dense layer with a scalar weight norm, torch ``weight_norm(...,
    dim=None)``: ``w = g * v / ||v||_F``, recomputed on every call inside
    autograd.  Parameters ``v`` (out, in), ``g`` () and ``b`` (out,)."""

    def __init__(self, in_dim: int, features: int):
        super().__init__()
        self.v = nn.Parameter(torch.empty(features, in_dim))
        self.g = nn.Parameter(torch.ones(()))
        self.b = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = (self.g / torch.linalg.vector_norm(self.v)) * self.v
        return F.linear(x, w, self.b)


class ProductFusionAttention(nn.Module):
    """Softmax attention over the RoIs through the projected elementwise
    product (reference ``butd.py:76-104``); returns (B, K, 1)."""

    def __init__(self, image_dim: int, hidden: int, dropout: float = 0.2):
        super().__init__()
        self.rate = dropout
        self.image_proj = WeightNormDense(image_dim, hidden)
        self.question_proj = WeightNormDense(hidden, hidden)
        self.linear = WeightNormDense(hidden, 1)

    def forward(self, image_features, question_emb, *, rng: Optional[DropoutRng] = None):
        img = F.relu(self.image_proj(image_features))
        q = F.relu(self.question_proj(question_emb))
        joint = _dropout(img * q[:, None, :], self.rate, self.training, rng)
        return torch.softmax(self.linear(joint), dim=1)


class ButdForGQA(nn.Module):
    """GRU + top-down attention GQA model.  Takes front-padded token
    indices (the padding index is ``vocab_size``, one past the last
    word), RoI ``feats`` (B, K, visual_dim) and ``boxes`` (B, K, 4);
    returns ``{"logits", "pooled"[, "conf"][, "attention"]}``, ``pooled``
    the joint question x image feature (the Mahalanobis scorer's)."""

    def __init__(
        self, vocab_size: int, num_answers: int, *, embed_dim: int = 300, hidden: int = 1024,
        visual_dim: int = 2048, branched: bool = False, attention_dropout: float = 0.2,
        answer_dropout: float = 0.5,
    ):
        super().__init__()
        self.hidden = hidden
        self.answer_dropout = answer_dropout
        self.precision = exact_f32  # the products' context (a profile swaps in TF32 to price it)
        image_dim = visual_dim + 4
        self.w_emb = nn.Embedding(vocab_size + 1, embed_dim)
        self.gru = nn.GRU(embed_dim, hidden, batch_first=True)
        self.att = ProductFusionAttention(image_dim, hidden, attention_dropout)
        self.q_project = WeightNormDense(hidden, hidden)
        self.img_project = WeightNormDense(image_dim, hidden)
        self.ans_fc1 = WeightNormDense(hidden, 2 * hidden)
        self.ans_fc2 = WeightNormDense(2 * hidden, num_answers)
        self.branched = branched
        if branched:
            self.conf_fc1 = WeightNormDense(hidden, 2 * hidden)
            self.conf_fc2 = WeightNormDense(2 * hidden, 1)

    def forward(
        self, token_ids, feats, boxes, *, rng: Optional[DropoutRng] = None,
        output_attention: bool = False,
    ) -> dict:
        with self.precision():
            w = self.w_emb(token_ids.long())
            h0 = torch.zeros((1, w.shape[0], self.hidden), dtype=w.dtype, device=w.device)
            outs, _ = self.gru(w, h0)
            # Front-padded: the last step is the question summary
            # (reference butd.py:66-68).
            q_enc = outs[:, -1]
            image_features = torch.cat([feats.float(), boxes.float()], dim=2)  # (B, K, 2052)
            att = self.att(image_features, q_enc, rng=rng)
            img_enc = (image_features * att).sum(dim=1)
            joint = F.relu(self.q_project(q_enc)) * F.relu(self.img_project(img_enc))
            hdn = _dropout(F.relu(self.ans_fc1(joint)), self.answer_dropout, self.training, rng)
            out = {"logits": self.ans_fc2(hdn), "pooled": joint}
            if self.branched:
                c = _dropout(F.relu(self.conf_fc1(joint)), self.answer_dropout, self.training, rng)
                out["conf"] = self.conf_fc2(c)[:, 0]
            if output_attention:
                out["attention"] = att
            return out


@torch.no_grad()
def init_butd_weights(model: ButdForGQA, generator: torch.Generator) -> None:
    """The JAX module's init, quirks included, drawn in module order:
    the embedding normal(0, 1/sqrt(embed_dim)) (flax ``Embed``); the GRU
    weights flax ``uniform(1/sqrt(hidden))``, U[0, 1/sqrt(hidden)), not
    symmetric, biases zero; each ``WeightNormDense`` ``v`` from
    ``variance_scaling(1/3, "fan_in", "uniform")``, which reads the fan-in
    off ``v``'s first axis (the output width): U(-1/sqrt(out),
    1/sqrt(out)); ``g`` one and ``b`` zero."""

    emb = model.w_emb.weight
    emb.copy_(torch.randn(emb.shape, generator=generator, device=emb.device) / math.sqrt(emb.shape[1]))
    scale = 1.0 / math.sqrt(model.hidden)
    for name in ("weight_ih_l0", "weight_hh_l0"):
        w = getattr(model.gru, name)
        w.copy_(torch.rand(w.shape, generator=generator, device=w.device) * scale)
    for name in ("bias_ih_l0", "bias_hh_l0"):
        getattr(model.gru, name).zero_()
    for mod in model.modules():
        if isinstance(mod, WeightNormDense):
            limit = 1.0 / math.sqrt(mod.v.shape[0])
            mod.v.copy_((torch.rand(mod.v.shape, generator=generator, device=mod.v.device) * 2 - 1) * limit)
            mod.g.fill_(1.0)
            mod.b.zero_()


# ---------------------------------------------------------------------------
# Framework-free copies of the JAX module's helpers.
# ---------------------------------------------------------------------------


def tokenize_front_padded(
    sentences, word2idx: dict[str, int], max_len: int = MAX_GQA_LENGTH
) -> np.ndarray:
    """BUTD's front-padded index tokenizer (reference ``butd.py:180-193``
    + ``preprocess.py:30-42``): lowercase, strip punctuation-ish chars,
    split possessives, pad in front with the padding index."""
    pad_idx = len(word2idx)
    out = np.full((len(sentences), max_len), pad_idx, dtype=np.int32)
    for i, sent in enumerate(sentences):
        toks = butd_split(sent)
        ids = [word2idx.get(t, pad_idx) for t in toks][:max_len]
        if ids:
            out[i, -len(ids):] = ids
    return out


def build_glove_matrix(
    word2idx: dict[str, int], glove_path: str, dim: int = 300
) -> np.ndarray:
    """GloVe embedding matrix for a word dict
    (reference ``butd/preprocess.py:54-123``): rows for known words from
    the GloVe text file, zeros elsewhere; one extra all-zero padding row."""
    out = np.zeros((len(word2idx) + 1, dim), np.float32)
    with open(glove_path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip().split(" ")
            word = parts[0]
            if word in word2idx and len(parts) == dim + 1:
                out[word2idx[word]] = np.asarray(parts[1:], np.float32)
    return out


def butd_split(sentence: str) -> list[str]:
    """The reference's ad-hoc word splitter (``preprocess.py:30-42``)."""
    s = (
        sentence.lower()
        .replace(",", "")
        .replace("?", "")
        .replace("'s", " 's")
    )
    return s.split()
