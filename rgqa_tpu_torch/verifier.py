"""Verifier rejection strategy: answer-statement plausibility (port of
``rgqa_tpu/verifier.py``; reference ``src/tasks/gqa_verifier.py``).

Each question becomes a declarative template with an ``**blank**``
answer slot; a binary verifier (a one-logit GQA model over statement +
image) trains on

- the gold-answer fill (label 1),
- a wrong top-k proposal fill of the frozen answerer (label 0),
- another question's gold fill (label 0)
  (``gqa_verifier.py:165-280``),

and at evaluation scores the statement filled with the answerer's
prediction.  :func:`statement_with_rule`, :func:`question_to_statement`
and :func:`fill_statement` are copies of the JAX module's rule set (the
reference parses with benepar, which neither package has), held to them
by ``tests/test_torch_port_rules.py``.  :class:`VerifierTrainer` keeps
the JAX class's API; its steps run the port's one-logit train step
(``--strategy separate``'s: #4 / #5 at the verifier's dropout on the
card) and its forwards #1.  The JAX package has no CLI for it, and
neither has the port.

Data parallel (the runners' ``mesh`` of N ranks, as the JAX trainer
shards each statement batch over its mesh): every rank draws the shuffle,
the wrong-proposal pick and the partner question of each global batch of
``b`` questions from the shared host stream, runs the answerer's top-k on
its own rows and gathers them, builds all ``3b`` statements and trains on
its rows of them (the world must divide ``b``); the gradients are
averaged before the clip and the loss is the global mean.  Evaluation
scores through the verifier's ``_map_eval``, and rank 0 dumps.
"""

from __future__ import annotations

import re
from typing import Optional, Sequence

import numpy as np
import torch

from rgqa_tpu_torch.data.batching import batch_iterator, to_device
from rgqa_tpu_torch.ops.dropout import DropoutRng
from rgqa_tpu_torch.parallel import check_batch_size, gather_rows, make_mesh, shard_batch
from rgqa_tpu_torch.scorers.core import make_msp_scorer
from rgqa_tpu_torch.train.optimizer import make_optimizer
from rgqa_tpu_torch.train.step import make_train_step

__all__ = [
    "question_to_statement",
    "statement_with_rule",
    "fill_statement",
    "VerifierTrainer",
]

_AUX = ("is", "are", "was", "were", "does", "do", "did", "can", "could")
_PRONOUNS = {"it", "this", "that", "he", "she"}


def statement_with_rule(sent: str) -> tuple[str, str]:
    """Question -> (statement template with an ``**blank**`` answer slot,
    name of the rule that fired).

    The rule set covers the real GQA question-form distribution — measured
    over the 11,158 questions of the reference's golden example
    (``compute_accfpr/example.json``) in
    ``tests/test_fidelity.py::TestVerifierTemplates`` — replacing the
    reference's benepar-parse POSTree transform (``POSTree.py:24+``),
    which is uninstallable here.  ``fallback`` marks questions no rule
    converts (statement keeps the question's own word order).
    """
    q = sent.strip().rstrip("?").strip()
    low = q.lower()
    # Contractions: "what's" -> "what is" etc. (121/11k GQA questions).
    low = re.sub(r"\b(what|who|where|which|how)'s\b", r"\1 is", low)
    words = low.split()
    if not words:
        return "**blank**", "empty"
    w0 = words[0]

    m = re.match(r"(?:of\s+)?(what|which)\s+colou?r\s+(is|are)\s+(.*)", low)
    if m:
        return f"the color of {m.group(3)} {m.group(2)} **blank**", "color"
    m = re.match(r"how\s+many\s+(.*)", low)
    if m:
        return f"there are **blank** {m.group(1)}", "count"
    # "how big/tall/... is X" -> "X is **blank**" (the answer is the
    # degree adjective: "how big is the house" / "large").
    m = re.match(r"how\s+(\w+)\s+(is|are)\s+(.*)", low)
    if m and m.group(1) not in ("many", "much"):
        return f"{m.group(3)} {m.group(2)} **blank**", "degree"
    # "how clean do you think is X" -> "X is **blank**".
    m = re.match(r"how\s+\w+\s+do\s+you\s+think\s+(is|are)\s+(.*)", low)
    if m:
        return f"{m.group(2)} {m.group(1)} **blank**", "degree"
    # "how is X called" / "what is X called" -> "X is called **blank**".
    m = re.match(r"(?:how|what)\s+(is|are)\s+(.*?)\s+called", low)
    if m:
        return f"{m.group(2)} {m.group(1)} called **blank**", "called"
    m = re.match(r"what\s+(.*?)\s+(is|are)\s+called", low)
    if m:  # GQA's inverted form: "what the X is called?"
        return f"{m.group(1)} {m.group(2)} called **blank**", "called"
    m = re.match(r"where\s+(is|are)\s+(.*)", low)
    if m:
        return f"{m.group(2)} {m.group(1)} in **blank**", "where"
    m = re.match(r"where\s+(does|do|did)\s+(.*)", low)
    if m:
        return f"{m.group(2)} in **blank**", "where-do"
    # "(on|in) which side ..." -> "... on the **blank** side".
    m = re.match(r"(on|in)\s+which\s+side(?:\s+of\s+(?:the\s+)?\w+)?\s+(is|are)\s+(.*)", low)
    if m:
        return (
            f"{m.group(3)} {m.group(2)} {m.group(1)} the **blank** side",
            "side",
        )
    m = re.match(r"(what|which|who)\s+(is|are|was|were)\s+(.*)", low)
    if m:
        rest = m.group(3)
        if rest in _PRONOUNS:  # "which place is it" -> "it is **blank**"
            return f"{rest} {m.group(2)} **blank**", "wh-pronoun"
        return f"**blank** {m.group(2)} {rest}", "wh-copula"
    # "what/which/who <noun phrase> <verb> ..." ("what kind of device is
    # shown", "which animal do you see") and do-support forms.
    m = re.match(r"(what|which|who)\s+(.*?)\s+(does|do|did)\s+(.*)", low)
    if m:
        return f"{m.group(4)} the **blank** {m.group(2)}", "wh-do"
    m = re.match(r"(what|which|who)\s+(.*)", low)
    if m:
        return f"the {m.group(2)} is **blank**", "wh-generic"
    if w0 in _AUX:
        # Yes/no question: "is there a dog" -> "there is a dog , **blank**".
        rest = " ".join(words[1:])
        return f"{rest} , **blank**", "yes-no"
    # Trailing-wh questions are already in statement order ("The vase
    # holds what?", "... is of which color?"): substitute the wh-tail.
    m = re.match(r"(.*)\s+(?:of\s+)?(?:which|what)\s+colou?r$", low)
    if m:
        return f"{m.group(1)} **blank** color", "tail-color"
    m = re.match(r"(.*)\s+(what|who|where|which)$", low)
    if m:
        return f"{m.group(1)} **blank**", "tail-wh"
    # "Beside/inside what is the X ..." -> "the X ... is beside **blank**".
    m = re.match(
        r"(beside|inside|behind|under|over|near|above|below|around)\s+"
        r"what\s+(is|are)\s+(.*)", low,
    )
    if m:
        return f"{m.group(3)} {m.group(2)} {m.group(1)} **blank**", "prep-wh"
    return f"{low} **blank**", "fallback"


def question_to_statement(sent: str) -> str:
    """Question -> statement template with an ``**blank**`` answer slot."""
    return statement_with_rule(sent)[0]


def fill_statement(template: str, answer: str) -> str:
    if answer == "":
        return template.replace(" **blank**", "").replace("**blank**", "")
    return template.replace("**blank**", answer)


class VerifierTrainer:
    """Trains and evaluates the statement verifier.

    ``answerer`` is a trained :class:`~rgqa_tpu_torch.runner.GQARunner`
    (frozen); ``verifier`` a ``GQARunner`` built with ``--strategy
    separate`` (a one-logit model) whose text inputs are statements.
    ``seed`` seeds the host generator of the shuffle, the wrong-proposal
    pick and the partner question (JAX's draws, in its order); the
    verifier's dropout draws from a :class:`DropoutRng` seeded 0 (the
    rank's stream of it), where JAX's key is ``PRNGKey(0)``.  A process
    launched as one of several ranks without joining raises, as the
    runners do."""

    def __init__(self, verifier, answerer, topk: int = 5, seed: int = 0):
        make_mesh()  # a rank launched without joining raises here
        self.verifier = verifier
        self.answerer = answerer
        self.topk = topk
        self.rng = np.random.default_rng(seed)
        self.templates: dict[str, str] = {}

    def _template(self, qid: str, sent: str) -> str:
        if qid not in self.templates:
            self.templates[qid] = question_to_statement(sent)
        return self.templates[qid]

    def _statement_batch(self, sents: Sequence[str], base_batch: dict) -> dict:
        ids, mask, seg = self.verifier.tokenizer.encode_batch(sents, self.verifier.cfg.model.max_text_len)
        return dict(base_batch, input_ids=ids, input_mask=mask, segment_ids=seg)

    def train(self, encoded, epochs: int = 1, batch_size: int = 16) -> list[float]:
        """``epochs`` over ``encoded`` (the verifier's encoding of a split),
        ``batch_size`` questions a step, each giving three statements (3 x
        ``batch_size`` rows); returns each step's loss."""
        ver, device, mesh = self.verifier, self.verifier.device, self.verifier.mesh
        check_batch_size(mesh, batch_size, "the verifier's batch_size")
        n_batches = len(encoded) // batch_size
        optimizer = make_optimizer(ver.cfg.train.optim, ver.model.parameters(), max(n_batches * epochs, 1))
        rng = DropoutRng.for_rank(0, device, rank=mesh.rank, world=mesh.world)
        # Clip 5.0, as the JAX step; under several ranks after the gradients' average.
        step = make_train_step(ver.forward, optimizer, binary=True, rng=rng, mesh=mesh)
        losses = []
        dataset = encoded.dataset
        label2ans = self.answerer.label2ans
        ver.model.train()
        try:
            for _ in range(epochs):
                for qids, batch, _ in batch_iterator(encoded, batch_size, shuffle=True, rng=self.rng,
                                                     drop_last=True):
                    with torch.no_grad():  # this rank's rows, every rank's proposals gathered
                        logits = self.answerer.forward(to_device(shard_batch(mesh, batch), self.answerer.device),
                                                       deterministic=True)["logits"]
                        top = torch.topk(logits.float(), self.topk, dim=-1).indices
                        proposals = gather_rows(mesh, top).cpu().numpy()
                    sents, labels = [], []
                    b = len(qids)
                    for j, qid in enumerate(qids):
                        datum = dataset.id2datum[qid]
                        tmpl = self._template(qid, datum["sent"])
                        gold = next(iter(datum.get("label") or {}), "")
                        # Positive: the gold fill.
                        sents.append(fill_statement(tmpl, gold))
                        labels.append(1.0)
                        # Negative 1: a wrong top-k proposal's fill.
                        wrong = [label2ans[int(p)] for p in proposals[j] if label2ans[int(p)] != gold]
                        pick = wrong[int(self.rng.integers(len(wrong)))] if wrong else ""
                        sents.append(fill_statement(tmpl, pick))
                        labels.append(0.0)
                        # Negative 2: another question's gold statement (never
                        # the anchor's own: it would be labeled 0 and 1).
                        k = (j + int(self.rng.integers(1, b))) % b
                        other = dataset.id2datum[qids[k]]
                        o_tmpl = self._template(qids[k], other["sent"])
                        o_gold = next(iter(other.get("label") or {}), "")
                        sents.append(fill_statement(o_tmpl, o_gold))
                        labels.append(0.0)
                    tiled = {k: np.repeat(np.asarray(batch[k]), 3, axis=0) for k in ("feats", "boxes")}
                    vb = self._statement_batch(sents, tiled)
                    vb["target"] = np.zeros((3 * b, 1), np.float32)
                    vb["id_mask"] = np.asarray(labels, np.float32)
                    losses.append(float(step(to_device(shard_batch(mesh, vb), device))["loss"]))
        finally:
            ver.model.eval()
        return losses

    def ood_evaluate(self, encoded, dump: Optional[str] = None) -> dict:
        """Answers from the answerer; confidence = the verifier's MSP of the
        statement filled with the answer (``gqa_verifier.py``'s evaluation);
        the RGQA metric dict, and with ``dump`` the prediction JSON."""
        ver = self.verifier
        answers = self.answerer.predict(self.answerer._encode(encoded.dataset))
        sents = [fill_statement(self._template(q, encoded.dataset.id2datum[q]["sent"]), answers[q])
                 for q in encoded.question_ids]
        statements = _Statements(encoded, self._statement_batch(sents, {}))
        quesid2ans = {}
        for qids, out, real in ver._map_eval(statements, make_msp_scorer(ver.forward), ("score",)):
            for qid, s in zip(qids, out["score"][:real]):
                quesid2ans[qid] = (answers[qid], float(s))
        return ver._rejection_results(encoded, quesid2ans, dump)


class _Statements:
    """``encoded``'s rows with the text fields of ``statements`` (one
    statement a row): the RoI feats and boxes, and the question ids."""

    def __init__(self, encoded, statements: dict):
        self.encoded, self.statements = encoded, statements
        self.question_ids = encoded.question_ids

    def __len__(self) -> int:
        return len(self.encoded)

    def gather_batch(self, idx, with_target: bool = False) -> dict:
        batch = self.encoded.gather_batch(idx)
        return dict({k: batch[k] for k in ("feats", "boxes")}, **{k: v[idx] for k, v in self.statements.items()})
