"""Port parity: the statement verifier (``rgqa_tpu_torch/verifier.py``)
against ``rgqa_tpu/verifier.py``, on the CPU.

- the statement rules equal JAX's on ``tests/test_longtail.py``'s cases,
  on the GQA question forms each rule covers, and on generated questions
  (``hypothesis``: wh-words, auxiliaries, prepositions and free words);
- ``VerifierTrainer.train`` at dropout 0 against JAX's with the same
  ``seed``, weights (a tiny LXMERT answerer and a one-logit verifier,
  the JAX inits carried across as ``.pth``) and batches: the same
  statements every step (so the same top-k proposals and draws), losses
  per step rtol 1e-4;
- ``ood_evaluate`` after those steps: AUAF / FF95 / FACC within 1e-6 of
  JAX's, and its dump round-trips through the port's ``compute_accfpr``
  to the JAX CLI's dict.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from rgqa_tpu_torch import verifier
from rgqa_tpu_torch.checkpoint.convert import from_jax_params, to_reference_state_dict
from rgqa_tpu_torch.data.dataset import GQADataset
from rgqa_tpu_torch.data.synthetic import SyntheticSpec, make_synthetic_gqa
from rgqa_tpu_torch.runner import GQARunner
from test_torch_slice import SPEC
from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)
from test_torch_train_strategies import _runner_cfg

LONGTAIL = [
    "What is on the white wall?", "What color is the dog?", "How many apples are on the table?",
    "Where is the cat?", "Is there a dog in the picture?",
]
FORMS = [
    "Of what color is the car?", "Which colour are the shoes?", "How big is the house?",
    "How clean do you think is the floor?", "How is this food called?", "What the animal is called?",
    "Where are the plates?", "Where does the man sit?", "On which side of the photo is the man?",
    "In which side is the lamp?", "Which place is it?", "What is the man holding?",
    "What kind of device is shown?", "Which animal do you see?", "Who is wearing a hat?",
    "What's on the table?", "Are there both cars and trucks?", "Does the shirt look white?",
    "The vase holds what?", "The car is of which color?", "Beside what is the dog lying?",
    "Was the woman happy", "", "?", "Could this be a kitchen?", "hat",
]
WORDS = ["what", "which", "who", "where", "how", "many", "color", "colour", "is", "are", "was", "does", "do",
         "did", "can", "called", "side", "of", "the", "on", "in", "beside", "under", "it", "this", "you",
         "think", "dog", "red", "what's", "shown"]


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


@pytest.mark.parametrize("q", LONGTAIL + FORMS)
def test_statement_rules_match_jax(jax, q):
    from rgqa_tpu import verifier as jax_verifier

    assert verifier.statement_with_rule(q) == jax_verifier.statement_with_rule(q)
    tmpl = verifier.question_to_statement(q)
    for answer in ("", "pipe", "left"):
        assert verifier.fill_statement(tmpl, answer) == jax_verifier.fill_statement(tmpl, answer)


@settings(max_examples=300, deadline=None)
@given(words=st.lists(st.one_of(st.sampled_from(WORDS), st.from_regex(r"[A-Za-z']{1,8}", fullmatch=True)),
                      max_size=9),
       mark=st.sampled_from(["?", " ?", ""]), upper=st.booleans())
def test_statement_rules_match_jax_on_generated_questions(jax, words, mark, upper):
    from rgqa_tpu import verifier as jax_verifier

    q = " ".join(words) + mark
    q = q.capitalize() if upper else q
    assert verifier.statement_with_rule(q) == jax_verifier.statement_with_rule(q)
    tmpl = verifier.question_to_statement(q)
    assert verifier.fill_statement(tmpl, "x y") == jax_verifier.fill_statement(tmpl, "x y")


# ---------------------------------------------------------------------------
# Training and evaluation against the JAX trainer.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("verifier") / "gqa")
    make_synthetic_gqa(path, SyntheticSpec(**dict(SPEC, n_train=24)))
    return path


def _cfgs(root, out, config, strategy="conf"):
    return _runner_cfg(root, out, config, strategy=strategy)


@pytest.fixture(scope="module")
def pths(jax, root, tmp_path_factory):
    """The answerer's and the one-logit verifier's ``.pth`` from JAX
    runners' seeded inits (the verifier's from another seed)."""
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.runner import GQARunner as JaxRunner
    from rgqa_tpu.runner import np_params

    tmp = tmp_path_factory.mktemp("verifier_init")
    out = {}
    for name, strategy, seed in (("answerer", "conf", 11), ("verifier", "separate", 12)):
        cfg = _cfgs(root, str(tmp / name), jax_config, strategy)
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, seed=seed))
        runner = JaxRunner(cfg, init_train=False)
        sd = to_reference_state_dict(from_jax_params(np_params(runner.params)), l_layers=1, x_layers=1, r_layers=1)
        out[name] = str(tmp / f"{name}.pth")
        torch.save(sd, out[name])
    return out


def _recorded(cls, record):
    """``cls._statement_batch`` wrapped to append each batch's statements."""
    inner = cls._statement_batch

    def wrapped(self, sents, base):
        record.append(list(sents))
        return inner(self, sents, base)

    return wrapped


@pytest.fixture(scope="module")
def trained(jax, root, pths, tmp_path_factory):
    """Both trainers after one epoch of ``train`` from the same weights and
    seed: (JAX trainer, port trainer, JAX losses, port losses, JAX
    statements, port statements)."""
    from rgqa_tpu import config as jax_config
    from rgqa_tpu import verifier as jax_verifier
    from rgqa_tpu.runner import GQARunner as JaxRunner

    tmp = tmp_path_factory.mktemp("verifier_runs")
    runners = {}
    for side, config, make in (("jax", jax_config, lambda c: JaxRunner(c)),
                               ("port", None, lambda c: GQARunner(c, device="cpu"))):
        for name, strategy in (("answerer", "conf"), ("verifier", "separate")):
            cfg = dataclasses.replace(_cfgs(root, str(tmp / side / name), config, strategy), load=pths[name])
            runners[(side, name)] = make(cfg)
    jstatements, statements = [], []
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_verifier.VerifierTrainer, "_statement_batch", _recorded(jax_verifier.VerifierTrainer, jstatements))
    mp.setattr(verifier.VerifierTrainer, "_statement_batch", _recorded(verifier.VerifierTrainer, statements))
    try:
        jvt = jax_verifier.VerifierTrainer(runners[("jax", "verifier")], runners[("jax", "answerer")], topk=3, seed=5)
        vt = verifier.VerifierTrainer(runners[("port", "verifier")], runners[("port", "answerer")], topk=3, seed=5)
        ds = GQADataset(root, "train,train_uq", add_uq=True)
        want = jvt.train(runners[("jax", "verifier")]._encode(_jax_ds(root, "train,train_uq")), epochs=2,
                         batch_size=8)
        got = vt.train(runners[("port", "verifier")]._encode(ds), epochs=2, batch_size=8)
    finally:
        mp.undo()
    return jvt, vt, want, got, jstatements, statements


def _jax_ds(root, splits):
    from rgqa_tpu.data import GQADataset as JaxGQADataset

    return JaxGQADataset(root, splits, add_uq=True)


def test_train_matches_jax(trained):
    _, _, want, got, jstatements, statements = trained
    assert statements == jstatements and len(statements) == len(got) >= 4
    assert all(len(s) == 3 * 8 for s in statements)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[0] != got[-1]


def test_ood_evaluate_matches_jax_and_its_dump_round_trips(jax, root, trained, tmp_path):
    from rgqa_tpu.metrics.compute_accfpr import main as jax_compute_accfpr
    from rgqa_tpu_torch.metrics.compute_accfpr import main as compute_accfpr

    jvt, vt, *_ = trained
    want = jvt.ood_evaluate(jvt.verifier._encode(_jax_ds(root, "testdev")), dump=str(tmp_path / "jax.json"))
    got = vt.ood_evaluate(vt.verifier._encode(GQADataset(root, "testdev", add_uq=True)),
                          dump=str(tmp_path / "port.json"))
    assert got.keys() == want.keys()
    for key in ("auaf", "fpr@0.95acc", "full_acc"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6, err_msg=key)
    dataset = f"{root}/testdev.json"
    assert compute_accfpr([dataset, str(tmp_path / "port.json")]) == jax_compute_accfpr(
        [dataset, str(tmp_path / "port.json")])
    assert compute_accfpr([dataset, str(tmp_path / "port.json")]) == compute_accfpr(
        [dataset, str(tmp_path / "jax.json")])
