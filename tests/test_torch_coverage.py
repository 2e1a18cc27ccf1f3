"""Port parity: the FRCNN object-coverage scorer against the JAX package
and NLTK, on the CPU.

- ``scorers.porter.stem`` equals ``nltk.stem.PorterStemmer().stem`` (its
  default ``NLTK_EXTENSIONS`` mode) on a word list that touches every
  step and extension (the coverage word sets, the synthetic lexicon and
  detector vocabulary, plurals, ``-ational`` / ``-izer`` / ``-li`` /
  ``-ement`` words, the irregular pool in any case, multi-word names)
  and on random strings of ``[A-Za-z' -]`` (``hypothesis``).  Skipped
  only without nltk.
- ``load_object_vocab``, ``noun_tokens`` and ``coverage_scores`` equal
  the JAX package's bit for bit on the synthetic root's questions and
  ``objects_id`` rows, the JAX side on its lexicon-free branch
  (``_nltk_nouns`` patched to ``None``: NLTK's tagger data is absent
  here and on the card machine; the JAX module is not edited).
- The evaluate CLI with ``--scorer frcnn --device cpu`` writes the same
  prediction JSON and metric dict as the JAX evaluate CLI from the same
  ``.pth`` (LXMERT); UNITER and BUTD answer through it too, their
  confidences the JAX scorer's.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from rgqa_tpu_torch import scorers
from rgqa_tpu_torch.cli import evaluate
from rgqa_tpu_torch.data.dataset import GQADataset
from rgqa_tpu_torch.data.synthetic import _ATTRIBUTES, _OBJECTS, SyntheticSpec, make_synthetic_gqa
from rgqa_tpu_torch.data.tsv import PackedFeatures
from rgqa_tpu_torch.scorers import coverage
from rgqa_tpu_torch.scorers.porter import stem
from test_torch_scoring_slice import _pth, _spread
from test_torch_slice import CLI_SPEC, TINY_FLAGS
from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

WORDS = [
    # plurals, -ies / -ied and the irregular pool, in any case
    "caresses", "ponies", "ties", "dies", "flies", "died", "spied", "cats", "caress", "skies", "Skies",
    "sky", "SKY", "dying", "DYING", "lying", "tying", "news", "innings", "outings", "cannings",
    "howe", "proceed", "exceed", "succeed", "giraffes", "glasses", "buses", "boxes", "benches",
    # step 1b
    "feed", "agreed", "plastered", "bled", "motoring", "sing", "conflated", "troubled", "sized",
    "hopping", "tanned", "falling", "hissing", "fizzed", "failing", "filing", "parked", "wearing",
    # step 1c
    "happy", "enjoy", "by", "spy", "try", "cherry", "toy",
    # step 2, the -li extensions among them
    "relational", "conditional", "rational", "valenci", "hesitanci", "digitizer", "organizer",
    "conformabli", "radicalli", "differentli", "vileli", "analogousli", "generously", "fully",
    "hopefulli", "vietnamization", "predication", "operator", "feudalism", "decisiveness",
    "hopefulness", "callousness", "formaliti", "sensitiviti", "sensibiliti", "archaeology",
    "geology", "theology", "analogi",
    # steps 3-5, -ement among them
    "triplicate", "formative", "formalize", "electriciti", "electrical", "hopeful", "goodness",
    "revival", "allowance", "inference", "airliner", "gyroscopic", "adjustable", "defensible",
    "irritant", "replacement", "agreement", "adjustment", "dependent", "adoption", "homologou",
    "communism", "activate", "angulariti", "homologous", "effective", "bowdlerize", "probate",
    "rate", "cease", "controll", "roll",
    # short words, apostrophes, hyphens and multi-word names
    "a", "is", "ox", "don't", "hot-dog", "t-shirt", "tennis racket", "traffic light", "fire hydrant",
    "teddy bear", "cell phone", "Stop Sign",
]


@pytest.fixture(scope="module")
def nltk_stem():
    nltk = pytest.importorskip("nltk")
    return nltk.stem.PorterStemmer().stem


@pytest.fixture(scope="module")
def jax_coverage():
    pytest.importorskip("jax")
    from rgqa_tpu.scorers import coverage as jax_cov

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_cov, "_nltk_nouns", lambda sent: None)
        yield jax_cov


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("coverage") / "gqa")
    make_synthetic_gqa(path, SyntheticSpec(**CLI_SPEC))
    return path


def _word_list(root):
    vocab = [line.strip() for line in open(os.path.join(root, "objects_vocab.txt"))]
    return (WORDS + list(coverage.NOUN_STOPLIST) + sorted(coverage._NON_NOUNS)
            + sorted(coverage._COMMON_ADJECTIVES) + _OBJECTS + _ATTRIBUTES + vocab[:40])


def test_stem_matches_nltk_on_the_word_list(nltk_stem, root):
    words = _word_list(root)
    assert len(words) > 350
    got = {w: stem(w) for w in words}
    want = {w: nltk_stem(w) for w in words}
    assert got == want
    assert got["skies"] == "sky" and got["generously"] == "gener" and got["giraffes"] == "giraff"
    assert got["tennis racket"] == "tennis racket" and got["agreement"] == "agreement"


@settings(max_examples=600, deadline=None, derandomize=True, database=None)
@given(st.text(alphabet="abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ' -", max_size=18))
def test_stem_matches_nltk_on_random_strings(nltk_stem, word):
    assert stem(word) == nltk_stem(word)


@settings(max_examples=400, deadline=None, derandomize=True, database=None)
@given(st.lists(st.sampled_from(["a", "e", "i", "o", "u", "y", "b", "l", "s", "t", "z", "c", "n", "g",
                                 "ational", "tional", "izer", "alli", "bli", "logi", "fulli", "ousli",
                                 "ement", "ment", "ies", "ied", "eed", "ing", "ed", "ization", "iviti",
                                 "biliti", "icate", "ative", "ness", "ful", "ll", "sses"]),
                max_size=6).map("".join))
def test_stem_matches_nltk_on_suffix_chains(nltk_stem, word):
    assert stem(word) == nltk_stem(word)


def _questions_and_objects(root):
    feats = PackedFeatures(os.path.join(root, "features"))
    sents, objects = [], []
    for split in ("train", "valid", "testdev", "train_uq"):
        for row in GQADataset(root, split).data:
            sents.append(row["sent"])
            objects.append(np.asarray(feats.objects_id[feats.index[row["img_id"]]]))
    return sents, objects


def test_coverage_matches_jax(jax_coverage, root):
    path = os.path.join(root, "objects_vocab.txt")
    vocab = scorers.load_object_vocab(path)
    assert vocab == jax_coverage.load_object_vocab(path) and len(vocab) == 1600
    sents, objects = _questions_and_objects(root)
    sents += ["Is the BLUE chair, next to a giraffe, empty?", "what kind of thing is it", ""]
    objects += [np.array([0, 1599, 5]), np.array([-1, 3, 4000]), np.array([], np.int64)]
    assert [scorers.noun_tokens(s) for s in sents] == [jax_coverage.noun_tokens(s) for s in sents]
    got = scorers.coverage_scores(sents, objects, vocab)
    want = jax_coverage.coverage_scores(sents, objects, vocab)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(got)  # the synthetic packs detect some questions' objects


@pytest.fixture(scope="module")
def answerer(root, tmp_path_factory):
    """A reference ``.pth`` written from a JAX runner's spread params."""
    pytest.importorskip("jax")
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.runner import GQARunner as JaxRunner
    from rgqa_tpu.runner import np_params

    tmp = tmp_path_factory.mktemp("coverage_cli")
    flags = [f for f in TINY_FLAGS if f not in ("--device", "cpu")]
    cfg, _ = jax_config.parse_cli(["--synthetic", "--data_root", root, "--test", "testdev",
                                   "--output", str(tmp / "init"), *flags])
    return tmp, _pth(tmp, "a", _spread(np_params(JaxRunner(cfg, init_train=False).params)))


def test_cli_frcnn_matches_the_jax_cli(jax_coverage, root, answerer):
    from rgqa_tpu.cli import evaluate as jax_evaluate

    tmp, pth = answerer
    flags = [f for f in TINY_FLAGS if f not in ("--device", "cpu")]
    argv = ["--synthetic", "--data_root", root, "--test", "testdev", "--load", pth, "--scorer", "frcnn"]
    want = jax_evaluate.main(argv + ["--output", str(tmp / "jax")] + flags)["testdev"]
    got = evaluate.main(argv + ["--output", str(tmp / "port")] + TINY_FLAGS)["testdev"]
    with open(tmp / "port" / "testdev_predict.json") as f:
        prows = json.load(f)
    with open(tmp / "jax" / "testdev_predict.json") as f:
        jrows = json.load(f)
    assert prows == jrows
    assert got == want and {"auaf", "fpr@0.95acc", "full_acc"} <= got.keys()
    assert len(prows) == CLI_SPEC["n_testdev"]
    assert {r["confidence"] for r in prows} <= {0.0, 1.0}


@pytest.mark.parametrize("backbone", ["uniter", "butd"])
def test_cli_frcnn_answers_with_every_roi_backbone(jax_coverage, root, tmp_path, backbone):
    size = (["--fp32", "--num_layers", "1", "--hidden_size", "32", "--num_heads", "4"]
            if backbone == "uniter" else [])
    out = str(tmp_path / "out")
    argv = ["--synthetic", "--data_root", root, "--test", "testdev", "--backbone", backbone, "--scorer", "frcnn",
            "--batchSize", "16", "--device", "cpu", "--output", out, *size]
    results = evaluate.main(argv)["testdev"]
    with open(os.path.join(out, "testdev_predict.json")) as f:
        rows = {r["questionId"]: (r["prediction"], r["confidence"]) for r in json.load(f)}
    cfg, device, plan = evaluate.parse_args(argv)
    runner = evaluate.make_runner(cfg, device, plan["scorer"])
    encoded = runner._encode(GQADataset(root, "testdev", add_uq=True))
    answers = runner.predict(encoded)
    sents = [encoded.dataset.id2datum[q]["sent"] for q in encoded.question_ids]
    objects = [np.asarray(runner.features.objects_id[r]) for r in encoded.img_row]
    path = os.path.join(root, "objects_vocab.txt")
    confs = jax_coverage.coverage_scores(sents, objects, jax_coverage.load_object_vocab(path))
    assert rows == {q: (answers[q], float(c)) for q, c in zip(encoded.question_ids, confs)}
    assert {"auaf", "fpr@0.95acc", "full_acc"} <= results.keys()
