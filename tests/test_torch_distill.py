"""Port parity: the cartography distillation (``rgqa_tpu_torch/distill.py``,
``cli/distill.py``) against the JAX package's, on the CPU.

- ``sample_repaired``, ``cartography_stats``, ``select_distill`` (with and
  without ``--balance``) and ``stats_from_charts`` equal JAX's bit for
  bit on the same numpy seeds;
- ``build_distill_split`` at dropout 0 (every MC-dropout pass is then
  MSP) equals JAX's row for row: the same rows in the same order, the
  pseudo-AQ confidences within rtol 1e-5 (the two packages' f32 MSP);
- ``build_ensemble_distill_split`` from two ``.pth`` files of the same
  weights on both sides: the same rows and labels, scores rtol 1e-5;
- the CLI writes ``<data_root>/<output_name>.json`` and a student trains
  one epoch on it through the train CLI; an orbax snapshot directory as
  a teacher is refused by name.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle

import numpy as np
import pytest
import torch

from rgqa_tpu_torch import distill
from rgqa_tpu_torch.checkpoint.convert import from_jax_params, to_reference_state_dict
from rgqa_tpu_torch.data.synthetic import SyntheticSpec, make_synthetic_gqa
from rgqa_tpu_torch.runner import GQARunner
from test_torch_slice import CLI_SPEC, SPEC, TINY_FLAGS
from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)
from test_torch_train_strategies import _runner_cfg

TAUS = dict(tau_aq_c=0.3, tau_aq_v=0.15, tau_uq_c=0.35, tau_uq_v=0.05)
SCALE, SHIFT = 10.0, -3.0  # the teacher's answer layer


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


def _rows(seed: int, n: int = 40) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"img_id": f"img{int(rng.integers(8)):03d}", "sent": f"question {i} ?", "question_id": f"q{i:04d}"}
            for i in range(n)]


def _passes(cands, seed: int, n_passes: int = 4) -> list[dict]:
    """Per-pass ``{qid: (answer, confidence)}`` with confident, unsure and
    unanswerable-looking candidates, ties in the answers included."""
    rng = np.random.default_rng(seed)
    base = rng.choice([0.03, 0.5, 0.8], len(cands))
    scale = rng.choice([0.01, 0.3], len(cands))
    out = []
    for _ in range(n_passes):
        noise = rng.normal(0, scale)
        out.append({c["question_id"]: (str(rng.choice(["cat", "dog"])), float(np.clip(b + n, 0, 1)))
                    for c, b, n in zip(cands, base, noise)})
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sampling_statistics_and_selection_match_jax(jax, seed):
    from rgqa_tpu import distill as jax_distill

    data = _rows(seed)
    got = distill.sample_repaired(data, np.random.default_rng(seed), 30)
    want = jax_distill.sample_repaired(data, np.random.default_rng(seed), 30)
    assert got == want
    assert all(d["img_id"] != next(r["img_id"] for r in data if r["question_id"] == d["original_question_id"])
               for d in got)
    passes = _passes(got, seed)
    stats = distill.cartography_stats(passes)
    assert stats == jax_distill.cartography_stats(passes)
    for balance, n_original in ((False, 0), (True, 0), (True, 12)):
        kw = dict(TAUS, balance=balance, n_original=n_original)
        mine = distill.select_distill(got, stats, rng=np.random.default_rng(seed), **kw)
        theirs = jax_distill.select_distill(got, stats, rng=np.random.default_rng(seed), **kw)
        assert mine == theirs
    aq, uq = distill.select_distill(got, stats, **TAUS)
    assert aq and uq  # both branches taken on these passes


def test_stats_from_charts_match_jax(jax, tmp_path):
    from rgqa_tpu import distill as jax_distill

    rng = np.random.default_rng(4)
    for epoch in range(3):
        qids = [f"q{i}" for i in range(12) if epoch == 0 or i % 5]  # some rows missing later: dropped
        chart = {q: (float(rng.random()), {"cat": 1.0}, str(rng.choice(["cat", "dog"]))) for q in qids}
        with open(tmp_path / f"epoch_{epoch}.pkl", "wb") as f:
            pickle.dump(chart, f)
    got = distill.stats_from_charts(str(tmp_path))
    assert got == jax_distill.stats_from_charts(str(tmp_path)) and len(got) == 9
    with pytest.raises(FileNotFoundError, match="no epoch_"):
        distill.stats_from_charts(str(tmp_path / "none"))


# ---------------------------------------------------------------------------
# End to end against the JAX runner.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny root, and ``train_uq_reason``: its UQ rows with the
    ``unanswerable_reason`` field of GQA-UQ's rows."""
    path = str(tmp_path_factory.mktemp("distill") / "gqa")
    make_synthetic_gqa(path, SyntheticSpec(**dict(SPEC, n_train=24)))
    with open(os.path.join(path, "train_uq.json")) as f:
        rows = json.load(f)
    with open(os.path.join(path, "train_uq_reason.json"), "w") as f:
        json.dump([dict(r, unanswerable_reason=f"reason{i % 3}") for i, r in enumerate(rows)], f)
    return path


@pytest.fixture(scope="module")
def teacher_pth(jax, root, tmp_path_factory):
    """A tiny LXMERT ``.pth`` from a JAX runner's seeded init, its answer
    layer scaled and shifted so the teacher's confidences straddle the
    thresholds."""
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.runner import GQARunner as JaxRunner
    from rgqa_tpu.runner import np_params

    tmp = tmp_path_factory.mktemp("distill_teacher")
    jax_runner = JaxRunner(_runner_cfg(root, str(tmp / "init"), jax_config), init_train=False)
    sd = to_reference_state_dict(from_jax_params(np_params(jax_runner.params)), l_layers=1, x_layers=1, r_layers=1)
    sd["logit_fc.3.weight"] = sd["logit_fc.3.weight"] * SCALE
    sd["logit_fc.3.bias"] = torch.full_like(sd["logit_fc.3.bias"], SHIFT)
    pth = str(tmp / "teacher.pth")
    torch.save(sd, pth)
    return pth


def _runners(root, pth, tmp_path):
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.runner import GQARunner as JaxRunner

    jcfg = dataclasses.replace(_runner_cfg(root, str(tmp_path / "jax"), jax_config), load=pth)
    pcfg = dataclasses.replace(_runner_cfg(root, str(tmp_path / "port")), load=pth)
    return JaxRunner(jcfg), GQARunner(pcfg, device="cpu")


def _same_rows(got, want, rtol=1e-5):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "label"} == {k: v for k, v in w.items() if k != "label"}
        assert list(g["label"]) == list(w["label"])
        np.testing.assert_allclose(list(g["label"].values()), list(w["label"].values()), rtol=rtol)


def test_build_distill_split_at_dropout_0_matches_jax(jax, root, teacher_pth, tmp_path):
    from rgqa_tpu import distill as jax_distill

    jax_runner, runner = _runners(root, teacher_pth, tmp_path)
    # Thresholds at the teacher's confidence quantiles over the candidates
    # (at dropout 0 every variability is 0), so both branches select.
    from rgqa_tpu_torch.data.dataset import GQADataset

    cands = distill.sample_repaired(runner.dataset.data, np.random.default_rng(0), 60)
    ds = GQADataset.from_rows(cands, ans2label=runner.dataset.ans2label, label2ans=runner.dataset.label2ans)
    conf = np.sort([c for _, c in runner.score_split(runner._encode(ds)).values()])
    mid = (conf[1:] + conf[:-1]) / 2  # thresholds between two candidates' confidences
    taus = dict(TAUS, tau_uq_c=float(mid[len(mid) // 3]), tau_aq_c=float(mid[2 * len(mid) // 3]))
    assert np.diff(conf).max() > 1e-4
    kw = dict(n_candidates=60, passes=2, balance=False, **taus)
    want = jax_distill.build_distill_split(jax_runner, out_path=str(tmp_path / "jax.json"), **kw)
    got = distill.build_distill_split(runner, out_path=str(tmp_path / "port.json"), **kw)
    _same_rows(got, want)
    with open(tmp_path / "port.json") as f:
        assert json.load(f) == got
    labels = [next(iter(r["label"])) for r in got]
    assert "UQ" in labels and any(a != "UQ" for a in labels)  # both pseudo-AQ and pseudo-UQ rows
    assert all("+" in r["question_id"] for r in got)


def test_ensemble_split_matches_jax(jax, root, teacher_pth, tmp_path):
    from rgqa_tpu import distill as jax_distill

    second = str(tmp_path / "second.pth")
    torch.save(torch.load(teacher_pth, weights_only=True), second)
    jax_runner, runner = _runners(root, teacher_pth, tmp_path)
    want = jax_distill.build_ensemble_distill_split(jax_runner, [teacher_pth, second], splits="train,train_uq_reason",
                                                    out_path=str(tmp_path / "jax.json"))
    got = distill.build_ensemble_distill_split(runner, [teacher_pth, second[:-4]], splits="train,train_uq_reason",
                                               out_path=str(tmp_path / "port.json"))
    _same_rows(got, want)
    assert any("+" in r["question_id"] for r in got)  # the reason-prefixed UQ ids
    one = distill.build_ensemble_distill_split(runner, [teacher_pth], splits="train,train_uq_reason",
                                               out_path=str(tmp_path / "one.json"))
    np.testing.assert_allclose([next(iter(r["label"].values())) for r in got],
                               [next(iter(r["label"].values())) ** 2 for r in one], rtol=1e-6)


def test_orbax_teacher_is_refused_by_name(root, teacher_pth, tmp_path):
    orbax = tmp_path / "orbax_snapshot"
    orbax.mkdir()
    runner = GQARunner(dataclasses.replace(_runner_cfg(root, str(tmp_path / "o")), load=teacher_pth), device="cpu")
    with pytest.raises(NotImplementedError, match="--teacher_path an orbax snapshot directory"):
        distill.build_ensemble_distill_split(runner, [teacher_pth, str(orbax)], splits="train",
                                             out_path=str(tmp_path / "x.json"))
    from rgqa_tpu_torch.cli import distill as distill_cli

    with pytest.raises(NotImplementedError, match="--teacher_path an orbax snapshot directory"):
        distill_cli.main(["--synthetic", "--data_root", root, "--output", str(tmp_path / "c"),
                          "--teacher_path", f"{teacher_pth},{orbax}", *TINY_FLAGS])


def test_cli_writes_the_split_and_a_student_trains_on_it(tmp_path, capsys):
    from rgqa_tpu_torch.cli import distill as distill_cli
    from rgqa_tpu_torch.cli import train

    root = str(tmp_path / "gqa")
    make_synthetic_gqa(root, SyntheticSpec(**CLI_SPEC))
    train.main(["--synthetic", "--data_root", root, "--output", str(tmp_path / "teacher"), "--epochs", "1",
                *TINY_FLAGS])
    teacher = str(tmp_path / "teacher" / "LAST.pth")
    rows = distill_cli.main(["--synthetic", "--data_root", root, "--output", str(tmp_path / "d"),
                             "--load", teacher, "--n_candidates", "40", "--passes", "2", "--tau_aq_c", "0.0",
                             "--tau_aq_v", "1.0", "--output_name", "distill_train", *TINY_FLAGS])
    assert f"wrote {len(rows)} distilled rows" in capsys.readouterr().out and rows
    with open(os.path.join(root, "distill_train.json")) as f:
        assert json.load(f) == rows
    ens = distill_cli.main(["--synthetic", "--data_root", root, "--output", str(tmp_path / "e"),
                            "--teacher_path", f"{teacher},{teacher[:-4]}", "--output_name", "ensemble_train",
                            *TINY_FLAGS])
    assert os.path.isfile(os.path.join(root, "ensemble_train.json")) and ens
    history = train.main(["--synthetic", "--data_root", root, "--output", str(tmp_path / "student"),
                          "--train", "distill_train", "--epochs", "1", *TINY_FLAGS])
    assert len(history["loss"]) == 1 and np.isfinite(history["loss"]).all()
