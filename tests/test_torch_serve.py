"""The port's JSONL scoring service (``rgqa_tpu_torch/cli/serve.py``)
against the JAX package's (``rgqa_tpu/cli/serve.py``), on the CPU.

Both serves read the same stream, on a tiny synthetic root, with the same
reference ``.pth`` (written by the port's ``save_reference_pth`` from a
seeded model whose answer logits are spread apart), f32 (``--fp32``):
they print the same lines, error records included: identical answers,
confidences equal at 4 dp with ``MAX_4DP_FLIPS`` flips.

Two faults of the JAX serve are not copied, and a test shows each:

- under bf16 it casts the weights to bf16 before ``make_scorer()``, so
  ``--scorer maha`` fits the shared ``sample_estimates.pkl`` from bf16
  weights (``rgqa_tpu/cli/serve.py:177-180``): the port's fit equals a
  training runner's fit from f32 weights;
- it keys arrival times and answers by question id
  (``rgqa_tpu/cli/serve.py:198,215,227``), so two records of one wave
  that share a question id get one arrival time and one answer: the
  port keeps each record's own.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import pickle
import time

import numpy as np
import pytest
import torch

from rgqa_tpu_torch import config as port_config
from rgqa_tpu_torch.cli import evaluate, serve
from rgqa_tpu_torch.data.dataset import GQADataset
from rgqa_tpu_torch.data.synthetic import SyntheticSpec, make_synthetic_gqa
from rgqa_tpu_torch.models.zoo import build_model
from rgqa_tpu_torch.runner import GQARunner
from rgqa_tpu_torch.train.state import save_reference_pth

from test_torch_scoring_slice import MAHA_F32_WEIGHTS_TOL, _fit_error
from test_torch_slice import CLI_SPEC, MAX_4DP_FLIPS, TINY_FLAGS
from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

JAX_FLAGS = [f for f in TINY_FLAGS if f not in ("--device", "cpu")]
BF16_FLAGS = [f for f in TINY_FLAGS if f != "--fp32"]
BAD_LINES = [
    "{not json",
    "[1, 2]",
    json.dumps({"sent": "what is it ?"}),
    json.dumps({"question_id": "q_unknown", "sent": "what is it ?", "img_id": "no_such_image"}),
]


def _seeded_pth(path, root, *, seed, vary=False):
    """A tiny LXMERT from a seeded generator as a reference ``.pth``; the
    answer logits are spread (x10) so no two answers nearly tie.
    ``vary``: the encoder's dense weights x10 (a covariance of pooled
    features the Mahalanobis fit can invert) and LayerNorm parameters
    ``+ 0.1 N(0, 1)``, which bf16 cannot hold."""
    cfg, _ = port_config.parse_cli(["--data_root", root, *TINY_FLAGS])
    ds = GQADataset(root, "testdev", add_uq=True)
    mcfg = dataclasses.replace(cfg.model, num_answers=ds.num_answers - 1)
    model, _ = build_model(mcfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        model.answer_head.logits.weight.mul_(10.0)
        for name, p in model.lxmert.named_parameters() if vary else ():
            if "ln" in name.split(".")[-2] or "layer_norm" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
            elif p.dim() == 2 and "embeddings" not in name:
                p.mul_(10.0)
    return save_reference_pth(model, mcfg, path)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    root, maha_root = str(tmp / "gqa"), str(tmp / "gqa_maha")
    make_synthetic_gqa(root, SyntheticSpec(**CLI_SPEC))
    # The Mahalanobis fit's root: more labeled train rows than the width.
    make_synthetic_gqa(maha_root, SyntheticSpec(**dict(CLI_SPEC, n_images=32, n_train=256)))
    paths = {"a": _seeded_pth(str(tmp / "a.pth"), root, seed=3),
             "maha": _seeded_pth(str(tmp / "maha.pth"), maha_root, seed=4, vary=True)}
    with open(os.path.join(root, "testdev.json")) as f:
        rows = json.load(f)
    return root, maha_root, tmp, paths, rows


def _record(row, qid=None) -> str:
    return json.dumps({"question_id": qid or row["question_id"], "sent": row["sent"],
                       "img_id": row["img_id"]})


def _serve(module, argv, lines) -> list:
    out = io.StringIO()
    module.main(argv, stdin=iter([line + "\n" for line in lines]), stdout=out)
    return out.getvalue().splitlines()


def _argv(root, out, load, *extra):
    return ["--synthetic", "--data_root", root, "--test", "testdev", "--output", out,
            "--load", load, *extra]


SCORERS = {
    "msp": [],
    "energy": ["--scorer", "energy"],
    "odin": ["--scorer", "odin", "--temperature", "1000", "--noise", "0.01"],
}


@pytest.mark.parametrize("scorer", list(SCORERS))
def test_serve_matches_jax_serve(env, scorer):
    """The same stream, good and bad records mixed, through both serves:
    the same error records at the same places, identical answers,
    confidences equal at 4 dp."""
    from rgqa_tpu.cli import serve as jax_serve

    root, _, tmp, paths, rows = env
    lines = [_record(r) for r in rows[:7]] + BAD_LINES + [_record(r) for r in rows[7:]]
    extra = [*SCORERS[scorer], "--wave_timeout", "0"]  # one wave: the same batches on both sides
    got = _serve(serve, _argv(root, str(tmp / f"port_{scorer}"), paths["a"], *extra, *TINY_FLAGS), lines)
    want = _serve(jax_serve, _argv(root, str(tmp / f"jax_{scorer}"), paths["a"], *extra, *JAX_FLAGS),
                  lines)
    assert len(got) == len(want) == len(lines)
    got_rows, want_rows = [json.loads(line) for line in got], [json.loads(line) for line in want]
    errors = [r for r in got_rows if "error" in r]
    assert [r["record"] for r in errors] == BAD_LINES
    assert errors == [r for r in want_rows if "error" in r]
    answers = [r for r in got_rows if "error" not in r]
    want_answers = [r for r in want_rows if "error" not in r]
    assert [r["questionId"] for r in answers] == [r["question_id"] for r in rows]
    assert [r["questionId"] for r in answers] == [r["questionId"] for r in want_answers]
    assert [r["prediction"] for r in answers] == [r["prediction"] for r in want_answers]
    flips = sum(a["confidence"] != w["confidence"] for a, w in zip(answers, want_answers))
    assert flips <= MAX_4DP_FLIPS
    assert all(a["confidence"] == round(a["confidence"], 4) for a in answers)


def test_serve_stats_line(env, capsys):
    """``--serve_stats``: ``served N questions`` and one latency JSON line
    on stderr, ``count`` the records answered."""
    root, _, tmp, paths, rows = env
    lines = [_record(r) for r in rows[:5]] + BAD_LINES[:1]
    out = io.StringIO()
    served = serve.main(_argv(root, str(tmp / "stats"), paths["a"], "--serve_stats",
                              "--wave_timeout", "0.02", *TINY_FLAGS),
                        stdin=io.StringIO("\n".join(lines) + "\n"), stdout=out)
    assert served == 5 and len(out.getvalue().splitlines()) == 6
    err = [line for line in capsys.readouterr().err.splitlines() if line.strip()]
    assert err[-2] == "served 5 questions"
    stats = json.loads(err[-1])["latency"]
    assert stats["count"] == 5
    assert 0.0 <= stats["p50_ms"] <= stats["p95_ms"] <= stats["p99_ms"] <= stats["max_ms"]


def test_serve_lines_returns_the_lines_the_stats_and_the_window(env):
    """``serve_lines`` (the in-process serve of the smoke and the serve
    profile): the lines ``main`` writes, the latency line's dict, and a
    window from the first record's arrival to the last line written, so
    it holds a pause in the input."""
    pause = 0.3
    root, _, tmp, paths, rows = env
    argv = _argv(root, str(tmp / "serve_lines"), paths["a"], "--wave_timeout", "0", *TINY_FLAGS)
    lines = [_record(r) for r in rows[:4]] + BAD_LINES[:1]

    def arriving():
        yield from lines[:2]
        time.sleep(pause)
        yield from lines[2:]

    out, stats, window = serve.serve_lines(argv + ["--serve_stats"], arriving())
    assert out == _serve(serve, argv, lines)
    assert stats["count"] == 4
    assert window >= pause
    assert serve.serve_lines(argv, lines[:1])[1] is None


def test_serve_counts_each_record_of_a_shared_qid_with_its_own_latency(env, capsys):
    """Two records of one wave share a question id and arrive ``GAP`` s
    apart: each is counted with its own arrival, so the larger latency
    exceeds the median (the mean of the two) by half the gap.  Keyed by
    question id, both would take the second's arrival and lie within
    microseconds."""
    gap = 0.6
    root, _, tmp, paths, rows = env

    def arriving():
        yield _record(rows[0], "shared") + "\n"
        time.sleep(gap)
        yield _record(rows[1], "shared") + "\n"

    served = serve.main(_argv(root, str(tmp / "dup_latency"), paths["a"], "--serve_stats",
                              "--wave_timeout", "0", *TINY_FLAGS),
                        stdin=arriving(), stdout=io.StringIO())
    stats = json.loads(capsys.readouterr().err.splitlines()[-1])["latency"]
    assert served == 2 and stats["count"] == 2
    assert stats["max_ms"] - stats["p50_ms"] >= 0.4 * gap * 1e3, stats


def test_serve_answers_records_of_a_shared_qid_by_place(env):
    """Records that share a question id in one wave each get their own
    answer: the lines equal those of the same stream with distinct ids."""
    root, _, tmp, paths, rows = env
    argv = _argv(root, str(tmp / "dup_answers"), paths["a"], "--wave_timeout", "0", *TINY_FLAGS)
    lines = [_record(r) for r in rows]
    distinct = [json.loads(line) for line in _serve(serve, argv, lines)]
    # Two records whose answers differ, renamed to one question id.
    i, j = next((i, j) for i in range(len(rows)) for j in range(i + 1, len(rows))
                if distinct[i]["prediction"] != distinct[j]["prediction"]
                or distinct[i]["confidence"] != distinct[j]["confidence"])
    lines[i], lines[j] = _record(rows[i], "shared"), _record(rows[j], "shared")
    got = [json.loads(line) for line in _serve(serve, argv, lines)]
    for k in (i, j):
        distinct[k]["questionId"] = "shared"
    assert got == distinct


def test_serve_maha_fits_from_f32_weights_under_bf16(env):
    """Under bf16 (no ``--fp32``) ``--scorer maha`` fits the estimator that
    ``sample_estimates.pkl`` keeps from f32 weights under bf16 compute:
    the cache equals a training runner's fit on the same weights.  An
    evaluate run on the same ``--output`` reads the serve's fit."""
    _, maha_root, tmp, paths, rows = env
    out = str(tmp / "maha_bf16")
    argv = _argv(maha_root, out, paths["maha"], "--scorer", "maha", *BF16_FLAGS)
    with open(os.path.join(maha_root, "testdev.json")) as f:
        lines = [_record(r) for r in json.load(f)]
    answered = [json.loads(line) for line in _serve(serve, argv, lines)]
    assert len(answered) == len(lines) and np.isfinite([r["confidence"] for r in answered]).all()
    with open(os.path.join(out, "sample_estimates.pkl"), "rb") as f:
        got = pickle.load(f)
    cfg, device, _ = evaluate.parse_args(_argv(maha_root, str(tmp / "maha_train"), paths["maha"],
                                               "--scorer", "maha", *BF16_FLAGS))
    assert cfg.train.use_bf16
    err = _fit_error(got, GQARunner(cfg, init_train=True, device=device).fit_maha_estimator())
    assert max(err.values()) <= MAHA_F32_WEIGHTS_TOL, err
    stamp = os.path.getmtime(os.path.join(out, "sample_estimates.pkl"))
    evaluate.main(argv)
    assert os.path.getmtime(os.path.join(out, "sample_estimates.pkl")) == stamp


def test_serve_vilt_answers_every_record(tmp_path):
    root = str(tmp_path / "gqa_vilt")
    flags = ["--backbone", "vilt", "--fp32", "--num_layers", "1", "--hidden_size", "32",
             "--num_heads", "4", "--vilt_image_size", "64", "--vilt_patch_size", "16",
             "--batchSize", "8", "--device", "cpu"]
    make_synthetic_gqa(root, SyntheticSpec(**CLI_SPEC))
    with open(os.path.join(root, "testdev.json")) as f:
        lines = [_record(r) for r in json.load(f)[:10]] + BAD_LINES[3:]
    out = [json.loads(line) for line in _serve(serve, ["--synthetic", "--data_root", root, "--test",
                                                       "testdev", "--output", str(tmp_path / "o"),
                                                       *flags], lines)]
    # A wave's error records come first, then its answers in order.
    assert len(out) == 11 and out[0]["error"] == "\"unknown img_id 'no_such_image'\""
    assert [r["questionId"] for r in out[1:]] == [json.loads(line)["question_id"] for line in lines[:10]]
    assert all(0.0 <= r["confidence"] <= 1.0 for r in out[1:])


@pytest.mark.parametrize("case", ["timeout", "input_error"])
def test_waves(case):
    """``timeout``: with the input idle past the timeout a partial wave
    goes out, and ``timeout=0`` waits for full waves.  ``input_error``:
    an error reading the input reaches the consumer after the wave that
    arrived before it."""
    if case == "timeout":
        def slow_lines():
            yield "a\n"
            yield "b\n"
            time.sleep(0.5)  # the input goes idle: the first wave times out
            yield "c\n"

        t0 = time.perf_counter()
        waves = [([line for line, _ in w], time.perf_counter() - t0)
                 for w in serve._waves(slow_lines(), wave_size=100, timeout=0.05)]
        assert [w[0] for w in waves] == [["a", "b"], ["c"]]
        assert waves[0][1] < 0.4  # the first wave left before the gap ended
        full = list(serve._waves(iter(["a\n", "b\n", "c\n"]), 100, timeout=0))
        assert [[line for line, _ in w] for w in full] == [["a", "b", "c"]]
    else:
        def bad_lines():
            yield "a\n"
            raise IOError("stdin broke")

        got = []
        with pytest.raises(IOError, match="stdin broke"):
            for w in serve._waves(bad_lines(), wave_size=100, timeout=0):
                got.append([line for line, _ in w])
        assert got == [["a"]]


@pytest.mark.parametrize(
    "extra, error, match",
    [
        (["--scorer", "frcnn"], SystemExit, "--scorer frcnn is not served"),
        (["--scorer", "clip"], SystemExit, "--scorer clip is not served"),
        (["--scorer", "match"], SystemExit, "--scorer match is not served"),
        (["--scorer", "caption"], SystemExit, "as is --scorer caption"),
        (["--scorer", "odin", "--backbone", "vilt"], SystemExit, "--scorer odin perturbs the RoI"),
        (["--scorer", "maha", "--backbone", "vilt"], SystemExit, "--scorer maha perturbs the RoI"),
        (["--scorer", "separate"], SystemExit, "--scorer separate and ensembles"),
        (["--load", "a.pth,b.pth"], SystemExit, "--scorer separate and ensembles"),
        (["--eval_chunk", "2"], NotImplementedError, "--eval_chunk > 1"),
    ],
)
def test_serve_refuses_by_name(tmp_path, extra, error, match):
    argv = ["--synthetic", "--data_root", str(tmp_path / "gqa"), "--test", "testdev",
            "--output", str(tmp_path / "out"), *TINY_FLAGS, *extra]
    with pytest.raises(error, match=match):
        serve.main(argv, stdin=io.StringIO(""), stdout=io.StringIO())


def test_serve_needs_the_test_split(tmp_path):
    with pytest.raises(SystemExit, match="--test <split> is required"):
        serve.main(["--data_root", str(tmp_path), *TINY_FLAGS], stdin=io.StringIO(""))
