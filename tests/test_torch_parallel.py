"""Data parallelism (``rgqa_tpu_torch.parallel``) on the CPU: N gloo ranks
against the one-process port and the JAX runners.

- Joining: without torchrun's environment ``initialize_distributed`` does
  nothing; with it (``--device cpu``) it joins a gloo group; ``--model_axis
  2``, a global batch the world does not divide and a ``LOCAL_RANK`` past
  the cards raise by name, and a process launched as one of two ranks that
  never joined raises in every entry point (the runner, serve, distill,
  the verifier) before it builds anything (the counterparts of
  ``tests/test_parallel_fullshape.py::TestInitializeMultihost``).
- One spawn of two gloo ranks (``rgqa_tpu_torch.tools.ddp_check``, joined
  through a store that the launching process hosts on a port the OS picks,
  one torch thread each), beside one process of the same tool at world 1:
  tiny widths, f32, dropout 0, global batch 8.  In order: RP, ``mixup_v1``,
  TreeMix, weighted RP, a min-max strategy (resampling), VILLA,
  ``distill_online``, ``--update_weight_model`` (a tiny CLIP trained
  beside the answerer: its objective too), pretraining (six tasks, batch
  16), VQA, NLVR2, evaluate with msp and maha, RP at dropout 0.1, the train
  CLI with a resume, the serve CLI (good records, a malformed one and an
  unknown image), the distill CLI (cartography over two passes, and two
  ensemble teachers) and the verifier (an epoch of training, then its
  evaluation), the last two also at dropout 0.1, where each rank draws
  its own passes and steps.  Every step's global loss (the pretraining parts) and every
  confidence is held to the one-process run at rtol 1e-5 (the runs differ
  by the order of the gradient sums: ~2e-7 here), and so are the maha
  fit's moments, before the covariance's inverse; the serve's printed
  confidences within one unit of the fourth decimal, its answers and
  error lines equal.
- RP training, pretraining, evaluate-msp and serve are also held to the JAX
  runners on their 8-device CPU mesh (``tests/conftest.py``): the JAX RP
  runner and serve load the port's seeded init (``INIT.pth``), the port's
  pretraining the JAX runner's params, and the ranks take the JAX key
  chains' rolls and masks; the bars are ``tests/test_train.py``'s
  trajectory rtol 1e-4 and the dump's rtol 2e-4 / atol 2e-5 (the serve's
  printed confidences: atol 1.2e-4, one rounding unit more).
- Every wait has a limit: the spawn's ranks ``PATH_SECONDS`` a path past
  their start (``ddp_check.launch``, which names the path of a rank that
  overruns), the wait for ``INIT.pth`` ``INIT_SECONDS``.
- At dropout 0.1 the ranks' attention seeds and hidden-dropout bytes
  differ, and their shifts, shuffles and mixup draws agree; on one rank
  the streams are the one-process run's.
- ``--load <run>/BEST`` takes ``<run>/BEST.pth`` (GQA and VQA runners).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import io
import json
import os
import time

import numpy as np
import pytest
import torch

from rgqa_tpu_torch import config as port_config
from rgqa_tpu_torch.checkpoint.convert import from_jax_params
from rgqa_tpu_torch.ops.dropout import DropoutRng
from rgqa_tpu_torch.parallel import (
    SINGLE,
    Mesh,
    check_batch_size,
    initialize_distributed,
    make_mesh,
    pad_batch_to,
    shard_batch,
)
from rgqa_tpu_torch.tools import ddp_check
from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

TRAIN_PATHS = ("rp", "mixup_v1", "treemix", "weighted_rp", "minmax", "villa", "distill", "weight_model", "pretrain",
               "vqa", "nlvr2", "cli")
EVAL_PATHS = ("eval_msp", "eval_maha")
DISTILL_PATHS = ("distill_mc", "distill_ensemble")
# The spawn's limits.  A path takes 1-6 s alone on one core at these widths
# (~95 s for the 20 paths and the ranks' start); the tier-1 run shares
# the host with five other workers.
PATH_SECONDS = 15.0
INIT_SECONDS = 120.0
RTOL = 1e-5  # two ranks against one process
JAX_RTOL = 1e-4  # tests/test_train.py's trajectory bar
SEED, BATCH, STEPS = 11, 8, 4  # the tool's seed and global batch; 32 train rows
FLAGS = ["--batchSize", str(BATCH), "--epochs", "1", "--dropout", "0.0", "--seed", str(SEED), "--lr", "0.001",
         "--fp32", *ddp_check.TINY]


def _records(run: list) -> list:
    return [r["paths"] for r in run]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(tmp dir, {"one": world-1 record, "two": [rank 0, rank 1] records,
    "jax": the JAX runners' results})."""
    jax = pytest.importorskip("jax")
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.cli import serve as jax_serve
    from rgqa_tpu.data import GQADataset as JaxDataset
    from rgqa_tpu.pretrain import PretrainRunner as JaxPretrainRunner
    from rgqa_tpu.runner import GQARunner as JaxRunner
    from rgqa_tpu.runner import np_params
    from test_torch_clip import write_clip_dir
    from test_torch_pretrain import jax_draws

    tmp = tmp_path_factory.mktemp("ddp")
    root = str(tmp / "roots")
    gqa, _, _ = ddp_check._roots(argparse.Namespace(root=root, spec="16,32,16,24", full=False), SINGLE)
    with pytest.MonkeyPatch.context() as mp:
        # The JAX runners' orbax snapshots are not compared: skip their writes.
        mp.setattr("rgqa_tpu.runner.save_checkpoint", lambda *a, **k: None)
        mp.setattr("rgqa_tpu.pretrain.trainer.save_checkpoint", lambda *a, **k: None)
        key, shifts = jax.random.PRNGKey(SEED), []
        for _ in range(STEPS):  # the JAX runner's chain: split a step, the step's split, its roll
            key, sub = jax.random.split(key)
            shifts.append(int(jax.random.randint(jax.random.split(sub)[1], (), 1, BATCH)))
        pflags = [*FLAGS, "--batchSize", str(2 * BATCH), "--train", "train,valid", "--valid", "testdev"]
        pcfg, _ = jax_config.parse_cli(["--data_root", gqa, "--synthetic", *pflags, "--output", str(tmp / "jax_pre")])
        jax_pre = JaxPretrainRunner(pcfg)
        pre_init = str(tmp / "pretrain_init.pt")
        torch.save(from_jax_params(np_params(jax_pre.params), backbone="lxmert_pretrain"), pre_init)
        t, k, vocab = pcfg.model.max_text_len, 36, pcfg.model.encoder.vocab_size
        key, train_draws = jax.random.PRNGKey(SEED), []
        for _ in range(48 // (2 * BATCH)):
            key, sub = jax.random.split(key)
            train_draws.append(jax_draws(jax, sub, 2 * BATCH, t, k, vocab))
        draws = str(tmp / "draws.pt")
        torch.save({"train": train_draws, "eval": jax_draws(jax, jax.random.PRNGKey(0), 2 * BATCH, t, k, vocab)},
                   draws)

        # The ranks start from the port's seeded init (rp writes it as
        # INIT.pth first), take the JAX chain's rolls and masks, and the
        # pretraining's JAX params.
        clip = write_clip_dir(tmp / "clip", seed=4)
        argv = ["--device", "cpu", "--root", root, "--batch", str(BATCH), "--shifts", ",".join(map(str, shifts)),
                "--pretrain_load", pre_init, "--draws", draws, "--clip_path", str(clip)]
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.path.dirname(os.path.dirname(__file__)))
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            one, two = (pool.submit(ddp_check.launch, world, [*argv, "--out", str(tmp / name)], env=env,
                                    path_seconds=PATH_SECONDS) for world, name in ((1, "one"), (2, "two")))
            # Meanwhile the JAX runners, on their 8-device mesh, from the same init.
            init = tmp / "one" / "rp" / "INIT.pth"
            deadline = time.monotonic() + INIT_SECONDS
            while not init.is_file() and not one.done() and time.monotonic() < deadline:
                time.sleep(0.1)
            if not init.is_file():
                one.result() if one.done() else pytest.fail(f"no {init} within {INIT_SECONDS} s")
            served = io.StringIO()
            jax_serve.main(["--synthetic", "--data_root", gqa, "--test", "testdev", "--load", str(init),
                            "--wave_timeout", "0", *FLAGS, "--output", str(tmp / "jax_serve")],
                           stdin=iter([line + "\n" for line in ddp_check.serve_records(gqa)]), stdout=served)
            jcfg, _ = jax_config.parse_cli(["--data_root", gqa, "--synthetic", *FLAGS, "--sample_pair", "--load",
                                            str(init), "--output", str(tmp / "jax_rp")])
            jax_rp = JaxRunner(jcfg)
            encoded = jax_rp._encode(JaxDataset(gqa, "testdev", add_uq=True))
            dump = str(tmp / "jax_predict.json")
            jax_rp.ood_evaluate(encoded, dump=dump)  # the init's scores, before training
            with open(dump) as f:
                jax_dump = [[r["questionId"], r["prediction"], r["confidence"]] for r in json.load(f)]
            jax_scores = {q: (a, float(c)) for q, (a, c) in jax_rp.score_split(encoded).items()}
            jax_hist = jax_rp.train()
            pre_hist = jax_pre.train()
            results = {"one": _records(one.result())[0], "two": _records(two.result())}
    results["jax"] = {"rp": jax_hist, "pretrain": pre_hist, "dump": jax_dump, "scores": jax_scores,
                      "serve": served.getvalue().splitlines()}
    return tmp, results


def _losses(record: dict) -> np.ndarray:
    """Every step's loss, the pretraining parts flattened, in order."""
    out = []
    for step in record["steps"]:
        loss = step["loss"]
        out.extend(loss.values() if isinstance(loss, dict) else [loss])
    return np.asarray(out)


# ---------------------------------------------------------------------------
# Joining the ranks.
# ---------------------------------------------------------------------------


def test_without_torchrun_env_nothing_is_joined(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_distributed("cpu") is None
    assert not torch.distributed.is_initialized()
    assert make_mesh("cpu") == Mesh(device=torch.device("cpu"))


def test_torchrun_env_joins_a_gloo_group_on_the_cpu(monkeypatch):
    # World 1: rank 0 hosts the store on a port the OS picks (0), bound at once.
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost", "MASTER_PORT": "0"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    try:
        assert initialize_distributed("cpu") == torch.device("cpu")
        assert torch.distributed.is_initialized() and torch.distributed.get_backend() == "gloo"
        mesh = make_mesh("cpu")
        assert (mesh.world, mesh.rank, mesh.backend) == (1, 0, "gloo")
    finally:
        torch.distributed.destroy_process_group()
    monkeypatch.delenv("MASTER_PORT")
    with pytest.raises(RuntimeError, match="MASTER_PORT missing"):
        initialize_distributed("cpu")


def test_model_axis_other_than_one_raises_naming_tensor_parallelism(tmp_path):
    from rgqa_tpu_torch.parallel import global_mesh
    from rgqa_tpu_torch.runner import GQARunner

    cfg, _ = port_config.parse_cli(["--data_root", str(tmp_path / "gqa"), "--synthetic", "--model_axis", "2",
                                    "--output", str(tmp_path / "out")])
    with pytest.raises(NotImplementedError, match="--model_axis 2: tensor parallelism"):
        GQARunner(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        global_mesh(model=2)


def test_a_global_batch_the_world_does_not_divide_raises():
    from rgqa_tpu_torch.data.batching import batch_iterator

    two = Mesh(world=2, rank=1)
    with pytest.raises(ValueError, match="--batchSize 9 is the global batch and WORLD_SIZE 2"):
        check_batch_size(two, 9)
    check_batch_size(two, 8)
    padded, real = pad_batch_to({"x": np.arange(3)}, 4)
    assert real == 3 and shard_batch(two, padded)["x"].tolist() == [2, 2] and two.rows(4) == slice(2, 4)
    assert shard_batch(SINGLE, padded) is padded

    class Rows:
        question_ids = [f"q{i}" for i in range(9)]

        def __len__(self):
            return 9

        def gather_batch(self, idx, with_target=False):
            return {"x": np.asarray(idx)}

    # Rank 1's rows of each padded global batch of 4; the ids and the real
    # count stay the global batch's.
    got = [(q, b["x"].tolist(), r) for q, b, r in batch_iterator(Rows(), 4, mesh=two)]
    assert got == [(["q0", "q1", "q2", "q3"], [2, 3], 4), (["q4", "q5", "q6", "q7"], [6, 7], 4),
                   (["q8"], [8, 8], 1)]
    with pytest.raises(ValueError, match="WORLD_SIZE 2"):
        next(batch_iterator(Rows(), 3, mesh=two))


def test_a_local_rank_past_the_cards_raises(monkeypatch):
    env = {"RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1", "MASTER_ADDR": "localhost", "MASTER_PORT": "1"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="LOCAL_RANK 1 but this host has 1 card"):
        initialize_distributed("cuda")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("entry", ["serve", "distill", "verifier", "runner"])
def test_one_process_entry_points_refuse_several_ranks(entry, monkeypatch, tmp_path):
    """A process launched as one of two ranks that never joined a group
    raises in every entry point, as the runner does, before it builds
    anything (the CLIs' join is skipped: a rank whose launcher left it
    out)."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    argv = ["--data_root", str(tmp_path / "gqa"), "--synthetic", "--device", "cpu", "--output", str(tmp_path / "o")]
    no_group = pytest.raises(RuntimeError, match="WORLD_SIZE is 2 but no process group is initialized")
    if entry == "serve":
        from rgqa_tpu_torch.cli import serve

        monkeypatch.setattr(serve, "initialize_distributed", lambda device: None)
        with no_group:
            serve.main([*argv, "--test", "testdev"])
    elif entry == "distill":
        from rgqa_tpu_torch.cli import distill

        monkeypatch.setattr(distill, "initialize_distributed", lambda device: None)
        with no_group:
            distill.main(argv)
    elif entry == "verifier":
        from rgqa_tpu_torch.verifier import VerifierTrainer

        with no_group:
            VerifierTrainer(None, None)
    else:  # a rank launched without joining never carries on alone
        from rgqa_tpu_torch.runner import GQARunner

        cfg, _ = port_config.parse_cli(argv)
        with no_group:
            GQARunner(cfg, device="cpu")
    assert not (tmp_path / "gqa").exists()


def test_one_rank_streams_are_the_one_process_streams():
    got = DropoutRng.for_rank(5, "cpu")
    want = DropoutRng(device=torch.Generator().manual_seed(5), host=torch.Generator().manual_seed(5))
    assert [got.seed(), got.shift(8), got.seed()] == [want.seed(), want.shift(8), want.seed()]
    assert torch.equal(torch.randint(0, 256, (32,), generator=got.device),
                       torch.randint(0, 256, (32,), generator=want.device))


# ---------------------------------------------------------------------------
# Two ranks against one process, and against the JAX runners.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", TRAIN_PATHS)
def test_two_ranks_train_like_one_process(runs, path):
    _, res = runs
    one, (r0, r1) = res["one"][path], (res["two"][0][path], res["two"][1][path])
    want = _losses(one)
    assert len(want) >= STEPS and np.all(np.isfinite(want))
    np.testing.assert_array_equal(_losses(r0), _losses(r1))  # every rank reports the global loss
    np.testing.assert_allclose(_losses(r0), want, rtol=RTOL)
    assert r0["qids"] == r1["qids"] == one["qids"]  # the same global batches on every rank
    assert r0["shifts"] == r1["shifts"] == one["shifts"]
    assert r0["mixup"] == r1["mixup"] == one["mixup"]
    for key, value in one["history"].items():  # the epochs' losses, validation and (VQA) train scores
        if path == "pretrain" and key == "train":
            value, got = [list(v.values()) for v in value], [list(v.values()) for v in r0["history"][key]]
        else:
            got = r0["history"][key]
        np.testing.assert_allclose(got, value, rtol=RTOL, err_msg=key)


@pytest.mark.parametrize("path", EVAL_PATHS)
def test_two_ranks_score_like_one_process(runs, path):
    _, res = runs
    one, r0, r1 = res["one"][path], res["two"][0][path], res["two"][1][path]
    assert [row[:2] for row in r0["dump"]] == [row[:2] for row in one["dump"]]  # ids, order, answers
    assert len(one["dump"]) == 24 and "dump" not in r1  # rank 0 alone writes it
    for got in (r0, r1):
        assert [row[:2] for row in got["scores"]] == [row[:2] for row in one["scores"]]
        np.testing.assert_allclose([row[2] for row in got["scores"]], [row[2] for row in one["scores"]],
                                   rtol=RTOL)
    np.testing.assert_allclose([row[2] for row in r0["dump"]], [row[2] for row in one["dump"]], rtol=RTOL)


def test_two_ranks_fit_maha_over_the_whole_train_split(runs):
    """The fit's moments, before the covariance's inverse: the gathered
    features' per-class sums, counts and second moment, as one process's."""
    _, res = runs
    got, want = (torch.load(r["eval_maha"]["moments"], weights_only=True) for r in (res["two"][0], res["one"]))
    sums, counts, second = want
    assert float(counts.sum()) >= 256  # every train row of the fit's root, each once per answer
    torch.testing.assert_close(got[1], counts, rtol=0, atol=0)
    for g, w in ((got[0], sums), (got[2], second)):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=RTOL * float(w.abs().max()))


def test_two_ranks_rp_matches_the_jax_runner(runs):
    _, res = runs
    got, want = res["two"][0]["rp"]["history"], res["jax"]["rp"]
    np.testing.assert_allclose(got["loss"], [float(x) for x in want["loss"]], rtol=JAX_RTOL)
    assert got["valid"] == want["valid"]
    assert _losses(res["two"][0]["rp"])[-1] == got["loss"][-1]


def test_two_ranks_pretraining_matches_the_jax_runner(runs):
    _, res = runs
    got, want = res["two"][0]["pretrain"]["history"], res["jax"]["pretrain"]
    assert set(got["train"][0]) == set(want["train"][0]) and len(got["train"][0]) == 6
    for name, value in want["train"][0].items():
        np.testing.assert_allclose(got["train"][0][name], value, rtol=JAX_RTOL, err_msg=name)
    np.testing.assert_allclose(got["eval"], want["eval"], rtol=JAX_RTOL)


def test_two_ranks_evaluate_msp_matches_the_jax_runner(runs):
    _, res = runs
    got, jax_dump, jax_scores = res["two"][0]["eval_msp"], res["jax"]["dump"], res["jax"]["scores"]
    assert [row[:2] for row in got["dump"]] == [row[:2] for row in jax_dump]
    np.testing.assert_allclose([row[2] for row in got["dump"]], [row[2] for row in jax_dump], rtol=2e-4, atol=2e-5)
    assert [row[1] for row in got["scores"]] == [jax_scores[row[0]][0] for row in got["scores"]]
    np.testing.assert_allclose([row[2] for row in got["scores"]], [jax_scores[row[0]][1] for row in got["scores"]],
                               rtol=2e-4, atol=2e-5)


def test_dropout_streams_are_per_rank_and_the_draws_shared(runs):
    _, res = runs
    (d0, s0), (d1, s1) = ((r["rp_drop"], r["streams"]) for r in res["two"])
    # Every attention call of a step draws a seed: each rank its own.
    assert len(d0["seeds"]) == len(d1["seeds"]) > 0
    assert all(a != b for a, b in zip(d0["seeds"], d1["seeds"]))
    assert s0["attention_seeds"] != s1["attention_seeds"] and s0["hidden"] != s1["hidden"]
    # The global batch's draws agree.
    assert d0["shifts"] == d1["shifts"] and len(d0["shifts"]) == STEPS
    assert d0["qids"] == d1["qids"]
    for key in ("shift", "shuffle", "mixup"):
        assert s0[key] == s1[key], key
    # The shared stream is the one-process stream; dropout makes the losses differ.
    assert d0["shifts"] == res["one"]["rp_drop"]["shifts"]
    assert s0["shuffle"] == res["one"]["streams"]["shuffle"] and s0["mixup"] == res["one"]["streams"]["mixup"]
    assert np.isfinite(_losses(d0)).all()


def test_two_rank_train_cli_writes_once_and_resumes(runs):
    tmp, res = runs
    out = tmp / "two" / "cli"
    lines = [l for l in (out / "log.log").read_text().splitlines() if l]
    assert len(lines) == 6 and lines[0].startswith("Epoch 0: Train Loss ") and lines[3].startswith("Epoch 0: ")
    assert (out / "BEST.pth").is_file() and (out / "LAST.pth").is_file()
    state = torch.load(out / "LAST.state.pt", weights_only=True)
    assert state["step"] == 2 * STEPS and len(state["rng_ranks"]) == 2
    assert not torch.equal(state["rng_ranks"][0]["device"], state["rng_ranks"][1]["device"])
    got, one = res["two"][0]["cli"], res["one"]["cli"]
    assert max(got["history"]["valid"]) > 0  # so BEST.pth was written
    np.testing.assert_allclose(got["resumed"]["loss"], one["resumed"]["loss"], rtol=RTOL)
    with open(tmp / "one" / "cli" / "LAST.state.pt", "rb") as f:
        assert "rng_ranks" not in torch.load(f, weights_only=True)  # one process: the old layout


def _served(lines: list) -> tuple[list, list]:
    """(the answers, the error records) of a serve's printed lines."""
    rows = [json.loads(line) for line in lines]
    return [r for r in rows if "error" not in r], [r for r in rows if "error" in r]


def test_two_rank_serve_answers_like_one_process(runs):
    _, res = runs
    one, r0, r1 = res["one"]["serve"], res["two"][0]["serve"], res["two"][1]["serve"]
    answers, errors = _served(r0["lines"])
    want_answers, want_errors = _served(one["lines"])
    assert r1["lines"] == [] and r0["served"] == r1["served"] == one["served"] == 24  # rank 0 alone prints
    assert len(errors) == 2 and errors == want_errors  # each bad record answered once
    assert [(a["questionId"], a["prediction"]) for a in answers] == [
        (a["questionId"], a["prediction"]) for a in want_answers]
    np.testing.assert_allclose([a["confidence"] for a in answers], [a["confidence"] for a in want_answers],
                               rtol=0, atol=1e-4 + 1e-9)
    for got in (r0, r1):  # every rank scores every row, unrounded
        assert [row[0] for row in got["scores"]] == [row[0] for row in one["scores"]]
        np.testing.assert_allclose([row[1] for row in got["scores"]], [row[1] for row in one["scores"]], rtol=RTOL)


def test_two_rank_serve_matches_the_jax_serve(runs):
    _, res = runs
    answers, errors = _served(res["two"][0]["serve"]["lines"])
    want_answers, want_errors = _served(res["jax"]["serve"])
    assert [e["record"] for e in errors] == [e["record"] for e in want_errors] and len(errors) == 2
    assert [(a["questionId"], a["prediction"]) for a in answers] == [
        (a["questionId"], a["prediction"]) for a in want_answers]
    np.testing.assert_allclose([a["confidence"] for a in answers], [a["confidence"] for a in want_answers],
                               rtol=2e-4, atol=1.2e-4)


@pytest.mark.parametrize("path", DISTILL_PATHS)
def test_two_ranks_distill_like_one_process(runs, path):
    _, res = runs
    one, r0, r1 = res["one"][path], res["two"][0][path], res["two"][1][path]
    assert one["rows"] and r0["written"] and one["written"] and "written" not in r1  # rank 0 alone writes
    for got in (r0, r1):
        assert [(r["question_id"], r["img_id"], list(r["label"])) for r in got["rows"]] == [
            (r["question_id"], r["img_id"], list(r["label"])) for r in one["rows"]]
        np.testing.assert_allclose([v for r in got["rows"] for v in r["label"].values()],
                                   [v for r in one["rows"] for v in r["label"].values()], rtol=RTOL)


def test_two_ranks_train_and_score_the_verifier_like_one_process(runs):
    _, res = runs
    one, r0, r1 = res["one"]["verifier"], res["two"][0]["verifier"], res["two"][1]["verifier"]
    assert len(one["losses"]) == 6 and np.all(np.isfinite(one["losses"]))  # 48 rows of train and train_uq at batch 8
    assert r0["losses"] == r1["losses"]  # every rank reports the global loss
    np.testing.assert_allclose(r0["losses"], one["losses"], rtol=RTOL)
    for got in (r0, r1):
        assert [row[:2] for row in got["scores"]] == [row[:2] for row in one["scores"]]
        np.testing.assert_allclose([row[2] for row in got["scores"]], [row[2] for row in one["scores"]], rtol=RTOL)
    assert [row[:2] for row in r0["dump"]] == [row[:2] for row in one["dump"]] and "dump" not in r1
    assert len(one["scores"]) == 24


@pytest.mark.parametrize("path", ["distill_mc_drop", "verifier_drop"])
def test_at_dropout_each_rank_draws_its_own_passes(runs, path):
    """At dropout 0.1 each rank's MC-dropout passes and verifier steps
    draw from its own stream, so two ranks do not repeat one process;
    every rank still reports the global result."""
    _, res = runs
    one, r0, r1 = res["one"][path], res["two"][0][path], res["two"][1][path]
    if path == "verifier_drop":
        assert r0["losses"] == r1["losses"] and len(r0["losses"]) == 6 and np.all(np.isfinite(r0["losses"]))
        assert not np.allclose(r0["losses"], one["losses"], rtol=RTOL)
        assert r0["scores"] == r1["scores"]
    else:
        assert r0["rows"] and r0["rows"] == r1["rows"]
        assert r0["rows"] != one["rows"]


# ---------------------------------------------------------------------------
# --load <run>/BEST
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("task", ["gqa", "vqa"])
def test_load_takes_the_pth_of_a_path_less_its_suffix(runs, task, tmp_path):
    from rgqa_tpu_torch.runner import GQARunner
    from rgqa_tpu_torch.vqa_task import VQARunner

    tmp, _ = runs
    run = tmp / "one" / ("rp" if task == "gqa" else "vqa")
    root = str(tmp / "roots" / task)
    make = (lambda cfg: GQARunner(cfg, init_train=False, device="cpu")) if task == "gqa" else (
        lambda cfg: VQARunner(cfg, init_train=False, device="cpu"))
    test = ["--test", "testdev"] if task == "gqa" else ["--test", "minival"]
    cfg, _ = port_config.parse_cli(["--data_root", root, *FLAGS, *test, "--load", str(run / "LAST"),
                                    "--output", str(tmp_path / "a")])
    runner = make(cfg)
    saved = torch.load(run / "LAST.pth", weights_only=True)
    key = "lxrt_encoder.model.bert.encoder.layer.0.attention.self.query.weight"
    torch.testing.assert_close(runner.model.lxmert.lang_layers[0].att.query.weight, saved[key], rtol=0, atol=0)
    os.makedirs(tmp_path / "orbax_dir")
    with pytest.raises(NotImplementedError, match="is not a .pth file"):
        make(cfg.replace(load=str(tmp_path / "orbax_dir"), output=str(tmp_path / "b")))
