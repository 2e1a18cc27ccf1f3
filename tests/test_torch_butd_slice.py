"""BUTD and the caption matcher end to end through the port's
entry points, against the JAX package on the CPU.

- The evaluate CLI with ``--backbone butd`` (msp and ODIN, under the
  default ``--bf16``: BUTD stays f32 in both packages, and its feed's
  feats are rounded to bf16 for msp and kept f32 for ODIN, as the JAX
  feed does) on a synthetic root at the CLI's width, on weights written
  from a JAX runner's parameters as a GQA-BUTD ``.pth``: the JAX CLI's
  answers, confidences within ``CONF_ATOL`` plus the prediction JSON's
  4-dp step, and metric dicts.
- ``--backbone caps --scorer caption --ans_backbone butd``: the caption
  matcher gating the BUTD answerer, the JAX CLI's prediction JSON.
- BUTD's word dictionary and GloVe caches, written by one package's
  runner and read by the other's.
- The Mahalanobis fit on BUTD's 1024-wide joint feature (not the
  encoder's hidden size): its class means are those of the pooled
  features of the train split.
- A 12-step BUTD RP trajectory and a 12-step caption-strategy trajectory
  at dropout 0: losses within rtol 1e-4 (``tests/test_train.py``'s bar).
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from rgqa_tpu_torch import config as port_config
from rgqa_tpu_torch.checkpoint.convert import from_jax_params, to_reference_state_dict
from rgqa_tpu_torch.cli import evaluate
from rgqa_tpu_torch.config import OptimConfig
from rgqa_tpu_torch.data.dataset import GQADataset
from rgqa_tpu_torch.data.synthetic import SyntheticSpec, make_synthetic_gqa
from rgqa_tpu_torch.models.zoo import build_model
from rgqa_tpu_torch.ops.dropout import DropoutRng
from rgqa_tpu_torch.runner import GQARunner
from rgqa_tpu_torch.train import optimizer, step as tstep

import test_torch_butd as butd_t
import test_torch_caps as caps_t
from test_torch_scoring_slice import CONF_ATOL, _same_dumps, _same_results
from test_torch_slice import CLI_SPEC
from test_torch_train import _tensors
from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

BUTD = ["--backbone", "butd", "--batchSize", "16"]
CAPS = ["--backbone", "caps", "--num_layers", "2", "--hidden_size", "32", "--num_heads", "4",
        "--intermediate_size", "64", "--batchSize", "16"]
CPU = ["--device", "cpu"]
N_STEPS = 12
CASES = {"msp": ["--scorer", "msp"], "odin": ["--scorer", "odin", "--temperature", "1000", "--noise", "0.01"]}


@pytest.fixture(scope="module")
def cli_env(tmp_path_factory):
    """(data root, tmp dir, a GQA-BUTD .pth and a GQABERT .pth of random
    weights, seeded)."""
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("butd_cli")
    root = str(tmp / "gqa")
    make_synthetic_gqa(root, SyntheticSpec(**CLI_SPEC))
    paths = {}
    for name, flags in (("butd", BUTD), ("caps", CAPS + ["--strategy", "caption"])):
        cfg, _ = port_config.parse_cli(["--synthetic", "--data_root", root, "--test", "testdev",
                                        "--output", str(tmp / f"init_{name}"), "--seed", "3", "--fp32", *flags,
                                         *CPU])
        runner = GQARunner(cfg, init_train=False, device="cpu")
        sd = runner.model.state_dict()
        if name == "butd":  # spread the answer logits of a random init (no near ties)
            sd["ans_fc2.g"] = sd["ans_fc2.g"] * 30.0
        paths[name] = str(tmp / f"{name}.pth")
        torch.save(to_reference_state_dict(sd, backbone=name, num_layers=2), paths[name])
    return root, tmp, paths


def _argv(root, out, *extra):
    return ["--synthetic", "--data_root", root, "--test", "testdev", "--output", out, *extra]


@pytest.mark.parametrize("case", list(CASES))
def test_butd_cli_matches_jax_cli(cli_env, case):
    from rgqa_tpu.cli import evaluate as jax_evaluate

    root, tmp, paths = cli_env
    jout, pout = str(tmp / f"jax_{case}"), str(tmp / f"port_{case}")
    extra = [*BUTD, "--load", paths["butd"], *CASES[case]]
    want = jax_evaluate.main(_argv(root, jout, *extra))["testdev"]
    got = evaluate.main(_argv(root, pout, *extra, *CPU))["testdev"]
    rows = _same_dumps(os.path.join(pout, "testdev_predict.json"),
                       os.path.join(jout, "testdev_predict.json"), atol=CONF_ATOL)
    assert len(rows) == CLI_SPEC["n_testdev"]
    if case == "msp":
        assert len({r["prediction"] for r in rows}) > 1  # the spread weights answer apart
    _same_results(got, want)


def test_caption_scorer_with_a_butd_answerer_matches_jax_cli(cli_env):
    from rgqa_tpu.cli import evaluate as jax_evaluate

    root, tmp, paths = cli_env
    extra = [*CAPS, "--fp32", "--scorer", "caption", "--load", paths["caps"], "--load_gqa", paths["butd"],
             "--ans_backbone", "butd"]
    jout, pout = str(tmp / "jax_caption"), str(tmp / "port_caption")
    want = jax_evaluate.main(_argv(root, jout, *extra))["testdev"]
    got = evaluate.main(_argv(root, pout, *extra, *CPU))["testdev"]
    _same_dumps(os.path.join(pout, "testdev_predict.json"), os.path.join(jout, "testdev_predict.json"),
                atol=CONF_ATOL)
    _same_results(got, want)
    # The answers are the BUTD answerer's.
    with open(os.path.join(pout, "testdev_predict.json")) as f:
        gated = {r["questionId"]: r["prediction"] for r in json.load(f)}
    cfg, _ = port_config.parse_cli(_argv(root, str(tmp / "answerer"), *BUTD, "--load", paths["butd"], *CPU))
    answerer = GQARunner(cfg, init_train=False, device="cpu")
    assert gated == answerer.predict(answerer._encode(GQADataset(root, "testdev", add_uq=True)))


def _glove(path, words, dim=300):
    rng = np.random.default_rng(0)
    with open(path, "w") as f:
        for w in words:
            f.write(w + " " + " ".join(f"{x:.5f}" for x in rng.standard_normal(dim)) + "\n")
        f.write("short 1.0 2.0\n")  # a line of the wrong width is skipped


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_dictionary_and_glove_caches_load_in_the_other_package(cli_env, writer, tmp_path):
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.runner import GQARunner as JaxRunner

    root = str(tmp_path / "gqa")
    make_synthetic_gqa(root, SyntheticSpec(**CLI_SPEC))
    os.makedirs(os.path.join(root, "butd"))
    _glove(os.path.join(root, "butd", "glove.6B.300d.txt"), ["what", "color", "is", "the", "zebra"])
    argv = _argv(root, str(tmp_path / "out"), *BUTD)

    def jax_run():
        runner = JaxRunner(jax_config.parse_cli(argv)[0], init_train=False)
        return runner.butd_word2idx, np.asarray(runner.params["w_emb"]["embedding"])

    def port_run():
        runner = GQARunner(port_config.parse_cli(argv + CPU)[0], init_train=False, device="cpu")
        return runner.butd_word2idx, runner.model.w_emb.weight.detach().numpy()

    first, second = (jax_run, port_run) if writer == "jax" else (port_run, jax_run)
    words, emb = first()
    files = {name: os.path.getmtime(os.path.join(root, "butd", name))
             for name in ("dictionary.json", "glove.npy", "glove.npy.meta.json")}
    words2, emb2 = second()
    assert words2 == words and len(words) > 5
    np.testing.assert_array_equal(emb2, emb)
    assert emb[words["zebra"]].any() and not emb[-1].any()  # GloVe rows in, the pad row zero
    for name, mtime in files.items():  # the reader did not rewrite the caches
        assert os.path.getmtime(os.path.join(root, "butd", name)) == mtime, name
    with open(os.path.join(root, "butd", "glove.6B.300d.txt")) as f:
        first_row = np.asarray(f.readline().split()[1:], np.float32)
    np.testing.assert_array_equal(emb[words["what"]], first_row)


def test_maha_fits_on_butds_joint_feature(cli_env):
    root, tmp, paths = cli_env
    argv = _argv(root, str(tmp / "maha"), *BUTD, "--load", paths["butd"], *CPU)
    runner = GQARunner(port_config.parse_cli(argv)[0], init_train=False, f32_weights=True, device="cpu")
    est = runner.fit_maha_estimator()
    assert est.class_mean.shape == (runner.model_cfg.num_answers, 1024)  # butd_hidden_dim wide
    assert os.path.isfile(os.path.join(str(tmp / "maha"), "sample_estimates.pkl"))
    train = runner._encode(GQADataset(root, runner.cfg.data.train_splits, add_uq=True))
    batch = train.gather_batch(np.arange(len(train)), with_target=True)
    with torch.no_grad():
        pooled = runner.forward(_tensors(batch), deterministic=True)["pooled"].numpy()
    hit = (batch["target"] > 0).astype(np.float32)  # a row counts once for each answer it carries
    want = (hit.T @ pooled) / np.maximum(hit.sum(0), 1.0)[:, None]
    np.testing.assert_allclose(est.class_mean.numpy(), want, rtol=1e-5, atol=1e-6)


def _adam(lr, n):
    from rgqa_tpu.config import OptimConfig as JaxOptimConfig
    from rgqa_tpu.train import make_optimizer as jax_make_optimizer

    return jax_make_optimizer(JaxOptimConfig(lr=lr), n)


def _jax_losses(jax, jforward, params, batches, lr, **kw):
    from rgqa_tpu.train import create_train_state, make_train_step as jax_make_train_step

    state = create_train_state(params, _adam(lr, N_STEPS))
    jstep = jax_make_train_step(jforward, grad_clip=5.0, donate=False, **kw)
    key, losses, shifts = jax.random.PRNGKey(0), [], []
    b = len(batches[0]["id_mask"])
    for batch in batches:
        key, sub = jax.random.split(key)
        shifts.append(int(jax.random.randint(jax.random.split(sub)[1], (), 1, b)))
        state, aux = jstep(state, {k: jax.numpy.asarray(v) for k, v in batch.items()}, sub)
        losses.append(float(aux["loss"]))
    return losses, shifts


def _port_losses(model, forward, batches, lr, shifts, **kw):
    opt = optimizer.make_optimizer(OptimConfig(lr=lr), model.parameters(), t_total=N_STEPS)
    step = tstep.make_train_step(forward, opt, grad_clip=5.0, rng=DropoutRng(), **kw)
    return [step(_tensors(batch), shift=s)["loss"].item() for batch, s in zip(batches, shifts)]


def _targets(batch, rng, answers):
    b = len(next(iter(batch.values())))
    t = np.zeros((b, answers), np.float32)
    t[np.arange(b), rng.integers(0, answers, b)] = rng.random(b, dtype=np.float32)
    return dict(batch, target=t, id_mask=(rng.random(b) > 0.3).astype(np.float32))


def test_twelve_step_butd_rp_trajectory_matches_jax():
    jax = pytest.importorskip("jax")
    b, lr = 6, 2e-3
    batches = [_targets(butd_t._batch(b, seed=i), np.random.default_rng(50 + i), butd_t.ANSWERS)
               for i in range(N_STEPS)]
    jmodel = butd_t._jax_model(attention_dropout=0.0, answer_dropout=0.0)
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(0), *[batches[0][k] for k in butd_t.INPUTS])["params"])

    def jforward(p, batch, *, deterministic=True, rng=None, **kw):
        return jmodel.apply({"params": p}, batch["token_ids"], batch["feats"], batch["boxes"],
                            deterministic=deterministic)

    jax_losses, shifts = _jax_losses(jax, jforward, params, batches, lr, sample_pair=True)
    model, forward = build_model(butd_t._cfg(), device="cpu", train=True)
    model.load_state_dict(from_jax_params(params), strict=True)
    model.att.rate = model.answer_dropout = 0.0
    port_losses = _port_losses(model, forward, batches, lr, shifts, sample_pair=True)
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-4)
    assert port_losses[0] != port_losses[-1]  # the weights moved


def test_twelve_step_caption_trajectory_matches_jax():
    jax = pytest.importorskip("jax")
    b, lr = 6, 2e-3
    batches = [_targets(caps_t._batch(b, seed=i), np.random.default_rng(70 + i), 1) for i in range(N_STEPS)]
    params, jforward = caps_t._jax_params(jax)
    jax_losses, shifts = _jax_losses(jax, jforward, params, batches, lr, binary=True)
    model, forward = build_model(caps_t._cfg(), device="cpu", train=True)
    model.load_state_dict(from_jax_params(params), strict=True)
    port_losses = _port_losses(model, forward, batches, lr, shifts, binary=True)
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-4)
    assert port_losses[0] != port_losses[-1]


def test_serve_answers_as_the_butd_evaluate_cli(cli_env):
    """The serve CLI with ``--backbone butd``: the evaluate CLI's msp
    answers and confidences (the 4 dp dump) for the records it serves.
    It is held to the port's evaluate CLI, not to the JAX serve: under
    ``--bf16`` the JAX serve rounds BUTD's f32 weights to bf16
    (``rgqa_tpu/cli/serve.py:177-179``), a divergence from the JAX
    package's own BUTD and evaluate CLI that the port does not copy
    (``rgqa_tpu_torch/cli/serve.py``'s docstring)."""
    from rgqa_tpu_torch.cli.serve import serve_lines

    root, tmp, paths = cli_env
    argv = _argv(root, str(tmp / "serve"), *BUTD, "--load", paths["butd"], "--scorer", "msp",
                 "--wave_timeout", "0", *CPU)
    with open(os.path.join(root, "testdev.json")) as f:
        rows = json.load(f)[:5]
    records = [json.dumps({k: r[k] for k in ("question_id", "sent", "img_id")}) for r in rows]
    out, _, _ = serve_lines(argv, records)
    want = evaluate.main(_argv(root, str(tmp / "serve_eval"), *BUTD, "--load", paths["butd"], *CPU))
    with open(os.path.join(str(tmp / "serve_eval"), "testdev_predict.json")) as f:
        dump = {r["questionId"]: r for r in json.load(f)}
    assert {"auaf", "full_acc"} <= set(want["testdev"])
    got = [json.loads(line) for line in out]
    assert [g["questionId"] for g in got] == [r["question_id"] for r in rows]
    for g in got:
        assert g["prediction"] == dump[g["questionId"]]["prediction"]
        assert g["confidence"] == pytest.approx(dump[g["questionId"]]["confidence"], abs=1e-4)


def test_strategy_separate_trains_and_gates_a_butd_detector(cli_env):
    """``--strategy separate`` trains a one-logit BUTD detector with the
    binary loss; ``--scorer separate`` gates a BUTD answerer with it."""
    from rgqa_tpu_torch.cli import train as train_cli

    root, tmp, paths = cli_env
    out = str(tmp / "separate")
    history = train_cli.main(_argv(root, out, *BUTD, "--strategy", "separate", "--epochs", "1",
                                   "--batchSize", "4", *CPU))
    assert np.isfinite(history["loss"]).all()
    ref = torch.load(os.path.join(out, "LAST.pth"), weights_only=True)
    assert ref["ans_classifier.3.weight_v"].shape == (1, 2048)
    res = evaluate.main(_argv(root, str(tmp / "separate_eval"), *BUTD, "--scorer", "separate", "--load",
                              os.path.join(out, "LAST.pth"), "--load_gqa", paths["butd"], *CPU))
    assert {"auaf", "full_acc"} <= set(res["testdev"])
    with open(os.path.join(str(tmp / "separate_eval"), "testdev_predict.json")) as f:
        gated = {r["questionId"]: r["prediction"] for r in json.load(f)}
    cfg, _ = port_config.parse_cli(_argv(root, str(tmp / "sep_answerer"), *BUTD, "--load", paths["butd"], *CPU))
    answerer = GQARunner(cfg, init_train=False, device="cpu")
    assert gated == answerer.predict(answerer._encode(GQADataset(root, "testdev", add_uq=True)))
