"""Slice 10 end to end: the port's rejection scorers through ``GQARunner``
and the evaluate CLI, against the JAX package's, on the CPU.

Tiny LXMERT runners (fp32, the synthetic root of
``tests/test_torch_slice.py``) of both packages share weights through a
reference ``.pth`` written from the JAX runner's parameters.  Bounds:

- ``ood_evaluate`` with energy, ODIN (T 1000, noise 1e-2), branched and
  Mahalanobis (noise 0 and 1e-2): equal answers, confidences within
  ``CONF_ATOL`` (energy, ODIN, branched) or ``MAHA_RTOL`` of the JAX
  package's, equal metric dicts.  A ``sample_estimates.pkl`` written by
  either package loads in the other and scores alike.
- ``ensemble_ood_evaluate`` over two ``.pth`` files and
  ``gated_ood_evaluate`` (a one-logit detector gating a GQA answerer):
  equal answers, confidences within ``CONF_ATOL``, equal metric dicts.
- ``predict_with_thresh``: tau within ``CONF_ATOL``, equal answers.  The
  dump differs from the JAX package's by one named exclusion: the JAX
  package rounds the confidences to 4 dp (``rgqa_tpu/eval.py:602``, a
  fault of the reference port; ``gqa_conf.py:295`` writes full
  precision), the port does not.
- The evaluate CLI on ``--device cpu`` with each new flag (``--scorer``
  energy / odin / dropout / maha / branched / separate, ``--target_acc``,
  ``--load a.pth,b.pth``) writes the same prediction JSON (answers equal,
  confidences within ``CONF_ATOL``) and metric dict as the JAX CLI on the
  same weights; MC-dropout at ``--dropout 0`` (the masks cannot match
  JAX's bits at a nonzero rate).  A subprocess runs the port's CLI with
  jax, flax and the JAX package blocked.

The model is back in eval mode after every run (MC-dropout and the
Mahalanobis fit included, on a runner built for the fit with
``init_train=True``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from rgqa_tpu_torch import config as port_config
from rgqa_tpu_torch import scorers as port_scorers
from rgqa_tpu_torch.checkpoint.convert import from_jax_params, to_reference_state_dict
from rgqa_tpu_torch.cli import evaluate
from rgqa_tpu_torch.data.dataset import GQADataset
from rgqa_tpu_torch.data.synthetic import SyntheticSpec, make_synthetic_gqa
from rgqa_tpu_torch.runner import GQARunner

from test_torch_slice import CLI_SPEC, ENC, REPO, SPEC, TINY_FLAGS

CONF_ATOL = 1e-5
# The Mahalanobis scores go through an f32 precision matrix whose
# covariance has condition ~2e3 here (``_varied``): the two packages'
# pooled features differ by f32 round-off (~1e-7), which moves the
# precision by up to ~7e-4 of its largest entry.
MAHA_RTOL = 2e-3
ODIN = dict(temperature=1000.0, noise=1e-2)


def _cfg(root, out, config=None, *, ood=None, strategy="conf", branched=False, seed=11, **kw):
    c = config or port_config
    return c.RunConfig(
        model=c.ModelConfig(backbone="lxmert", encoder=c.EncoderConfig(**ENC), max_text_len=12,
                            branched=branched),
        train=c.TrainConfig(batch_size=16, use_bf16=False, seed=seed, strategy=strategy),
        ood=c.OODConfig(**(ood or {})),
        data=c.DataConfig(data_root=root, test_splits="testdev", synthetic=True),
        output=out,
        **kw,
    )


def _spread(params, scale=10.0):
    """Spread the answer logits of a random init (no near-tie labels)."""
    import jax

    params = jax.tree_util.tree_map(np.array, params)
    params["answer_head"]["logits"]["kernel"] *= scale
    return params


def _favour(params, root, boost=8.0):
    """Raise the bias of testdev's most frequent answer: a random init
    answers no question right, and ``--target_acc`` needs some right."""
    import collections

    with open(os.path.join(root, "testdev.json")) as f:
        labels = [a for row in json.load(f) for a in row["label"] if a != "UQ"]
    with open(os.path.join(root, "trainval_ans2label.json")) as f:
        ans2label = json.load(f)
    params = {**params, "answer_head": {**params["answer_head"]}}
    logits = dict(params["answer_head"]["logits"])
    logits["bias"] = logits["bias"].copy()
    logits["bias"][ans2label[collections.Counter(labels).most_common(1)[0][0]]] += boost
    params["answer_head"]["logits"] = logits
    return params


def _varied(params, scale=10.0):
    """Scale the encoder's dense kernels: at the random init's std 0.02
    the pooled features hardly depend on the input, their covariance is
    near singular (eigenvalues 1e-8 - 1e-6) and its pseudo-inverse is
    round-off.  Scaled, the covariance's condition number is ~2e3."""
    import jax

    def scale_kernel(path, x):
        names = [getattr(k, "key", str(k)) for k in path]
        return x * scale if names[0] == "lxmert" and names[-1] == "kernel" else x

    return jax.tree_util.tree_map_with_path(scale_kernel, params)


def _ln_varied(params, seed=7, std=0.1):
    """Seeded LayerNorm scales ``1 + std N(0, 1)`` and biases ``std N(0,
    1)``, which bf16 cannot hold exactly (the init's 1 and 0 it can): a
    fit from bf16 weights then reads other LayerNorm parameters than one
    from f32 weights."""
    import jax

    rng = np.random.default_rng(seed)

    def vary(path, x):
        names = [getattr(k, "key", str(k)) for k in path]
        if names[-1] in ("scale", "bias") and (names[-2].endswith("ln") or names[-2] == "layer_norm"):
            return x + (std * rng.standard_normal(x.shape)).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(vary, params)


def _pth(tmp, name, params):
    path = str(tmp / f"{name}.pth")
    torch.save(to_reference_state_dict(from_jax_params(params), l_layers=1, x_layers=1, r_layers=1), path)
    return path


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Synthetic root, weights as ``.pth`` files and a runner factory for
    each package."""
    pytest.importorskip("jax")
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.runner import GQARunner as JaxRunner
    from rgqa_tpu.runner import np_params

    tmp = tmp_path_factory.mktemp("scoring")
    root = str(tmp / "gqa")
    make_synthetic_gqa(root, SyntheticSpec(**SPEC))
    seed_runner = JaxRunner(_cfg(root, str(tmp / "seed"), jax_config), init_train=False)
    params = _spread(np_params(seed_runner.params))
    paths = {"a": _pth(tmp, "a", params), "maha": _pth(tmp, "maha", _varied(params)),
             "thresh": _pth(tmp, "thresh", _favour(params, root))}
    other = JaxRunner(_cfg(root, str(tmp / "seed_b"), jax_config, seed=3), init_train=False)
    paths["b"] = _pth(tmp, "b", _spread(np_params(other.params)))
    det = JaxRunner(_cfg(root, str(tmp / "seed_det"), jax_config, strategy="separate"), init_train=False)
    paths["det"] = _pth(tmp, "det", np_params(det.params))
    branched = JaxRunner(_cfg(root, str(tmp / "seed_br"), jax_config, branched=True), init_train=False)
    bparams = _spread(np_params(branched.params))
    bparams["conf_head"]["logits"]["kernel"] *= 30.0
    paths["branched"] = str(tmp / "branched.pth")
    torch.save(to_reference_state_dict(from_jax_params(bparams), l_layers=1, x_layers=1, r_layers=1),
               paths["branched"])

    # The Mahalanobis fit needs more labeled train rows than the hidden
    # width, or its covariance is singular and the precision ill-posed.
    maha_root = str(tmp / "gqa_maha")
    make_synthetic_gqa(maha_root, SyntheticSpec(**dict(SPEC, n_images=32, n_train=256)))

    def runners(name, *, init_train=False, load="a", data_root=root, **kw):
        jax_runner = JaxRunner(
            _cfg(data_root, str(tmp / f"jax_{name}"), jax_config, load=paths[load], **kw),
            init_train=init_train,
        )
        port_runner = GQARunner(_cfg(data_root, str(tmp / f"port_{name}"), load=paths[load], **kw),
                                init_train=init_train, device="cpu")
        return jax_runner, port_runner

    runners.maha_root = maha_root
    return root, tmp, paths, runners


def _encoded(runner, root, jax_side):
    if jax_side:
        from rgqa_tpu.data import GQADataset as JaxDataset

        return runner._encode(JaxDataset(root, "testdev", add_uq=True))
    return runner._encode(GQADataset(root, "testdev", add_uq=True))


def _same_results(got, want):
    assert got.keys() == want.keys()
    assert {"auaf", "fpr@0.95acc", "full_acc"} <= got.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-12, err_msg=key)


def _same_dumps(pdump, jdump, *, rtol=0.0, atol=CONF_ATOL):
    with open(pdump) as f:
        prows = json.load(f)
    with open(jdump) as f:
        jrows = json.load(f)
    assert [r["questionId"] for r in prows] == [r["questionId"] for r in jrows]
    assert [r["prediction"] for r in prows] == [r["prediction"] for r in jrows]
    # The dump holds 4-dp confidences: allow one step of the rounding.
    np.testing.assert_allclose([p["confidence"] for p in prows], [j["confidence"] for j in jrows],
                               rtol=rtol, atol=max(atol, 1e-4))
    return prows


def _score_both(jax_runner, port_runner, root, tmp, tag, jax_scorer=None, port_scorer=None):
    jdump, pdump = str(tmp / f"{tag}_jax.json"), str(tmp / f"{tag}_port.json")
    want = jax_runner.ood_evaluate(_encoded(jax_runner, root, True), dump=jdump, scorer=jax_scorer)
    got = port_runner.ood_evaluate(_encoded(port_runner, root, False), dump=pdump, scorer=port_scorer)
    return got, want, pdump, jdump


@pytest.mark.parametrize("name", ["energy", "odin", "branched"])
def test_ood_evaluate_matches_jax(env, name):
    root, tmp, _, runners = env
    kw = dict(ood=dict(scorer=name, **ODIN))
    if name == "branched":
        kw.update(branched=True, load="branched")
    jax_runner, port_runner = runners(name, **kw)
    got, want, pdump, jdump = _score_both(jax_runner, port_runner, root, tmp, name)
    _same_dumps(pdump, jdump)
    _same_results(got, want)
    scores = port_runner.score_split(_encoded(port_runner, root, False))
    ref = jax_runner.score_split(_encoded(jax_runner, root, True))
    for qid, (ans, conf) in scores.items():
        assert ans == ref[qid][0]
        assert abs(conf - ref[qid][1]) <= CONF_ATOL
    assert not port_runner.model.training


@pytest.fixture(scope="module")
def maha_pair(env):
    """Runners built for the fit (``init_train=True``), the port's model
    in eval mode from its construction on."""
    _, _, _, runners = env
    jax_runner, port_runner = runners("maha", init_train=True, ood=dict(scorer="maha"),
                                      data_root=runners.maha_root, load="maha")
    assert not port_runner.model.training
    return jax_runner, port_runner


@pytest.mark.parametrize("noise", [0.0, 1e-2], ids=["plain", "noised"])
def test_maha_ood_evaluate_matches_jax(env, maha_pair, noise):
    from rgqa_tpu import scorers as jax_scorers

    _, tmp, _, runners = env
    root = runners.maha_root
    jax_runner, port_runner = maha_pair
    jest, pest = jax_runner.fit_maha_estimator(), port_runner.fit_maha_estimator()
    assert not port_runner.model.training
    np.testing.assert_allclose(pest.class_mean.numpy(), np.asarray(jest.class_mean), rtol=1e-4, atol=1e-6)
    got, want, pdump, jdump = _score_both(
        jax_runner, port_runner, root, tmp, f"maha_{noise}",
        jax_scorers.make_scorer("maha", jax_runner.forward, estimator=jest, noise=noise),
        port_scorers.make_scorer("maha", port_runner.forward, estimator=pest, noise=noise),
    )
    _same_dumps(pdump, jdump, rtol=MAHA_RTOL)
    _same_results(got, want)
    assert not port_runner.model.training


def test_maha_fit_on_an_evaluation_runner_matches_jax(env, maha_pair):
    """The evaluate CLI's Mahalanobis runner is an evaluation runner
    (``init_train=False``): its fit encodes the train split itself and
    gives the estimator of the JAX package's training runner."""
    _, _, _, runners = env
    jax_runner, _ = maha_pair
    _, port_eval = runners("maha_eval", ood=dict(scorer="maha"), data_root=runners.maha_root, load="maha")
    assert port_eval.train_set is None
    jest, pest = jax_runner.fit_maha_estimator(), port_eval.fit_maha_estimator()
    assert not port_eval.model.training
    np.testing.assert_allclose(pest.class_mean.numpy(), np.asarray(jest.class_mean), rtol=1e-4, atol=1e-6)
    jprec = np.asarray(jest.precision)
    np.testing.assert_allclose(pest.precision.numpy(), jprec, rtol=MAHA_RTOL,
                               atol=MAHA_RTOL * np.abs(jprec).max())


def test_maha_cache_loads_in_either_package(env, maha_pair):
    from rgqa_tpu import scorers as jax_scorers

    _, tmp, _, runners = env
    root = runners.maha_root
    jax_runner, port_runner = maha_pair
    jax_runner.fit_maha_estimator()
    port_runner.fit_maha_estimator()
    jpkl = os.path.join(jax_runner.output, "sample_estimates.pkl")
    ppkl = os.path.join(port_runner.output, "sample_estimates.pkl")
    with open(jpkl, "rb") as f:
        jdata = pickle.load(f)
    with open(ppkl, "rb") as f:
        pdata = pickle.load(f)
    for data in (jdata, pdata):
        assert sorted(data) == ["mean", "precision"]
        assert all(isinstance(v, np.ndarray) and v.dtype == np.float32 for v in data.values())
    # Each package's cache in the other's output directory.
    jax_reader, port_reader = runners("maha_swap", ood=dict(scorer="maha"), data_root=root, load="maha")
    with open(os.path.join(jax_reader.output, "sample_estimates.pkl"), "wb") as f:
        pickle.dump(pdata, f)
    with open(os.path.join(port_reader.output, "sample_estimates.pkl"), "wb") as f:
        pickle.dump(jdata, f)
    jest, pest = jax_reader.fit_maha_estimator(), port_reader.fit_maha_estimator()
    np.testing.assert_array_equal(np.asarray(jest.precision), pdata["precision"])
    np.testing.assert_array_equal(pest.precision.numpy(), jdata["precision"])
    # The same estimator (the JAX package's) in both: the scores agree.
    jest = jax_scorers.MahaEstimator(jdata["mean"], jdata["precision"])
    got, want, pdump, jdump = _score_both(
        jax_reader, port_reader, root, tmp, "maha_swap",
        jax_scorers.make_scorer("maha", jax_reader.forward, estimator=jest),
        port_reader.make_scorer("maha"),
    )
    _same_dumps(pdump, jdump, rtol=MAHA_RTOL)
    _same_results(got, want)


def test_ensemble_ood_evaluate_matches_jax(env):
    root, tmp, paths, runners = env
    jax_runner, port_runner = runners("ens", ood=dict(ensemble_method="mean"))
    jdump, pdump = str(tmp / "ens_jax.json"), str(tmp / "ens_port.json")
    want = jax_runner.ensemble_ood_evaluate(_encoded(jax_runner, root, True), [paths["a"], paths["b"]], jdump)
    got = port_runner.ensemble_ood_evaluate(_encoded(port_runner, root, False), [paths["a"], paths["b"]],
                                            pdump)
    _same_dumps(pdump, jdump)
    _same_results(got, want)


def test_gated_ood_evaluate_matches_jax(env):
    root, tmp, paths, runners = env
    jax_det, port_det = runners("det", load="det", strategy="separate")
    jax_ans, port_ans = runners("ans")
    assert port_det.model_cfg.num_answers == 1
    jdump, pdump = str(tmp / "gated_jax.json"), str(tmp / "gated_port.json")
    want = jax_det.gated_ood_evaluate(_encoded(jax_det, root, True), jax_ans, jdump)
    got = port_det.gated_ood_evaluate(_encoded(port_det, root, False), port_ans, pdump)
    _same_dumps(pdump, jdump)
    _same_results(got, want)


def test_predict_with_thresh_matches_jax_but_for_the_4dp_dump(env):
    root, tmp, _, runners = env
    jax_runner, port_runner = runners("thresh", ood=dict(target_acc=0.1), load="thresh")
    jdump, pdump = str(tmp / "thresh_jax.json"), str(tmp / "thresh_port.json")
    want = jax_runner.predict_with_thresh(_encoded(jax_runner, root, True), dump=jdump)
    got = port_runner.predict_with_thresh(_encoded(port_runner, root, False), dump=pdump)
    assert abs(got["tau"] - want["tau"]) <= CONF_ATOL
    assert {q: a for q, (a, _) in got["quesid2ans"].items()} == {
        q: a for q, (a, _) in want["quesid2ans"].items()}
    assert any(a == "UQ" for a, _ in got["quesid2ans"].values())
    with open(pdump) as f:
        prows = json.load(f)
    with open(jdump) as f:
        jrows = json.load(f)
    assert prows.keys() == jrows.keys()
    for qid, (ans, conf) in prows.items():
        assert ans == jrows[qid][0]
        assert conf == got["quesid2ans"][qid][1]  # full precision
        # The named exclusion: the JAX dump holds the 4-dp rounding.
        assert abs(round(conf, 4) - jrows[qid][1]) <= 1e-4 + 1e-12
    assert any(round(c, 4) != c for _, c in prows.values())


def test_pseudo_labels_carry_the_scorer_answer(env):
    root, tmp, _, runners = env
    jax_runner, port_runner = runners("pseudo", ood=dict(scorer="energy"))
    want = jax_runner.get_pseudo_labels(_encoded(jax_runner, root, True))
    got = port_runner.get_pseudo_labels(_encoded(port_runner, root, False), dump=str(tmp / "pseudo.json"))
    assert [r["question_id"] for r in got] == [r["question_id"] for r in want]
    for g, w in zip(got, want):
        (ga, gs), = g["label"].items()
        (wa, ws), = w["label"].items()
        assert ga == wa and abs(gs - ws) <= CONF_ATOL * max(1.0, abs(ws))
    with open(tmp / "pseudo.json") as f:
        assert len(json.load(f)) == len(got)


def test_mc_dropout_leaves_the_model_in_eval_mode(env):
    root, _, _, runners = env
    _, port_runner = runners("mcd", ood=dict(scorer="dropout", seed_list=(0, 1, 2)))
    modes = []
    forward = port_runner.forward

    def spy(batch, **kw):
        out = forward(batch, **kw)
        modes.append(kw.get("deterministic"))
        return out

    port_runner.forward = spy
    out = port_runner.score_split(_encoded(port_runner, root, False))
    assert len(out) == SPEC["n_testdev"] and not port_runner.model.training
    assert set(modes) == {False}


# ---------------------------------------------------------------------------
# The evaluate CLI, each new flag, against the JAX CLI.
# ---------------------------------------------------------------------------

CLI_CASES = {
    "energy": ["--scorer", "energy"],
    "odin": ["--scorer", "odin", "--temperature", "1000", "--noise", "0.01"],
    "dropout": ["--scorer", "dropout", "--dropout", "0", "--seed_list", "0,1,2"],
    "maha": ["--scorer", "maha", "--noise", "0.01"],
    "branched": ["--scorer", "branched", "--branched", "--mix_branched_score"],
    "separate": ["--scorer", "separate"],
    "target_acc": ["--target_acc", "0.1"],
    "ensemble": ["--ensemble_method", "multiply"],
}


@pytest.fixture(scope="module")
def cli_env(tmp_path_factory):
    """A synthetic root at the CLI's feature width and ``.pth`` weights
    written from JAX runners built by the JAX CLI's own parser."""
    pytest.importorskip("jax")
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.runner import GQARunner as JaxRunner
    from rgqa_tpu.runner import np_params

    tmp = tmp_path_factory.mktemp("scoring_cli")
    root = str(tmp / "gqa")
    make_synthetic_gqa(root, SyntheticSpec(**CLI_SPEC))
    # The Mahalanobis fit's root: more labeled train rows than the width.
    make_synthetic_gqa(str(tmp / "gqa_maha"), SyntheticSpec(**dict(CLI_SPEC, n_images=32, n_train=256)))
    flags = [f for f in TINY_FLAGS if f not in ("--device", "cpu")]
    paths = {}
    for name, extra in (("a", []), ("b", ["--seed", "3"]), ("det", ["--strategy", "separate"]),
                        ("branched", ["--branched"])):
        cfg, _ = jax_config.parse_cli(["--synthetic", "--data_root", root, "--test", "testdev",
                                       "--output", str(tmp / f"init_{name}"), *flags, *extra])
        params = np_params(JaxRunner(cfg, init_train=False).params)
        if name != "det":
            params = _spread(params)
        if name == "branched":
            params["conf_head"]["logits"]["kernel"] *= 30.0
        paths[name] = _pth(tmp, name, params)
        if name == "a":
            paths["maha"] = _pth(tmp, "maha", _varied(params))
            paths["maha_ln"] = _pth(tmp, "maha_ln", _ln_varied(_varied(params)))
            paths["thresh"] = _pth(tmp, "thresh", _favour(params, root))
    return root, tmp, paths


def _cli_argv(root, out, paths, case):
    load = {"separate": paths["det"], "branched": paths["branched"], "maha": paths["maha"],
            "target_acc": paths["thresh"], "ensemble": f"{paths['a']},{paths['b']}"}.get(case, paths["a"])
    if case == "maha":
        root = os.path.join(os.path.dirname(root), "gqa_maha")
    argv = ["--synthetic", "--data_root", root, "--test", "testdev", "--output", out,
            "--load", load, *CLI_CASES[case]]
    if case == "separate":
        argv += ["--load_gqa", paths["a"]]
    return argv


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_matches_jax_cli(cli_env, case):
    from rgqa_tpu.cli import evaluate as jax_evaluate

    root, tmp, paths = cli_env
    jout, pout = str(tmp / f"jax_{case}"), str(tmp / f"port_{case}")
    flags = [f for f in TINY_FLAGS if f not in ("--device", "cpu")]
    want = jax_evaluate.main(_cli_argv(root, jout, paths, case) + flags)["testdev"]
    got = evaluate.main(_cli_argv(root, pout, paths, case) + TINY_FLAGS)["testdev"]
    with open(os.path.join(pout, "testdev_result.json")) as f:
        assert json.load(f) == got
    jpred, ppred = os.path.join(jout, "testdev_predict.json"), os.path.join(pout, "testdev_predict.json")
    if case == "target_acc":
        assert got.keys() == want.keys() == {"tau"}
        assert abs(got["tau"] - want["tau"]) <= CONF_ATOL
        with open(ppred) as f:
            prows = json.load(f)
        with open(jpred) as f:
            jrows = json.load(f)
        assert {q: a for q, (a, _) in prows.items()} == {q: a for q, (a, _) in jrows.items()}
        return
    _same_dumps(ppred, jpred, rtol=MAHA_RTOL if case == "maha" else 0.0)
    _same_results(got, want)
    if case == "maha":  # a second run reads the fitted estimator back
        with open(os.path.join(pout, "sample_estimates.pkl"), "rb") as f:
            cached = pickle.load(f)
        again = evaluate.main(_cli_argv(root, pout, paths, case) + TINY_FLAGS)["testdev"]
        _same_results(again, got)
        with open(os.path.join(pout, "sample_estimates.pkl"), "rb") as f:
            np.testing.assert_array_equal(pickle.load(f)["precision"], cached["precision"])


# bf16, on weights whose LayerNorm parameters bf16 cannot hold
# (``_ln_varied``): the class means and the precision of the CLI's fit
# against two fits from f32 weights under bf16 compute, as fractions of
# the largest entry.  The port's training runner computes in the same
# order, so the CLI must give its fit to f32 round-off
# (``MAHA_F32_WEIGHTS_TOL``; measured 0, and from bf16 weights 1.3e-2 in
# the means, 4.5e-2 in the precision).  The JAX training runner rounds
# its products in other orders, which moves the fit as far as the
# weights' rounding does (measured from f32 / bf16 weights: means 8.1e-3
# / 1.2e-2, precision 4.1e-2 / 2.0e-2), so that bound (``MAHA_BF16_TOL``)
# holds the packages together and cannot tell the weights apart.
MAHA_F32_WEIGHTS_TOL = 1e-5
MAHA_BF16_TOL = {"mean": 2e-2, "precision": 5e-2}


def _fit_error(got, want) -> dict:
    out = {}
    for name, w in (("mean", want.class_mean), ("precision", want.precision)):
        w = np.asarray(w)
        out[name] = float(np.abs(got[name] - w).max() / np.abs(w).max())
    return out


def test_cli_maha_fits_from_f32_weights_under_bf16(cli_env):
    """Under bf16 (the default, no ``--fp32``) the evaluate CLI fits the
    Mahalanobis estimator it caches from f32 weights under bf16 compute,
    as the JAX CLI's training runner does (``init_train=scorer_name ==
    "maha"``): it equals the fit of the port's training runner and agrees
    with the JAX training runner's ``fit_maha_estimator`` on the same
    weights.  An evaluation runner's bf16 serving weights round the
    LayerNorm parameters, which both packages read in f32, and the fit
    from them, which ``sample_estimates.pkl`` keeps for every later run,
    leaves ``MAHA_F32_WEIGHTS_TOL``."""
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.runner import GQARunner as JaxRunner

    root, tmp, paths = cli_env
    paths = dict(paths, maha=paths["maha_ln"])
    bf16 = [f for f in TINY_FLAGS if f != "--fp32"]
    out = str(tmp / "port_maha_bf16")
    evaluate.main(_cli_argv(root, out, paths, "maha") + bf16)
    with open(os.path.join(out, "sample_estimates.pkl"), "rb") as f:
        got = pickle.load(f)
    cfg, device, _ = evaluate.parse_args(_cli_argv(root, str(tmp / "port_maha_train"), paths, "maha") + bf16)
    assert cfg.train.use_bf16
    err = _fit_error(got, GQARunner(cfg, init_train=True, device=device).fit_maha_estimator())
    assert max(err.values()) <= MAHA_F32_WEIGHTS_TOL, err
    flags = [f for f in bf16 if f not in ("--device", "cpu")]
    cfg, _ = jax_config.parse_cli(_cli_argv(root, str(tmp / "jax_maha_bf16"), paths, "maha") + flags)
    err = _fit_error(got, JaxRunner(cfg, init_train=True).fit_maha_estimator())
    assert all(err[name] <= MAHA_BF16_TOL[name] for name in err), err


def test_cli_maha_takes_the_evaluation_flags_under_bf16(cli_env):
    """``--scorer maha`` takes the flags the other scorers take at
    evaluation: under bf16, on a branched checkpoint (``--branched``), it
    scores every question and caches its fit, as the JAX CLI does."""
    root, tmp, paths = cli_env
    paths = dict(paths, maha=paths["branched"])
    bf16 = [f for f in TINY_FLAGS if f != "--fp32"]
    out = str(tmp / "port_maha_branched")
    got = evaluate.main(_cli_argv(root, out, paths, "maha") + ["--branched"] + bf16)["testdev"]
    assert {"auaf", "fpr@0.95acc", "full_acc"} <= got.keys()
    with open(os.path.join(out, "testdev_predict.json")) as f:
        rows = json.load(f)
    assert len(rows) == CLI_SPEC["n_testdev"]
    assert np.isfinite([r["confidence"] for r in rows]).all()
    with open(os.path.join(out, "sample_estimates.pkl"), "rb") as f:
        assert all(np.isfinite(v).all() for v in pickle.load(f).values())


@pytest.mark.parametrize(
    "extra, match",
    [
        (["--scorer", "frcnn"], "--scorer frcnn is not ported"),
        (["--scorer", "clip"], "--scorer clip is not ported"),
        (["--scorer", "match"], "--scorer match is not ported"),
        (["--scorer", "caption"], "--scorer caption is not ported"),
        (["--scorer", "odin", "--backbone", "vilt"], "--scorer odin perturbs the RoI"),
        (["--scorer", "maha", "--backbone", "vilt"], "--scorer maha perturbs the RoI"),
        (["--scorer", "separate"], "--load_gqa"),
    ],
)
def test_cli_refuses_by_name(tmp_path, extra, match):
    argv = ["--synthetic", "--data_root", str(tmp_path), "--test", "testdev",
            "--output", str(tmp_path / "out"), *TINY_FLAGS, *extra]
    with pytest.raises(SystemExit, match=match):
        evaluate.main(argv)


_JAX_FREE = r"""
import importlib, json, os, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "flax", "orbax", "rgqa_tpu")
for name in [m for m in sys.modules if m.split(".")[0] in BLOCKED]:
    del sys.modules[name]
for name in BLOCKED:
    sys.modules[name] = None  # any import of them now raises ImportError
import rgqa_tpu_torch
for mod in pkgutil.walk_packages(rgqa_tpu_torch.__path__, "rgqa_tpu_torch."):
    importlib.import_module(mod.name)
from rgqa_tpu_torch.cli import evaluate
cases = json.loads(sys.argv[1])
out = {name: sorted(evaluate.main(argv)["testdev"]) for name, argv in cases.items()}
loaded = [m for m, v in sys.modules.items() if v is not None and m.split(".")[0] in BLOCKED]
print("RESULT", json.dumps({"keys": out, "loaded": loaded}))
"""


def test_cli_scorers_run_with_jax_blocked(cli_env):
    root, tmp, paths = cli_env
    cases = {case: _cli_argv(root, str(tmp / f"blocked_{case}"), paths, case) + TINY_FLAGS
             for case in CLI_CASES}
    cases["dropout"] = [a if a != "0" else "0.1" for a in cases["dropout"]]  # --dropout 0.1
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_FREE, json.dumps(cases)], cwd=str(tmp),
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(l for l in proc.stdout.splitlines() if l.startswith("RESULT "))
    res = json.loads(line[len("RESULT "):])
    assert res["loaded"] == []
    for case, keys in res["keys"].items():
        assert (keys == ["tau"]) if case == "target_acc" else {"auaf", "fpr@0.95acc", "full_acc"} <= set(keys)


def test_runner_takes_branched_heads_for_evaluation_only(env):
    root, tmp, paths, _ = env
    cfg = _cfg(root, str(tmp / "br_train"), branched=True)
    with pytest.raises(NotImplementedError, match="--branched"):
        GQARunner(cfg, init_train=True, device="cpu")
    runner = GQARunner(dataclasses.replace(cfg, load=paths["branched"]), init_train=False, device="cpu")
    ref = torch.load(paths["branched"], weights_only=True)  # the conf head comes from the .pth
    torch.testing.assert_close(runner.model.state_dict()["conf_head.logits.weight"], ref["conf_fc.3.weight"])
