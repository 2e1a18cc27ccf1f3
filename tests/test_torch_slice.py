"""Slice 1 end to end: the port's evaluate path against the JAX runner.

A tiny JAX ``GQARunner`` (fp32, synthetic data) and the port's runner,
loaded with the JAX runner's weights through a reference ``.pth``, score
the same ``testdev`` split with MSP.  Answers are equal, the dumped
confidences (rounded to 4 dp by the prediction-JSON contract) are equal
with at most ``MAX_4DP_FLIPS`` rounding flips, and the metric dicts are
equal.  A subprocess with jax, flax and the JAX package blocked imports
every module of the port and runs the train and evaluate CLIs, which
shows the port runs where jax is absent.  The port's runner is built
from the port's own ``RunConfig`` and asked for the CPU.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rgqa_tpu_torch.checkpoint.convert import from_jax_params, to_reference_state_dict
from rgqa_tpu_torch import config as port_config
from rgqa_tpu_torch.cli import evaluate
from rgqa_tpu_torch.data.dataset import GQADataset
from rgqa_tpu_torch.data.synthetic import SyntheticSpec, make_synthetic_gqa
from rgqa_tpu_torch.runner import GQARunner
from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f32 on both sides; the sums differ only in order, so a confidence may
# land on the other side of a 4-dp rounding boundary.  None was seen.
MAX_4DP_FLIPS = 0
ENC = dict(
    hidden_size=32, num_heads=4, intermediate_size=64, vocab_size=256,
    l_layers=1, x_layers=1, r_layers=1, num_objects=10, visual_feat_dim=48,
)
SPEC = dict(n_images=16, n_train=16, n_valid=8, n_testdev=45, num_boxes=10, feat_dim=48, seed=5)
# The CLI has no flag for the RoI feature width: it reads 36 x 2048 packs.
CLI_SPEC = dict(n_images=6, n_train=8, n_valid=8, n_testdev=20, seed=5)
TINY_FLAGS = [
    "--fp32", "--llayers", "1", "--xlayers", "1", "--rlayers", "1",
    "--hidden_size", "32", "--num_heads", "4", "--batchSize", "16", "--device", "cpu",
]


def _cfg(root, out, config=None, **kw):
    """The tiny run's config, from the port's ``RunConfig`` or from
    ``config``, the JAX package's module."""
    c = config or port_config
    return c.RunConfig(
        model=c.ModelConfig(backbone="lxmert", encoder=c.EncoderConfig(**ENC), max_text_len=12),
        train=c.TrainConfig(batch_size=16, use_bf16=False, seed=11),
        ood=c.OODConfig(scorer="msp"),
        data=c.DataConfig(data_root=root, test_splits="testdev", synthetic=True),
        output=out,
        **kw,
    )


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(jax runner, port runner, data root, tmp dir) sharing weights."""
    pytest.importorskip("jax")
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.runner import GQARunner as JaxRunner
    from rgqa_tpu.runner import np_params

    tmp = tmp_path_factory.mktemp("slice")
    root = str(tmp / "gqa")
    make_synthetic_gqa(root, SyntheticSpec(**SPEC))
    jax_runner = JaxRunner(_cfg(root, str(tmp / "jax"), jax_config), init_train=False)
    sd = from_jax_params(np_params(jax_runner.params))
    pth = str(tmp / "jax_weights.pth")
    torch.save(to_reference_state_dict(sd, l_layers=1, x_layers=1, r_layers=1), pth)
    port_runner = GQARunner(_cfg(root, str(tmp / "port"), load=pth), init_train=False, device="cpu")
    return jax_runner, port_runner, root, tmp


def _encoded(runner, root, jax_side):
    if jax_side:
        from rgqa_tpu.data import GQADataset as JaxDataset

        return runner._encode(JaxDataset(root, "testdev", add_uq=True))
    return runner._encode(GQADataset(root, "testdev", add_uq=True))


def test_ood_evaluate_matches_jax_runner(both):
    jax_runner, port_runner, root, tmp = both
    jdump, pdump = str(tmp / "jax_predict.json"), str(tmp / "port_predict.json")
    want = jax_runner.ood_evaluate(_encoded(jax_runner, root, True), dump=jdump)
    got = port_runner.ood_evaluate(_encoded(port_runner, root, False), dump=pdump)

    with open(jdump) as f:
        jrows = json.load(f)
    with open(pdump) as f:
        prows = json.load(f)
    assert len(prows) == SPEC["n_testdev"]
    assert [r["questionId"] for r in prows] == [r["questionId"] for r in jrows]
    assert [r["prediction"] for r in prows] == [r["prediction"] for r in jrows]
    flips = sum(p["confidence"] != j["confidence"] for p, j in zip(prows, jrows))
    assert flips <= MAX_4DP_FLIPS
    np.testing.assert_allclose(
        [p["confidence"] for p in prows], [j["confidence"] for j in jrows], atol=1e-4
    )
    assert got.keys() == want.keys()
    assert {"auaf", "fpr@0.95acc", "full_acc"} <= got.keys()
    for key in want:
        np.testing.assert_equal(got[key], want[key], err_msg=key)


def test_score_split_confidences_agree(both):
    jax_runner, port_runner, root, _ = both
    want = jax_runner.score_split(_encoded(jax_runner, root, True))
    got = port_runner.score_split(_encoded(port_runner, root, False))
    assert got.keys() == want.keys()
    for qid, (ans, conf) in got.items():
        assert ans == want[qid][0]
        assert abs(conf - want[qid][1]) <= 1e-5


def test_predict_matches_jax_runner(both, tmp_path):
    jax_runner, port_runner, root, _ = both
    want = jax_runner.predict(_encoded(jax_runner, root, True))
    got = port_runner.predict(_encoded(port_runner, root, False), dump=str(tmp_path / "p.json"))
    assert got == want
    with open(tmp_path / "p.json") as f:
        assert len(json.load(f)) == len(got)


def test_runner_shapes_and_seeded_init(both):
    _, port_runner, _, tmp = both
    assert port_runner.model_cfg.num_answers == port_runner.dataset.num_answers - 1
    assert port_runner.label2ans[-1] == "UQ"
    assert os.path.exists(tmp / "port" / "run_config.json")


def test_cli_writes_predictions_and_metrics(tmp_path):
    root, out = str(tmp_path / "gqa"), str(tmp_path / "out")
    make_synthetic_gqa(root, SyntheticSpec(**CLI_SPEC))
    results = evaluate.main([
        "--synthetic", "--data_root", root, "--test", "testdev", "--scorer", "msp",
        "--output", out, *TINY_FLAGS,
    ])
    with open(os.path.join(out, "testdev_predict.json")) as f:
        rows = json.load(f)
    with open(os.path.join(out, "testdev_result.json")) as f:
        written = json.load(f)
    assert len(rows) == CLI_SPEC["n_testdev"]
    assert written.keys() == results["testdev"].keys()
    assert {"auaf", "fpr@0.95acc", "full_acc"} <= written.keys()


@pytest.mark.parametrize(
    "extra, match",
    [
        (["--scorer", "clip"], "--scorer clip needs --clip_path"),
        (["--scorer", "match"], "--scorer match needs --loadLXMERT"),
        (["--scorer", "maha", "--backbone", "caps"], "--backbone caps has none"),
    ],
)
def test_cli_refuses_unported_options(tmp_path, extra, match):
    argv = ["--synthetic", "--data_root", str(tmp_path), "--test", "testdev",
            "--output", str(tmp_path / "out"), *TINY_FLAGS, *extra]
    with pytest.raises(SystemExit, match=match):
        evaluate.main(argv)


def test_runner_refuses_orbax_snapshots_and_unported_options(tmp_path):
    root = str(tmp_path / "gqa")
    make_synthetic_gqa(root, SyntheticSpec(**SPEC))
    with pytest.raises(NotImplementedError, match="orbax"):
        GQARunner(_cfg(root, str(tmp_path / "o"), load=str(tmp_path / "snap_dir")),
                  init_train=False, device="cpu")
    # --loadLXMERTQA reads a .pth (tests/test_torch_pretrained_init.py);
    # an orbax snapshot directory stays refused by name.
    (tmp_path / "qa_snapshot").mkdir()
    cfg = _cfg(root, str(tmp_path / "o"), load_lxmert_qa=str(tmp_path / "qa_snapshot"))
    with pytest.raises(NotImplementedError, match="--loadLXMERTQA an orbax"):
        GQARunner(cfg, init_train=False, device="cpu")


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
from rgqa_tpu_torch.cli import evaluate, train
argv, out = sys.argv[1:], sys.argv[sys.argv.index("--output") + 1]
history = train.main(argv + ["--epochs", "1", "--sample_pair"])
results = evaluate.main(argv + ["--test", "testdev", "--load", os.path.join(out, "LAST.pth")])
loaded = [m for m, v in sys.modules.items() if v is not None and m.split(".")[0] in BLOCKED]
print("RESULT", json.dumps({"keys": sorted(results["testdev"]), "loss": history["loss"], "loaded": loaded}))
"""


def test_port_runs_with_jax_blocked(tmp_path):
    root, out = str(tmp_path / "gqa"), str(tmp_path / "out")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_FREE, "--synthetic", "--data_root", root,
         "--output", out, *TINY_FLAGS],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(l for l in proc.stdout.splitlines() if l.startswith("RESULT "))
    res = json.loads(line[len("RESULT "):])
    assert res["loaded"] == []
    assert {"auaf", "fpr@0.95acc", "full_acc"} <= set(res["keys"])
    assert len(res["loss"]) == 1
    for name in ("LAST.pth", "LAST.state.pt", "log.log", "testdev_predict.json"):
        assert os.path.exists(os.path.join(out, name)), name
