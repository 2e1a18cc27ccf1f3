"""The port's rules, checked on the CPU.

- No module of ``rgqa_tpu_torch`` and not ``chip_smoke.py`` imports the
  JAX package, the JAX experiments (``experiments/``), jax, jaxlib, flax
  or orbax (an AST scan; the blocked-import subprocesses of
  ``tests/test_torch_slice.py`` and of this file import every module of
  the port and run the LXMERT and ViLT train and evaluate CLIs and the
  three experiment entry points with all of them blocked).
- Every CUDA source under ``csrc/`` is in the build's ``SOURCES``, and
  ``chip_smoke.py``'s ``KERNELS`` names every kernel wrapper of
  ``ops.attention`` and of ``rgqa_tpu_torch.experiments``, with its
  source and the TPU kernel it replaces.
- The entry points run on the card unless asked for the CPU: without a
  card the runner, ``build_model`` and both CLIs raise when not given the
  CPU.
- The port's copies of framework-free JAX-package modules are held to
  their originals on the same inputs: the config parser (equal
  ``dataclasses.asdict``), the metrics (equal dicts, byte-equal dumps) and
  the checkpoint key map (equal lists, equal loads).
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from rgqa_tpu_torch import config as port_config
from rgqa_tpu_torch import metrics as port_metrics
from rgqa_tpu_torch.checkpoint import torch_import as port_import

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"rgqa_tpu", "experiments", "jax", "jaxlib", "flax", "orbax"}
EXPERIMENTS = ("xfuse_exp", "headfold_exp", "epilogue_exp")


def _port_sources():
    return sorted((REPO / "rgqa_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_of_the_jax_package(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add((node.module or "").split(".")[0])
    assert not roots & FORBIDDEN, f"{path} imports {sorted(roots & FORBIDDEN)}"


_VILT_JAX_FREE = r"""
import importlib, json, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "flax", "orbax", "rgqa_tpu", "experiments")
for name in [m for m in sys.modules if m.split(".")[0] in BLOCKED]:
    del sys.modules[name]
for name in BLOCKED:
    sys.modules[name] = None  # any import of them now raises ImportError
import rgqa_tpu_torch
names = [m.name for m in pkgutil.walk_packages(rgqa_tpu_torch.__path__, "rgqa_tpu_torch.")]
for name in names:
    importlib.import_module(name)
cli = importlib.import_module(f"rgqa_tpu_torch.{sys.argv[1]}")
results = cli.main(sys.argv[2:])
loaded = [m for m, v in sys.modules.items() if v is not None and m.split(".")[0] in BLOCKED]
print("RESULT", json.dumps({"modules": names, "keys": sorted(results.get("testdev", results)),
                            "loaded": loaded}))
"""


_VILT_FLAGS = ["--backbone", "vilt", "--fp32", "--num_layers", "1", "--hidden_size", "32",
               "--num_heads", "4", "--vilt_image_size", "64", "--vilt_patch_size", "16",
               "--batchSize", "16", "--device", "cpu"]


def _run_jax_free(module: str, argv: list, cwd) -> dict:
    """Run ``rgqa_tpu_torch.<module>.main(argv)`` with the JAX package,
    the JAX experiments and jax / flax / orbax blocked."""
    proc = subprocess.run(
        [sys.executable, "-c", _VILT_JAX_FREE, module, *argv], cwd=str(cwd),
        env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(l for l in proc.stdout.splitlines() if l.startswith("RESULT "))
    res = json.loads(line[len("RESULT "):])
    assert res["loaded"] == []
    return res


def test_vilt_evaluate_runs_with_jax_blocked(tmp_path):
    root, out = str(tmp_path / "gqa"), str(tmp_path / "out")
    res = _run_jax_free("cli.evaluate", ["--synthetic", "--data_root", root, "--test", "testdev",
                                     "--output", out, *_VILT_FLAGS], tmp_path)
    assert {"rgqa_tpu_torch.models.vilt", "rgqa_tpu_torch.data.images",
            "rgqa_tpu_torch.ops.pixels"} <= set(res["modules"])
    assert {"auaf", "fpr@0.95acc", "full_acc"} <= set(res["keys"])
    assert os.path.isfile(os.path.join(out, "testdev_predict.json"))


def test_vilt_train_runs_with_jax_blocked(tmp_path):
    root, out = str(tmp_path / "gqa"), str(tmp_path / "out")
    res = _run_jax_free("cli.train", ["--synthetic", "--data_root", root, "--sample_pair",
                                  "--no_randaug", "--epochs", "1", "--output", out, *_VILT_FLAGS],
                        tmp_path)
    assert res["keys"] == ["loss", "valid"]
    for name in ("LAST.pth", "LAST.state.pt"):
        assert os.path.isfile(os.path.join(out, name)), name


@pytest.mark.parametrize("name", EXPERIMENTS)
def test_experiments_run_with_jax_blocked(name, tmp_path):
    res = _run_jax_free(f"experiments.{name}", ["--device", "cpu", "--batch", "2", "--iters", "1"],
                        tmp_path)
    assert {f"rgqa_tpu_torch.experiments.{e}" for e in EXPERIMENTS} <= set(res["modules"])
    assert "launches" in res["keys"] and "rows" in res["keys"]


def test_every_kernel_source_is_built_and_smoked():
    import importlib
    import importlib.util

    from rgqa_tpu_torch.ops import _build, attention as att

    sources = sorted(p.stem for p in (REPO / "rgqa_tpu_torch" / "csrc").glob("*.cu"))
    assert sorted(_build.SOURCES) == sources
    assert {"fused_attention_long_bwd", "xfuse", "headfold", "epilogue"} <= set(sources)
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    modules = [att] + [importlib.import_module(f"rgqa_tpu_torch.experiments.{e}") for e in EXPERIMENTS]
    wrappers = {name.removesuffix("_cuda"): mod for mod in modules for name in mod.__all__
                if name.endswith("_cuda")}
    assert set(smoke.KERNELS) == set(wrappers)
    assert {"fused_attention_long_bwd", "dual_pair", "cat_call", "headfold", "epi_fused"} <= set(wrappers)
    for name, (source, replaces) in smoke.KERNELS.items():
        assert pathlib.Path(source).stem in _build.SOURCES, name
        assert hasattr(getattr(wrappers[name], f"{name}_cuda"), "launches"), name
        path, lines = replaces.split(":")
        for line in lines.split(","):
            text = (REPO / path).read_text().splitlines()[int(line) - 1]
            if wrappers[name] is att:
                assert text.startswith("def _fused"), name
            else:  # an experiment's kernel body
                assert text.startswith("def _") and "_kernel(" in text, name


# ---------------------------------------------------------------------------
# On the card unless asked for the CPU.
# ---------------------------------------------------------------------------


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points would run on it")


def test_entry_points_refuse_to_fall_back_to_the_cpu(no_card, tmp_path):
    from rgqa_tpu_torch.cli import evaluate, train
    from rgqa_tpu_torch.models.zoo import build_model
    from rgqa_tpu_torch.runner import GQARunner

    cfg, ns = port_config.parse_cli(["--data_root", str(tmp_path / "gqa"), "--synthetic",
                                     "--output", str(tmp_path / "out")])
    assert ns.device == "cuda"
    for make in (
        lambda: GQARunner(cfg),
        lambda: GQARunner(cfg, init_train=False),
        lambda: build_model(cfg.model),
        lambda: train.main(["--synthetic", "--data_root", str(tmp_path / "gqa"),
                            "--output", str(tmp_path / "t")]),
        lambda: evaluate.main(["--synthetic", "--data_root", str(tmp_path / "gqa"),
                               "--test", "testdev", "--output", str(tmp_path / "e")]),
    ):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            make()
    assert not (tmp_path / "gqa").exists()  # nothing ran before the refusal


# ---------------------------------------------------------------------------
# The copies against their originals.
# ---------------------------------------------------------------------------

ARGVS = [
    [],
    ["--fp32", "--llayers", "1", "--xlayers", "2", "--rlayers", "3", "--hidden_size", "32",
     "--num_heads", "4", "--batchSize", "16"],
    ["--sample_pair", "--epochs", "1", "--lr", "3e-3", "--dropout", "0", "--seed", "7",
     "--output", "snap/x", "--load", "a.pth"],
    ["--test", "testdev", "--scorer", "energy", "--tau", "0.3", "--seed_list", "1,2,3",
     "--mceLoss", "--mixup_mode", "mixup_v2", "--strategy", "adv", "--bf16_moments"],
    ["--synthetic", "--tiny", "--train", "train,train_uq", "--valid", "", "--eval_chunk", "4",
     "--intermediate_size", "64", "--branched", "--uq_as_class", "--optim", "adam"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_config_copy_parses_like_the_original(argv):
    from rgqa_tpu import config as jax_config

    got, ns = port_config.parse_cli(argv + ["--device", "cpu"])
    want, _ = jax_config.parse_cli(argv)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert ns.device == "cpu"


def test_config_copy_dumps_like_the_original(tmp_path):
    from rgqa_tpu import config as jax_config

    cfg, _ = port_config.parse_cli(ARGVS[1])
    port_path = port_config.dump_run_config(cfg, str(tmp_path / "port"))
    jax_path = jax_config.dump_run_config(jax_config.parse_cli(ARGVS[1])[0], str(tmp_path / "jax"))
    assert json.loads(open(port_path).read()) == json.loads(open(jax_path).read())


def _predictions(seed: int, n: int = 300):
    rng = np.random.default_rng(seed)
    answers = ["red", "blue", "cat", "dog", "yes", "no"]
    qid2label, quesid2ans = {}, {}
    for i in range(n):
        qid = f"q{i:04d}"
        qid2label[qid] = {"UQ": 1.0} if rng.random() < 0.4 else {answers[rng.integers(6)]: 1.0}
        quesid2ans[qid] = (answers[rng.integers(6)], float(rng.random()))
    return qid2label, quesid2ans


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_copy_matches_the_original(seed, tmp_path):
    from rgqa_tpu import metrics as jax_metrics

    qid2label, quesid2ans = _predictions(seed)
    for tau in (0.5, 0.0, 1.0):
        got = port_metrics.RGQAEvaluator(qid2label, tau=tau).evaluate_quesid2ans(quesid2ans)
        want = jax_metrics.RGQAEvaluator(qid2label, tau=tau).evaluate_quesid2ans(quesid2ans)
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_equal(got[key], want[key], err_msg=key)
    port_metrics.dump_predictions(quesid2ans, str(tmp_path / "port.json"))
    jax_metrics.dump_predictions(quesid2ans, str(tmp_path / "jax.json"))
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()

    closed = {q: a for q, (a, _) in quesid2ans.items()}
    port_closed = port_metrics.ClosedSetEvaluator(qid2label)
    jax_closed = jax_metrics.ClosedSetEvaluator(qid2label)
    assert port_closed.evaluate(closed) == jax_closed.evaluate(closed)
    port_closed.dump_result(closed, str(tmp_path / "port_closed.json"))
    jax_closed.dump_result(closed, str(tmp_path / "jax_closed.json"))
    assert (tmp_path / "port_closed.json").read_bytes() == (tmp_path / "jax_closed.json").read_bytes()


@pytest.mark.parametrize(
    "kw", [{}, {"l_layers": 1, "x_layers": 2, "r_layers": 3},
           {"branched": True, "encoder_prefix": "", "answer_head": False}],
    ids=["default", "depths", "options"],
)
def test_key_map_copy_matches_the_original(kw):
    from rgqa_tpu.checkpoint import torch_import as jax_import

    assert port_import.lxmert_key_map(**kw) == jax_import.lxmert_key_map(**kw)


def test_state_dict_loader_copy_matches_the_original(tmp_path):
    from rgqa_tpu.checkpoint import torch_import as jax_import

    g = torch.Generator().manual_seed(0)
    raw = {
        "module.lxrt_encoder.model.bert.embeddings.LayerNorm.gamma": torch.randn(4, generator=g),
        "module.lxrt_encoder.model.bert.embeddings.LayerNorm.beta": torch.randn(4, generator=g),
        "logit_fc.0.weight": torch.randn(3, 4, generator=g),
    }
    path = str(tmp_path / "ref.pth")
    torch.save(raw, path)
    got, want = port_import.load_torch_state_dict(path), jax_import.load_torch_state_dict(path)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
