"""The port's rules, checked on the CPU.

- No module of ``rgqa_tpu_torch`` and not ``chip_smoke.py`` imports the
  JAX package, the JAX experiments (``experiments/``), jax, jaxlib, flax,
  orbax, nltk or the offline export ``orbax_to_pth.py``, which reads orbax
  (an AST scan; the blocked-import subprocesses of
  ``tests/test_torch_slice.py`` and of this file import every module of
  the port and run the LXMERT and ViLT train and evaluate CLIs, the
  UNITER evaluate CLI, ``--scorer frcnn``, a ``--mixup_mode mixup_v1``
  training, the serve
  and prepare-data CLIs, the three experiment entry points and, since
  slice 21, the pretraining and VQA CLIs with all of them blocked: the
  machine with the card has none of them).
- Every CUDA source under ``csrc/`` is in the build's ``SOURCES``, and
  ``chip_smoke.py``'s ``KERNELS`` names every kernel wrapper of
  ``ops.attention`` and of ``rgqa_tpu_torch.experiments``, with its
  source and the TPU kernel it replaces.
- The entry points run on the card unless asked for the CPU: without a
  card the runner, ``build_model`` (LXMERT, UNITER and ViLT), the
  train, evaluate and serve CLIs, and since slice 21 the pretraining,
  VQA and NLVR2 runners and the pretraining and VQA CLIs, and the
  data-parallel check ``tools/ddp_check.py``, and since slice 24 the
  dry-run entry (``entry.py``: ``entry``, ``dryrun_multichip``,
  ``dryrun_multichip_fullshape``), raise when not given the CPU
  (prepare-data runs no device code).
- The port's copies of framework-free JAX-package modules are held to
  their originals on the same inputs: the config parser (equal
  ``dataclasses.asdict``), the metrics (equal dicts, byte-equal dumps),
  the checkpoint key maps (equal lists, equal loads; UNITER's in
  ``tests/test_torch_uniter.py``; BUTD's and the caption matcher's here,
  their loads in ``tests/test_torch_butd.py`` / ``test_torch_caps.py``),
  BUTD's tokenizer, word splitter and GloVe reader (equal arrays), the
  TreeMix parse utilities (``data/parse.py``: equal trees, spans and
  arrays), the pretraining answer table (``pretrain/answer_table.py``,
  ``--loadLXMERTQA``'s: equal tables and normalized answers) and
  ``cli/plot_attention.py`` (the same figures, byte for byte, in
  ``tests/test_torch_uniter_slice.py``); since slice 19 the
  distillation's pure functions (``distill.py``), the verifier's
  statement rules (``verifier.py``) and ``metrics/compute_accfpr.py``,
  source for source; since slice 21 ``make_synthetic_vqa`` and
  ``VQAEvaluator``, source for source (the files the generator writes
  are compared in ``tests/test_torch_vqa.py``).
- The distillation CLI and ``--strategy weight --update_weight_model``
  run with the JAX package blocked.
"""

from __future__ import annotations

import ast
import dataclasses
import io
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
from rgqa_tpu_torch.data.synthetic import make_synthetic_gqa
from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"rgqa_tpu", "experiments", "jax", "jaxlib", "flax", "orbax", "nltk", "orbax_to_pth"}
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
BLOCKED = ("jax", "jaxlib", "flax", "orbax", "rgqa_tpu", "experiments", "nltk")
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
keys = sorted(results.get("testdev", results)) if isinstance(results, dict) else results
loaded = [m for m, v in sys.modules.items() if v is not None and m.split(".")[0] in BLOCKED]
print("RESULT", json.dumps({"modules": names, "keys": keys, "loaded": loaded}))
"""


_VILT_FLAGS = ["--backbone", "vilt", "--fp32", "--num_layers", "1", "--hidden_size", "32",
               "--num_heads", "4", "--vilt_image_size", "64", "--vilt_patch_size", "16",
               "--batchSize", "16", "--device", "cpu"]


def _run_jax_free(module: str, argv: list, cwd, stdin: str | None = None) -> dict:
    """Run ``rgqa_tpu_torch.<module>.main(argv)`` with the JAX package,
    the JAX experiments and jax / flax / orbax blocked (``stdin``: its
    standard input); the result has its other output lines as ``out``."""
    proc = subprocess.run(
        [sys.executable, "-c", _VILT_JAX_FREE, module, *argv], cwd=str(cwd), input=stdin,
        env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(l for l in proc.stdout.splitlines() if l.startswith("RESULT "))
    res = json.loads(line[len("RESULT "):])
    assert res["loaded"] == []
    res["out"] = [l for l in proc.stdout.splitlines() if not l.startswith("RESULT ")]
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


_TINY_LXMERT = ["--fp32", "--llayers", "1", "--xlayers", "1", "--rlayers", "1", "--hidden_size", "32",
                "--num_heads", "4", "--batchSize", "16", "--device", "cpu"]


def test_frcnn_evaluate_runs_with_jax_and_nltk_blocked(tmp_path):
    root, out = str(tmp_path / "gqa"), str(tmp_path / "out")
    res = _run_jax_free("cli.evaluate", ["--synthetic", "--data_root", root, "--test", "testdev",
                                         "--scorer", "frcnn", "--output", out, *_TINY_LXMERT], tmp_path)
    assert {"rgqa_tpu_torch.scorers.coverage", "rgqa_tpu_torch.scorers.porter"} <= set(res["modules"])
    assert {"auaf", "fpr@0.95acc", "full_acc"} <= set(res["keys"])
    with open(os.path.join(out, "testdev_predict.json")) as f:
        assert {r["confidence"] for r in json.load(f)} <= {0.0, 1.0}


def test_mixup_train_runs_with_jax_blocked(tmp_path):
    root, out = str(tmp_path / "gqa"), str(tmp_path / "out")
    res = _run_jax_free("cli.train", ["--synthetic", "--data_root", root, "--mixup_mode", "mixup_v1",
                                      "--mixup_beta", "5", "--epochs", "1", "--output", out, *_TINY_LXMERT],
                        tmp_path)
    assert res["keys"] == ["loss", "valid"] and "rgqa_tpu_torch.data.parse" in res["modules"]
    for name in ("LAST.pth", "LAST.state.pt"):
        assert os.path.isfile(os.path.join(out, name)), name


def test_distill_runs_with_jax_blocked(tmp_path):
    root = str(tmp_path / "gqa")
    res = _run_jax_free("cli.distill", ["--synthetic", "--data_root", root, "--output", str(tmp_path / "out"),
                                        "--n_candidates", "20", "--passes", "2", "--tau_aq_c", "0",
                                        "--tau_aq_v", "1", *_TINY_LXMERT], tmp_path)
    assert "rgqa_tpu_torch.distill" in res["modules"] and res["keys"]
    with open(os.path.join(root, "distill_train.json")) as f:
        assert json.load(f) == res["keys"]


def test_weight_model_train_runs_with_jax_blocked(tmp_path):
    from test_torch_clip import write_clip_dir

    root, out = str(tmp_path / "gqa"), str(tmp_path / "out")
    clip = write_clip_dir(tmp_path / "clip")
    res = _run_jax_free("cli.train", ["--synthetic", "--data_root", root, "--strategy", "weight",
                                      "--update_weight_model", "--clip_path", clip, "--epochs", "1",
                                      "--output", out, *_TINY_LXMERT], tmp_path)
    assert res["keys"] == ["loss", "valid"]
    for name in ("LAST.pth", "LAST_clip.pth", "clip_params/pytorch_model.bin", "clip_params/config.json"):
        assert os.path.isfile(os.path.join(out, name)), name


def test_pretrain_runs_with_jax_blocked(tmp_path):
    root, out = str(tmp_path / "gqa"), str(tmp_path / "out")
    res = _run_jax_free("cli.pretrain", ["--synthetic", "--data_root", root, "--epochs", "1", "--output", out,
                                         *_TINY_LXMERT], tmp_path)
    assert {"rgqa_tpu_torch.pretrain.trainer", "rgqa_tpu_torch.cli.pretrain"} <= set(res["modules"])
    assert res["keys"] == ["eval", "train"] and res["out"][-1].startswith('{"eval_loss": [')
    for name in ("BEST_EVAL_LOSS_LXRT.pth", "Epoch00_LXRT.pth"):
        assert os.path.isfile(os.path.join(out, name)), name


def test_vqa_runs_with_jax_blocked(tmp_path):
    root, out = str(tmp_path / "vqa"), str(tmp_path / "out")
    res = _run_jax_free("cli.vqa", ["--synthetic", "--data_root", root, "--train", "train,nominival", "--valid",
                                    "minival", "--epochs", "1", "--output", out, *_TINY_LXMERT], tmp_path)
    assert {"rgqa_tpu_torch.vqa_task", "rgqa_tpu_torch.cli.vqa"} <= set(res["modules"])
    assert res["keys"] == ["loss", "train", "valid"]
    for name in ("BEST.pth", "LAST.pth"):
        assert os.path.isfile(os.path.join(out, name)), name


def test_uniter_evaluate_runs_with_jax_blocked(tmp_path):
    root, out = str(tmp_path / "gqa"), str(tmp_path / "out")
    res = _run_jax_free("cli.evaluate", ["--synthetic", "--data_root", root, "--test", "testdev",
                                         "--output", out, "--backbone", "uniter", "--scorer", "odin",
                                         "--fp32", "--num_layers", "1", "--hidden_size", "32",
                                         "--num_heads", "4", "--batchSize", "16", "--device", "cpu"],
                        tmp_path)
    assert {"rgqa_tpu_torch.models.uniter", "rgqa_tpu_torch.cli.plot_attention"} <= set(res["modules"])
    assert {"auaf", "fpr@0.95acc", "full_acc"} <= set(res["keys"])
    assert os.path.isfile(os.path.join(out, "testdev_predict.json"))


def test_serve_runs_with_jax_blocked(tmp_path):
    from test_torch_slice import TINY_FLAGS

    root = str(tmp_path / "gqa")
    make_synthetic_gqa(root)
    with open(os.path.join(root, "testdev.json")) as f:
        rows = json.load(f)[:3]
    lines = [json.dumps({k: r[k] for k in ("question_id", "sent", "img_id")}) for r in rows]
    res = _run_jax_free("cli.serve", ["--synthetic", "--data_root", root, "--test", "testdev",
                                      "--output", str(tmp_path / "out"), *TINY_FLAGS],
                        tmp_path, stdin="\n".join(lines + ["{not json"]) + "\n")
    assert "rgqa_tpu_torch.cli.serve" in res["modules"] and res["keys"] == 3
    out = [json.loads(line) for line in res["out"] if line.startswith("{")]
    assert [r.get("questionId") for r in out] == [None] + [r["question_id"] for r in rows]


def test_prepare_data_runs_with_jax_blocked(tmp_path):
    from rgqa_tpu_torch.data.synthetic import random_obj_rows
    from rgqa_tpu_torch.data.tsv import write_obj_tsv

    tsv = str(tmp_path / "obj.tsv")
    write_obj_tsv(tsv, random_obj_rows([36, 10, 50], feat_dim=8))
    (tmp_path / "json").mkdir()
    (tmp_path / "json" / "testdev.json").write_text("[]")
    (tmp_path / "vocab.txt").write_text("[PAD]\n[UNK]\n")
    out = tmp_path / "root"
    res = _run_jax_free("cli.prepare_data", ["--tsv", tsv, "--json_dir", str(tmp_path / "json"),
                                             "--vocab", str(tmp_path / "vocab.txt"), "--out", str(out)],
                        tmp_path)
    assert "rgqa_tpu_torch.cli.prepare_data" in res["modules"]
    assert res["keys"] == ["images", "pixels"]
    assert len(json.loads((out / "features" / "img_ids.json").read_text())) == 3
    assert (out / "testdev.json").is_file() and (out / "vocab.txt").is_file()


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
    from rgqa_tpu_torch import entry
    from rgqa_tpu_torch.cli import distill, evaluate, pretrain, serve, train, vqa
    from rgqa_tpu_torch.models.zoo import build_model, default_config
    from rgqa_tpu_torch.nlvr2_task import Nlvr2Runner
    from rgqa_tpu_torch.pretrain.trainer import PretrainRunner
    from rgqa_tpu_torch.runner import GQARunner
    from rgqa_tpu_torch.tools import ddp_check
    from rgqa_tpu_torch.vqa_task import VQARunner

    cfg, ns = port_config.parse_cli(["--data_root", str(tmp_path / "gqa"), "--synthetic",
                                     "--output", str(tmp_path / "out")])
    assert ns.device == "cuda"
    for make in (
        lambda: GQARunner(cfg),
        lambda: GQARunner(cfg, init_train=False),
        lambda: build_model(cfg.model),
        lambda: build_model(default_config("uniter")),
        lambda: build_model(default_config("vilt")),
        lambda: build_model(default_config("butd")),
        lambda: build_model(default_config("caps")),
        lambda: train.main(["--synthetic", "--data_root", str(tmp_path / "gqa"),
                            "--output", str(tmp_path / "t")]),
        lambda: evaluate.main(["--synthetic", "--data_root", str(tmp_path / "gqa"),
                               "--test", "testdev", "--output", str(tmp_path / "e")]),
        lambda: serve.main(["--synthetic", "--data_root", str(tmp_path / "gqa"),
                            "--test", "testdev", "--output", str(tmp_path / "s")],
                           stdin=io.StringIO(""), stdout=io.StringIO()),
        lambda: distill.main(["--synthetic", "--data_root", str(tmp_path / "gqa"),
                              "--output", str(tmp_path / "d")]),
        lambda: PretrainRunner(cfg),
        lambda: VQARunner(cfg),
        lambda: VQARunner(cfg, init_train=False),
        lambda: Nlvr2Runner(cfg, {"train": []}),
        lambda: pretrain.main(["--synthetic", "--data_root", str(tmp_path / "gqa"),
                               "--output", str(tmp_path / "p")]),
        lambda: vqa.main(["--synthetic", "--data_root", str(tmp_path / "gqa"),
                          "--output", str(tmp_path / "v")]),
        lambda: ddp_check.main(["--root", str(tmp_path / "gqa"), "--out", str(tmp_path / "dp")]),
        lambda: entry.entry(),
        lambda: entry.entry(entry.tiny_config()),
        lambda: entry.dryrun_multichip(2),
        lambda: entry.dryrun_multichip_fullshape(2),
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


@pytest.mark.parametrize("kw", [{}, {"branched": True}], ids=["default", "branched"])
def test_butd_key_map_copy_matches_the_original(kw):
    from rgqa_tpu.checkpoint import torch_import as jax_import

    assert port_import.butd_key_map(**kw) == jax_import.butd_key_map(**kw)


@pytest.mark.parametrize(
    "kw", [{}, {"num_layers": 2, "match_head": True}, {"num_layers": 3, "pooler": False}],
    ids=["default", "head", "no_pooler"],
)
def test_bert_caps_key_map_copy_matches_the_original(kw):
    from rgqa_tpu.checkpoint import torch_import as jax_import

    assert port_import.bert_caps_key_map(**kw) == jax_import.bert_caps_key_map(**kw)


BUTD_SENTENCES = [
    "What color is the zebra's hat?", "is there a car , or a bus ?", "", "  ", "Which ONE's bigger?",
    " ".join(["word"] * 45) + "?", "unknownword is here",
]


@pytest.mark.parametrize("max_len", [40, 6])
def test_butd_tokenizer_copies_match_the_originals(max_len):
    from rgqa_tpu.models import butd as jax_butd

    from rgqa_tpu_torch.models import butd as port_butd

    word2idx = {}
    for sent in BUTD_SENTENCES[:-1]:
        assert port_butd.butd_split(sent) == jax_butd.butd_split(sent)
        for tok in port_butd.butd_split(sent):
            word2idx.setdefault(tok, len(word2idx))
    got = port_butd.tokenize_front_padded(BUTD_SENTENCES, word2idx, max_len)
    want = jax_butd.tokenize_front_padded(BUTD_SENTENCES, word2idx, max_len)
    assert got.dtype == np.int32 and got.shape == (len(BUTD_SENTENCES), max_len)
    np.testing.assert_array_equal(got, want)


def test_glove_matrix_copy_matches_the_original(tmp_path):
    from rgqa_tpu.models import butd as jax_butd

    from rgqa_tpu_torch.models import butd as port_butd

    rng = np.random.default_rng(0)
    path = tmp_path / "glove.txt"
    lines = [f"{w} " + " ".join(f"{x:.6f}" for x in rng.standard_normal(8)) for w in ("the", "zebra", "a")]
    path.write_text("\n".join(lines + ["bad 1.0 2.0", "zebra"]) + "\n", encoding="utf-8")
    word2idx = {"zebra": 0, "the": 1, "missing": 2}
    got = port_butd.build_glove_matrix(word2idx, str(path), dim=8)
    np.testing.assert_array_equal(got, jax_butd.build_glove_matrix(word2idx, str(path), dim=8))
    assert got.shape == (4, 8) and got[0].any() and not got[2:].any()


PARSES = ["(ROOT (S (NP (DT the) (NN cat)) (VP (VBZ is) (ADJP (JJ red))) (. ?)))", "(S (W a))", "(S (W a)",
          "(S (W a)) extra", "", None, "(ROOT (S (NP (W Which) (W ONE's)) (W bigger?)))"]


def test_parse_copy_matches_the_original(tmp_path):
    from rgqa_tpu.data import parse as jax_parse

    from rgqa_tpu_torch.data import parse as port_parse
    from rgqa_tpu_torch.data.tokenizer import WordPieceTokenizer, load_vocab

    root = str(tmp_path / "gqa")
    make_synthetic_gqa(root)
    with open(os.path.join(root, "train.json")) as f:
        rows = json.load(f)
    parses = [r["parse"] for r in rows] + PARSES
    sents = [r["sent"] for r in rows] + ["the cat is red ?", "a", "a", "a", "", "x", "which one's bigger?"]
    for parse in parses[:-6] + PARSES[:2] + PARSES[-1:]:
        tree = port_parse.parse_tree(parse)
        assert tree == jax_parse.parse_tree(parse)
        assert port_parse.tree_leaves(tree) == jax_parse.tree_leaves(tree)
        assert port_parse.subtree_spans(tree) == jax_parse.subtree_spans(tree)
    for bad in PARSES[2:4]:
        for module in (port_parse, jax_parse):
            with pytest.raises((ValueError, IndexError)):
                module.parse_tree(bad)
    tok = WordPieceTokenizer(load_vocab(os.path.join(root, "vocab.txt")))
    for max_len, max_spans in ((20, port_parse.MAX_PARSE_SPANS), (8, 3)):
        got = port_parse.encode_parse_spans(parses, sents, tok, max_len, max_spans=max_spans)
        want = jax_parse.encode_parse_spans(parses, sents, tok, max_len, max_spans=max_spans)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)
        assert (got[2] > 0).sum() >= (len(rows) // 2 if max_len == 20 else 1)  # usable parses
    assert port_parse.MAX_PARSE_SPANS == jax_parse.MAX_PARSE_SPANS


ANSWERS = ["yes", "man", "2", "gray", "Apple.", "the kite", "a woman", "One", "grey", "ten", "an", ""]


@pytest.mark.parametrize("dsets", [None, ["gqa"], ["vqa", "vg"]])
def test_answer_table_copy_matches_the_original(tmp_path, dsets):
    from rgqa_tpu.pretrain import answer_table as jax_table

    from rgqa_tpu_torch.pretrain import answer_table as port_table

    rows = [{"ans": a, "dsets": [("gqa", "vqa", "vg")[i % 3]]} for i, a in enumerate(ANSWERS) if a]
    path = tmp_path / "all_ans.json"
    path.write_text(json.dumps(rows))
    got, want = port_table.AnswerTable(dsets, path=str(path)), jax_table.AnswerTable(dsets, path=str(path))
    assert got.all_answers() == want.all_answers() and got.ans2id_map() == want.ans2id_map()
    assert got.num_answers == want.num_answers and got.ans_set == want.ans_set
    for ans in ANSWERS:
        assert port_table.AnswerTable.convert_ans(ans) == jax_table.AnswerTable.convert_ans(ans), ans
        assert got.used(ans) == want.used(ans)
    assert port_table.ANS_CONVERT == jax_table.ANS_CONVERT
    with pytest.raises(FileNotFoundError):
        port_table.AnswerTable(path=str(tmp_path / "missing.json"))


@pytest.mark.parametrize("module,name", [("data.synthetic", "make_synthetic_vqa"), ("vqa_task", "VQAEvaluator")],
                         ids=lambda x: x)
def test_slice_21_copies_match_their_originals(module, name):
    import importlib
    import inspect

    mine, theirs = (importlib.import_module(f"{pkg}.{module}") for pkg in ("rgqa_tpu_torch", "rgqa_tpu"))
    assert inspect.getsource(getattr(mine, name)) == inspect.getsource(getattr(theirs, name))


# The slice-19 copies: each function's source equals its original's.
COPIED = [("distill", n) for n in ("sample_repaired", "stats_from_charts", "cartography_stats", "select_distill")]
COPIED += [("verifier", n) for n in ("statement_with_rule", "question_to_statement", "fill_statement")]
COPIED += [("metrics.compute_accfpr", "main")]


@pytest.mark.parametrize("module,name", COPIED, ids=lambda x: x)
def test_slice_19_copies_match_their_originals(module, name):
    import importlib
    import inspect

    mine, theirs = (importlib.import_module(f"{pkg}.{module}") for pkg in ("rgqa_tpu_torch", "rgqa_tpu"))
    assert inspect.getsource(getattr(mine, name)) == inspect.getsource(getattr(theirs, name))
    if module == "verifier":
        assert (mine._AUX, mine._PRONOUNS) == (theirs._AUX, theirs._PRONOUNS)
