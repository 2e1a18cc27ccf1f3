"""Port parity: the VQA task (``rgqa_tpu_torch.vqa_task``, ``cli.vqa`` and
``data.synthetic.make_synthetic_vqa``) against the JAX package, on the CPU.

- ``make_synthetic_vqa`` writes the JAX generator's files byte for byte.
- ``VQAEvaluator`` scores and dumps as the JAX class (both copies are
  held to their sources in ``tests/test_torch_port_rules.py``).
- A 2-epoch ``VQARunner`` at dropout 0, f32, from the JAX runner's init
  (through a reference ``.pth``): the per-epoch loss, train and valid
  scores within rtol 1e-4 of JAX's runner, the oracle score equal, the
  ``minival`` dump equal byte for byte (integer question ids, ``indent=4,
  sort_keys=True``).
- ``cli.vqa``'s dispatch: ``--test test`` dumps ``test_predict.json``
  without a score, ``--test minival`` scores and dumps; from the port's
  ``BEST.pth`` both equal the JAX CLI's files from the same ``.pth``.
- ``--loadLXMERTQA <prefix>`` from a pretraining file the port's
  ``PretrainRunner`` wrote: the port's and the JAX runner's weights are
  equal (the answer rows transplanted through ``all_ans.json``), and so
  are their printed counts; without the table the encoder alone loads.
- The refusals: ``--train_chunk`` / ``--eval_chunk`` > 1, ``--feed_int8``,
  a non-LXMERT backbone, an orbax ``--load``.

Sizes: hidden 32, 4 heads, 1 / 1 / 1 layers, the CLI's 36 x 2048 RoIs,
batch 16.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import pytest
import torch

from rgqa_tpu_torch import config as port_config
from rgqa_tpu_torch.checkpoint.convert import from_jax_params, to_reference_state_dict
from rgqa_tpu_torch.cli import vqa as vqa_cli
from rgqa_tpu_torch.data.synthetic import SyntheticSpec, make_synthetic_vqa
from rgqa_tpu_torch.vqa_task import VQAEvaluator, VQARunner
from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

SPEC = dict(n_images=24, n_train=48, n_valid=32, n_testdev=16, seed=3)
TINY = ["--fp32", "--llayers", "1", "--xlayers", "1", "--rlayers", "1", "--hidden_size", "32",
        "--num_heads", "4", "--batchSize", "16", "--dropout", "0", "--seed", "5"]
RTOL = 1e-4


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


@pytest.fixture(scope="module")
def vqa_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("vqa") / "vqa")
    make_synthetic_vqa(root, SyntheticSpec(**SPEC))
    return root


def _cfg(config, root, extra):
    return config.parse_cli(["--data_root", root, *TINY, *extra])[0]


def _files(root) -> dict:
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_synthetic_vqa_matches_the_jax_generator(jax, vqa_root, tmp_path):
    from rgqa_tpu.data import synthetic as jax_synthetic

    jax_root = str(tmp_path / "jax")
    want = jax_synthetic.make_synthetic_vqa(jax_root, jax_synthetic.SyntheticSpec(**SPEC))
    got = _files(vqa_root)
    assert got == _files(jax_root) and want["splits"] == ["minival", "nominival", "test", "train"]
    with open(os.path.join(vqa_root, "train.json")) as f:
        rows = json.load(f)
    assert all(isinstance(r["question_id"], int) for r in rows)
    assert {s for r in rows for s in r["label"].values()} <= {0.3, 0.6, 0.9, 1.0}
    assert all("label" not in r for r in json.loads(got["test.json"]))


def test_evaluator_scores_and_dumps_as_the_jax_class(jax, vqa_root, tmp_path):
    from rgqa_tpu import vqa_task as jax_vqa
    from rgqa_tpu.data.dataset import GQADataset as JaxDataset

    from rgqa_tpu_torch.data.dataset import GQADataset

    ds = GQADataset(vqa_root, "minival", add_uq=False)
    answers = ds.label2ans
    quesid2ans = {d["question_id"]: answers[i % len(answers)] if i % 3 else max(d["label"], key=d["label"].get)
                  for i, d in enumerate(ds.data)}
    got = VQAEvaluator(ds).evaluate(quesid2ans)
    jev = jax_vqa.VQAEvaluator(JaxDataset(vqa_root, "minival", add_uq=False))
    assert got == jev.evaluate(quesid2ans) and got > 0
    VQAEvaluator(ds).dump_result(quesid2ans, str(tmp_path / "port.json"))
    jev.dump_result(quesid2ans, str(tmp_path / "jax.json"))
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


@pytest.fixture(scope="module")
def trained(jax, vqa_root, tmp_path_factory):
    """(tmp dir, JAX runner, its history, port runner, its history)."""
    from rgqa_tpu import config as jax_config
    from rgqa_tpu import vqa_task as jax_vqa
    from rgqa_tpu.runner import np_params

    tmp = tmp_path_factory.mktemp("vqa_train")
    extra = ["--train", "train,nominival", "--valid", "minival", "--epochs", "2", "--lr", "3e-3"]
    jax_runner = jax_vqa.VQARunner(_cfg(jax_config, vqa_root, extra + ["--output", str(tmp / "jax")]))
    pth = str(tmp / "init.pth")
    torch.save(to_reference_state_dict(from_jax_params(np_params(jax_runner.params)), l_layers=1, x_layers=1,
                                       r_layers=1), pth)
    runner = VQARunner(_cfg(port_config, vqa_root, extra + ["--output", str(tmp / "port"), "--load", pth]),
                       device="cpu")
    # The JAX runner's orbax snapshots are not compared (the port writes
    # .pth files): skip their writes.
    saves = jax_vqa.save_checkpoint
    jax_vqa.save_checkpoint = lambda *a, **k: None
    try:
        want = jax_runner.train()
    finally:
        jax_vqa.save_checkpoint = saves
    got = runner.train()
    return tmp, jax_runner, want, runner, got


def test_runner_history_matches_the_jax_runner(trained):
    tmp, _, want, _, got = trained
    assert len(got["loss"]) == len(got["train"]) == len(got["valid"]) == 2
    np.testing.assert_allclose(got["loss"], [float(x) for x in want["loss"]], rtol=RTOL)
    np.testing.assert_allclose(got["train"], want["train"], rtol=RTOL)
    np.testing.assert_allclose(got["valid"], want["valid"], rtol=RTOL)
    assert got["loss"][0] != got["loss"][1] and max(got["valid"]) > 0  # it trained; BEST.pth was written
    for name in ("BEST.pth", "LAST.pth", "log.log", "run_config.json"):
        assert (tmp / "port" / name).is_file(), name
    lines = [l for l in (tmp / "port" / "log.log").read_text().splitlines() if l]
    assert lines[:3] == [f"Epoch 0: Train {got['train'][0] * 100:0.2f}", f"Epoch 0: Valid {got['valid'][0] * 100:0.2f}",
                         f"Epoch 0: Best {got['valid'][0] * 100:0.2f}"]


def test_oracle_and_minival_dump_match_the_jax_runner(trained):
    tmp, jax_runner, _, runner, _ = trained
    assert runner.oracle_score("minival") == jax_runner.oracle_score("minival") > 0
    jdump, pdump = tmp / "jax_minival.json", tmp / "port_minival.json"
    want = jax_runner.evaluate("minival", dump=str(jdump))
    got = runner.evaluate("minival", dump=str(pdump))
    assert got == want
    assert pdump.read_bytes() == jdump.read_bytes()
    rows = json.loads(pdump.read_text())
    assert len(rows) == SPEC["n_valid"] and all(isinstance(r["question_id"], int) for r in rows)


@pytest.mark.parametrize("split", ["test", "minival"])
def test_cli_dispatch_matches_the_jax_cli(jax, trained, vqa_root, split, capsys):
    from rgqa_tpu.cli import vqa as jax_vqa_cli

    tmp = trained[0]
    best = str(tmp / "port" / "BEST.pth")
    name = "test_predict.json" if split == "test" else "minival_predict.json"
    vqa_cli.main(["--data_root", vqa_root, *TINY, "--test", split, "--load", best, "--output",
                  str(tmp / f"cli_{split}"), "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jax_vqa_cli.main(["--data_root", vqa_root, *TINY, "--test", split, "--load", best, "--output",
                      str(tmp / f"jax_cli_{split}")])
    jline = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == jline
    if split == "test":
        assert line == {"split": "test", "dumped": True}
    else:
        assert set(line) == {"split", "accuracy"} and line["accuracy"] == trained[3].evaluate("minival")
    got = (tmp / f"cli_{split}" / name).read_bytes()
    assert got == (tmp / f"jax_cli_{split}" / name).read_bytes()
    assert all(isinstance(r["question_id"], int) for r in json.loads(got))


@pytest.mark.parametrize("with_table", [True, False], ids=["all_ans", "no_all_ans"])
def test_load_lxmert_qa_from_a_port_pretraining_file(jax, vqa_root, tmp_path, capsys, with_table):
    from rgqa_tpu import config as jax_config
    from rgqa_tpu import vqa_task as jax_vqa
    from rgqa_tpu.runner import np_params

    from rgqa_tpu_torch.pretrain.trainer import PretrainRunner

    root = str(tmp_path / "vqa")
    shutil.copytree(vqa_root, root)
    with open(os.path.join(root, "trainval_label2ans.json")) as f:
        answers = json.load(f)
    table = ["man", "woman"] + answers[::2]
    with open(os.path.join(root, "all_ans.json"), "w") as f:
        json.dump([{"ans": a, "dsets": ["vqa"]} for a in table], f)
    pre = PretrainRunner(_cfg(port_config, root, ["--train", "train", "--valid", "minival", "--output",
                                                  str(tmp_path / "pre")]), device="cpu")
    assert pre.answer_table.all_answers() == table
    prefix = os.path.splitext(pre.save("BEST_EVAL_LOSS"))[0].removesuffix("_LXRT")
    if not with_table:
        os.remove(os.path.join(root, "all_ans.json"))
    extra = ["--train", "train", "--valid", "minival", "--loadLXMERTQA", prefix]
    capsys.readouterr()
    jax_runner = jax_vqa.VQARunner(_cfg(jax_config, root, extra + ["--output", str(tmp_path / "jax")]))
    jax_out = capsys.readouterr().out
    runner = VQARunner(_cfg(port_config, root, extra + ["--output", str(tmp_path / "port")]), device="cpu")
    out = capsys.readouterr().out
    want = from_jax_params(np_params(jax_runner.params))
    got = runner.model.state_dict()
    ref = torch.load(prefix + "_LXRT.pth", weights_only=True)
    torch.testing.assert_close(got["lxmert.embeddings.word_embeddings.weight"],
                               ref["bert.embeddings.word_embeddings.weight"], rtol=0, atol=0)
    if with_table:
        loaded = sum(a in table for a in answers)
        line = f"Loaded {loaded} answers from LXRTQA pre-training and {len(answers) - loaded} not"
        assert line in out and line in jax_out
        for key, value in got.items():  # every weight is the file's: the encoder and the whole head
            torch.testing.assert_close(value, want[key], rtol=0, atol=0, msg=key)
        row = answers.index(answers[2])
        torch.testing.assert_close(got["answer_head.logits.weight"][row],
                                   ref["answer_head.logit_fc.3.weight"][table.index(answers[2])])
    else:
        for key, value in got.items():  # the encoder alone; both heads stay at their (unlike) inits
            if not key.startswith("answer_head."):
                torch.testing.assert_close(value, want[key], rtol=0, atol=0, msg=key)


@pytest.mark.parametrize("flags,named", [
    (["--train_chunk", "2"], "--train_chunk"),
    (["--eval_chunk", "2"], "--eval_chunk"),
    (["--feed_int8"], "--feed_int8"),
    (["--backbone", "uniter"], "--backbone uniter"),
], ids=["train_chunk", "eval_chunk", "feed_int8", "backbone"])
def test_unported_flags_are_refused_by_name(vqa_root, tmp_path, flags, named):
    with pytest.raises(NotImplementedError, match=named):
        VQARunner(_cfg(port_config, vqa_root, flags + ["--output", str(tmp_path / "o")]), device="cpu")


def test_orbax_load_is_refused(vqa_root, tmp_path):
    snap = tmp_path / "BEST"
    snap.mkdir()
    with pytest.raises(NotImplementedError, match="orbax"):
        VQARunner(_cfg(port_config, vqa_root, ["--test", "minival", "--load", str(snap), "--output",
                                               str(tmp_path / "o")]), init_train=False, device="cpu")
