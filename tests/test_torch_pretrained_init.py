"""Port parity: the pretrained initialisations ``--loadLXMERT`` (LXMERT)
and ``--loadLXMERTQA`` against the JAX package, on the CPU.

Random reference ``model_LXRT.pth`` files are written from the port's
seeded init (``tests/test_torch_match.py``'s writer): at the tiny width
of ``tests/test_torch_slice.py`` for the module and runner checks, at the
train CLI's tiny width for the CLI runs.

- ``--loadLXMERT``: ``load_lxmert_pretrained`` against JAX
  ``import_lxmert_gqa(from_pretrain=True)``: the same missing and unused
  keys, and the pooled output of the loaded encoder within rtol 2e-4 /
  atol 2e-5 (``tests/test_torch_import.py``'s bar); the runners print
  the same line and hold the file's encoder.
- ``--loadLXMERTQA``: ``load_lxmert_qa`` against the JAX function on
  answers that only ``AnswerTable.convert_ans`` matches (articles, number
  words, spellings, a trailing period): equal loaded / zeroed counts,
  head rows and biases, encoder and head transform; the runners with an
  ``all_ans.json`` under the data root and the ``_LXRT.pth`` suffix rule
  (equal printed counts, equal weights), and without any ``all_ans.json``
  (the JAX runner's warning, the encoder alone).
- ``AnswerTable``'s copy against its original.
- The train CLI with each flag, one epoch at tiny width.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from rgqa_tpu_torch import config as port_config
from rgqa_tpu_torch.checkpoint.convert import from_jax_params, load_lxmert_pretrained, load_lxmert_qa
from rgqa_tpu_torch.data.synthetic import SyntheticSpec, make_synthetic_gqa
from rgqa_tpu_torch.models.lxmert import LxmertForGQA
from rgqa_tpu_torch.models.zoo import example_batch, init_weights
from rgqa_tpu_torch.pretrain import AnswerTable
from rgqa_tpu_torch.runner import GQARunner
from test_torch_match import write_pretraining_pth
from test_torch_slice import ENC, SPEC, _cfg
from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

LAYERS = dict(l_layers=1, x_layers=1, r_layers=1)
# GQA answers whose pretraining form only convert_ans finds, and two it does not.
LABEL2ANS = ["The Man", "two.", "grey", "apple", "zebra", "unknownthing", "a woman", "Nine", "UQ"]
PRETRAIN_ANSWERS = ["yes", "man", "2", "gray", "apple", "woman", "9", "no"]


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


@pytest.fixture(scope="module")
def pretrain_pth(tmp_path_factory):
    return write_pretraining_pth(tmp_path_factory.mktemp("pretrained_init") / "model_LXRT.pth",
                                 port_config.EncoderConfig(**ENC), seed=3)


def _jax_gqa_params(jax, answers):
    from rgqa_tpu.config import EncoderConfig as JaxEncoderConfig
    from rgqa_tpu.models.lxmert import LxmertForGQA as JaxGQA

    jmodel = JaxGQA(JaxEncoderConfig(**ENC), num_answers=answers)
    batch = example_batch(port_config.ModelConfig(encoder=port_config.EncoderConfig(**ENC), max_text_len=12), 3)
    args = [batch[k] for k in ("input_ids", "input_mask", "segment_ids", "feats", "boxes")]
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0), *args)["params"])
    return jmodel, params, batch


def test_load_lxmert_pretrained_matches_jax(jax, pretrain_pth):
    from rgqa_tpu.checkpoint import import_lxmert_gqa

    jmodel, params, batch = _jax_gqa_params(jax, 5)
    jparams, jmissing, junused = import_lxmert_gqa(params, pretrain_pth, from_pretrain=True, **LAYERS)
    sd, missing, unused = load_lxmert_pretrained(pretrain_pth, **LAYERS)
    assert missing == jmissing == []
    assert sorted(unused) == sorted(junused) and "answer_head.logit_fc.3.weight" in unused
    model = LxmertForGQA(port_config.EncoderConfig(**ENC), 5)
    init_weights(model, torch.Generator().manual_seed(0))
    model.load_state_dict(from_jax_params(params))  # the JAX init's head; the file's encoder below
    assert set(model.load_state_dict(sd, strict=False).missing_keys) == {
        k for k in model.state_dict() if k.startswith("answer_head.")}
    model.eval()
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        got = model(t["input_ids"], t["input_mask"], t["segment_ids"], t["feats"], t["boxes"])
    want = jmodel.apply({"params": jparams}, *[batch[k] for k in ("input_ids", "input_mask", "segment_ids",
                                                                    "feats", "boxes")])
    np.testing.assert_allclose(got["pooled"].numpy(), np.asarray(want["pooled"]), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), rtol=2e-4, atol=2e-5)


def test_load_lxmert_qa_matches_jax(jax, pretrain_pth):
    from rgqa_tpu.checkpoint import load_lxmert_qa as jax_load_lxmert_qa
    from rgqa_tpu.pretrain.answer_table import AnswerTable as JaxAnswerTable

    answers = len(LABEL2ANS) - 1  # the head has no UQ logit: its label is skipped
    _, params, _ = _jax_gqa_params(jax, answers)
    jtable, table = JaxAnswerTable(answers=PRETRAIN_ANSWERS), AnswerTable(answers=PRETRAIN_ANSWERS)
    jparams, jloaded, jzeroed = jax_load_lxmert_qa(
        params, pretrain_pth, LABEL2ANS, src_ans2id=jtable.ans2id_map(), convert_ans=jtable.convert_ans, **LAYERS)
    init = from_jax_params(params)
    sd, loaded, zeroed = load_lxmert_qa(
        pretrain_pth, LABEL2ANS, init["answer_head.logits.weight"], init["answer_head.logits.bias"],
        src_ans2id=table.ans2id_map(), convert_ans=table.convert_ans, **LAYERS)
    assert (loaded, zeroed) == (jloaded, jzeroed) == (6, 2)
    want = from_jax_params(jparams)
    assert set(sd) == set(want)  # the encoder and the whole answer head
    for key, value in sd.items():
        torch.testing.assert_close(value, want[key], rtol=0, atol=0, msg=key)
    ref = torch.load(pretrain_pth, weights_only=True)
    head = sd["answer_head.logits.weight"]
    torch.testing.assert_close(head[1], ref["answer_head.logit_fc.3.weight"][2])  # "two." is "2", row 2
    assert not head[4].any() and not head[5].any() and sd["answer_head.logits.bias"][4] == 0


def test_answer_table_matches_the_original(jax, tmp_path):
    from rgqa_tpu.pretrain.answer_table import AnswerTable as JaxAnswerTable

    rows = [{"ans": a, "dsets": ["vqa"] if i % 2 else ["gqa", "vqa"]} for i, a in enumerate(PRETRAIN_ANSWERS)]
    path = tmp_path / "all_ans.json"
    path.write_text(json.dumps(rows))
    for dsets in (None, ["gqa"]):
        got, want = AnswerTable(dsets, path=str(path)), JaxAnswerTable(dsets, path=str(path))
        assert got.all_answers() == want.all_answers() and got.ans2id_map() == want.ans2id_map()
    for ans in LABEL2ANS + ["", "The.", "an apple", "ten", "a", "Grey."]:
        assert AnswerTable.convert_ans(ans) == JaxAnswerTable.convert_ans(ans), ans


# ---------------------------------------------------------------------------
# The runners.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def qa_root(tmp_path_factory, pretrain_pth):
    """A synthetic root with an ``all_ans.json`` holding half its answers
    (and others), and ``model_LXRT.pth`` copied as ``<prefix>_LXRT.pth``."""
    tmp = tmp_path_factory.mktemp("pretrained_init_runner")
    root = str(tmp / "gqa")
    make_synthetic_gqa(root, SyntheticSpec(**SPEC))
    with open(os.path.join(root, "trainval_label2ans.json")) as f:
        gqa_answers = json.load(f)
    rows = [{"ans": a, "dsets": ["gqa"]} for a in ["man", "woman"] + gqa_answers[::2]]
    with open(os.path.join(root, "all_ans.json"), "w") as f:
        json.dump(rows, f)
    prefix = str(tmp / "qa_pretrained")
    torch.save(torch.load(pretrain_pth, weights_only=True), prefix + "_LXRT.pth")
    bare = str(tmp / "bare_gqa")
    make_synthetic_gqa(bare, SyntheticSpec(**SPEC))
    return root, bare, prefix


@pytest.mark.parametrize("with_table", [True, False], ids=["all_ans", "no_all_ans"])
def test_runner_load_lxmert_qa_matches_the_jax_runner(jax, qa_root, tmp_path, capsys, with_table):
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.runner import GQARunner as JaxRunner
    from rgqa_tpu.runner import np_params

    root, bare, prefix = qa_root
    root = root if with_table else bare
    jax_runner = JaxRunner(_cfg(root, str(tmp_path / "jax"), jax_config, load_lxmert_qa=prefix))
    jax_out = capsys.readouterr().out
    runner = GQARunner(_cfg(root, str(tmp_path / "port"), load_lxmert_qa=prefix), device="cpu")
    out = capsys.readouterr().out
    line = "WARNING: all_ans.json not found"
    if with_table:
        table = AnswerTable(path=os.path.join(root, "all_ans.json")).ans2id_map()
        real = runner.label2ans[: runner.model_cfg.num_answers]  # UQ has no logit
        loaded = sum(AnswerTable.convert_ans(a) in table for a in real)
        assert 0 < loaded < len(real)
        line = f"Loaded {loaded} answers from LXRTQA pre-training and {len(real) - loaded} not"
    assert line in out and line in jax_out
    want = from_jax_params(np_params(jax_runner.params))
    got = runner.model.state_dict()
    ref = torch.load(prefix + "_LXRT.pth", weights_only=True)
    for key, value in got.items():
        if key.startswith("answer_head.") and not with_table:
            continue  # the JAX branch loads the encoder alone; both heads stay at their (unlike) inits
        torch.testing.assert_close(value, want[key], rtol=0, atol=0, msg=key)
    torch.testing.assert_close(got["lxmert.embeddings.word_embeddings.weight"],
                               ref["bert.embeddings.word_embeddings.weight"])
    if with_table:
        torch.testing.assert_close(got["answer_head.dense.weight"], ref["answer_head.logit_fc.0.weight"])
        ans2id = {r["ans"]: i for i, r in enumerate(json.load(open(os.path.join(root, "all_ans.json"))))}
        label = runner.label2ans.index("apple")
        assert ("apple" in ans2id) == bool(got["answer_head.logits.weight"][label].any())


def test_runner_load_lxmert_matches_the_jax_runner(jax, qa_root, pretrain_pth, tmp_path, capsys):
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.runner import GQARunner as JaxRunner
    from rgqa_tpu.runner import np_params

    root, _, _ = qa_root
    jax_runner = JaxRunner(_cfg(root, str(tmp_path / "jax"), jax_config, load_lxmert=pretrain_pth))
    jax_out = capsys.readouterr().out
    runner = GQARunner(_cfg(root, str(tmp_path / "port"), load_lxmert=pretrain_pth), device="cpu")
    assert "Loaded LXMERT encoder (0 keys left at init)" in capsys.readouterr().out
    assert "Loaded LXMERT encoder (0 keys left at init)" in jax_out
    want = from_jax_params(np_params(jax_runner.params))
    for key, value in runner.model.state_dict().items():
        if key.startswith("lxmert."):
            torch.testing.assert_close(value, want[key], rtol=0, atol=0, msg=key)


def test_pretrained_flags_are_ignored_off_lxmert_and_uniter(qa_root, pretrain_pth, tmp_path, capsys):
    # The JAX runner has no branch for them on BUTD: nothing loads.
    root, _, prefix = qa_root
    cfg = _cfg(root, str(tmp_path / "o"), load_lxmert_qa=prefix)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, backbone="butd"))
    GQARunner(cfg, device="cpu")
    assert "--loadLXMERTQA ignored on --backbone butd" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The train CLI.
# ---------------------------------------------------------------------------


TINY = ["--device", "cpu", "--fp32", "--llayers", "1", "--xlayers", "1", "--rlayers", "1", "--hidden_size", "32",
        "--num_heads", "4", "--batchSize", "16", "--epochs", "1"]


@pytest.fixture(scope="module")
def cli_env(tmp_path_factory):
    """The CLI's root with an ``all_ans.json`` and a 9500-answer
    ``model_LXRT.pth`` at the CLI's width (36 x 2048 RoIs, BERT's vocab)."""
    tmp = tmp_path_factory.mktemp("pretrained_init_cli")
    root = str(tmp / "gqa")
    make_synthetic_gqa(root)
    with open(os.path.join(root, "trainval_label2ans.json")) as f:
        answers = json.load(f)
    with open(os.path.join(root, "all_ans.json"), "w") as f:
        json.dump([{"ans": a, "dsets": ["gqa"]} for a in answers[1::2]], f)
    enc = port_config.EncoderConfig(hidden_size=32, num_heads=4, intermediate_size=128, **LAYERS)
    pth = write_pretraining_pth(tmp / "model_LXRT.pth", enc, seed=4)
    return root, pth, len(answers[1::2]), tmp


@pytest.mark.parametrize("flag", ["--loadLXMERT", "--loadLXMERTQA"])
def test_train_cli_starts_from_the_pretrained_file(cli_env, tmp_path, flag, capsys):
    from rgqa_tpu_torch.cli import train

    root, pth, n_table, _ = cli_env
    history = train.main(["--synthetic", "--data_root", root, "--output", str(tmp_path / "o"), *TINY, flag, pth])
    out = capsys.readouterr().out
    assert np.isfinite(history["loss"]).all()
    if flag == "--loadLXMERT":
        assert "Loaded LXMERT encoder (0 keys left at init)" in out
    else:
        # The table's answers the root uses, less UQ (no logit); the rest zeroed.
        with open(os.path.join(root, "trainval_label2ans.json")) as f:
            real = [a for a in json.load(f) if a != "UQ"]
        with open(os.path.join(root, "all_ans.json")) as f:
            table = {r["ans"] for r in json.load(f)}
        loaded = sum(a in table for a in real)
        assert 0 < loaded < len(real) and loaded <= n_table
        assert f"Loaded {loaded} answers from LXRTQA pre-training and {len(real) - loaded} not" in out
