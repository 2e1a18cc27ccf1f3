"""Slice 14 end to end: UNITER through the port's entry points, and the
inspection methods, against the JAX package on the CPU.

- The evaluate CLI (``--backbone uniter --device cpu``; msp, energy,
  ODIN) on a synthetic root at the CLI's feature width, on weights
  written from a JAX runner's parameters as a GQA-UNITER ``.pth``: the
  JAX CLI's answers, confidences within ``CONF_ATOL`` (plus the
  prediction JSON's 4-dp step) and metric dicts.
- The train CLI (RP, dropout 0.1) writes ``LAST.pth`` in GQA-UNITER's
  key format, which the JAX package's ``import_uniter_gqa`` reads with
  no key missing or unused and the port's evaluate CLI scores.
- ``--loadLXMERT`` of a ``bert.``-prefixed encoder written from random
  weights loads the encoder (as the JAX runner does) and leaves the
  answer head at its init.
- ``--branched`` on UNITER, ``--loadLXMERT`` on LXMERT and
  ``--loadLXMERTQA`` raise by name.
- ``topk_predict``, ``oracle_score`` and ``dump_attention`` against the
  JAX runner's on the same weights (the tiny LXMERT of
  ``tests/test_longtail.py``): equal accuracies, the same ``.npz`` names
  and keys, arrays within 2e-5; the port's ``plot_attention`` writes one
  PNG per qid from the dumps, byte-equal to the JAX CLI's figures.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import torch

from rgqa_tpu_torch import config as port_config
from rgqa_tpu_torch.checkpoint.convert import from_jax_params, to_reference_state_dict
from rgqa_tpu_torch.cli import evaluate, plot_attention
from rgqa_tpu_torch.cli import train as train_cli
from rgqa_tpu_torch.data.dataset import GQADataset
from rgqa_tpu_torch.data.synthetic import SyntheticSpec, make_synthetic_gqa
from rgqa_tpu_torch.runner import GQARunner

from test_torch_scoring_slice import CONF_ATOL, _same_dumps, _same_results, _spread
from test_torch_slice import CLI_SPEC
from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

LAYERS = 2
UNITER_FLAGS = ["--backbone", "uniter", "--fp32", "--num_layers", str(LAYERS), "--hidden_size", "32",
                "--num_heads", "4", "--batchSize", "16"]
CPU = ["--device", "cpu"]
CASES = {
    "msp": ["--scorer", "msp"],
    "energy": ["--scorer", "energy"],
    "odin": ["--scorer", "odin", "--temperature", "1000", "--noise", "0.01"],
}


def _save_uniter(sd, path) -> str:
    torch.save(to_reference_state_dict(sd, backbone="uniter", num_layers=LAYERS), path)
    return path


@pytest.fixture(scope="module")
def cli_env(tmp_path_factory):
    """(data root, tmp dir, GQA-UNITER .pth of a JAX runner's weights)."""
    pytest.importorskip("jax")
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.runner import GQARunner as JaxRunner
    from rgqa_tpu.runner import np_params

    tmp = tmp_path_factory.mktemp("uniter_cli")
    root = str(tmp / "gqa")
    make_synthetic_gqa(root, SyntheticSpec(**CLI_SPEC))
    cfg, _ = jax_config.parse_cli(["--synthetic", "--data_root", root, "--test", "testdev",
                                   "--output", str(tmp / "init"), *UNITER_FLAGS])
    params = _spread(np_params(JaxRunner(cfg, init_train=False).params))
    return root, tmp, _save_uniter(from_jax_params(params), str(tmp / "uniter.pth"))


def _argv(root, out, load, case):
    return ["--synthetic", "--data_root", root, "--test", "testdev", "--output", out,
            "--load", load, *UNITER_FLAGS, *CASES[case]]


@pytest.mark.parametrize("case", list(CASES))
def test_cli_matches_jax_cli(cli_env, case):
    from rgqa_tpu.cli import evaluate as jax_evaluate

    root, tmp, pth = cli_env
    jout, pout = str(tmp / f"jax_{case}"), str(tmp / f"port_{case}")
    want = jax_evaluate.main(_argv(root, jout, pth, case))["testdev"]
    got = evaluate.main(_argv(root, pout, pth, case) + CPU)["testdev"]
    rows = _same_dumps(os.path.join(pout, "testdev_predict.json"),
                       os.path.join(jout, "testdev_predict.json"), atol=CONF_ATOL)
    assert len(rows) == CLI_SPEC["n_testdev"]
    _same_results(got, want)


def test_train_cli_writes_gqa_uniter_checkpoints(cli_env):
    pytest.importorskip("jax")
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.checkpoint.torch_import import import_uniter_gqa
    from rgqa_tpu.runner import GQARunner as JaxRunner
    from rgqa_tpu.runner import np_params

    root, tmp, _ = cli_env
    out = str(tmp / "train")
    history = train_cli.main(["--synthetic", "--data_root", root, "--sample_pair", "--epochs", "1",
                              "--output", out, *UNITER_FLAGS, "--batchSize", "4", "--dropout", "0.1",
                              *CPU])
    assert len(history["loss"]) == 1 and np.isfinite(history["loss"][0])
    last = os.path.join(out, "LAST.pth")
    keys = torch.load(last, weights_only=True)
    assert all(k.startswith(("encoder.model.uniter.", "logit_fc.")) for k in keys)
    cfg, _ = jax_config.parse_cli(["--synthetic", "--data_root", root, "--test", "testdev",
                                   "--output", str(tmp / "jax_train_init"), *UNITER_FLAGS])
    params, missing, unused = import_uniter_gqa(
        np_params(JaxRunner(cfg, init_train=False).params), last, num_layers=LAYERS)
    assert missing == [] and unused == []
    np.testing.assert_array_equal(params["answer_head"]["logits"]["bias"],
                                  keys["logit_fc.3.bias"].numpy())
    res = evaluate.main(["--synthetic", "--data_root", root, "--test", "testdev", "--output",
                         str(tmp / "train_eval"), "--load", last, *UNITER_FLAGS, *CPU])["testdev"]
    assert {"auaf", "fpr@0.95acc", "full_acc"} <= set(res)


def test_load_lxmert_reads_a_bert_prefixed_encoder(cli_env):
    pytest.importorskip("jax")
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.runner import GQARunner as JaxRunner
    from rgqa_tpu.runner import np_params

    root, tmp, _ = cli_env
    base = ["--synthetic", "--data_root", root, "--test", "testdev", *UNITER_FLAGS]
    cfg, _ = port_config.parse_cli(base + ["--output", str(tmp / "src"), "--seed", "5"])
    src = GQARunner(cfg, init_train=False, device="cpu").model.state_dict()
    ref = to_reference_state_dict(src, backbone="uniter", num_layers=LAYERS)
    path = str(tmp / "pretrained_bert.pth")
    torch.save({"bert." + k.removeprefix("encoder.model.uniter."): v for k, v in ref.items()
                if not k.startswith("logit_fc")}, path)

    cfg, _ = port_config.parse_cli(base + ["--output", str(tmp / "init_only")])
    init = GQARunner(cfg, device="cpu").model.state_dict()
    loaded = GQARunner(dataclasses.replace(cfg, load_lxmert=path, output=str(tmp / "loaded")),
                       device="cpu").model.state_dict()
    for key, value in loaded.items():
        want = init[key] if key.startswith("answer_head.") else src[key]
        torch.testing.assert_close(value, want, rtol=0, atol=0, msg=key)
    assert not torch.equal(init["uniter.layers.0.att.query.weight"], src["uniter.layers.0.att.query.weight"])

    jcfg, _ = jax_config.parse_cli(base + ["--output", str(tmp / "jax_loaded"), "--loadLXMERT", path])
    jax_sd = from_jax_params(np_params(JaxRunner(jcfg).params))
    for key, value in jax_sd.items():
        if key.startswith("uniter."):
            torch.testing.assert_close(loaded[key], value, rtol=0, atol=0, msg=key)


@pytest.mark.parametrize(
    "extra,train,match",
    [
        (["--backbone", "uniter", "--branched"], False, "UNITER has no branched confidence head"),
        (["--backbone", "uniter", "--branched_layer"], False, "UNITER has no branched confidence head"),
        # LXMERT's pretrained starts read .pth files now; an orbax
        # snapshot directory ({dir}) stays refused.
        (["--loadLXMERT", "{dir}"], True, "--loadLXMERT an orbax"),
        (["--loadLXMERTQA", "{dir}"], True, "--loadLXMERTQA an orbax"),
        (["--backbone", "uniter", "--strategy", "adv"], True, "--strategy adv on --backbone uniter"),
    ],
    ids=["branched", "branched_layer", "loadLXMERT-lxmert", "loadLXMERTQA", "adv-uniter"],
)
def test_refusals_by_name(tmp_path, extra, train, match):
    (tmp_path / "snapshot").mkdir()
    extra = [str(tmp_path / "snapshot") if e == "{dir}" else e for e in extra]
    cfg, _ = port_config.parse_cli(["--synthetic", "--data_root", str(tmp_path / "gqa"), "--test",
                                    "testdev", "--output", str(tmp_path / "out"), "--num_layers", "1",
                                    "--hidden_size", "32", "--num_heads", "4", *extra])
    with pytest.raises(NotImplementedError, match=match):
        GQARunner(cfg, init_train=train, device="cpu")


# ---------------------------------------------------------------------------
# The inspection methods, on the tiny LXMERT of tests/test_longtail.py.
# ---------------------------------------------------------------------------

LT_ENC = dict(hidden_size=32, num_heads=4, intermediate_size=64, l_layers=1, x_layers=1, r_layers=1,
              num_objects=36, visual_feat_dim=2048)
LT_SPEC = dict(n_images=16, n_train=64, n_valid=16, n_testdev=32)


def _lt_cfg(c, root, out, **kw):
    return c.RunConfig(
        model=c.ModelConfig(backbone="lxmert", encoder=c.EncoderConfig(**LT_ENC), max_text_len=12),
        train=c.TrainConfig(batch_size=16, use_bf16=False),
        data=c.DataConfig(data_root=root, synthetic=True),
        output=out, **kw,
    )


@pytest.fixture(scope="module")
def inspect_env(tmp_path_factory):
    """(JAX runner, port runner, data root, tmp dir) sharing weights."""
    pytest.importorskip("jax")
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.runner import GQARunner as JaxRunner
    from rgqa_tpu.runner import np_params

    tmp = tmp_path_factory.mktemp("inspect")
    root = str(tmp / "gqa")
    make_synthetic_gqa(root, SyntheticSpec(**LT_SPEC))
    jax_runner = JaxRunner(_lt_cfg(jax_config, root, str(tmp / "jax")), init_train=False)
    jax_runner.params = _spread(np_params(jax_runner.params))
    pth = str(tmp / "lxmert.pth")
    torch.save(to_reference_state_dict(from_jax_params(jax_runner.params), l_layers=1, x_layers=1,
                                       r_layers=1), pth)
    port_runner = GQARunner(_lt_cfg(port_config, root, str(tmp / "port"), load=pth),
                            init_train=False, device="cpu")
    return jax_runner, port_runner, root, tmp


def _both_encoded(jax_runner, port_runner, root, split="valid"):
    from rgqa_tpu.data import GQADataset as JaxDataset

    return (jax_runner._encode(JaxDataset(root, split, add_uq=True)),
            port_runner._encode(GQADataset(root, split, add_uq=True)))


@pytest.mark.parametrize("k", [1, 4])
def test_topk_and_oracle_match_jax_runner(inspect_env, k):
    jax_runner, port_runner, root, tmp = inspect_env
    jenc, penc = _both_encoded(jax_runner, port_runner, root)
    jdump, pdump = str(tmp / f"jax_top{k}.json"), str(tmp / f"port_top{k}.json")
    want = jax_runner.topk_predict(jenc, k=k, dump=jdump)
    got = port_runner.topk_predict(penc, k=k, dump=pdump)
    assert got == want
    with open(pdump, "rb") as p, open(jdump, "rb") as j:
        assert p.read() == j.read()
    if k == 1:
        assert got == port_runner.evaluate(penc)
    assert port_runner.oracle_score(penc) == jax_runner.oracle_score(jenc) == pytest.approx(1.0)


def test_dump_attention_matches_jax_runner_and_plots(inspect_env):
    jax_runner, port_runner, root, tmp = inspect_env
    jenc, penc = _both_encoded(jax_runner, port_runner, root)
    jdir, pdir = str(tmp / "att_jax"), str(tmp / "att_port")
    assert jax_runner.dump_attention(jenc, jdir, limit=5) == 5
    assert port_runner.dump_attention(penc, pdir, limit=5) == 5
    names = sorted(os.listdir(pdir))
    assert names == sorted(os.listdir(jdir)) and len(names) == 5
    for name in names:
        with np.load(os.path.join(pdir, name)) as got, np.load(os.path.join(jdir, name)) as want:
            assert list(got.keys()) == list(want.keys()) == ["lang2visn_0", "visn2lang_0"]
            assert got["lang2visn_0"].shape == (4, 12, 36) and got["visn2lang_0"].shape == (4, 36, 12)
            for key in want:
                np.testing.assert_allclose(got[key], np.asarray(want[key], np.float32), rtol=0,
                                           atol=2e-5, err_msg=f"{name} {key}")
    # The kernels' path is untouched by the dump: the same answers after it.
    assert port_runner.evaluate(penc) == jax_runner.evaluate(jenc)

    pytest.importorskip("matplotlib")
    from rgqa_tpu.cli import plot_attention as jax_plot

    written = plot_attention.main([pdir, "--out", str(tmp / "png_port")])
    assert sorted(os.path.basename(p) for p in written) == [n.replace(".npz", ".png") for n in names]
    # The copy draws what the original draws, byte for byte, on the same dumps.
    qids = ["--qids", ",".join(n.removesuffix(".npz") for n in names[:2])]
    for flags in (qids, [*qids, "--mean-heads", "--direction", "visn2lang"]):
        mine = plot_attention.main([jdir, "--out", str(tmp / "png_copy"), *flags])
        theirs = jax_plot.main([jdir, "--out", str(tmp / "png_orig"), *flags])
        assert len(mine) == len(theirs) == 2
        for a, b in zip(mine, theirs):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), a


def test_dump_attention_refuses_a_single_stream_backbone(cli_env):
    root, tmp, pth = cli_env
    cfg, _ = port_config.parse_cli(_argv(root, str(tmp / "dump_uniter"), pth, "msp"))
    runner = GQARunner(cfg, init_train=False, device="cpu")
    with pytest.raises(NotImplementedError, match="LXMERT's cross-modal attention"):
        runner.dump_attention(runner._encode(GQADataset(root, "testdev", add_uq=True)),
                              str(tmp / "dump_uniter" / "att"))
