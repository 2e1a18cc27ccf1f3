"""Slice 2 end to end: the port's trainer against the JAX runner's.

``rgqa_tpu.runner.GQARunner.train()`` and the port's ``GQARunner(...,
device="cpu").train()`` fine-tune the same tiny LXMERT (loaded into the
port through a reference ``.pth``) on one tiny synthetic split, in f32
with dropout 0, for 2 epochs of the same shuffled batches (the same
``np.random.default_rng(seed)``): the per-epoch losses agree within rtol
1e-4 (``tests/test_train.py``'s bar) and the valid accuracies are equal.
The port's ``BEST.pth`` then loads into the port's evaluate CLI
(``--device cpu --load``) and into the JAX package's
``import_lxmert_gqa``, and their predictions agree; ``train(resume=
"LAST")`` continues from the saved step and optimizer state.
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
from rgqa_tpu_torch.data.synthetic import SyntheticSpec, make_synthetic_gqa
from rgqa_tpu_torch.runner import GQARunner
from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

# Shapes the CLIs can express (36 x 2048 RoI features, the BERT vocab,
# intermediate 4 x hidden), so that the evaluate CLI can load BEST.pth.
SPEC = dict(n_images=16, n_train=32, n_valid=16, n_testdev=24, seed=3)
ENC = dict(
    hidden_size=32, num_heads=4, intermediate_size=128, l_layers=1, x_layers=1, r_layers=1,
    hidden_dropout=0.0, attention_dropout=0.0,
)
FLAGS = ["--fp32", "--llayers", "1", "--xlayers", "1", "--rlayers", "1", "--hidden_size", "32",
         "--num_heads", "4", "--batchSize", "8", "--dropout", "0", "--device", "cpu"]


def _cfg(c, root, out, epochs=2, **kw):
    return c.RunConfig(
        model=c.ModelConfig(backbone="lxmert", encoder=c.EncoderConfig(**ENC)),
        train=c.TrainConfig(batch_size=8, epochs=epochs, use_bf16=False, seed=11, dropout=0.0,
                            optim=c.OptimConfig(lr=1e-2)),
        data=c.DataConfig(data_root=root, synthetic=True),
        output=out,
        **kw,
    )


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(tmp dir, data root, JAX history, port history, port output dir)."""
    pytest.importorskip("jax")
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.runner import GQARunner as JaxRunner
    from rgqa_tpu.runner import np_params

    tmp = tmp_path_factory.mktemp("train")
    root = str(tmp / "gqa")
    make_synthetic_gqa(root, SyntheticSpec(**SPEC))
    jax_runner = JaxRunner(_cfg(jax_config, root, str(tmp / "jax")))
    pth = str(tmp / "init.pth")
    torch.save(to_reference_state_dict(from_jax_params(np_params(jax_runner.params)),
                                       l_layers=1, x_layers=1, r_layers=1), pth)
    port_out = str(tmp / "port")
    port_runner = GQARunner(_cfg(port_config, root, port_out, load=pth), device="cpu")
    want = jax_runner.train()
    got = port_runner.train()
    return tmp, root, want, got, port_out


def test_history_matches_jax_runner(trained):
    _, _, want, got, out = trained
    assert len(got["loss"]) == len(got["valid"]) == 2
    np.testing.assert_allclose(got["loss"], [float(x) for x in want["loss"]], rtol=1e-4)
    assert got["valid"] == want["valid"]
    assert max(got["valid"]) > 0  # so BEST.pth was written
    for name in ("BEST.pth", "LAST.pth", "LAST.state.pt", "log.log", "run_config.json"):
        assert os.path.exists(os.path.join(out, name)), name
    with open(os.path.join(out, "log.log")) as f:
        lines = [l for l in f.read().splitlines() if l]
    assert lines[0].startswith("Epoch 0: Train Loss ") and lines[1].startswith("Epoch 0: Valid ")
    assert len(lines) == 6


def test_best_pth_scores_alike_in_the_port_and_the_jax_package(trained):
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.data import GQADataset as JaxDataset
    from rgqa_tpu.runner import GQARunner as JaxRunner

    tmp, root, _, _, out = trained
    best = os.path.join(out, "BEST.pth")
    eval_out = str(tmp / "port_eval")
    evaluate.main(["--synthetic", "--data_root", root, "--test", "testdev", "--load", best,
                   "--output", eval_out, *FLAGS])
    jax_runner = JaxRunner(_cfg(jax_config, root, str(tmp / "jax_eval"), load=best), init_train=False)
    jdump = str(tmp / "jax_predict.json")
    jax_runner.ood_evaluate(jax_runner._encode(JaxDataset(root, "testdev", add_uq=True)), dump=jdump)
    with open(os.path.join(eval_out, "testdev_predict.json")) as f:
        prows = json.load(f)
    with open(jdump) as f:
        jrows = json.load(f)
    assert len(prows) == SPEC["n_testdev"]
    assert [r["questionId"] for r in prows] == [r["questionId"] for r in jrows]
    assert [r["prediction"] for r in prows] == [r["prediction"] for r in jrows]
    np.testing.assert_allclose([r["confidence"] for r in prows],
                               [r["confidence"] for r in jrows], atol=1e-4)


def test_resume_continues_from_the_saved_step_and_optimizer_state(trained):
    tmp, root, _, _, out = trained
    saved = torch.load(os.path.join(out, "LAST.state.pt"), weights_only=True)
    steps_per_epoch = SPEC["n_train"] // 8
    assert saved["step"] == 2 * steps_per_epoch
    assert saved["optimizer"]["param_groups"][0]["count"] == 2 * steps_per_epoch

    runner = GQARunner(_cfg(port_config, root, out, epochs=1), device="cpu")
    last = torch.load(os.path.join(out, "LAST.pth"), weights_only=True)
    before = {k: v.clone() for k, v in runner.model.state_dict().items()}
    history = runner.train(resume="LAST")
    assert len(history["loss"]) == 1 and np.isfinite(history["loss"][0])
    resumed = torch.load(os.path.join(out, "LAST.state.pt"), weights_only=True)
    assert resumed["step"] == 3 * steps_per_epoch
    assert resumed["optimizer"]["param_groups"][0]["count"] == 3 * steps_per_epoch
    # It started from LAST's weights, not from the runner's own init.
    key = "lxmert.lang_layers.0.att.query.weight"
    ref_key = "lxrt_encoder.model.bert.encoder.layer.0.attention.self.query.weight"
    assert not torch.equal(before[key], last[ref_key])
    assert not torch.equal(runner.model.state_dict()[key], before[key])
