"""Slice 3 end to end: the port's ViLT evaluate path against the JAX runner.

A tiny JAX ``GQARunner(backbone="vilt", init_train=False)`` (fp32, 2
layers x 32, 64 px images in 16 px patches) and the port's runner,
loaded with the JAX runner's weights through a reference GQAViLT
``.pth``, score the same synthetic ``testdev`` split with MSP, both
reading one pixel pack made by the port's generator (the u8 wire, the
config default).  Answers are equal, the dumped confidences (4 dp, the
prediction-JSON contract) are equal with at most ``MAX_4DP_FLIPS``
rounding flips, and the metric dicts are equal.  The CLI runs the same
path at a tiny size on the CPU; the train CLI trains ViLT from the pixel
pack with ``--no_randaug`` and, without JPEGs for randaug, refuses by
naming that flag (slice 4 ported ViLT training;
``tests/test_torch_vilt_train.py`` holds it to the JAX package).
"""

import json
import os

import numpy as np
import pytest
import torch

from rgqa_tpu_torch import config as port_config
from rgqa_tpu_torch.checkpoint.convert import from_jax_params, to_reference_state_dict
from rgqa_tpu_torch.cli import evaluate, train
from rgqa_tpu_torch.data.dataset import GQADataset
from rgqa_tpu_torch.data.images import PixelPack
from rgqa_tpu_torch.data.synthetic import SyntheticSpec, make_synthetic_gqa, make_synthetic_pixel_pack
from rgqa_tpu_torch.runner import GQARunner

# f32 on both sides; the sums differ only in order, so a confidence may
# land on the other side of a 4-dp rounding boundary.  None was seen.
MAX_4DP_FLIPS = 0
ENC = dict(hidden_size=32, num_heads=4, intermediate_size=64, vocab_size=256, num_layers=2)
SPEC = dict(n_images=12, n_train=8, n_valid=8, n_testdev=40, num_boxes=4, feat_dim=48, seed=9)
TINY_FLAGS = [
    "--backbone", "vilt", "--fp32", "--num_layers", "2", "--hidden_size", "32",
    "--num_heads", "4", "--vilt_image_size", "64", "--vilt_patch_size", "16",
    "--batchSize", "16", "--device", "cpu",
]


def _cfg(root, out, config=None, **kw):
    c = config or port_config
    return c.RunConfig(
        model=c.ModelConfig(backbone="vilt", encoder=c.EncoderConfig(**ENC), max_text_len=8,
                            vilt_patch_size=16, vilt_image_size=64),
        train=c.TrainConfig(batch_size=16, use_bf16=False, seed=4),
        ood=c.OODConfig(scorer="msp"),
        data=c.DataConfig(data_root=root, test_splits="testdev", synthetic=True),
        output=out,
        **kw,
    )


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(jax runner, port runner, data root, tmp dir) sharing weights and pixels."""
    pytest.importorskip("jax")
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.runner import GQARunner as JaxRunner
    from rgqa_tpu.runner import np_params

    tmp = tmp_path_factory.mktemp("vilt_slice")
    root = str(tmp / "gqa")
    make_synthetic_gqa(root, SyntheticSpec(**SPEC))
    make_synthetic_pixel_pack(root, 64, "pad")
    jax_runner = JaxRunner(_cfg(root, str(tmp / "jax"), jax_config), init_train=False)
    sd = from_jax_params(np_params(jax_runner.params))
    pth = str(tmp / "jax_vilt.pth")
    torch.save(to_reference_state_dict(sd, backbone="vilt", num_layers=2), pth)
    port_runner = GQARunner(_cfg(root, str(tmp / "port"), load=pth), init_train=False, device="cpu")
    return jax_runner, port_runner, root, tmp


def _encoded(runner, root, jax_side):
    if jax_side:
        from rgqa_tpu.data import GQADataset as JaxDataset

        return runner._encode(JaxDataset(root, "testdev", add_uq=True))
    return runner._encode(GQADataset(root, "testdev", add_uq=True))


def test_both_runners_read_the_pack(both):
    from rgqa_tpu.data.images import PixelPack as JaxPixelPack

    jax_runner, port_runner, root, _ = both
    assert isinstance(port_runner.image_source, PixelPack)
    jax_encoded = _encoded(jax_runner, root, True)
    assert isinstance(jax_encoded.image_source, JaxPixelPack)
    batch = _encoded(port_runner, root, False).gather_batch(np.arange(3))
    want = jax_encoded.gather_batch(np.arange(3), with_target=False)
    assert batch.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(batch[key], want[key], err_msg=key)


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


# 64 px: 16 patches + CLS + 20 text tokens; 512 px: 1024 + 1 + 20 = 1045,
# a stream past the long kernels' old cap of 256 keys (the plain versions
# on the CPU).
@pytest.mark.parametrize("image_size", [64, 512])
def test_cli_writes_predictions_and_metrics(tmp_path, image_size):
    root, out = str(tmp_path / "gqa"), str(tmp_path / "out")
    make_synthetic_gqa(root, SyntheticSpec(n_images=6, n_train=8, n_valid=8, n_testdev=20, seed=5))
    results = evaluate.main([
        "--synthetic", "--data_root", root, "--test", "testdev", "--scorer", "msp",
        "--output", out, *TINY_FLAGS, "--vilt_image_size", str(image_size),
    ])
    assert os.path.isfile(os.path.join(root, f"pixels_{image_size}_pad", "meta.json"))  # made on first use
    with open(os.path.join(out, "testdev_predict.json")) as f:
        rows = json.load(f)
    assert len(rows) == 20
    assert {"auaf", "fpr@0.95acc", "full_acc"} <= results["testdev"].keys()


def test_runner_refuses_vilt_training(tmp_path):
    """What the runner still refuses of ViLT training: randaug (the
    default) where there are no JPEGs to augment, by naming
    ``--no_randaug``; with it, the train CLI trains from the pixel pack."""
    root, out = str(tmp_path / "gqa"), str(tmp_path / "out")
    argv = ["--synthetic", "--data_root", root, "--sample_pair", "--epochs", "1",
            "--output", out, *TINY_FLAGS]
    with pytest.raises(RuntimeError, match="--no_randaug"):
        train.main(argv)
    history = train.main(argv + ["--no_randaug"])
    assert len(history["loss"]) == 1 and np.isfinite(history["loss"][0])
    for name in ("LAST.pth", "LAST.state.pt", "log.log"):
        assert os.path.isfile(os.path.join(out, name)), name
