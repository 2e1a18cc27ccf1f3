"""Slice 4: ViLT RP fine-tuning in the port against the JAX package.

On the CPU, f32, dropout 0, inputs made by numpy from a seed:

- the 12-step trajectory: a tiny ``ViltForGQA`` (2 layers x 32, 4 heads,
  64 px images in 16 px patches) on the u8 wire with padded rects, RP
  pairing on, through the JAX ``make_train_step`` and through the port's
  step on ``from_jax_params`` of the same params, on the same 12 batches
  with the shift of each step taken from the JAX key chain: losses within
  rtol 1e-4 and final params within atol 1e-4 (``tests/test_train.py``'s
  bar, as ``tests/test_torch_train.py`` holds LXMERT to it).  Before the
  RP repair the port paired 2B text rows with B images and failed here;
- the runners: the JAX ``GQARunner.train()`` and the port's train the
  same tiny ViLT (loaded into the port through a reference GQAViLT
  ``.pth``) with ``--no_randaug`` on one synthetic root, both reading one
  pixel pack, for 2 epochs of the same shuffled batches: equal loss
  histories (rtol 1e-4) and valid accuracies.  The port's ``BEST.pth``
  scores alike in the port's evaluate CLI and in the JAX package; its
  ``LAST.pth`` loads back into the port and through the JAX package's
  ``import_vilt_gqa`` (before the repair the runner wrote LXMERT keys, or
  failed); ``train(resume="LAST")`` continues from the saved state;
- the runner's image sources: with randaug on the train split decodes
  the JPEGs and draws from ``default_rng(--seed)``; with it off, and for
  the eval splits, the pixel pack.

A test marked ``cuda`` runs one training step on the card at a stream
longer than 64 tokens and counts the long kernels' launches.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from rgqa_tpu_torch import config as port_config
from rgqa_tpu_torch.checkpoint.convert import from_jax_params, load_reference_pth, to_reference_state_dict
from rgqa_tpu_torch.cli import evaluate
from rgqa_tpu_torch.data.images import GQAImageSource, PixelPack
from rgqa_tpu_torch.data.synthetic import BASE_IMAGES, SyntheticSpec, make_synthetic_gqa, make_synthetic_pixel_pack
from rgqa_tpu_torch.models.zoo import build_model, example_batch
from rgqa_tpu_torch.ops.dropout import DropoutRng
from rgqa_tpu_torch.runner import GQARunner
from rgqa_tpu_torch.train import optimizer, step as tstep
from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

N_STEPS = 12


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


def _model_cfg(c, **kw):
    enc = c.EncoderConfig(hidden_size=32, num_heads=4, intermediate_size=64, vocab_size=128,
                          num_layers=2, hidden_dropout=0.0, attention_dropout=0.0)
    return c.ModelConfig(backbone="vilt", encoder=enc, num_answers=7, max_text_len=8,
                         vilt_patch_size=16, vilt_image_size=64, **kw)


def _train_batch(cfg, b, seed):
    """``example_batch`` on the u8 wire (three rows of four in padded
    rects) with padded text, soft targets and an id mask."""
    batch = example_batch(cfg, b, seed=seed, pixel_wire="u8")
    rng = np.random.default_rng(seed + 100)
    lengths = rng.integers(3, cfg.max_text_len + 1, b)
    pad = np.arange(cfg.max_text_len)[None, :] >= lengths[:, None]
    batch["input_ids"][pad] = 0
    batch["input_mask"][pad] = 0
    target = np.zeros((b, cfg.num_answers), np.float32)
    target[np.arange(b), rng.integers(0, cfg.num_answers, b)] = rng.random(b, dtype=np.float32)
    batch["target"] = target
    batch["id_mask"] = (rng.random(b) > 0.3).astype(np.float32)
    return batch


def _tensors(batch, device="cpu"):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def test_twelve_step_vilt_rp_trajectory_matches_jax(jax):
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.models.zoo import build_model as jax_build_model
    from rgqa_tpu.train import create_train_state, make_optimizer as jax_make_optimizer
    from rgqa_tpu.train import make_train_step as jax_make_train_step

    cfg, b, lr = _model_cfg(port_config), 6, 2e-3
    batches = [_train_batch(cfg, b, seed=i) for i in range(N_STEPS)]
    assert batches[0]["pixel_mask"].min() == 0  # the pad patches are masked
    jmodel, jforward = jax_build_model(_model_cfg(jax_config))
    init = example_batch(cfg, 2, seed=0)  # f32 pixels: the init's signature
    params = jmodel.init(jax.random.PRNGKey(0), *(init[k] for k in ("input_ids", "input_mask", "pixels")))
    params = jax.tree_util.tree_map(np.asarray, params["params"])

    state = create_train_state(params, jax_make_optimizer(jax_config.OptimConfig(lr=lr), N_STEPS))
    jstep = jax_make_train_step(jforward, sample_pair=True, grad_clip=5.0, donate=False)
    key = jax.random.PRNGKey(0)
    jax_losses, shifts = [], []
    for batch in batches:
        key, sub = jax.random.split(key)
        _, aug = jax.random.split(sub)
        shifts.append(int(jax.random.randint(aug, (), 1, b)))
        state, aux = jstep(state, {k: jax.numpy.asarray(v) for k, v in batch.items()}, sub)
        jax_losses.append(float(aux["loss"]))

    model, forward = build_model(cfg, device="cpu", train=True)
    model.load_state_dict(from_jax_params(params), strict=True)
    opt = optimizer.make_optimizer(port_config.OptimConfig(lr=lr), model.parameters(), t_total=N_STEPS)
    step = tstep.make_train_step(forward, opt, sample_pair=True, grad_clip=5.0, rng=DropoutRng())
    outs = [step(_tensors(batch), shift=s) for batch, s in zip(batches, shifts)]
    assert outs[0]["score"].shape == (2 * b,)  # RP doubled every field

    np.testing.assert_allclose([o["loss"].item() for o in outs], jax_losses, rtol=1e-4)
    assert outs[0]["loss"].item() != outs[-1]["loss"].item()  # the weights moved
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, state.params))
    got = model.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# The runners.
# ---------------------------------------------------------------------------

# Shapes the CLIs can express (the BERT vocab, intermediate 4 x hidden, 20
# text tokens), so that the evaluate CLI can load BEST.pth.
SPEC = dict(n_images=12, n_train=32, n_valid=16, n_testdev=24, num_boxes=4, feat_dim=48, seed=9)
ENC = dict(hidden_size=32, num_heads=4, intermediate_size=128, num_layers=2,
           hidden_dropout=0.0, attention_dropout=0.0)
FLAGS = ["--backbone", "vilt", "--fp32", "--num_layers", "2", "--hidden_size", "32",
         "--num_heads", "4", "--vilt_image_size", "64", "--vilt_patch_size", "16",
         "--batchSize", "8", "--dropout", "0", "--no_randaug", "--device", "cpu"]


def _run_cfg(c, root, out, epochs=2, randaug=False, **kw):
    return c.RunConfig(
        model=c.ModelConfig(backbone="vilt", encoder=c.EncoderConfig(**ENC), vilt_patch_size=16,
                            vilt_image_size=64),
        train=c.TrainConfig(batch_size=8, epochs=epochs, use_bf16=False, seed=11, dropout=0.0,
                            optim=c.OptimConfig(lr=1e-2)),
        data=c.DataConfig(data_root=root, synthetic=True, vilt_randaug=randaug),
        output=out,
        **kw,
    )


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(tmp dir, data root, JAX history, port history, port runner)."""
    pytest.importorskip("jax")
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.data.images import PixelPack as JaxPixelPack
    from rgqa_tpu.runner import GQARunner as JaxRunner
    from rgqa_tpu.runner import np_params

    tmp = tmp_path_factory.mktemp("vilt_train")
    root = str(tmp / "gqa")
    make_synthetic_gqa(root, SyntheticSpec(**SPEC))
    make_synthetic_pixel_pack(root, 64, "pad")
    jax_runner = JaxRunner(_run_cfg(jax_config, root, str(tmp / "jax")))
    assert isinstance(jax_runner.train_set.image_source, JaxPixelPack)
    pth = str(tmp / "init.pth")
    torch.save(to_reference_state_dict(from_jax_params(np_params(jax_runner.params)),
                                       backbone="vilt", num_layers=2), pth)
    port_runner = GQARunner(_run_cfg(port_config, root, str(tmp / "port"), load=pth), device="cpu")
    assert isinstance(port_runner.train_set.image_source, PixelPack)
    want = jax_runner.train()
    got = port_runner.train()
    return tmp, root, want, got, port_runner


def test_vilt_history_matches_jax_runner(trained):
    _, _, want, got, runner = trained
    out = runner.output
    assert len(got["loss"]) == len(got["valid"]) == 2
    np.testing.assert_allclose(got["loss"], [float(x) for x in want["loss"]], rtol=1e-4)
    assert got["valid"] == want["valid"]
    assert max(got["valid"]) > 0  # so BEST.pth was written
    for name in ("BEST.pth", "LAST.pth", "LAST.state.pt", "log.log", "run_config.json"):
        assert os.path.exists(os.path.join(out, name)), name


def test_vilt_best_pth_scores_alike_in_the_port_and_the_jax_package(trained):
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.data import GQADataset as JaxDataset
    from rgqa_tpu.runner import GQARunner as JaxRunner

    tmp, root, _, _, runner = trained
    best = os.path.join(runner.output, "BEST.pth")
    eval_out = str(tmp / "port_eval")
    evaluate.main(["--synthetic", "--data_root", root, "--test", "testdev", "--load", best,
                   "--output", eval_out, *FLAGS])
    jax_runner = JaxRunner(_run_cfg(jax_config, root, str(tmp / "jax_eval"), load=best),
                           init_train=False)
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


def test_vilt_pth_loads_into_the_port_and_the_jax_importer(jax, trained):
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.checkpoint.torch_import import import_vilt_gqa
    from rgqa_tpu.runner import GQARunner as JaxRunner

    tmp, root, _, _, runner = trained
    last = os.path.join(runner.output, "LAST.pth")
    ref = torch.load(last, weights_only=True)
    assert "transformer.blocks.1.attn.qkv.weight" in ref  # GQAViLT's fused Q/K/V
    assert not any(k.startswith("lxrt_encoder") for k in ref)
    sd, missing, unused = load_reference_pth(last, backbone="vilt", num_layers=2)
    assert missing == [] and unused == []
    want = runner.model.state_dict()  # the weights at the end of training
    assert sd.keys() == want.keys()
    for key in sd:
        torch.testing.assert_close(sd[key], want[key], rtol=0, atol=0)
    jax_runner = JaxRunner(_run_cfg(jax_config, root, str(tmp / "jax_load")), init_train=False)
    params, missing, unused = import_vilt_gqa(jax_runner.params, last, num_layers=2)
    assert missing == [] and unused == []
    for key, val in from_jax_params(jax.tree_util.tree_map(np.asarray, params)).items():
        np.testing.assert_array_equal(val.numpy(), sd[key].numpy(), err_msg=key)


def test_vilt_resume_continues_from_the_saved_step(trained):
    tmp, root, _, _, runner = trained
    out = runner.output
    steps_per_epoch = SPEC["n_train"] // 8
    assert torch.load(os.path.join(out, "LAST.state.pt"), weights_only=True)["step"] == 2 * steps_per_epoch
    runner = GQARunner(_run_cfg(port_config, root, out, epochs=1), device="cpu")
    before = {k: v.clone() for k, v in runner.model.state_dict().items()}
    history = runner.train(resume="LAST")
    assert len(history["loss"]) == 1 and np.isfinite(history["loss"][0])
    resumed = torch.load(os.path.join(out, "LAST.state.pt"), weights_only=True)
    assert resumed["step"] == 3 * steps_per_epoch
    key = "blocks.0.query.weight"
    assert not torch.equal(runner.model.state_dict()[key], before[key])


# ---------------------------------------------------------------------------
# The runner's image sources.
# ---------------------------------------------------------------------------


def _jpeg_root(tmp_path):
    """A synthetic root with its pack and, under images/, its base images
    as JPEGs (PIL, as the JAX generator writes them)."""
    from PIL import Image

    root = str(tmp_path / "gqa")
    make_synthetic_gqa(root, SyntheticSpec(n_images=4, n_train=8, n_valid=4, n_testdev=4,
                                           num_boxes=3, feat_dim=48, seed=1))
    make_synthetic_pixel_pack(root, 64, "pad")
    os.makedirs(os.path.join(root, "images"))
    with open(os.path.join(root, "features", "img_ids.json")) as f:
        img_ids = json.load(f)
    for img_id, base in zip(img_ids, np.load(os.path.join(root, BASE_IMAGES))):
        Image.fromarray(base).resize((64, 64), Image.BICUBIC).save(
            os.path.join(root, "images", f"{img_id}.jpg"), quality=95)
    return root


def _encoded_sets(root, out, randaug):
    runner = GQARunner(_run_cfg(port_config, root, out, randaug=randaug), device="cpu")
    return runner.train_set, runner.valid_set


@pytest.mark.parametrize("randaug", [True, False], ids=["randaug", "no_randaug"])
def test_runner_image_source_follows_the_jax_rule(tmp_path, randaug):
    pytest.importorskip("PIL")
    train, valid = _encoded_sets(_jpeg_root(tmp_path), str(tmp_path / "out"), randaug)
    assert isinstance(valid.image_source, PixelPack) and valid.image_augment_rng is None
    if not randaug:
        assert isinstance(train.image_source, PixelPack) and train.image_augment_rng is None
        return
    assert isinstance(train.image_source, GQAImageSource)
    assert train.image_augment_rng.random() == np.random.default_rng(11).random()  # --seed
    a = train.gather_batch(np.arange(4))["pixels_u8"]
    b = train.gather_batch(np.arange(4))["pixels_u8"]
    assert a.shape == (4, 64, 64, 3) and not np.array_equal(a, b)  # drawn anew per batch


def test_runner_randaug_without_pil_or_jpegs_names_the_flag(tmp_path, monkeypatch):
    root = str(tmp_path / "gqa")  # the port's synthetic root: a pack, no JPEGs
    with pytest.raises(RuntimeError, match="--no_randaug"):
        _encoded_sets(root, str(tmp_path / "out"), randaug=True)
    os.makedirs(os.path.join(root, "images"))
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "PIL" else find_spec(name, *a))
    with pytest.raises(RuntimeError, match="missing here: PIL. --no_randaug"):
        _encoded_sets(root, str(tmp_path / "out"), randaug=True)


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("image_size", [128, 512])
def test_vilt_train_step_launches_the_long_kernels_on_card(image_size):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rgqa_tpu_torch.ops import attention as att

    # 128 px in 16 px patches: 64 patches + CLS + 8 text tokens = 73 > 64;
    # 512 px: 1024 + 1 + 8 = 1033, through the long kernels' key tiles.
    cfg = dataclasses.replace(_model_cfg(port_config), vilt_image_size=image_size)
    model, forward = build_model(cfg, use_bf16=True, device="cuda", train=True)
    opt = optimizer.make_optimizer(port_config.OptimConfig(lr=1e-3), model.parameters(), t_total=2)
    step = tstep.make_train_step(forward, opt, sample_pair=True, rng=DropoutRng())
    batch = _tensors(_train_batch(cfg, 4, seed=2), "cuda")
    wrappers = (att.fused_attention_cuda, att.fused_attention_long_cuda, att.fused_attention_bwd_cuda,
                att.fused_attention_long_bwd_cuda)
    before = [w.launches for w in wrappers]
    out = step(batch)
    torch.cuda.synchronize()
    assert [w.launches - n for w, n in zip(wrappers, before)] == [0, 2, 0, 2]  # 2 layers
    assert torch.isfinite(out["loss"])
