"""Port parity: slice 14's UNITER pieces against the JAX package.

The same numpy inputs go through the JAX function and its counterpart in
the port, at a small size (3 layers x 64, 4 heads, 6 objects, 10 text
tokens; questions of mixed length, so the text pads sit in the middle of
the 16-token stream, before the image keys):

- ``uniter_box_transform`` on pixel boxes (exact);
- ``UniterForGQA``'s forward on the JAX model's weights through
  ``from_jax_params``, on UNITER boxes of pixel boxes (areas to ~3e5):
  pooled and logits at rtol 2e-4 / atol 2e-5 in f32, within 3e-2 in bf16
  (both round every product to bf16, in other orders);
- ``uniter_key_map`` (equal lists), a ``.pth`` from
  ``to_reference_state_dict`` through the JAX ``import_uniter_gqa`` (the
  same params), and each of the three encoder prefixes the JAX importer
  reads (``encoder.model.uniter.``, ``uniter.``, ``bert.``) into the port;
- the ``uniter7`` boxes of ``EncodedGQA`` (equal arrays), and the box
  cache of a feature pack shared by splits of two backbones;
- the 12-step RP trajectory in f32 at dropout 0: losses within rtol 1e-4
  (``tests/test_train.py``'s bar), final params within atol 1e-4.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from rgqa_tpu_torch.checkpoint import torch_import as port_import
from rgqa_tpu_torch.checkpoint.convert import (
    from_jax_params,
    load_reference_pth,
    to_reference_state_dict,
)
from rgqa_tpu_torch.config import EncoderConfig, ModelConfig, OptimConfig
from rgqa_tpu_torch.data.dataset import EncodedGQA, GQADataset
from rgqa_tpu_torch.data.synthetic import SyntheticSpec, make_synthetic_gqa
from rgqa_tpu_torch.data.tokenizer import WordPieceTokenizer, load_vocab
from rgqa_tpu_torch.data.tsv import PackedFeatures
from rgqa_tpu_torch.models.uniter import uniter_box_transform
from rgqa_tpu_torch.models.zoo import build_model, example_batch
from rgqa_tpu_torch.ops.dropout import DropoutRng
from rgqa_tpu_torch.train import optimizer, step as tstep

from test_torch_train import _tensors
from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

LAYERS = 3
ENC = dict(hidden_size=64, num_heads=4, intermediate_size=128, vocab_size=200, num_layers=LAYERS,
           num_objects=6, visual_feat_dim=40)
TEXT = 10
N_STEPS = 12
INPUTS = ("input_ids", "input_mask", "segment_ids", "feats", "boxes")


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


def _cfg(config=None, dropout=0.0, num_answers=9):
    c = config
    enc = (c.EncoderConfig if c else EncoderConfig)(
        **ENC, hidden_dropout=dropout, attention_dropout=dropout)
    return (c.ModelConfig if c else ModelConfig)(
        backbone="uniter", encoder=enc, num_answers=num_answers, max_text_len=TEXT)


def _pixel_boxes(rng, shape):
    """(x1, y1, x2, y2) boxes inside a 640 x 480 image."""
    x1, y1 = rng.uniform(0, 500, shape), rng.uniform(0, 380, shape)
    w, h = rng.uniform(1, 640 - x1), rng.uniform(1, 480 - y1)
    return np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)


def _batch(cfg, b, seed, target=False):
    """``example_batch`` with ragged questions (pads mid-stream) and
    UNITER boxes of pixel boxes; ``target`` adds training targets."""
    batch = example_batch(cfg, b, seed=seed)
    rng = np.random.default_rng(seed + 100)
    lengths = rng.integers(3, TEXT + 1, b)
    lengths[0] = TEXT
    pad = np.arange(TEXT)[None, :] >= lengths[:, None]
    batch["input_ids"][pad] = 0
    batch["input_mask"][pad] = 0
    batch["boxes"] = uniter_box_transform(_pixel_boxes(rng, (b, cfg.encoder.num_objects)))
    if target:
        t = np.zeros((b, cfg.num_answers), np.float32)
        t[np.arange(b), rng.integers(0, cfg.num_answers, b)] = rng.random(b, dtype=np.float32)
        batch["target"] = t
        batch["id_mask"] = (rng.random(b) > 0.3).astype(np.float32)
    return batch


def _jax_params(jax, cfg, batch, seed=0):
    from rgqa_tpu.models.zoo import build_model as jax_build_model

    jmodel, jforward = jax_build_model(cfg)
    params = jmodel.init(jax.random.PRNGKey(seed), *[batch[k] for k in INPUTS])["params"]
    return jax.tree_util.tree_map(np.asarray, params), jforward


def test_box_transform_matches_jax(jax):
    from rgqa_tpu.models.uniter import uniter_box_transform as jax_transform

    boxes = _pixel_boxes(np.random.default_rng(0), (5, 36))
    got = uniter_box_transform(boxes)
    assert got.shape == (5, 36, 7) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_transform(boxes))
    assert got[..., 6].max() > 1e4  # areas of pixel boxes


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(jax, dtype):
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.models.zoo import build_model as jax_build_model

    batch = _batch(_cfg(), 7, seed=3)
    params, _ = _jax_params(jax, _cfg(jax_config), batch)
    bf16 = dtype == "bfloat16"
    _, jforward = jax_build_model(_cfg(jax_config), use_bf16=bf16)
    want = jforward(params, batch, deterministic=True)

    model, forward = build_model(_cfg(), use_bf16=bf16, device="cpu")
    model.load_state_dict(from_jax_params(params), strict=True)
    with torch.no_grad():
        got = forward(_tensors(batch))
    assert got["logits"].dtype == getattr(torch, dtype)
    for key in ("logits", "pooled"):
        g, w = got[key].float().numpy(), np.asarray(want[key], np.float32)
        if bf16:
            np.testing.assert_allclose(g, w, atol=3e-2, rtol=0, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-5, err_msg=key)
    # The mid-stream text pads are masked: other ids there change nothing.
    other = dict(batch, input_ids=np.where(batch["input_mask"] == 1, batch["input_ids"], 7))
    with torch.no_grad():
        again = forward(_tensors(other))
    torch.testing.assert_close(again["logits"], got["logits"], rtol=0, atol=0)


@pytest.mark.parametrize(
    "kw", [{}, {"num_layers": LAYERS}, {"encoder_prefix": "bert.", "answer_head": False},
           {"encoder_prefix": "encoder.model.uniter."}],
    ids=["default", "depth", "bert", "gqa"],
)
def test_key_map_copy_matches_the_original(kw):
    from rgqa_tpu.checkpoint import torch_import as jax_import

    assert port_import.uniter_key_map(**kw) == jax_import.uniter_key_map(**kw)


@pytest.fixture(scope="module")
def weights(jax):
    """(JAX params, the port's state_dict of them, the reference dict)."""
    from rgqa_tpu import config as jax_config

    params, _ = _jax_params(jax, _cfg(jax_config), _batch(_cfg(), 2, seed=0))
    sd = from_jax_params(params)
    return params, sd, to_reference_state_dict(sd, backbone="uniter", num_layers=LAYERS)


def test_reference_pth_loads_through_the_jax_importer(jax, weights, tmp_path):
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.checkpoint.torch_import import import_uniter_gqa

    params, _, ref = weights
    assert all(k.startswith(("encoder.model.uniter.", "logit_fc.")) for k in ref)
    path = str(tmp_path / "gqa_uniter.pth")
    torch.save(ref, path)
    other, _ = _jax_params(jax, _cfg(jax_config), _batch(_cfg(), 2, seed=0), seed=5)
    loaded, missing, unused = import_uniter_gqa(other, path, num_layers=LAYERS)
    assert missing == [] and unused == []
    flat = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(loaded))
    for path_, leaf in flat:
        np.testing.assert_array_equal(np.asarray(got[path_]), leaf)


@pytest.mark.parametrize("prefix", ["encoder.model.uniter.", "uniter.", "bert."])
def test_each_prefix_loads_into_the_port(weights, prefix, tmp_path):
    _, sd, ref = weights
    head = prefix == "encoder.model.uniter."
    renamed = {(k if k.startswith("logit_fc") else prefix + k.removeprefix("encoder.model.uniter.")): v
               for k, v in ref.items() if head or not k.startswith("logit_fc")}
    path = str(tmp_path / "ckpt.pth")
    torch.save({"module." + k: v for k, v in renamed.items()}, path)  # DataParallel's prefix
    loaded, missing, unused = load_reference_pth(path, backbone="uniter", num_layers=LAYERS)
    # A bare encoder has no logit_fc: the key map leaves the head out (the
    # JAX importer's), so the head stays at its init and nothing is missing.
    assert unused == [] and missing == []
    want = {k: v for k, v in sd.items() if head or not k.startswith("answer_head")}
    assert loaded.keys() == want.keys()
    for key, value in want.items():
        torch.testing.assert_close(loaded[key], value, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The uniter7 boxes and the feature pack's box cache.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("uniter_gqa"))
    make_synthetic_gqa(root, SyntheticSpec(n_images=6, n_train=12, n_valid=6, n_testdev=10,
                                           num_boxes=6, feat_dim=40, seed=2))
    return root


def _encode(root, features, backbone, split="testdev"):
    tok = WordPieceTokenizer(load_vocab(f"{root}/vocab.txt"))
    return EncodedGQA(GQADataset(root, split, add_uq=True), features, tokenizer=tok,
                      max_text_len=TEXT, backbone=backbone)


def test_uniter7_boxes_match_jax_encoded(jax, root):
    from rgqa_tpu.data import GQADataset as JaxDataset
    from rgqa_tpu.data.dataset import EncodedGQA as JaxEncoded
    from rgqa_tpu.data.tokenizer import WordPieceTokenizer as JaxTokenizer
    from rgqa_tpu.data.tokenizer import load_vocab as jax_load_vocab
    from rgqa_tpu.data.tsv import PackedFeatures as JaxPacked

    got = _encode(root, PackedFeatures(f"{root}/features"), "uniter")
    want = JaxEncoded(JaxDataset(root, "testdev", add_uq=True), JaxPacked(f"{root}/features"),
                      tokenizer=JaxTokenizer(jax_load_vocab(f"{root}/vocab.txt")),
                      max_text_len=TEXT, backbone="uniter")
    assert got.img_boxes.shape[-1] == 7
    np.testing.assert_array_equal(got.img_boxes, want.img_boxes)
    idx = np.arange(len(got))[::-1]
    gb, wb = got.gather_batch(idx), want.gather_batch(idx, with_target=False)
    for key in INPUTS:
        np.testing.assert_array_equal(gb[key], np.asarray(wb[key]), err_msg=key)


@pytest.mark.parametrize("order", [("lxmert", "uniter"), ("uniter", "lxmert")])
def test_box_cache_keeps_each_backbone_its_own_boxes(root, order):
    features = PackedFeatures(f"{root}/features")
    first, second = (_encode(root, features, b, split) for b, split in zip(order, ("train", "testdev")))
    by = {first.backbone: first, second.backbone: second}
    sizes = np.asarray(features.sizes, np.float32)
    norm = np.asarray(features.boxes, np.float32) / np.concatenate([sizes[:, None, ::-1]] * 2, -1)
    np.testing.assert_allclose(by["lxmert"].img_boxes, np.clip(norm, 0.0, 1.0), rtol=1e-6)
    np.testing.assert_array_equal(by["uniter"].img_boxes, uniter_box_transform(features.boxes))
    assert by["uniter"].gather_batch(np.arange(3))["boxes"].shape == (3, 6, 7)
    assert by["lxmert"].gather_batch(np.arange(3))["boxes"].shape == (3, 6, 4)


# ---------------------------------------------------------------------------
# The 12-step RP trajectory.
# ---------------------------------------------------------------------------


def test_twelve_step_rp_trajectory_matches_jax(jax):
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.config import OptimConfig as JaxOptimConfig
    from rgqa_tpu.train import create_train_state, make_optimizer as jax_make_optimizer
    from rgqa_tpu.train import make_train_step as jax_make_train_step

    b, lr = 6, 2e-3
    batches = [_batch(_cfg(), b, seed=i, target=True) for i in range(N_STEPS)]
    params, jforward = _jax_params(jax, _cfg(jax_config), batches[0])
    state = create_train_state(params, jax_make_optimizer(JaxOptimConfig(lr=lr), N_STEPS))
    jstep = jax_make_train_step(jforward, sample_pair=True, grad_clip=5.0, donate=False)
    key = jax.random.PRNGKey(0)
    jax_losses, shifts = [], []
    for batch in batches:
        key, sub = jax.random.split(key)
        _, aug = jax.random.split(sub)
        shifts.append(int(jax.random.randint(aug, (), 1, b)))
        state, aux = jstep(state, {k: jax.numpy.asarray(v) for k, v in batch.items()}, sub)
        jax_losses.append(float(aux["loss"]))

    model, forward = build_model(_cfg(), device="cpu", train=True)
    model.load_state_dict(from_jax_params(params), strict=True)
    opt = optimizer.make_optimizer(OptimConfig(lr=lr), model.parameters(), t_total=N_STEPS)
    step = tstep.make_train_step(forward, opt, sample_pair=True, grad_clip=5.0, rng=DropoutRng())
    port_losses = [step(_tensors(batch), shift=s)["loss"].item() for batch, s in zip(batches, shifts)]

    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-4)
    assert port_losses[0] != port_losses[-1]  # the weights moved
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, state.params))
    got = model.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-4, err_msg=k)
