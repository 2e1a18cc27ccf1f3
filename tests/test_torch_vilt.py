"""Port parity for ViLT: ``rgqa_tpu_torch.models.vilt`` and its feed
against the JAX package, on the CPU, at the shapes of
``tests/test_vilt.py`` (2 layers, width 32, 4 heads, MLP 64, vocab 256,
64 px images in 16 px patches: 16 patches + CLS, 6 text tokens), f32,
inputs made by numpy from a seed.

- The port's ``ViltForGQA``, with the JAX model's weights through
  ``from_jax_params``, against the JAX ``ViltForGQA`` (XLA attention):
  logits and pooled within rtol 2e-4 / atol 2e-5 (the bar of
  ``tests/test_torch_import.py``), on the f32 wire (pad patches masked
  from content) and on the u8 wire (normalized on the device, mask from
  the rects), each with a pad region that moves the logits, so the
  masking is load-bearing.
- The key-map copy equals the original; a reference ``.pth`` written by
  ``to_reference_state_dict`` loads through the JAX ``import_vilt_gqa``
  and the port's ``load_reference_pth`` to the same weights.
- The images copy against the original (``pixelbert_normalize``,
  ``rect_patch_mask``, ``PixelPack`` rows, the JPEG decode, the
  train-time ``randaug`` bit for bit from the same generator seed), the
  on-device normalize against ``pixelbert_normalize_jnp`` (eager, bit
  for bit), a pack of the port's synthetic generator in the JAX
  ``PixelPack``, and the port's pack detection, which also checks size,
  mode and transform.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from rgqa_tpu_torch import config as port_config
from rgqa_tpu_torch.checkpoint import torch_import as port_import
from rgqa_tpu_torch.checkpoint.convert import (
    from_jax_params,
    load_reference_pth,
    to_reference_state_dict,
)
from rgqa_tpu_torch.data import images as port_images
from rgqa_tpu_torch.data.synthetic import SyntheticSpec, make_synthetic_gqa, make_synthetic_pixel_pack
from rgqa_tpu_torch.models.zoo import build_model, example_batch
from rgqa_tpu_torch.ops.pixels import pixelbert_normalize
from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

ENC = dict(hidden_size=32, num_heads=4, intermediate_size=64, vocab_size=256, num_layers=2)
MODEL = dict(backbone="vilt", num_answers=7, max_text_len=6, vilt_patch_size=16, vilt_image_size=64)
RTOL, ATOL = 2e-4, 2e-5


def _cfg(config, **kw):
    return config.ModelConfig(encoder=config.EncoderConfig(**ENC), **dict(MODEL, **kw))


def _models(**kw):
    """(jax forward, jax params, port model, port forward) sharing weights."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.models import zoo as jax_zoo

    cfg = _cfg(jax_config, **kw)
    jmodel, jforward = jax_zoo.build_model(cfg)
    b = jax_zoo.example_batch(cfg, batch_size=2, seed=0)
    params = jmodel.init(
        jax.random.PRNGKey(3), *(jnp.asarray(b[k]) for k in ("input_ids", "input_mask", "pixels"))
    )["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    model, forward = build_model(_cfg(port_config, **kw), device="cpu")
    model.load_state_dict(from_jax_params(params))
    return jforward, params, model, forward


@pytest.fixture(scope="module")
def models():
    return _models()


@pytest.fixture(scope="module")
def models_263():
    """As ``models`` at 256 px images: 16^2 patches + CLS + 6 text tokens,
    a 263-token stream, past the long kernels' old cap of 256 keys."""
    return _models(vilt_image_size=256)


def _both(models, batch, **kw):
    """The JAX and the port's outputs on one numpy batch, as numpy."""
    import jax.numpy as jnp

    jforward, params, _, forward = models
    want = jforward(params, {k: jnp.asarray(v) for k, v in batch.items()},
                    **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        got = forward({k: torch.from_numpy(v) for k, v in batch.items()},
                      **{k: torch.from_numpy(v) for k, v in kw.items()})
    return ({k: np.asarray(want[k]) for k in ("logits", "pooled")},
            {k: got[k].numpy() for k in ("logits", "pooled")})


def _assert_close(want, got):
    for key in ("logits", "pooled"):
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, atol=ATOL, err_msg=key)


def _text(rng, b):
    ids = rng.integers(1, 256, (b, 6)).astype(np.int32)
    mask = np.ones((b, 6), np.int32)
    mask[0, 4:] = 0  # padded text in row 0
    return ids, mask


def test_example_batch_draws_match_jax():
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.models import zoo as jax_zoo

    got = example_batch(_cfg(port_config), 3, seed=4)
    want = jax_zoo.example_batch(_cfg(jax_config), 3, seed=4)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_f32_wire_matches_jax_with_content_mask(models):
    rng = np.random.default_rng(0)
    ids, mask = _text(rng, 3)
    pixels = rng.standard_normal((3, 64, 64, 3), dtype=np.float32)
    pixels[:2, :16] = 0.0  # pad band: patch row 0 of rows 0 and 1
    pixels[1, :, 48:] = 0.0  # and patch column 3 of row 1
    batch = {"input_ids": ids, "input_mask": mask, "pixels": pixels}
    want, got = _both(models, batch)
    _assert_close(want, got)
    # The content mask is load-bearing: a port that let the pad patches
    # in would fail the parity bound.
    _, open_ = _both(models, batch, pixel_mask=np.ones((3, 16), np.int32))
    assert not np.allclose(open_["logits"], want["logits"], rtol=RTOL, atol=ATOL)


def test_u8_wire_matches_jax_with_rect_mask(models):
    rng = np.random.default_rng(1)
    ids, mask = _text(rng, 3)
    u8 = rng.integers(0, 256, (3, 64, 64, 3)).astype(np.uint8)
    rects = np.asarray([[0, 0, 64, 64], [8, 0, 40, 64], [0, 20, 64, 24]], np.int32)
    pmask = port_images.rect_patch_mask(rects, 64, 16)
    assert pmask[1:].min() == 0  # rows 1 and 2 have pad patches
    batch = {"input_ids": ids, "input_mask": mask, "pixels_u8": u8, "pixel_rect": rects,
             "pixel_mask": pmask}
    want, got = _both(models, batch)
    _assert_close(want, got)
    _, open_ = _both(models, batch, pixel_mask=np.ones((3, 16), np.uint8))
    assert not np.allclose(open_["logits"], want["logits"], rtol=RTOL, atol=ATOL)


def test_u8_wire_matches_jax_beyond_256_tokens(models_263):
    rng = np.random.default_rng(2)
    ids, mask = _text(rng, 2)
    u8 = rng.integers(0, 256, (2, 256, 256, 3)).astype(np.uint8)
    rects = np.asarray([[0, 0, 256, 256], [0, 40, 256, 170]], np.int32)
    pmask = port_images.rect_patch_mask(rects, 256, 16)
    assert pmask.shape == (2, 256) and pmask[1].min() == 0  # row 1 has pad patches
    batch = {"input_ids": ids, "input_mask": mask, "pixels_u8": u8, "pixel_rect": rects,
             "pixel_mask": pmask}
    want, got = _both(models_263, batch)
    _assert_close(want, got)
    _, open_ = _both(models_263, batch, pixel_mask=np.ones((2, 256), np.uint8))
    assert not np.allclose(open_["logits"], want["logits"], rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_vilt_beyond_256_tokens_matches_plain_on_card():
    # 512 px images in 16 px patches: 1024 patches + CLS + 6 text tokens,
    # f32, through #2's key-tiled body against the plain attention.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rgqa_tpu_torch.ops import attention as att

    cfg = _cfg(port_config, vilt_image_size=512)
    _, forward = build_model(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    batch = {k: torch.from_numpy(v).cuda() for k, v in example_batch(cfg, 3, seed=1).items()}
    before = att.fused_attention_long_cuda.launches
    with torch.no_grad():
        got, want = forward(batch), forward(batch, use_fused=False)
    torch.cuda.synchronize()
    assert att.fused_attention_long_cuda.launches == before + 2  # one per layer
    for key in ("logits", "pooled"):
        assert torch.isfinite(got[key]).all()
        torch.testing.assert_close(got[key], want[key], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("num_layers", [2, 12])
def test_key_map_copy_matches_the_original(num_layers):
    from rgqa_tpu.checkpoint import torch_import as jax_import

    assert port_import.vilt_key_map(num_layers) == jax_import.vilt_key_map(num_layers)


def test_reference_pth_round_trip(models, tmp_path):
    from rgqa_tpu.checkpoint.torch_import import import_vilt_gqa

    _, params, model, _ = models
    ref = to_reference_state_dict(model.state_dict(), backbone="vilt", num_layers=2)
    assert ref["transformer.blocks.0.attn.qkv.weight"].shape == (96, 32)  # fused, as GQAViLT
    assert ref["transformer.patch_embed.proj.weight"].shape == (32, 3, 16, 16)
    path = str(tmp_path / "vilt.pth")
    torch.save(ref, path)

    loaded, missing, unused = import_vilt_gqa(params, path, num_layers=2)  # fills a copy
    assert missing == [] and unused == []
    flat_want = dict(_leaves(params))
    for key, val in _leaves(loaded):
        np.testing.assert_array_equal(np.asarray(val), flat_want[key], err_msg=key)

    sd, missing, unused = load_reference_pth(path, backbone="vilt", num_layers=2)
    assert missing == [] and unused == []
    want_sd = model.state_dict()
    assert sd.keys() == want_sd.keys()
    for key in sd:
        torch.testing.assert_close(sd[key], want_sd[key], rtol=0, atol=0)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_from_jax_params_raises_on_a_missing_or_leftover_parameter(models):
    _, params, _, _ = models
    extra = dict(params, stray={"kernel": np.zeros(2)})
    with pytest.raises(ValueError, match="stray"):
        from_jax_params(extra)
    missing = {k: v for k, v in params.items() if k != "pos_embed"}
    with pytest.raises(KeyError, match="pos_embed"):
        from_jax_params(missing, backbone="vilt")


# ---------------------------------------------------------------------------
# Images.
# ---------------------------------------------------------------------------


def _img(seed=0, w=300, h=100):
    from PIL import Image

    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8))


@pytest.mark.parametrize("mode", ["pad", "crop"])
def test_images_copy_matches_the_original(mode):
    from rgqa_tpu.data import images as jax_images

    img = _img(seed=1 if mode == "pad" else 2)
    u8, rect = port_images.pixelbert_u8(img, 64, mode=mode)
    ju8, jrect = jax_images.pixelbert_u8(img, 64, mode=mode)
    np.testing.assert_array_equal(u8, ju8)
    np.testing.assert_array_equal(rect, jrect)
    np.testing.assert_array_equal(
        port_images.pixelbert_normalize(u8, rect), jax_images.pixelbert_normalize(u8, rect)
    )
    rects = np.asarray([[0, 0, 64, 64], [11, 0, 42, 64], [0, 5, 64, 17], [3, 40, 1, 1]], np.int32)
    for patch in (16, 32):
        np.testing.assert_array_equal(
            port_images.rect_patch_mask(rects, 64, patch), jax_images.rect_patch_mask(rects, 64, patch)
        )


@pytest.mark.parametrize("mode", ["pad", "crop"])
def test_randaug_matches_the_original(mode):
    pytest.importorskip("PIL")
    from rgqa_tpu.data import images as jax_images

    img = _img(seed=3, w=120, h=80)
    plain, _ = port_images.pixelbert_u8(img, 64, mode=mode)
    ops, changed = set(), False
    for seed in range(12):  # enough draws to pick every op
        u8, rect = port_images.pixelbert_u8(img, 64, rng=np.random.default_rng(seed), mode=mode)
        ju8, jrect = jax_images.pixelbert_u8(img, 64, rng=np.random.default_rng(seed), mode=mode)
        np.testing.assert_array_equal(u8, ju8, err_msg=f"seed {seed}")
        np.testing.assert_array_equal(rect, jrect)
        changed |= not np.array_equal(u8, plain)
        draws = np.random.default_rng(seed)  # randaug's draws: an op, then its magnitude
        for _ in range(2):
            ops.add(int(draws.integers(6)))
            draws.random()
    assert ops == set(range(6)) and changed


def test_device_normalize_matches_jnp_bit_for_bit():
    import jax.numpy as jnp
    from rgqa_tpu.ops.pixels import pixelbert_normalize_jnp

    rng = np.random.default_rng(5)
    u8 = rng.integers(0, 256, (4, 32, 32, 3)).astype(np.uint8)
    rects = np.asarray([[0, 0, 32, 32], [4, 0, 20, 32], [0, 7, 32, 9], [31, 31, 1, 1]], np.int32)
    got = pixelbert_normalize(torch.from_numpy(u8), torch.from_numpy(rects)).numpy()
    np.testing.assert_array_equal(got, np.asarray(pixelbert_normalize_jnp(jnp.asarray(u8), jnp.asarray(rects))))
    for i in range(4):  # and the host normalize of either package, row by row
        np.testing.assert_array_equal(got[i], port_images.pixelbert_normalize(u8[i], rects[i]))


def test_synthetic_pack_reads_alike_in_both_packages(tmp_path):
    from rgqa_tpu.data import images as jax_images

    root = str(tmp_path / "gqa")
    make_synthetic_gqa(root, SyntheticSpec(n_images=5, n_train=4, n_valid=2, n_testdev=4,
                                           num_boxes=3, feat_dim=48, seed=2))
    pack = make_synthetic_pixel_pack(root, 64, "pad")
    jpack = jax_images.PixelPack(os.path.join(root, "pixels_64_pad"))
    assert jpack.matches_source(os.path.join(root, "images"))
    assert (jpack.size, jpack.mode, jpack.transform) == (64, "pad", "pixelbert")
    assert jpack.img_ids == pack.img_ids and len(pack.img_ids) == 5
    for img_id in pack.img_ids:
        for a, b in zip(pack.load_u8(img_id), jpack.load_u8(img_id)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(pack.load(img_id), jpack.load(img_id))
    u8, rect = pack.load_u8(pack.img_ids[0])
    assert tuple(rect) == (0, 0, 64, 64)  # square images: the whole frame is real
    base = np.load(os.path.join(root, "synthetic_images_u8.npy"))
    np.testing.assert_array_equal(u8[::2, ::2], base[0])  # nearest neighbour, 32 -> 64


def test_jpeg_source_matches_the_original(tmp_path):
    from rgqa_tpu.data import images as jax_images

    img_dir = tmp_path / "images"
    img_dir.mkdir()
    _img(seed=7, w=90, h=60).save(img_dir / "a.jpg")
    port = port_images.GQAImageSource(str(img_dir), size=64, mode="pad")
    jax_src = jax_images.GQAImageSource(str(img_dir), size=64, mode="pad")
    assert "a" in port and "b" not in port
    for a, b in zip(port_images.load_image_batch_u8(port, ["a"]),
                    jax_images.load_image_batch_u8(jax_src, ["a"])):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port_images.load_image_batch(port, ["a"]),
                                  jax_images.load_image_batch(jax_src, ["a"]))


@pytest.mark.parametrize(
    "change", [{}, {"size": 32}, {"mode": "crop"}, {"transform": "clip"}, {"img_root": "/elsewhere"}],
    ids=["match", "size", "mode", "transform", "source"],
)
def test_pack_detection_checks_size_mode_and_transform(tmp_path, change):
    """The JAX runner takes any pack built from the image root
    (``rgqa_tpu/runner.py:287-295``); the port also wants this run's size,
    mode and transform, and decodes the JPEGs otherwise."""
    from rgqa_tpu_torch.data.images import GQAImageSource, PixelPack
    from rgqa_tpu_torch.runner import GQARunner

    root = str(tmp_path / "gqa")
    make_synthetic_gqa(root, SyntheticSpec(n_images=4, n_train=4, n_valid=2, n_testdev=4,
                                           num_boxes=3, feat_dim=48, seed=1))
    pack_dir = make_synthetic_pixel_pack(root, 64, "pad").dir
    meta_path = os.path.join(pack_dir, "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta.update(change)  # the pack's bytes stay; only its claims differ
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    cfg = port_config.RunConfig(
        model=dataclasses.replace(_cfg(port_config), num_answers=7),
        train=port_config.TrainConfig(batch_size=4, use_bf16=False),
        data=port_config.DataConfig(data_root=root, test_splits="testdev", synthetic=True),
        output=str(tmp_path / "out"),
    )
    if change.get("size"):  # a smaller pack file than the header says: do not map it
        os.remove(os.path.join(pack_dir, "pixels_u8.bin"))
        np.zeros((4, 32, 32, 3), np.uint8).tofile(os.path.join(pack_dir, "pixels_u8.bin"))
    source = GQARunner(cfg, init_train=False, device="cpu").image_source
    if change:
        assert isinstance(source, GQAImageSource)
    else:
        assert isinstance(source, PixelPack) and source.dir == pack_dir
