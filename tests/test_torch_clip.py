"""The CLIP slice on the CPU: the port's CLIP model, scorer, pixel pack and
``--scorer clip`` against the JAX package's, on the same weights.

A tiny HF-layout CLIP checkpoint directory (``config.json``,
``pytorch_model.bin`` with HF's ``position_ids`` buffers, ``vocab.json``,
``merges.txt``) is written once from the port's seeded init, its
LayerNorm parameters and logit scale moved off their init values; the
JAX package reads it through ``import_clip``.  Bounds: f32 on both
sides, sums in another order, so image and text features and the
cosine within rtol 2e-4 / atol 2e-5, in both EOT-pooling modes and with
padded text; prediction JSONs (4 dp) with equal answers and confidences
within one rounding step.

- The copies (tokenizer, ``clip_key_map``, the image functions, the
  device-side normalize) equal their originals on the same inputs.
- ``from_jax_params`` of the JAX tree and the HF-directory loader give
  the same port weights, bit for bit.
- ``ClipScorer`` (scores, embeddings, weight similarity) against the
  JAX ``ClipScorer``.
- ``clip_ood_evaluate`` and the evaluate CLI (``--scorer clip``) against
  the JAX runner's and the JAX CLI's over one synthetic root and the
  CLIP pack the port's synthetic root writes; ``pack_pixels`` and
  ``prepare_data --pixel_transform clip`` against the JAX packer.
- The refusals: an orbax ``jax_params/`` checkpoint without the
  ``pytorch_model.bin`` that ``orbax_to_pth.py`` writes beside it (with
  it, the directory loads), a checkpoint with a missing key, ``--scorer clip`` without ``--clip_path``, and a root
  with neither a matching pack nor JPEGs and PIL (named, with the
  ``prepare_data`` command).
- ``--scorer clip`` runs in a subprocess with jax and the JAX package
  blocked.
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from rgqa_tpu_torch.checkpoint import torch_import as port_import
from rgqa_tpu_torch.checkpoint.convert import from_jax_params, load_clip_state_dict
from rgqa_tpu_torch.cli import evaluate
from rgqa_tpu_torch.data import clip_tokenizer as port_tok
from rgqa_tpu_torch.data.synthetic import SyntheticSpec, make_synthetic_gqa, make_synthetic_pixel_pack
from rgqa_tpu_torch.models.clip import ClipModel, clip_config_from_hf, init_clip_weights
from rgqa_tpu_torch.ops import pixels as port_pixels
from rgqa_tpu_torch.scorers import clip as port_clip

from test_torch_slice import CLI_SPEC, TINY_FLAGS
from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

RTOL, ATOL = 2e-4, 2e-5
HF_CONFIG = dict(
    projection_dim=20,
    logit_scale_init_value=2.6592,
    text_config=dict(hidden_size=16, num_hidden_layers=2, num_attention_heads=4, intermediate_size=32,
                     vocab_size=600, max_position_embeddings=12, eos_token_id=2),
    vision_config=dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
                       image_size=32, patch_size=16),
)
SENTENCES = ["Is there a red apple on the table?", "What color is the dog's tail?", "the THE   The",
             "hello, world!! 12 cats AND a dog.", "what is this", "a_b c'd'll 3.5 été"]
FIRST_EOS = 599  # a re-exported config's real EOT id: pooled at its first occurrence


def _tiny_vocab(directory):
    """A valid byte-level BPE vocab: the byte alphabet (+ ``</w>``), a few
    merges, the specials last (EOT the highest id, as in CLIP's)."""
    b2u = port_tok.bytes_to_unicode()
    tokens = list(b2u.values()) + [t + "</w>" for t in b2u.values()]
    merges = [("t", "h"), ("th", "e</w>"), ("i", "s</w>"), ("a", "n"), ("an", "d</w>"), ("o", "n</w>"),
              ("r", "e"), ("re", "d</w>"), ("c", "a"), ("ca", "t</w>"), ("d", "o"), ("do", "g</w>"),
              ("w", "h"), ("wh", "a"), ("wha", "t</w>"), ("th", "e"), ("'", "s</w>")]
    tokens += [a + b for a, b in merges if a + b not in tokens]
    tokens += ["<|startoftext|>", "<|endoftext|>"]
    with open(os.path.join(directory, "vocab.json"), "w") as f:
        json.dump({t: i for i, t in enumerate(tokens)}, f)
    with open(os.path.join(directory, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))


def write_clip_dir(directory, config=HF_CONFIG, seed=0):
    """An HF CLIP checkpoint directory from the port's seeded init, with
    LayerNorm parameters and the logit scale moved off the init."""
    os.makedirs(directory, exist_ok=True)
    model = ClipModel(clip_config_from_hf(config))
    gen = torch.Generator().manual_seed(seed)
    init_clip_weights(model, gen)
    sd = model.state_dict()
    for key, value in sd.items():
        if "norm" in key:
            value.add_(0.1 * torch.randn(value.shape, generator=gen))
    sd["logit_scale"].fill_(3.1)
    cfg = clip_config_from_hf(config)
    sd["vision_model.embeddings.position_ids"] = torch.arange(cfg.num_patches + 1)[None]
    sd["text_model.embeddings.position_ids"] = torch.arange(cfg.max_text_len)[None]
    torch.save(sd, os.path.join(directory, "pytorch_model.bin"))
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(config, f)
    _tiny_vocab(directory)
    return str(directory)


@pytest.fixture(scope="module")
def clip_dir(tmp_path_factory):
    return write_clip_dir(tmp_path_factory.mktemp("clip") / "ckpt")


def _jax_clip(path, config):
    import jax

    from rgqa_tpu.checkpoint import import_clip
    from rgqa_tpu.models.clip import ClipModel as JaxClip
    from rgqa_tpu.models.clip import clip_config_from_hf as jax_config_from_hf

    jcfg = jax_config_from_hf(config)
    jmodel = JaxClip(jcfg)
    shapes = jax.eval_shape(
        lambda *a: jmodel.init(jax.random.PRNGKey(0), *a),
        np.zeros((1, jcfg.max_text_len), np.int32), np.ones((1, jcfg.max_text_len), np.int32),
        np.zeros((1, jcfg.image_size, jcfg.image_size, 3), np.float32),
    )["params"]
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    params, missing, unused = import_clip(template, os.path.join(path, "pytorch_model.bin"),
                                          vision_layers=jcfg.vision.num_layers,
                                          text_layers=jcfg.text.num_layers)
    assert not missing and not unused
    return jmodel, params


@pytest.fixture(scope="module")
def jax_clip(clip_dir):
    pytest.importorskip("jax")
    return _jax_clip(clip_dir, HF_CONFIG)


def _inputs(eos, b=5, seed=1):
    """Random ids of random lengths, EOT at the end of each (the vocab's
    highest id for argmax pooling, ``FIRST_EOS`` repeated to the end
    otherwise), padded; standard-normal pixels."""
    rng = np.random.default_rng(seed)
    s, vocab = 12, 600
    ids = rng.integers(5, vocab - 1, (b, s)).astype(np.int32)
    mask = np.zeros((b, s), np.int32)
    for i, n in enumerate(rng.integers(3, s, b)):
        mask[i, :n] = 1
        if eos == 2:
            ids[i, n - 1], ids[i, n:] = vocab - 1, 3
        else:
            ids[i, n - 1 :] = eos
    pixels = rng.standard_normal((b, 32, 32, 3)).astype(np.float32)
    return ids, mask, pixels


def test_tokenizer_copy_matches_the_original(clip_dir):
    from rgqa_tpu.data import clip_tokenizer as jax_tok

    assert port_tok.bytes_to_unicode() == jax_tok.bytes_to_unicode()
    mine = port_tok.ClipBPETokenizer.from_dir(clip_dir)
    ref = jax_tok.ClipBPETokenizer.from_dir(clip_dir)
    for sent in SENTENCES:
        assert mine.tokenize(sent) == ref.tokenize(sent), sent
    for max_len in (6, 12):
        got, want = mine.encode_batch(SENTENCES, max_len), ref.encode_batch(SENTENCES, max_len)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype


@pytest.mark.parametrize("layers", [(2, 2), (12, 12), (3, 5)])
def test_clip_key_map_copy_matches_the_original(layers):
    from rgqa_tpu.checkpoint import torch_import as jax_import

    assert port_import.clip_key_map(*layers) == jax_import.clip_key_map(*layers)


def test_image_functions_match_the_originals():
    from PIL import Image

    from rgqa_tpu.ops.pixels import clip_normalize_jnp
    from rgqa_tpu.scorers import clip as jax_clip_scorer

    rng = np.random.default_rng(0)
    for h, w in ((48, 64), (100, 40), (32, 32), (33, 77)):
        img = Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8))
        got, want = port_clip.clip_resize_crop(img, 32), jax_clip_scorer.clip_resize_crop(img, 32)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(port_clip.clip_preprocess(img, 24), jax_clip_scorer.clip_preprocess(img, 24))
    u8 = rng.integers(0, 256, (3, 8, 8, 3), np.uint8)
    host = port_clip.clip_normalize(u8)
    np.testing.assert_array_equal(host, jax_clip_scorer.clip_normalize(u8))
    # The device-side normalize: the same f32 expression, the same bits.
    np.testing.assert_array_equal(port_pixels.clip_normalize(torch.from_numpy(u8)).numpy(), host)
    np.testing.assert_allclose(port_pixels.clip_normalize(torch.from_numpy(u8)).numpy(),
                               np.asarray(clip_normalize_jnp(u8)), rtol=2e-7, atol=0)
    sims = rng.standard_normal(9)
    np.testing.assert_array_equal(port_clip.clip_loss_weights(sims, 0.5),
                                  jax_clip_scorer.clip_loss_weights(sims, 0.5))


def test_from_jax_params_matches_the_hf_loader(clip_dir, jax_clip):
    _, params = jax_clip
    got = from_jax_params(params, "clip")
    assert from_jax_params(params).keys() == got.keys()  # the backbone read off the tree
    want = load_clip_state_dict(clip_dir)
    assert got.keys() == want.keys() == ClipModel(clip_config_from_hf(HF_CONFIG)).state_dict().keys()
    for key in want:
        torch.testing.assert_close(got[key], want[key].float(), rtol=0, atol=0, msg=key)


@pytest.mark.parametrize("eos", [2, FIRST_EOS], ids=["argmax_eot", "first_eos"])
def test_clip_model_matches_jax(clip_dir, jax_clip, eos):
    from rgqa_tpu.models.clip import ClipModel as JaxClip
    from rgqa_tpu.models.clip import clip_config_from_hf as jax_config_from_hf

    config = dict(HF_CONFIG, text_config=dict(HF_CONFIG["text_config"], eos_token_id=eos))
    jmodel = JaxClip(jax_config_from_hf(config))
    params = jax_clip[1]
    model = ClipModel(clip_config_from_hf(config))
    assert model.text_model.eos_token_id == eos
    model.load_state_dict(load_clip_state_dict(clip_dir))
    ids, mask, pixels = _inputs(eos)
    apply = lambda method, *a: np.asarray(jmodel.apply({"params": params}, *a, method=method))  # noqa: E731
    t = [torch.from_numpy(x) for x in (ids, mask, pixels)]
    with torch.no_grad():
        img, txt = model.image_features(t[2]).numpy(), model.text_features(t[0], t[1]).numpy()
        cos = model.cosine(*t).numpy()
        out = model(*t)
    np.testing.assert_allclose(img, apply(JaxClip.image_features, pixels), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(txt, apply(JaxClip.text_features, ids, mask), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(cos, apply(JaxClip.cosine, ids, mask, pixels), rtol=RTOL, atol=ATOL)
    jout = jmodel.apply({"params": params}, ids, mask, pixels)
    for key in ("image_embeds", "text_embeds", "logits_per_image", "logits_per_text"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(jout[key]), rtol=RTOL, atol=ATOL, err_msg=key)
    # Padded rows add the causal and padding terms to -inf: no NaN.
    assert np.isfinite(txt).all() and (mask == 0).any()


def test_text_mask_stays_finite_and_pads_change_nothing(clip_dir):
    """Every text row keeps its own position visible: no NaN, and what
    follows a row's EOT moves nothing before it."""
    model = ClipModel(clip_config_from_hf(HF_CONFIG))
    model.load_state_dict(load_clip_state_dict(clip_dir))
    ids, mask, _ = _inputs(2)
    other = ids.copy()
    other[mask == 0] = 7
    with torch.no_grad():
        a = model.text_features(torch.from_numpy(ids), torch.from_numpy(mask))
        b = model.text_features(torch.from_numpy(other), torch.from_numpy(mask))
    assert torch.isfinite(a).all()
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.fixture(scope="module")
def scorers(clip_dir):
    pytest.importorskip("jax")
    from rgqa_tpu.scorers.clip import ClipScorer as JaxScorer

    return port_clip.ClipScorer(clip_dir, batch_size=4, device="cpu"), JaxScorer(clip_dir, backend="jax",
                                                                                  batch_size=4)


def test_clip_scorer_matches_jax(scorers):
    port, jax_scorer = scorers
    assert port.image_size == jax_scorer.image_size == 32 and port.consumes_uint8_rows
    rng = np.random.default_rng(3)
    rows = list(rng.integers(0, 256, (len(SENTENCES), 32, 32, 3), np.uint8))
    np.testing.assert_allclose(port.scores(rows, SENTENCES), jax_scorer.scores(rows, SENTENCES),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(port.weight_similarity(rows, SENTENCES),
                               jax_scorer.weight_similarity(rows, SENTENCES), rtol=RTOL, atol=1e-4)
    assert port.logit_scale == pytest.approx(jax_scorer.logit_scale, rel=1e-6)
    np.testing.assert_allclose(port.image_embeds(rows), jax_scorer.image_embeds(rows), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(port.text_embeds(SENTENCES), jax_scorer.text_embeds(SENTENCES),
                               rtol=RTOL, atol=ATOL)


def test_checkpoint_refusals(clip_dir, tmp_path):
    # A JAX export (clip_params/: jax_params/ and no .bin) is refused,
    # naming the command that exports it; with that export's .bin beside
    # jax_params/ the directory loads.
    orbax = tmp_path / "exported"
    shutil.copytree(clip_dir, orbax)
    os.remove(orbax / "pytorch_model.bin")
    (orbax / "jax_params").mkdir()
    with pytest.raises(NotImplementedError, match="--clip_path an orbax snapshot directory.*orbax_to_pth.py"):
        port_clip.ClipScorer(str(orbax), device="cpu")
    shutil.copy(os.path.join(clip_dir, "pytorch_model.bin"), orbax / "pytorch_model.bin")
    assert port_clip.ClipScorer(str(orbax), device="cpu").logit_scale > 0
    broken = tmp_path / "broken"
    shutil.copytree(clip_dir, broken)
    sd = torch.load(broken / "pytorch_model.bin", weights_only=True)
    del sd["vision_model.post_layernorm.weight"]
    os.remove(broken / "pytorch_model.bin")
    torch.save(sd, broken / "model.bin")  # the other file name a directory may hold
    with pytest.raises(ValueError, match="missing keys.*post_layernorm"):
        port_clip.ClipScorer(str(broken), device="cpu")


# ---------------------------------------------------------------------------
# The scoring path: clip_ood_evaluate and --scorer clip.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cli_env(tmp_path_factory, clip_dir):
    """A synthetic root at the CLI's width with its CLIP pack, and a tiny
    LXMERT answerer's ``.pth`` written from a JAX runner."""
    pytest.importorskip("jax")
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.runner import GQARunner as JaxRunner
    from rgqa_tpu.runner import np_params
    from rgqa_tpu_torch.checkpoint.convert import to_reference_state_dict

    from test_torch_scoring_slice import _spread

    tmp = tmp_path_factory.mktemp("clip_cli")
    root = str(tmp / "gqa")
    make_synthetic_gqa(root, SyntheticSpec(**CLI_SPEC))
    make_synthetic_pixel_pack(root, 32, transform="clip")
    flags = [f for f in TINY_FLAGS if f not in ("--device", "cpu")]
    cfg, _ = jax_config.parse_cli(["--synthetic", "--data_root", root, "--test", "testdev",
                                   "--output", str(tmp / "init"), *flags])
    jax_runner = JaxRunner(cfg, init_train=False)
    pth = str(tmp / "gqa.pth")
    torch.save(to_reference_state_dict(from_jax_params(_spread(np_params(jax_runner.params))),
                                       l_layers=1, x_layers=1, r_layers=1), pth)
    return root, tmp, pth, flags


def _argv(root, out, pth, clip_dir):
    return ["--synthetic", "--data_root", root, "--test", "testdev", "--output", out, "--load", pth,
            "--scorer", "clip", "--clip_path", clip_dir]


def _rows(path):
    with open(path) as f:
        return json.load(f)


def test_cli_scorer_clip_matches_the_jax_cli(cli_env, clip_dir):
    from rgqa_tpu.cli import evaluate as jax_evaluate

    root, tmp, pth, flags = cli_env
    jout, pout = str(tmp / "jax_cli"), str(tmp / "port_cli")
    want = jax_evaluate.main(_argv(root, jout, pth, clip_dir) + flags)["testdev"]
    got = evaluate.main(_argv(root, pout, pth, clip_dir) + TINY_FLAGS)["testdev"]
    prows, jrows = _rows(os.path.join(pout, "testdev_predict.json")), _rows(os.path.join(jout, "testdev_predict.json"))
    assert len(prows) == CLI_SPEC["n_testdev"]
    assert [(r["questionId"], r["prediction"]) for r in prows] == [(r["questionId"], r["prediction"]) for r in jrows]
    np.testing.assert_allclose([r["confidence"] for r in prows], [r["confidence"] for r in jrows], atol=1e-4)
    assert len({r["confidence"] for r in prows}) > 1 and all(-1 <= r["confidence"] <= 1 for r in prows)
    assert got.keys() == want.keys() and {"auaf", "fpr@0.95acc", "full_acc"} <= got.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-12, err_msg=key)


def test_clip_ood_evaluate_matches_the_jax_runner(cli_env, clip_dir, scorers, monkeypatch):
    """The runners' own method, full-precision confidences; the pack's
    rows feed both (the port's synthetic root has no JPEGs, and PIL is
    blocked for the port's run)."""
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.data import GQADataset as JaxDataset
    from rgqa_tpu.runner import GQARunner as JaxRunner
    from rgqa_tpu_torch.config import parse_cli
    from rgqa_tpu_torch.data.dataset import GQADataset
    from rgqa_tpu_torch.runner import GQARunner

    root, tmp, pth, flags = cli_env
    port_scorer, jax_scorer = scorers
    argv = ["--synthetic", "--data_root", root, "--test", "testdev", "--load", pth, *flags]
    jcfg, _ = jax_config.parse_cli(argv + ["--output", str(tmp / "jax_runner")])
    pcfg, _ = parse_cli(argv + ["--output", str(tmp / "port_runner")])
    jax_runner, runner = JaxRunner(jcfg, init_train=False), GQARunner(pcfg, init_train=False, device="cpu")
    img_root = os.path.join(root, "images")
    jax_runner.clip_ood_evaluate(jax_runner._encode(JaxDataset(root, "testdev", add_uq=True)),
                                 jax_scorer.scores, img_root, dump=str(tmp / "j.json"))
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    runner.clip_ood_evaluate(runner._encode(GQADataset(root, "testdev", add_uq=True)), port_scorer.scores,
                             img_root, dump=str(tmp / "p.json"), batch_size=7)
    want = {r["questionId"]: (r["prediction"], r["confidence"]) for r in _rows(tmp / "j.json")}
    got = {r["questionId"]: (r["prediction"], r["confidence"]) for r in _rows(tmp / "p.json")}
    assert got.keys() == want.keys()
    assert {q: a for q, (a, _) in got.items()} == {q: a for q, (a, _) in want.items()}
    np.testing.assert_allclose([got[q][1] for q in want], [want[q][1] for q in want], atol=1e-4)


def test_a_root_without_pack_jpegs_or_pil_is_refused_by_name(cli_env, clip_dir, tmp_path, monkeypatch):
    root, _, pth, _ = cli_env
    bare = str(tmp_path / "gqa")
    shutil.copytree(root, bare, ignore=shutil.ignore_patterns("pixels_clip_*", "synthetic_images_u8.npy"))
    argv = ["--data_root", bare, "--test", "testdev", "--output", str(tmp_path / "out"), "--load", pth,
            "--scorer", "clip", "--clip_path", clip_dir, *TINY_FLAGS]
    with pytest.raises(RuntimeError, match=r"pixels_clip_32.*JPEGs under .*images.*prepare_data .*"
                                           r"--pixel_transform clip --pixel_size 32"):
        evaluate.main(argv)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(RuntimeError, match="decoding the JPEGs needs PIL, 20 JPEGs|needs PIL"):
        evaluate.main(argv)
    # A pack of another size does not stand in either.
    make_synthetic_pixel_pack(root, 16, transform="clip")
    shutil.copytree(os.path.join(root, "pixels_clip_16"), os.path.join(bare, "pixels_clip_32"))
    with pytest.raises(RuntimeError, match="needs PIL"):
        evaluate.main(argv)


def test_cli_needs_the_clip_path(tmp_path):
    with pytest.raises(SystemExit, match="--scorer clip needs --clip_path"):
        evaluate.main(["--synthetic", "--data_root", str(tmp_path), "--test", "testdev", "--output",
                       str(tmp_path / "out"), "--scorer", "clip", *TINY_FLAGS])


def _jpegs(directory):
    from PIL import Image

    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(1)
    for i, (h, w) in enumerate([(48, 96), (90, 60), (64, 64)]):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(directory, f"img{i:04d}.jpg"))
    return directory


def test_clip_pack_matches_the_jax_pack(tmp_path):
    pytest.importorskip("PIL")
    from rgqa_tpu.data.images import pack_pixels as jax_pack_pixels
    from rgqa_tpu_torch.data.images import PixelPack, pack_pixels

    from test_torch_prepare_data import _tree

    img_root = _jpegs(str(tmp_path / "images"))
    pack = pack_pixels(img_root, str(tmp_path / "port"), size=40, transform="clip")
    jax_pack_pixels(img_root, str(tmp_path / "jax"), size=40, transform="clip")
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    assert isinstance(pack, PixelPack) and (pack.transform, pack.size, pack.mode) == ("clip", 40, None)


def test_prepare_data_writes_the_jax_clip_pack(tmp_path):
    """``prepare_data --pixel_transform clip`` (default 224 px) writes
    the JAX CLI's root, ``pixels_clip_224/`` included."""
    pytest.importorskip("PIL")
    from rgqa_tpu.cli import prepare_data as jax_prepare_data
    from rgqa_tpu_torch.cli import prepare_data

    from test_torch_prepare_data import _tree, _write_tsv

    tsv = _write_tsv(str(tmp_path / "obj.tsv"))
    json_dir = tmp_path / "json"
    json_dir.mkdir()
    (json_dir / "train.json").write_text("[]")
    (json_dir / "vocab.txt").write_text("[PAD]\n[UNK]\n")
    argv = ["--tsv", tsv, "--json_dir", str(json_dir), "--vocab", str(json_dir / "vocab.txt"),
            "--pack_pixels", _jpegs(str(tmp_path / "images")), "--pixel_transform", "clip"]
    done = prepare_data.main(argv + ["--out", str(tmp_path / "port")])
    jax_prepare_data.main(argv + ["--out", str(tmp_path / "jax")])
    got = _tree(tmp_path / "port")
    assert got == _tree(tmp_path / "jax")
    assert done["pixels"] == 3 and "pixels_clip_224/meta.json" in got


def test_scorer_clip_runs_with_jax_blocked(cli_env, clip_dir, tmp_path):
    """The evaluate CLI's ``--scorer clip`` in a subprocess with jax, flax,
    orbax and the JAX package blocked (the machine with the card has
    none of them)."""
    from test_torch_port_rules import _run_jax_free

    root, _, pth, _ = cli_env
    out = str(tmp_path / "out")
    res = _run_jax_free("cli.evaluate", _argv(root, out, pth, clip_dir) + TINY_FLAGS, tmp_path)
    assert {"rgqa_tpu_torch.models.clip", "rgqa_tpu_torch.scorers.clip",
            "rgqa_tpu_torch.data.clip_tokenizer"} <= set(res["modules"])
    assert {"auaf", "fpr@0.95acc", "full_acc"} <= set(res["keys"])
    assert len(_rows(os.path.join(out, "testdev_predict.json"))) == CLI_SPEC["n_testdev"]
