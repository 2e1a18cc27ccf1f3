"""The port's data preparation (``data/tsv.py``'s decoder, packer and
writer, ``data/images.py::pack_pixels``, ``cli/prepare_data.py``) against
the JAX package's, on the CPU.

A TSV written here from a numpy seed, with rows of 36, 10 and 50 boxes
(padded and truncated to 36), goes through the port's packer and the JAX
packer's g++ decoder, with and without ``topk``; every ``.npy`` and
``img_ids.json`` equals the JAX numpy packer's byte for byte (the g++
cases skip where g++ is absent).  The prepare-data CLI writes the
JAX CLI's root file for file; ``pack_pixels`` (pixelbert, pad and crop)
writes the JAX one's pack byte for byte where PIL is present.
"""

from __future__ import annotations

import json
import os
import pathlib
import sys

import numpy as np
import pytest

from rgqa_tpu_torch.cli import prepare_data
from rgqa_tpu_torch.data import tsv
from rgqa_tpu_torch.data.synthetic import random_obj_rows
from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

BOXES = (36, 10, 50, 36, 36, 10, 50)  # boxes per row: as packed, zero-padded, truncated
FEAT_DIM = 24


def _write_tsv(path) -> str:
    tsv.write_obj_tsv(path, random_obj_rows(BOXES, feat_dim=FEAT_DIM))
    return path


def _tree(directory) -> dict:
    """{relative path: bytes} of every file under ``directory``."""
    root = pathlib.Path(directory)
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def tsv_path(tmp_path_factory):
    return _write_tsv(str(tmp_path_factory.mktemp("tsv") / "obj.tsv"))


@pytest.mark.parametrize("topk", [None, 4])
@pytest.mark.parametrize("packer", ["port-numpy", "jax-native"])
def test_packs_equal_the_jax_numpy_pack_byte_for_byte(tsv_path, tmp_path, packer, topk):
    from rgqa_tpu.data import tsv as jax_tsv

    if packer == "jax-native":
        from rgqa_tpu import native as jax_native

        if not jax_native.available():
            pytest.skip("g++ not available")
        got = jax_tsv.pack_obj_tsv(tsv_path, str(tmp_path / "got"), topk=topk, use_native=True)
    else:
        got = tsv.pack_obj_tsv(tsv_path, str(tmp_path / "got"), topk=topk)
    jax_tsv.pack_obj_tsv(tsv_path, str(tmp_path / "want"), topk=topk, use_native=False)
    assert len(got) == (topk or len(BOXES))
    want = _tree(tmp_path / "want")
    assert sorted(want) == sorted([f"{name}.npy" for name in tsv.PackedFeatures.ARRAYS] + ["img_ids.json"])
    assert _tree(tmp_path / "got") == want
    assert got.features.shape == (topk or len(BOXES), 36, FEAT_DIM)


@pytest.mark.parametrize("boxes", [BOXES, (1,), (50, 10)])
def test_written_rows_read_back_through_the_jax_reader(tmp_path, boxes):
    """``write_obj_tsv`` is the inverse of the TSV reader: the JAX
    package's reader returns the rows it was given, with ``num_boxes``
    their length."""
    from rgqa_tpu.data import tsv as jax_tsv

    rows = list(random_obj_rows(boxes, feat_dim=FEAT_DIM, seed=3))
    path = str(tmp_path / "rows.tsv")
    assert tsv.write_obj_tsv(path, rows) == os.path.getsize(path)
    got = jax_tsv.load_obj_tsv(path)
    assert [r["img_id"] for r in got] == [r["img_id"] for r in rows]
    for g, r in zip(got, rows):
        assert (g["num_boxes"], g["img_h"], g["img_w"]) == (len(r["boxes"]), r["img_h"], r["img_w"])
        for key, dtype in (("objects_id", np.int64), ("objects_conf", np.float32), ("attrs_id", np.int64),
                           ("attrs_conf", np.float32), ("boxes", np.float32), ("features", np.float32)):
            np.testing.assert_array_equal(g[key], np.asarray(r[key], dtype).reshape(g[key].shape), err_msg=key)


def test_empty_tsv_is_refused_as_the_jax_packer_refuses_it(tmp_path):
    from rgqa_tpu.data import tsv as jax_tsv

    path = tmp_path / "empty.tsv"
    path.write_text("")
    for pack in (tsv.pack_obj_tsv, lambda *a: jax_tsv.pack_obj_tsv(*a, use_native=False)):
        with pytest.raises(ValueError, match="no rows decoded"):
            pack(str(path), str(tmp_path / "out"))


def test_rows_decode_as_the_jax_decoder_decodes_them(tsv_path):
    from rgqa_tpu.data import tsv as jax_tsv

    assert tsv.OBJ_TSV_FIELDS == jax_tsv.OBJ_TSV_FIELDS
    got, want = tsv.load_obj_tsv(tsv_path, topk=5), jax_tsv.load_obj_tsv(tsv_path, topk=5)
    assert [r["num_boxes"] for r in got] == list(BOXES[:5])
    assert [r["img_id"] for r in got] == [f"img{i:06d}" for i in range(5)]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def test_int8_pack_is_refused_by_name(tsv_path, tmp_path):
    with pytest.raises(NotImplementedError, match="int8 feature packs"):
        tsv.pack_obj_tsv(tsv_path, str(tmp_path / "q"), int8=True)


def _jpegs(directory, n=3):
    """``n`` seeded JPEGs of three aspect ratios."""
    from PIL import Image

    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(1)
    for i, (h, w) in enumerate([(48, 96), (90, 60), (64, 64)][:n]):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(directory, f"img{i:04d}.jpg"))
    return directory


@pytest.fixture(scope="module")
def json_dir(tmp_path_factory, tsv_path):
    """Split JSONs, the answer vocabulary and a WordPiece vocab file."""
    d = tmp_path_factory.mktemp("gqa_json")
    rows = [{"img_id": f"img{i:06d}", "question_id": f"q{i}", "sent": "what is it ?",
             "label": {"cat": 1.0}} for i in range(len(BOXES))]
    for split in ("train", "testdev"):
        (d / f"{split}.json").write_text(json.dumps(rows))
    (d / "trainval_ans2label.json").write_text(json.dumps({"cat": 0, "dog": 1}))
    (d / "trainval_label2ans.json").write_text(json.dumps(["cat", "dog"]))
    (d / "vocab.txt").write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "what", "is", "it", "?"]))
    return d


@pytest.mark.parametrize("case", ["features", "pixels"])
def test_cli_writes_the_jax_cli_root(tsv_path, json_dir, tmp_path, case):
    """``prepare_data`` writes the JAX CLI's root file for file: the split
    JSONs, ``vocab.txt``, ``features/`` (``--topk``), and under
    ``--pack_pixels`` a pixel pack (crop mode, 64 px; needs PIL)."""
    from rgqa_tpu.cli import prepare_data as jax_prepare_data

    argv = ["--tsv", tsv_path, "--json_dir", str(json_dir), "--vocab", str(json_dir / "vocab.txt"),
            "--topk", "5"]
    if case == "pixels":
        pytest.importorskip("PIL")
        argv += ["--pack_pixels", _jpegs(str(tmp_path / "images")), "--pixel_size", "64",
                 "--pixel_mode", "crop"]
    done = prepare_data.main(argv + ["--out", str(tmp_path / "port")])
    jax_prepare_data.main(argv + ["--out", str(tmp_path / "jax")])
    got = _tree(tmp_path / "port")
    assert got == _tree(tmp_path / "jax")
    assert done == {"images": 5, "pixels": 3 if case == "pixels" else None}
    assert {"train.json", "testdev.json", "trainval_ans2label.json", "vocab.txt",
            "features/features.npy", "features/img_ids.json"} <= set(got)
    if case == "pixels":
        assert {"pixels_64_crop/pixels_u8.bin", "pixels_64_crop/rects.bin",
                "pixels_64_crop/meta.json"} <= set(got)


@pytest.mark.parametrize("extra, match", [
    (["--int8"], "--int8 is not ported"),
    (["--pixel_transform", "clip", "--pixel_mode", "pad"], "--pixel_mode applies to --pixel_transform pixelbert"),
])
def test_cli_refuses_by_name(tsv_path, json_dir, tmp_path, extra, match):
    argv = ["--tsv", tsv_path, "--json_dir", str(json_dir), "--vocab", str(json_dir / "vocab.txt"),
            "--out", str(tmp_path / "out"), *extra]
    with pytest.raises(SystemExit, match=match):
        prepare_data.main(argv)
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("mode", ["pad", "crop"])
def test_pack_pixels_matches_the_jax_pack(tmp_path, mode):
    pytest.importorskip("PIL")
    from rgqa_tpu.data.images import pack_pixels as jax_pack_pixels
    from rgqa_tpu_torch.data.images import PixelPack, pack_matches, pack_pixels

    img_root = _jpegs(str(tmp_path / "images"))
    pack = pack_pixels(img_root, str(tmp_path / "port"), size=48, mode=mode)
    jax_pack_pixels(img_root, str(tmp_path / "jax"), size=48, mode=mode)
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    assert isinstance(pack, PixelPack) and pack_matches(pack, img_root, 48, mode)
    assert pack.img_ids == ["img0000", "img0001", "img0002"]


def test_pack_pixels_refuses_the_clip_transform(tmp_path, monkeypatch):
    """Where PIL is absent (the machine with the card), the CLIP pack is
    refused by name before anything is written; the synthetic root's
    pack stands in there."""
    from rgqa_tpu_torch.data.images import pack_pixels

    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(RuntimeError, match=r"pack_pixels\(transform='clip'\) decodes JPEGs with PIL"):
        pack_pixels(str(tmp_path), str(tmp_path / "out"), transform="clip")
    assert not (tmp_path / "out").exists()


def test_the_port_root_serves(tsv_path, json_dir, tmp_path):
    """The prepared root is one the port's runner reads: its feature pack
    and vocabulary load, and every split row finds its image."""
    from rgqa_tpu_torch.data.dataset import EncodedGQA, GQADataset
    from rgqa_tpu_torch.data.tokenizer import WordPieceTokenizer, load_vocab

    out = str(tmp_path / "root")
    prepare_data.main(["--tsv", tsv_path, "--json_dir", str(json_dir), "--vocab",
                       str(json_dir / "vocab.txt"), "--out", out])
    enc = EncodedGQA(GQADataset(out, "testdev", add_uq=True), tsv.PackedFeatures(os.path.join(out, "features")),
                     tokenizer=WordPieceTokenizer(load_vocab(os.path.join(out, "vocab.txt"))), max_text_len=8)
    assert len(enc) == len(BOXES)
    assert enc.gather_batch(np.arange(3))["feats"].shape == (3, 36, FEAT_DIM)
