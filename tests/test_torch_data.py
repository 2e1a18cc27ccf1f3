"""Port parity: the port's numpy-only data copies against the JAX package's.

The port carries copies of the tokenizer, the synthetic data generator,
the feature-pack reader and the dataset encoder (``rgqa_tpu.data``
imports jax and flax); these tests hold each copy to its original on the
same inputs: equal arrays, equal files.
"""

import json
import os

import numpy as np
import pytest
import torch

from rgqa_tpu_torch.data import batching, dataset, synthetic, tokenizer, tsv
from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

SPEC = dict(n_images=12, n_train=24, n_valid=8, n_testdev=21, num_boxes=6, feat_dim=40, seed=3)
SENTENCES = [
    "what is the red object near the apple ?",
    "Is there a Zebra in the picture?",
    "where is the shiny guitar , exactly ?",
    "",
    "café über naïve résumé",
    "how many 苹果 can you see ?",
    "unknownword xylophone's kite!!",
    "a " * 40,
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def jax_data():
    pytest.importorskip("jax")
    from rgqa_tpu import data

    return data


# The 32 x 32 base images the JAX generator hands to PIL before its JPEG
# step, captured while it writes its root.
JAX_BASE_IMAGES: list = []


@pytest.fixture(scope="module")
def roots(tmp_path_factory, jax_data):
    """The same synthetic spec written by both packages."""
    from PIL import Image

    port_root = str(tmp_path_factory.mktemp("port_gqa"))
    jax_root = str(tmp_path_factory.mktemp("jax_gqa"))
    synthetic.make_synthetic_gqa(port_root, synthetic.SyntheticSpec(**SPEC))
    fromarray = Image.fromarray

    def capture(arr, *a, **kw):
        JAX_BASE_IMAGES.append(np.array(arr))
        return fromarray(arr, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Image, "fromarray", capture)
        jax_data.make_synthetic_gqa(jax_root, jax_data.SyntheticSpec(**SPEC))
    return port_root, jax_root


def test_synthetic_files_match(roots):
    # The port keeps the base images as an array where the JAX package
    # writes JPEGs (its images/ and the other files it alone writes).
    port_root, jax_root = roots
    port_files = sorted(set(os.listdir(port_root)) - {synthetic.BASE_IMAGES})
    assert set(port_files) <= set(os.listdir(jax_root))
    assert {"testdev.json", "trainval_ans2label.json", "vocab.txt", "objects_vocab.txt",
            "features"} <= set(port_files)
    for name in port_files:
        if name == "features":
            continue
        with open(os.path.join(port_root, name), "rb") as a, open(os.path.join(jax_root, name), "rb") as b:
            assert a.read() == b.read(), name


def test_synthetic_base_images_are_the_jax_draws(roots):
    port_root, _ = roots
    assert len(JAX_BASE_IMAGES) == SPEC["n_images"]
    np.testing.assert_array_equal(
        np.load(os.path.join(port_root, synthetic.BASE_IMAGES)), np.stack(JAX_BASE_IMAGES)
    )


def test_synthetic_feature_pack_matches(roots):
    port_root, jax_root = roots
    names = sorted(os.listdir(os.path.join(port_root, "features")))
    assert names == sorted(os.listdir(os.path.join(jax_root, "features")))
    for name in names:
        a, b = (os.path.join(r, "features", name) for r in roots)
        if name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a), np.load(b))
        else:
            with open(a) as fa, open(b) as fb:
                assert json.load(fa) == json.load(fb)


@pytest.mark.parametrize("max_len", [6, 20])
def test_tokenizer_matches(roots, jax_data, max_len):
    from rgqa_tpu.data.tokenizer import load_vocab as jax_load_vocab

    vocab_path = os.path.join(roots[0], "vocab.txt")
    port_tok = tokenizer.WordPieceTokenizer(tokenizer.load_vocab(vocab_path))
    jax_tok = jax_data.WordPieceTokenizer(jax_load_vocab(vocab_path))
    for sent in SENTENCES:
        assert port_tok.tokenize(sent) == jax_tok.tokenize(sent)
    for got, want in zip(port_tok.encode_batch(SENTENCES, max_len), jax_tok.encode_batch(SENTENCES, max_len)):
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_len", [8, 20])
def test_tokenizer_pairs_match(roots, jax_data, max_len):
    """Sentence pairs (the caption matcher's ``[CLS] caption [SEP]
    question [SEP]``): longest-first truncation, ties popping the first
    segment, segment id 1 on the second."""
    from rgqa_tpu.data.tokenizer import load_vocab as jax_load_vocab

    vocab_path = os.path.join(roots[0], "vocab.txt")
    port_tok = tokenizer.WordPieceTokenizer(tokenizer.load_vocab(vocab_path))
    jax_tok = jax_data.WordPieceTokenizer(jax_load_vocab(vocab_path))
    captions = [f"a photo of the {w}" for w in ("apple", "shiny red guitar", "", "kite")]
    firsts, seconds = captions + SENTENCES, SENTENCES + captions
    got = port_tok.encode_batch(firsts, max_len, text_pairs=seconds)
    want = jax_tok.encode_batch(firsts, max_len, text_pairs=seconds)
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    assert got[2].any() and got[2].max() == 1
    for i, (a, b) in enumerate(zip(firsts, seconds)):
        assert port_tok.encode(a, max_len, b) == tuple(jax_tok.encode(a, max_len, b)), i


@pytest.mark.parametrize("split", ["testdev", "train,valid"])
def test_encoded_dataset_matches(roots, jax_data, split):
    from rgqa_tpu.data.tokenizer import load_vocab as jax_load_vocab

    root = roots[0]
    port_ds = dataset.GQADataset(root, split, add_uq=True)
    jax_ds = jax_data.GQADataset(root, split, add_uq=True)
    assert port_ds.label2ans == jax_ds.label2ans and port_ds.num_answers == jax_ds.num_answers
    assert port_ds.qid2label == jax_ds.qid2label

    vocab = os.path.join(root, "vocab.txt")
    port_enc = dataset.EncodedGQA(
        port_ds, tsv.PackedFeatures(os.path.join(root, "features")),
        tokenizer=tokenizer.WordPieceTokenizer(tokenizer.load_vocab(vocab)), max_text_len=12,
    )
    jax_enc = jax_data.EncodedGQA(
        jax_ds, jax_data.PackedFeatures(os.path.join(root, "features")),
        tokenizer=jax_data.WordPieceTokenizer(jax_load_vocab(vocab)), max_text_len=12,
    )
    assert port_enc.question_ids == jax_enc.question_ids
    for name in ("input_ids", "input_mask", "segment_ids", "img_row", "label_idx", "label_score", "img_boxes"):
        np.testing.assert_array_equal(getattr(port_enc, name), getattr(jax_enc, name), err_msg=name)

    # Batches, with the padded final batch and its real-row count.
    port_batches = list(batching.batch_iterator(port_enc, 8))
    jax_batches = list(jax_data.batch_iterator(jax_enc, 8, with_target=False))
    assert len(port_batches) == len(jax_batches)
    for (pq, pb, pr), (jq, jb, jr) in zip(port_batches, jax_batches):
        assert pq == jq and pr == jr
        assert pb.keys() <= jb.keys()
        for key in pb:
            np.testing.assert_array_equal(pb[key], jb[key], err_msg=key)
    assert sum(real for _, _, real in port_batches) == len(port_enc)


@pytest.mark.parametrize("drop_last", [False, True])
def test_shuffled_batch_order_and_targets_match(roots, jax_data, drop_last):
    # The training feed: the same np.random.default_rng(seed) draws the same
    # order, and the targets drop the UQ column into id_mask.
    from rgqa_tpu.data.batching import batch_indices as jax_batch_indices
    from rgqa_tpu.data.tokenizer import load_vocab as jax_load_vocab

    for n in (24, 25):
        got = list(batching.batch_indices(n, 8, shuffle=True, rng=np.random.default_rng(9),
                                          drop_last=drop_last))
        want = list(jax_batch_indices(n, 8, shuffle=True, rng=np.random.default_rng(9),
                                      drop_last=drop_last))
        assert [g.tolist() for g in got] == [w.tolist() for w in want]

    root = roots[0]
    vocab = os.path.join(root, "vocab.txt")
    port_enc = dataset.EncodedGQA(
        dataset.GQADataset(root, "testdev", add_uq=True), tsv.PackedFeatures(os.path.join(root, "features")),
        tokenizer=tokenizer.WordPieceTokenizer(tokenizer.load_vocab(vocab)), max_text_len=12,
    )
    jax_enc = jax_data.EncodedGQA(
        jax_data.GQADataset(root, "testdev", add_uq=True), jax_data.PackedFeatures(os.path.join(root, "features")),
        tokenizer=jax_data.WordPieceTokenizer(jax_load_vocab(vocab)), max_text_len=12,
    )
    port_batches = list(batching.batch_iterator(
        port_enc, 8, shuffle=True, rng=np.random.default_rng(3), drop_last=drop_last, with_target=True))
    jax_batches = list(jax_data.batch_iterator(
        jax_enc, 8, shuffle=True, rng=np.random.default_rng(3), drop_last=drop_last, with_target=True))
    assert len(port_batches) == len(jax_batches) == (2 if drop_last else 3)
    for (pq, pb, pr), (jq, jb, jr) in zip(port_batches, jax_batches):
        assert pq == jq and pr == jr
        assert {"target", "id_mask"} <= pb.keys() <= jb.keys()
        for key in pb:
            np.testing.assert_array_equal(pb[key], jb[key], err_msg=key)
    uq = [b["id_mask"] for _, b, _ in port_batches]
    assert 0 < np.concatenate(uq).mean() < 1  # testdev mixes UQ and answerable rows


def test_build_targets_matches(jax_data):
    from rgqa_tpu.data.dataset import build_targets as jax_build_targets

    rng = np.random.default_rng(0)
    idx = rng.integers(-1, 9, (5, dataset.MAX_LABELS)).astype(np.int32)
    score = rng.random((5, dataset.MAX_LABELS), dtype=np.float32)
    np.testing.assert_array_equal(dataset.build_targets(idx, score, 9), jax_build_targets(idx, score, 9))


def test_feature_pack_truncate_and_int8_refusal(roots, tmp_path):
    feats = tsv.PackedFeatures(os.path.join(roots[0], "features"))
    view = feats.truncate(5)
    assert len(view) == 5 and view.features.shape[0] == 5
    assert feats.truncate(100) is feats
    with pytest.raises(FileNotFoundError, match="int8"):
        tsv.PackedFeatures(str(tmp_path))


def test_device_prefetch_on_cpu(roots):
    root = roots[0]
    ds = dataset.GQADataset(root, "testdev", add_uq=True)
    enc = dataset.EncodedGQA(
        ds, tsv.PackedFeatures(os.path.join(root, "features")),
        tokenizer=tokenizer.WordPieceTokenizer(tokenizer.load_vocab(os.path.join(root, "vocab.txt"))),
    )
    host = list(batching.batch_iterator(enc, 4))
    moved = list(batching.device_prefetch(iter(host), "cpu"))
    assert len(moved) == len(host)
    for (hq, hb, hr), (mq, mb, mr) in zip(host, moved):
        assert hq == mq and hr == mr
        for key in hb:
            assert isinstance(mb[key], torch.Tensor)
            np.testing.assert_array_equal(mb[key].numpy(), hb[key])


def test_pad_batch_repeats_last_row():
    batch = {"a": np.arange(6).reshape(3, 2), "b": np.arange(3)}
    padded, real = batching.pad_batch_to(batch, 5)
    assert real == 3
    np.testing.assert_array_equal(padded["b"], [0, 1, 2, 2, 2])
    with pytest.raises(ValueError):
        batching.pad_batch_to(batch, 2)


@pytest.mark.cuda
def test_device_prefetch_on_card(cuda):
    rng = np.random.default_rng(0)
    host = [([f"q{i}"], {"x": rng.standard_normal((4, 3), dtype=np.float32)}, 4) for i in range(5)]
    moved = list(batching.device_prefetch(iter(host), cuda))
    assert len(moved) == 5
    for (_, hb, _), (_, mb, _) in zip(host, moved):
        assert mb["x"].device.type == "cuda"
        np.testing.assert_array_equal(mb["x"].cpu().numpy(), hb["x"])
