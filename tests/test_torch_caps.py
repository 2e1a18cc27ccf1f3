"""Port parity: the caption matcher against the JAX package.

The same numpy inputs go through the JAX function and its counterpart in
the port, at a small size (2 layers x 32, 4 heads, a vocabulary of 200;
caption-question pairs of ragged length in 20 tokens, so the pads sit at
the end of the keys, and segment ids 1 on the question):

- ``CaptionMatcher``'s forward on the JAX model's weights through
  ``from_jax_params``: the (B,) match logits and the pooled output at
  rtol 2e-4 / atol 2e-5 in f32, within 3e-2 in bf16;
- a ``.pth`` written by ``to_reference_state_dict`` (a trained GQABERT,
  ``encoder.*`` + ``logit_fc.*``) through the JAX ``import_bert_caps``:
  the same params and logits;
- ``--load_bert`` of a random-weight HF BERT in each layout the JAX
  importer reads (a bare ``BertModel``, ``bert.``-prefixed, a trained
  GQABERT, and a directory holding ``pytorch_model.bin``; each with a
  ``position_ids`` buffer), written here: the port loads what the JAX
  importer loads, and the runner leaves the match head at its init;
- the caption branch of ``EncodedGQA`` (equal arrays);
- one-logit heads: the scorers and the train step take (B,) logits as
  (B, 1), and the binary loss is BCE against ``id_mask`` (not the
  answers' BCE).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import torch

from rgqa_tpu_torch import config as port_config
from rgqa_tpu_torch.checkpoint.convert import (
    from_jax_params,
    load_reference_pth,
    to_reference_state_dict,
)
from rgqa_tpu_torch.config import EncoderConfig, ModelConfig
from rgqa_tpu_torch.data.dataset import EncodedGQA, GQADataset
from rgqa_tpu_torch.data.synthetic import SyntheticSpec, make_synthetic_gqa
from rgqa_tpu_torch.data.tokenizer import WordPieceTokenizer, load_vocab
from rgqa_tpu_torch.data.tsv import PackedFeatures
from rgqa_tpu_torch.models.zoo import build_model, example_batch
from rgqa_tpu_torch.runner import GQARunner
from rgqa_tpu_torch.scorers import make_dropout_scorer, make_msp_scorer
from rgqa_tpu_torch.train import optimizer, step as tstep

from test_torch_train import _tensors
from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

LAYERS, TEXT = 2, 20
ENC = dict(hidden_size=32, num_heads=4, intermediate_size=64, vocab_size=200, num_layers=LAYERS)
INPUTS = ("input_ids", "input_mask", "segment_ids")


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


def _cfg(config=None, dropout=0.0):
    c = config
    enc = (c.EncoderConfig if c else EncoderConfig)(**ENC, hidden_dropout=dropout,
                                                    attention_dropout=dropout)
    return (c.ModelConfig if c else ModelConfig)(backbone="caps", encoder=enc, num_answers=1,
                                                 max_text_len=TEXT)


def _batch(b, seed):
    """Pairs of ragged length: ``[CLS] caption [SEP] question [SEP]`` then
    pads, segment 1 from the question on."""
    batch = example_batch(_cfg(), b, seed=seed)
    rng = np.random.default_rng(seed + 100)
    lengths = rng.integers(6, TEXT + 1, b)
    lengths[0] = TEXT
    cap = rng.integers(2, 5, b)  # caption pieces
    pos = np.arange(TEXT)[None, :]
    pad = pos >= lengths[:, None]
    batch["input_ids"][pad] = 0
    batch["input_mask"][pad] = 0
    batch["segment_ids"] = ((pos >= cap[:, None] + 2) & ~pad).astype(np.int32)
    return batch


def _jax_params(jax, seed=0):
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.models.zoo import build_model as jax_build_model

    jmodel, jforward = jax_build_model(_cfg(jax_config))
    params = jmodel.init(jax.random.PRNGKey(seed), *[_batch(2, 0)[k] for k in INPUTS])["params"]
    return jax.tree_util.tree_map(np.asarray, params), jforward


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(jax, dtype):
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.models.zoo import build_model as jax_build_model

    params, _ = _jax_params(jax)
    bf16 = dtype == "bfloat16"
    _, jforward = jax_build_model(_cfg(jax_config), use_bf16=bf16)
    batch = _batch(7, seed=3)
    want = jforward(params, batch, deterministic=True)
    model, forward = build_model(_cfg(), use_bf16=bf16, device="cpu")
    model.load_state_dict(from_jax_params(params), strict=True)
    with torch.no_grad():
        got = forward(_tensors(batch))
    assert got["logits"].shape == (7,)
    for key in ("logits", "pooled"):
        g, w = got[key].float().numpy(), np.asarray(want[key], np.float32)
        if bf16:
            np.testing.assert_allclose(g, w, atol=3e-2, rtol=0, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-5, err_msg=key)
    # The suffix pads are masked: other ids there change nothing.
    other = dict(batch, input_ids=np.where(batch["input_mask"] == 1, batch["input_ids"], 7))
    with torch.no_grad():
        torch.testing.assert_close(forward(_tensors(other))["logits"], got["logits"], rtol=0, atol=0)


def test_reference_pth_loads_through_the_jax_importer(jax, tmp_path):
    from rgqa_tpu.checkpoint import import_bert_caps

    params, jforward = _jax_params(jax)
    ref = to_reference_state_dict(from_jax_params(params), backbone="caps", num_layers=LAYERS)
    assert all(k.startswith(("encoder.", "logit_fc.")) for k in ref)
    assert "encoder.encoder.layer.1.output.LayerNorm.weight" in ref and "logit_fc.3.bias" in ref
    path = str(tmp_path / "gqabert.pth")
    torch.save(ref, path)
    loaded, missing, unused = import_bert_caps(_jax_params(jax, seed=5)[0], path, num_layers=LAYERS)
    assert missing == [] and unused == []
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    for path_, leaf in jax.tree_util.tree_leaves_with_path(loaded):
        np.testing.assert_array_equal(np.asarray(leaf), want[path_])
    batch = _batch(4, seed=1)
    np.testing.assert_array_equal(np.asarray(jforward(loaded, batch)["logits"]),
                                  np.asarray(jforward(params, batch)["logits"]))


def _hf_files(sd, tmp_path, layout):
    """A random-weight HF-layout checkpoint of the port's ``sd`` in one of
    ``import_bert_caps``'s layouts; returns the path to hand over."""
    ref = to_reference_state_dict(sd, backbone="caps", num_layers=LAYERS)
    bare = {k.removeprefix("encoder."): v for k, v in ref.items() if not k.startswith("logit_fc")}
    bare["embeddings.position_ids"] = torch.arange(ENC["vocab_size"])[None]  # a buffer, dropped
    if layout in ("bare", "dir"):
        out = bare
    elif layout == "bert":
        out = {"bert." + k: v for k, v in bare.items()}
        out["cls.predictions.bias"] = torch.zeros(ENC["vocab_size"])  # a pretraining head: unused
    else:  # a trained GQABERT
        out = {("encoder." + k): v for k, v in bare.items()}
        out.update({k: v for k, v in ref.items() if k.startswith("logit_fc")})
    if layout == "dir":
        directory = tmp_path / "bert-base-uncased"
        directory.mkdir()
        torch.save(out, str(directory / "pytorch_model.bin"))
        return str(directory)
    path = str(tmp_path / f"{layout}.bin")
    torch.save(out, path)
    return path


@pytest.mark.parametrize("layout", ["bare", "bert", "gqabert", "dir"])
def test_load_bert_layouts_match_the_jax_importer(jax, layout, tmp_path):
    from rgqa_tpu.checkpoint import import_bert_caps

    src, _ = build_model(_cfg(), device="cpu", generator=torch.Generator().manual_seed(9))
    path = _hf_files(src.state_dict(), tmp_path, layout)
    loaded, missing, unused = load_reference_pth(path, backbone="caps", num_layers=LAYERS)
    jparams, jmissing, junused = import_bert_caps(_jax_params(jax, seed=1)[0], path, num_layers=LAYERS)
    assert missing == jmissing == []
    assert unused == junused == (["cls.predictions.bias"] if layout == "bert" else [])
    head = layout == "gqabert"
    assert any(k.startswith("match_head.") for k in loaded) == head
    jsd = from_jax_params(jparams)
    for key, value in loaded.items():
        torch.testing.assert_close(value, jsd[key], rtol=0, atol=0, msg=key)
        torch.testing.assert_close(value, src.state_dict()[key], rtol=0, atol=0, msg=key)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("caps_gqa"))
    make_synthetic_gqa(root, SyntheticSpec(n_images=6, n_train=12, n_valid=6, n_testdev=10,
                                           num_boxes=6, feat_dim=40, seed=2))
    return root


def _run_cfg(root, out, **kw):
    return port_config.RunConfig(
        model=_cfg(), train=port_config.TrainConfig(batch_size=4, use_bf16=False, strategy="caption"),
        data=port_config.DataConfig(data_root=root, synthetic=True, valid_splits=""), output=out, **kw)


def test_runner_load_bert_keeps_the_match_head_at_init(root, tmp_path):
    src, _ = build_model(_cfg(), device="cpu", generator=torch.Generator().manual_seed(9))
    path = _hf_files(src.state_dict(), tmp_path, "bert")
    init = GQARunner(_run_cfg(root, str(tmp_path / "init")), device="cpu").model.state_dict()
    got = GQARunner(_run_cfg(root, str(tmp_path / "bert"), load_bert=path), device="cpu").model.state_dict()
    for key, value in got.items():
        want = init[key] if key.startswith("match_head.") else src.state_dict()[key]
        torch.testing.assert_close(value, want, rtol=0, atol=0, msg=key)


def test_caption_branch_matches_jax_encoded(jax, root):
    import json

    from rgqa_tpu.data import GQADataset as JaxDataset
    from rgqa_tpu.data.dataset import EncodedGQA as JaxEncoded
    from rgqa_tpu.data.tokenizer import WordPieceTokenizer as JaxTokenizer
    from rgqa_tpu.data.tokenizer import load_vocab as jax_load_vocab
    from rgqa_tpu.data.tsv import PackedFeatures as JaxPacked

    with open(os.path.join(root, "image2caps.json")) as f:
        caps = json.load(f)
    caps.pop(next(iter(caps)))  # an image without a caption pairs with ""
    got = EncodedGQA(GQADataset(root, "testdev", add_uq=True), PackedFeatures(f"{root}/features"),
                     tokenizer=WordPieceTokenizer(load_vocab(f"{root}/vocab.txt")), max_text_len=TEXT,
                     backbone="caps", image2caps=caps)
    want = JaxEncoded(JaxDataset(root, "testdev", add_uq=True), JaxPacked(f"{root}/features"),
                      tokenizer=JaxTokenizer(jax_load_vocab(f"{root}/vocab.txt")), max_text_len=TEXT,
                      backbone="caps", image2caps=caps)
    assert got.segment_ids.any()
    idx = np.arange(len(got))
    gb, wb = got.gather_batch(idx, with_target=True), want.gather_batch(idx)
    assert "feats" not in gb  # the matcher reads the text pair alone
    for key in (*INPUTS, "target", "id_mask"):
        np.testing.assert_array_equal(gb[key], np.asarray(wb[key]), err_msg=key)


def _one_logit_forward(logits):
    def forward(batch, **kw):
        return {"logits": logits, "pooled": logits[:, None]}

    return forward


def test_scorers_take_one_logit_heads():
    logits = torch.tensor([-2.0, 0.5, 3.0])
    for scorer in (make_msp_scorer(_one_logit_forward(logits)),
                   make_dropout_scorer(_one_logit_forward(logits), [0, 1, 2])):
        out = scorer({"x": logits})
        assert out["label"].tolist() == [0, 0, 0]
        torch.testing.assert_close(out["score"], torch.sigmoid(logits))


@pytest.mark.parametrize("binary", [True, False])
def test_train_step_takes_one_logit_heads(binary):
    torch.manual_seed(0)
    lin = torch.nn.Linear(3, 1)
    x = torch.randn(5, 3)
    batch = {"x": x, "target": torch.rand(5, 1), "id_mask": torch.tensor([1.0, 0.0, 1.0, 1.0, 0.0])}
    with torch.no_grad():
        z = lin(x)[:, 0]
    opt = optimizer.make_optimizer(port_config.OptimConfig(lr=1e-3), lin.parameters(), t_total=10)
    step = tstep.make_train_step(lambda b, **kw: {"logits": lin(b["x"])[:, 0]}, opt, binary=binary)
    out = step(batch)
    target = batch["id_mask"] if binary else batch["target"][:, 0]
    want = torch.clamp(z, min=0) - z * target + torch.log1p(torch.exp(-z.abs()))
    torch.testing.assert_close(out["loss"], want.mean())
    assert out["label"].shape == (5,) and out["label"].eq(0).all()
    torch.testing.assert_close(out["score"], torch.sigmoid(z))


def test_strategy_caption_trains_a_one_logit_head(root, tmp_path):
    runner = GQARunner(dataclasses.replace(_run_cfg(root, str(tmp_path / "t")),
                                           train=port_config.TrainConfig(batch_size=4, use_bf16=False,
                                                                         strategy="caption", epochs=1)),
                       device="cpu")
    assert runner.model.match_head.logits.weight.shape == (1, 64)
    history = runner.train()
    assert np.isfinite(history["loss"]).all()
    keys = torch.load(os.path.join(str(tmp_path / "t"), "LAST.pth"), weights_only=True)
    assert all(k.startswith(("encoder.", "logit_fc.")) for k in keys)


# ---------------------------------------------------------------------------
# On the card: #1 / #3 / #4 / #5 at 20 x 20 under the pair mask.
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_kernels_on_card_under_the_pair_mask(dropout):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rgqa_tpu_torch.data.batching import to_device
    from rgqa_tpu_torch.ops import attention as att
    from rgqa_tpu_torch.ops.dropout import DropoutRng

    enc = EncoderConfig(num_layers=LAYERS, vocab_size=200, hidden_dropout=dropout,
                        attention_dropout=dropout)  # 768 wide, 12 heads of 64
    cfg = ModelConfig(backbone="caps", encoder=enc, num_answers=1, max_text_len=TEXT)
    batch = _batch(32, seed=5)
    batch["id_mask"] = (np.arange(32) % 3 != 0).astype(np.float32)
    batch = to_device(batch, "cuda")
    wrappers = (att.fused_attention_cuda, att.fused_attention_bwd_cuda, att.fused_attention_dropout_cuda,
                att.fused_attention_dropout_bwd_cuda)
    model, forward = build_model(cfg, use_bf16=True, device="cuda")
    with torch.no_grad():
        before = [w.launches for w in wrappers]
        got = forward(batch)["logits"].float()
        assert [w.launches - n for w, n in zip(wrappers, before)] == [LAYERS, 0, 0, 0]
        want = forward(batch, use_fused=False)["logits"].float()
    torch.testing.assert_close(got, want, rtol=0, atol=5e-2)
    losses = {}
    for fused in (None, False):
        model, forward = build_model(cfg, use_bf16=True, device="cuda", train=True)
        opt = optimizer.make_optimizer(port_config.OptimConfig(lr=1e-4), model.parameters(), t_total=2)
        step = tstep.make_train_step(forward, opt, binary=True, use_fused=fused,
                                     rng=DropoutRng(device=torch.Generator(device="cuda").manual_seed(0),
                                                    host=torch.Generator().manual_seed(0)))
        before = [w.launches for w in wrappers]
        losses[fused] = step(batch)["loss"].item()
        counts = [w.launches - n for w, n in zip(wrappers, before)]
        if fused is None:
            assert counts == ([LAYERS, LAYERS, 0, 0] if dropout == 0 else [0, 0, LAYERS, LAYERS]), counts
        else:
            assert counts == [0, 0, 0, 0]
    if dropout == 0:  # the same draws then: hidden dropout off, no attention dropout
        assert losses[None] == pytest.approx(losses[False], rel=1e-3)
