"""Port parity: the BUTD pieces against the JAX package.

The same numpy inputs go through the JAX function and its counterpart in
the port, at a small size (a vocabulary of 50 words, GRU hidden 32,
embeddings of 12, RoI features of 16 over 5 RoIs, 9 answers; questions
front-padded to 40 tokens with ragged lengths):

- ``ButdForGQA``'s forward on the JAX model's weights through
  ``from_jax_params``: logits, pooled and conf at rtol 2e-4 / atol 2e-5
  in f32, and the same under ``use_bf16`` (both packages keep BUTD f32);
- ``gru_scan`` against ``torch.nn.GRU`` on the same weights;
- the init's quirks, drawn in both packages: the GRU's U[0, 1/sqrt(h)),
  each ``v`` within 1/sqrt(its output width), ``g`` one;
- ``.pth`` files written by ``to_reference_state_dict`` through the JAX
  ``import_butd_gqa`` (the same params, the same logits), and
  ``weight_g`` read 0-d and with singleton dims;
- the RP roll of ``token_ids`` (BUTD's text field: rolling only the BERT
  text fields would pair no question with another image) and the
  exact-rate dropout.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from rgqa_tpu_torch.checkpoint.convert import (
    from_jax_params,
    load_reference_pth,
    to_reference_state_dict,
)
from rgqa_tpu_torch.config import EncoderConfig, ModelConfig
from rgqa_tpu_torch.models import butd as port_butd
from rgqa_tpu_torch.models.zoo import build_model, example_batch
from rgqa_tpu_torch.train import step as tstep

from test_torch_train import _tensors
from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

VOCAB, HIDDEN, EMBED, FEAT, ROIS, ANSWERS = 50, 32, 12, 16, 5, 9
INPUTS = ("token_ids", "feats", "boxes")


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


def _cfg(branched=False):
    return ModelConfig(backbone="butd", encoder=EncoderConfig(visual_feat_dim=FEAT, num_objects=ROIS),
                       num_answers=ANSWERS, butd_vocab_size=VOCAB, butd_embed_dim=EMBED,
                       butd_hidden_dim=HIDDEN, branched=branched)


def _jax_model(branched=False, **kw):
    from rgqa_tpu.models.butd import ButdForGQA

    return ButdForGQA(vocab_size=VOCAB, num_answers=ANSWERS, embed_dim=EMBED, hidden=HIDDEN,
                      branched=branched, **kw)


def _batch(b, seed):
    """``example_batch`` with ragged front-padded questions (the pad
    index is the vocabulary size) and scaled RoI features."""
    batch = example_batch(_cfg(), b, seed=seed)
    rng = np.random.default_rng(seed + 100)
    lengths = rng.integers(1, 41, b)
    batch["token_ids"][np.arange(40)[None, :] < 40 - lengths[:, None]] = VOCAB
    batch["feats"] = batch["feats"] * 3.0
    return batch


def _jax_params(jax, branched=False, seed=0):
    params = _jax_model(branched).init(jax.random.PRNGKey(seed), *_batch(2, 0).values())["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _jax_forward(jax, params, batch, branched=False):
    return _jax_model(branched).apply({"params": params}, *[batch[k] for k in INPUTS])


@pytest.mark.parametrize("case", ["f32", "branched", "bf16"])
def test_forward_matches_jax(jax, case):
    branched = case == "branched"
    params = _jax_params(jax, branched)
    batch = _batch(7, seed=3)
    want = _jax_forward(jax, params, batch, branched)
    model, forward = build_model(_cfg(branched), use_bf16=case == "bf16", device="cpu")
    # BUTD keeps f32 weights and products under bf16 (the JAX _build_butd
    # ignores the dtype): no bf16 cast of the inference weights.
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    model.load_state_dict(from_jax_params(params), strict=True)
    with torch.no_grad():
        got = forward(_tensors(batch), deterministic=True)
    keys = ("logits", "pooled", "conf") if branched else ("logits", "pooled")
    assert set(got) == set(keys)
    for key in keys:
        assert got[key].dtype == torch.float32, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=2e-4, atol=2e-5,
                                   err_msg=key)


def test_gru_matches_gru_scan(jax):
    from rgqa_tpu.ops.gru import gru_scan

    rng = np.random.default_rng(0)
    b, t, d, h = 4, 9, EMBED, HIDDEN
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    h0 = rng.standard_normal((b, h)).astype(np.float32) * 0.5
    w = {name: rng.uniform(-0.3, 0.3, shape).astype(np.float32) for name, shape in (
        ("weight_ih_l0", (3 * h, d)), ("weight_hh_l0", (3 * h, h)),
        ("bias_ih_l0", (3 * h,)), ("bias_hh_l0", (3 * h,)))}
    outs, final = gru_scan(x, h0, w["weight_ih_l0"], w["weight_hh_l0"], w["bias_ih_l0"], w["bias_hh_l0"])
    gru = torch.nn.GRU(d, h, batch_first=True)
    gru.load_state_dict({k: torch.from_numpy(v) for k, v in w.items()})
    with torch.no_grad():
        got, hn = gru(torch.from_numpy(x), torch.from_numpy(h0)[None])
    np.testing.assert_allclose(got.numpy(), np.asarray(outs), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(hn[0].numpy(), np.asarray(final), rtol=2e-4, atol=2e-5)


def test_init_keeps_the_jax_quirks(jax):
    params = _jax_params(jax)
    model, _ = build_model(_cfg(), device="cpu")
    sd = model.state_dict()
    ported = from_jax_params(params)
    assert sd.keys() == ported.keys()
    limit = 1.0 / np.sqrt(HIDDEN)
    for name, tree in (("port", sd), ("jax", ported)):
        for key in ("gru.weight_ih_l0", "gru.weight_hh_l0"):
            w = tree[key]
            assert 0.0 <= w.min() and w.max() < limit and w.max() > 0.9 * limit, (name, key)
        for key in ("gru.bias_ih_l0", "gru.bias_hh_l0"):
            assert not tree[key].any(), (name, key)
        for key, v in tree.items():
            if key.endswith(".v"):
                bound = 1.0 / np.sqrt(v.shape[0])  # fan-in read off the output axis
                assert v.abs().max() <= bound and v.abs().max() > 0.5 * bound, (name, key)
                assert tree[key[:-1] + "g"].item() == 1.0 and not tree[key[:-1] + "b"].any()
        emb = tree["w_emb.weight"]
        assert abs(emb.std().item() * np.sqrt(EMBED) - 1.0) < 0.15, name


@pytest.mark.parametrize("branched", [False, True])
def test_reference_pth_loads_through_the_jax_importer(jax, branched, tmp_path):
    from rgqa_tpu.checkpoint.torch_import import import_butd_gqa

    params = _jax_params(jax, branched)
    ref = to_reference_state_dict(from_jax_params(params), backbone="butd")
    assert "w_emb.emb.weight" in ref and "q_enc.rnn.weight_hh_l0" in ref
    assert ref["att.linear.weight_g"].shape == ()  # PyTorch weight_norm(dim=None)'s layout
    assert any(k.startswith("conf_classifier.") for k in ref) == branched
    path = str(tmp_path / "butd.pth")
    torch.save(ref, path)
    loaded, missing, unused = import_butd_gqa(_jax_params(jax, branched, seed=4), path, branched=branched)
    assert missing == [] and unused == []
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    for path_, leaf in jax.tree_util.tree_leaves_with_path(loaded):
        np.testing.assert_array_equal(np.asarray(leaf), want[path_])
    batch = _batch(5, seed=1)
    np.testing.assert_array_equal(np.asarray(_jax_forward(jax, loaded, batch, branched)["logits"]),
                                  np.asarray(_jax_forward(jax, params, batch, branched)["logits"]))


@pytest.mark.parametrize("shape", [(), (1, 1)], ids=["0d", "singleton"])
def test_weight_g_loads_in_either_layout(shape, tmp_path):
    model, _ = build_model(_cfg(), device="cpu", generator=torch.Generator().manual_seed(3))
    sd = model.state_dict()
    ref = to_reference_state_dict(sd, backbone="butd")
    path = str(tmp_path / "butd.pth")
    torch.save({"module." + k: (v.reshape(shape) if k.endswith("weight_g") else v) for k, v in ref.items()},
               path)
    loaded, missing, unused = load_reference_pth(path, backbone="butd")
    assert missing == [] and unused == [] and loaded.keys() == sd.keys()
    for key, value in sd.items():
        torch.testing.assert_close(loaded[key], value, rtol=0, atol=0, msg=key)


def test_rp_roll_rolls_butd_token_ids():
    batch = _tensors(dict(_batch(6, seed=2), target=np.eye(6, ANSWERS, dtype=np.float32),
                          id_mask=np.ones(6, np.float32)))
    out = tstep.rp_augment(batch, 2)
    torch.testing.assert_close(out["token_ids"], torch.cat([batch["token_ids"],
                                                            torch.roll(batch["token_ids"], 2, 0)]))
    for key in ("feats", "boxes"):
        torch.testing.assert_close(out[key], torch.cat([batch[key], batch[key]]))
    assert out["target"][6:].abs().sum() == 0 and out["id_mask"].tolist() == [1.0] * 6 + [0.0] * 6


@pytest.mark.parametrize("rate", [0.2, 0.5])
def test_dropout_keeps_at_the_exact_rate(rate):
    x = torch.ones(200_000)
    rng = port_butd.DropoutRng(device=torch.Generator().manual_seed(0))
    y = port_butd._dropout(x, rate, True, rng)
    kept = (y != 0).float().mean().item()
    assert abs(kept - (1 - rate)) < 5e-3
    torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0], 1 / (1 - rate)))
    assert torch.equal(port_butd._dropout(x, rate, False, rng), x)


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_forward_and_backward_on_card_match_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rgqa_tpu_torch.ops import attention as att

    cpu_model, cpu_forward = build_model(_cfg(True), device="cpu", train=True,
                                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():  # rows of unit norm: logits of O(1)
        for mod in cpu_model.modules():
            if isinstance(mod, port_butd.WeightNormDense):
                mod.g.fill_(float(np.sqrt(mod.v.shape[0])))
    card_model, card_forward = build_model(_cfg(True), device="cuda", train=True)
    card_model.load_state_dict(cpu_model.state_dict())
    for model in (cpu_model, card_model):  # training mode (cuDNN's GRU backward needs it), no dropout
        model.att.rate = model.answer_dropout = 0.0
    batch = _batch(64, seed=4)
    before = att.fused_attention_cuda.launches
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default: the model turns it off for itself
    outs, grads = [], []
    for model, forward, device in ((cpu_model, cpu_forward, "cpu"), (card_model, card_forward, "cuda")):
        tensors = {k: v.to(device) for k, v in _tensors(batch).items()}
        with forward.precision():
            out = forward(tensors, deterministic=False)
            (out["logits"].square().mean() + out["conf"].square().mean()).backward()
        outs.append({k: v.detach().cpu() for k, v in out.items()})
        grads.append({n: p.grad.detach().cpu() for n, p in model.named_parameters()})
    assert torch.backends.cudnn.allow_tf32 and att.fused_attention_cuda.launches == before
    for key in ("logits", "pooled", "conf"):
        torch.testing.assert_close(outs[1][key], outs[0][key], rtol=1e-4, atol=1e-5, msg=key)
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=1e-3, atol=1e-6, msg=name)


@pytest.mark.parametrize(
    "backbone, flag, match",
    [("butd", "branched_layers", "--branched_layer: BUTD has no layer taps"),
     ("caps", "branched", "the caption matcher has no branched confidence head")],
)
def test_branched_refusals_by_name(backbone, flag, match):
    import dataclasses

    cfg = _cfg() if backbone == "butd" else ModelConfig(backbone="caps")
    with pytest.raises(NotImplementedError, match=match):
        build_model(dataclasses.replace(cfg, **{flag: True}), device="cpu")
