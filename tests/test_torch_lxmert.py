"""Port parity: ``rgqa_tpu_torch`` LXMERT against the flax model.

A tiny ``LxmertForGQA`` (hidden 32, 4 heads, vocab 128) is initialised by
the JAX package, converted with ``from_jax_params`` and loaded strictly
into the port; both forwards run on one numpy batch (with padded text)
and agree on logits and pooled at rtol 2e-4 / atol 2e-5, the bar of
``tests/test_torch_import.py``.  The weights also round-trip through the
reference checkpoint's key names, which the JAX importer reads back.
"""

import numpy as np
import pytest
import torch

from rgqa_tpu.config import EncoderConfig, ModelConfig
from rgqa_tpu_torch.checkpoint.convert import (
    from_jax_params,
    load_reference_pth,
    port_key,
    to_reference_state_dict,
)
from rgqa_tpu_torch.models import transformer as tt
from rgqa_tpu_torch.models.zoo import build_model, example_batch
from rgqa_tpu_torch.ops import attention as att
from rgqa_tpu_torch.ops.dropout import HiddenDropout
from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

DEPTHS = [(1, 1, 1), (2, 1, 2)]  # (language, cross, vision) layers


def _cfg(l_layers=1, x_layers=1, r_layers=1, num_answers=7, **enc):
    enc = {
        "hidden_size": 32, "num_heads": 4, "intermediate_size": 64,
        "vocab_size": 128, "visual_feat_dim": 48, "num_objects": 10,
        "l_layers": l_layers, "x_layers": x_layers, "r_layers": r_layers,
        **enc,
    }
    return ModelConfig(
        backbone="lxmert", encoder=EncoderConfig(**enc),
        num_answers=num_answers, max_text_len=12,
    )


def _batch(cfg, b=5, seed=1):
    batch = example_batch(cfg, b, seed=seed)
    batch["input_mask"][1:, 7:] = 0  # padded questions
    batch["input_ids"][1:, 7:] = 0
    return batch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module", params=DEPTHS, ids=lambda d: "l{}x{}r{}".format(*d))
def jax_model(request):
    pytest.importorskip("jax")
    import jax

    from rgqa_tpu.models.zoo import build_model as jax_build_model

    cfg = _cfg(*request.param)
    model, forward = jax_build_model(cfg)
    batch = _batch(cfg)
    args = [batch[k] for k in ("input_ids", "input_mask", "segment_ids", "feats", "boxes")]
    params = model.init(jax.random.PRNGKey(0), *args)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    return cfg, params, forward, batch


def _port_model(cfg, params):
    model, forward = build_model(cfg, device="cpu")
    model.load_state_dict(from_jax_params(params), strict=True)
    return model, forward


def test_forward_matches_flax(jax_model):
    cfg, params, jax_forward, batch = jax_model
    want = jax_forward(params, batch, deterministic=True)
    _, forward = _port_model(cfg, params)
    with torch.inference_mode():
        got = forward({k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ("logits", "pooled"):
        np.testing.assert_allclose(
            got[key].numpy(), np.asarray(want[key]), rtol=2e-4, atol=2e-5
        )


def test_plain_switch_is_the_same_on_cpu(jax_model):
    cfg, params, _, batch = jax_model
    _, forward = _port_model(cfg, params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.inference_mode():
        auto, plain = forward(tb), forward(tb, use_fused=False)
    torch.testing.assert_close(auto["logits"], plain["logits"], rtol=0, atol=0)


def test_reference_pth_roundtrip(jax_model, tmp_path):
    import jax

    from rgqa_tpu.checkpoint.torch_import import import_lxmert_gqa

    cfg, params, _, _ = jax_model
    enc = cfg.encoder
    depths = dict(l_layers=enc.l_layers, x_layers=enc.x_layers, r_layers=enc.r_layers)
    sd = from_jax_params(params)
    path = str(tmp_path / "gqa.pth")
    torch.save(to_reference_state_dict(sd, **depths), path)

    back, missing, unused = load_reference_pth(path, **depths)
    assert missing == [] and unused == []
    assert back.keys() == sd.keys()
    for key in sd:
        torch.testing.assert_close(back[key], sd[key], rtol=0, atol=0)

    # The JAX package's importer reads the same file into its own tree.
    zeros = jax.tree_util.tree_map(np.zeros_like, params)
    tree, missing, unused = import_lxmert_gqa(zeros, path, **depths)
    assert missing == [] and unused == []
    for (path_a, a), (path_b, b) in zip(
        jax.tree_util.tree_leaves_with_path(params),
        jax.tree_util.tree_leaves_with_path(tree),
    ):
        assert path_a == path_b
        np.testing.assert_array_equal(a, b)


def test_from_jax_params_refuses_unported_heads():
    pytest.importorskip("jax")
    import dataclasses

    import jax

    from rgqa_tpu.models.zoo import build_model as jax_build_model

    cfg = dataclasses.replace(_cfg(), branched=True)
    model, _ = jax_build_model(cfg)
    batch = _batch(cfg)
    args = [batch[k] for k in ("input_ids", "input_mask", "segment_ids", "feats", "boxes")]
    params = model.init(jax.random.PRNGKey(0), *args)["params"]
    # The branched confidence head is ported (slice 10) ...
    assert from_jax_params(params)["conf_head.logits.weight"].shape == (1, 64)
    # ... a pretraining head is not.
    params = dict(params, matched_head={"kernel": np.zeros((32, 2), np.float32),
                                        "bias": np.zeros((2,), np.float32)})
    with pytest.raises(ValueError, match="matched_head"):
        from_jax_params(params)


def test_port_key_renames():
    assert port_key(("lxmert", "lang_3", "att", "query", "kernel")) == "lxmert.lang_layers.3.att.query.weight"
    assert port_key(("lxmert", "x_0", "cross_att", "out_ln", "scale")) == "lxmert.x_layers.0.cross_att.out_ln.weight"
    assert port_key(("lxmert", "embeddings", "word_embeddings", "embedding")) == "lxmert.embeddings.word_embeddings.weight"
    assert port_key(("answer_head", "logits", "bias")) == "answer_head.logits.bias"


def test_example_batch_matches_jax():
    pytest.importorskip("jax")
    from rgqa_tpu.models.zoo import example_batch as jax_example_batch

    cfg = _cfg()
    want = jax_example_batch(cfg, 6, seed=3)
    got = example_batch(cfg, 6, seed=3)
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_gelu_mask_match_flax(dtype):
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from rgqa_tpu.models import transformer as jt

    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 16), dtype=np.float32) * 3 + 1
    scale = rng.standard_normal(16, dtype=np.float32)
    bias = rng.standard_normal(16, dtype=np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tol = {"float32": 1e-5, "bfloat16": 2e-2}[dtype]

    ln = tt.LayerNorm(16)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
    want = jt.LayerNorm().apply({"params": {"scale": scale, "bias": bias}}, jnp.asarray(x, jdt))
    with torch.no_grad():
        got = ln(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol)

    want = jt.gelu(jnp.asarray(x, jdt))
    got = tt.gelu(torch.from_numpy(x).to(tdt))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol)

    mask = (rng.random((3, 7)) > 0.5).astype(np.int32)
    want = jt.mask_to_bias(jnp.asarray(mask), jdt)
    got = tt.mask_to_bias(torch.from_numpy(mask), tdt)
    assert tuple(got.shape) == (3, 1, 1, 7) and got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_bf16_build_casts_every_weight():
    model, forward = build_model(_cfg(), use_bf16=True, device="cpu")
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    batch = {k: torch.from_numpy(v) for k, v in _batch(_cfg()).items()}
    with torch.inference_mode():
        out = forward(batch)
    assert out["logits"].dtype == torch.bfloat16 and out["logits"].shape == (5, 7)
    assert torch.isfinite(out["logits"].float()).all()


def test_init_is_seeded():
    def weights(seed):
        model, _ = build_model(_cfg(), device="cpu", generator=torch.Generator().manual_seed(seed))
        return model.state_dict()

    a, b, c = weights(5), weights(5), weights(6)
    w = "lxmert.lang_layers.0.att.query.weight"
    torch.testing.assert_close(a[w], b[w], rtol=0, atol=0)
    assert not torch.equal(a[w], c[w])
    assert abs(a[w].std().item() - 0.02) < 0.005
    assert torch.equal(a["lxmert.lang_layers.0.att.out_ln.weight"], torch.ones(32))


def test_hidden_dropout_is_identity_at_inference():
    x = torch.randn(4, 8)
    drop = HiddenDropout(0.1)
    assert drop.eval()(x) is x
    assert HiddenDropout(0.0).train()(x) is x
    # Training mode drops (the cheap_dropout contract, tests/test_torch_train.py).
    out = drop.train()(torch.ones(64, 64))
    assert set(out.unique().tolist()) == {0.0, torch.tensor(256 / 230).item()}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_depth_kernel_launches_and_agrees_on_card(cuda, dtype):
    cfg = _cfg(9, 5, 5, hidden_size=128, num_heads=2, intermediate_size=256)
    model, forward = build_model(cfg, use_bf16=dtype == "bfloat16", device=cuda)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in _batch(cfg, b=7).items()}
    with torch.inference_mode():
        before = att.fused_attention_cuda.launches
        got = forward(batch)
        torch.cuda.synchronize()
        assert att.fused_attention_cuda.launches - before == 34
        want = forward(batch, use_fused=False)
    err = (got["logits"].float() - want["logits"].float()).abs().max().item()
    assert err <= {"float32": 1e-4, "bfloat16": 1e-1}[dtype]
