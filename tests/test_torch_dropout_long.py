"""Port parity: attention dropout on streams longer than 64 tokens (4L / 5L).

UNITER with 40-token questions (BUTD's question length in the config)
attends over a 40 + 36 = 76-token stream, past the short dropout
kernels' 64.  On the card that stream runs 4L / 5L
(``fused_attention_dropout_long_cuda`` / ``_bwd_cuda``); on the CPU the
plain pair, which these tests hold:

- UNITER at ``max_text_len`` 40 and 36 RoIs (a tiny width: 2 layers x 64,
  4 heads) against the JAX UNITER on the same weights
  (``from_jax_params``), dropout 0: pooled and logits at rtol 2e-4 /
  atol 2e-5 in f32, and 3 RP steps' losses within rtol 1e-4;
- the plain pair at rate 0.1 and 65, 76, 165 and 277 tokens (2 heads of
  64): the autograd gradient of ``attention_dropout_ref`` equals
  ``attention_dropout_bwd_ref`` within 1e-5 in f32; the mask the forward
  applies, read out through a one-hot V, is ``dropout_keep_mask_ref``'s,
  whose bits equal an independent scalar Philox4x32-10 at sampled
  elements; the kept fraction is within 5 sigma of (256 - t) / 256.  The
  JAX side draws its bits from the TPU's generator (threefry on the XLA
  path), so rate > 0 is held to the port's own contract, as for #4 / #5;
- the routing (#4 / #5 up to 64 tokens, 4L / 5L beyond, on CUDA) and the
  CPU dispatch to the plain pair at length.

Tests marked ``cuda`` hold 4L / 5L under autograd to the plain pair and
count their launches, hold 5L on both of its routes (D by a sweep of its
own with the bias gradient, or D from 4L's output without it) to the
plain pair and at rate 0 to #3L bit for bit, and check that only a bias
that takes a gradient gets one; they skip without a card (``python -m
pytest --noconftest -m cuda tests/test_torch_dropout_long.py`` there).
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from rgqa_tpu_torch.checkpoint.convert import from_jax_params
from rgqa_tpu_torch.config import EncoderConfig, ModelConfig, OptimConfig
from rgqa_tpu_torch.models.uniter import uniter_box_transform
from rgqa_tpu_torch.models.zoo import build_model, example_batch
from rgqa_tpu_torch.ops import attention as att
from rgqa_tpu_torch.ops.dropout import DropoutRng, keep_threshold
from rgqa_tpu_torch.train import optimizer, step as tstep

from test_torch_train import _tensors
from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

TEXT, OBJECTS = 40, 36  # a 76-token stream
ENC = dict(hidden_size=64, num_heads=4, intermediate_size=128, vocab_size=200, num_layers=2,
           num_objects=OBJECTS, visual_feat_dim=40)
INPUTS = ("input_ids", "input_mask", "segment_ids", "feats", "boxes")
RATE = 0.1
PAIR_SHAPES = [65, 76, 165, 277]  # Sq = Skv
PAIR_H, PAIR_D = 2, 64


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cfg(config=None, num_answers=9):
    c = config
    enc = (c.EncoderConfig if c else EncoderConfig)(**ENC, hidden_dropout=0.0, attention_dropout=0.0)
    return (c.ModelConfig if c else ModelConfig)(
        backbone="uniter", encoder=enc, num_answers=num_answers, max_text_len=TEXT)


def _batch(cfg, b, seed, target=False):
    """``example_batch`` with questions of 3-40 tokens (the pads sit
    mid-stream, before the 36 image keys) and UNITER boxes of pixel
    boxes; ``target`` adds training targets."""
    batch = example_batch(cfg, b, seed=seed)
    rng = np.random.default_rng(seed + 100)
    lengths = rng.integers(3, TEXT + 1, b)
    lengths[0] = TEXT
    pad = np.arange(TEXT)[None, :] >= lengths[:, None]
    batch["input_ids"][pad] = 0
    batch["input_mask"][pad] = 0
    x1, y1 = rng.uniform(0, 500, (b, OBJECTS)), rng.uniform(0, 380, (b, OBJECTS))
    w, h = rng.uniform(1, 640 - x1), rng.uniform(1, 480 - y1)
    batch["boxes"] = uniter_box_transform(np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32))
    if target:
        t = np.zeros((b, cfg.num_answers), np.float32)
        t[np.arange(b), rng.integers(0, cfg.num_answers, b)] = rng.random(b, dtype=np.float32)
        batch["target"] = t
        batch["id_mask"] = (rng.random(b) > 0.3).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def jax_uniter(jax):
    """The JAX UNITER at 76 tokens: (params as numpy, the module's config)."""
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.models.zoo import build_model as jax_build_model

    jcfg = _cfg(jax_config)
    batch = _batch(_cfg(), 4, seed=0)
    jmodel, _ = jax_build_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), *[batch[k] for k in INPUTS])["params"]
    return jax.tree_util.tree_map(np.asarray, params), jcfg


def test_uniter_forward_at_76_tokens_matches_jax(jax_uniter):
    from rgqa_tpu.models.zoo import build_model as jax_build_model

    params, jcfg = jax_uniter
    batch = _batch(_cfg(), 5, seed=3)
    assert batch["input_ids"].shape[1] + batch["feats"].shape[1] == 76
    _, jforward = jax_build_model(jcfg)
    want = jforward(params, batch, deterministic=True)
    model, forward = build_model(_cfg(), device="cpu")
    model.load_state_dict(from_jax_params(params), strict=True)
    with torch.no_grad():
        got = forward(_tensors(batch))
    for key in ("logits", "pooled"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key], np.float32),
                                   rtol=2e-4, atol=2e-5, err_msg=key)


def test_uniter_rp_steps_at_76_tokens_match_jax(jax, jax_uniter):
    from rgqa_tpu.config import OptimConfig as JaxOptimConfig
    from rgqa_tpu.models.zoo import build_model as jax_build_model
    from rgqa_tpu.train import create_train_state, make_optimizer as jax_make_optimizer
    from rgqa_tpu.train import make_train_step as jax_make_train_step

    params, jcfg = jax_uniter
    b, lr, n = 4, 2e-3, 3
    batches = [_batch(_cfg(), b, seed=10 + i, target=True) for i in range(n)]
    _, jforward = jax_build_model(jcfg)
    state = create_train_state(params, jax_make_optimizer(JaxOptimConfig(lr=lr), n))
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
    opt = optimizer.make_optimizer(OptimConfig(lr=lr), model.parameters(), t_total=n)
    step = tstep.make_train_step(forward, opt, sample_pair=True, grad_clip=5.0, rng=DropoutRng())
    port_losses = [step(_tensors(batch), shift=s)["loss"].item() for batch, s in zip(batches, shifts)]
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-4)
    assert port_losses[0] != port_losses[-1]  # the weights moved


# ---------------------------------------------------------------------------
# The plain pair at long streams, rate 0.1.
# ---------------------------------------------------------------------------


def _pair_inputs(s, seed, b=2):
    """f32 q, k, v, g (B, s, 2 x 64) and a (B, s) -10000 bias: text keys
    of random lengths, the last 36 keys kept, row 1 fully masked."""
    gen = torch.Generator().manual_seed(seed)
    q, k, v, g = (torch.randn(b, s, PAIR_H * PAIR_D, generator=gen) for _ in range(4))
    text = s - 36
    lengths = torch.randint(1, text + 1, (b, 1), generator=gen)
    bias = ((torch.arange(s)[None, :] >= lengths) & (torch.arange(s)[None, :] < text)).float() * -10000.0
    bias[1] = -10000.0
    return q, k, v, g, bias


def _philox_scalar(c, key):
    """Philox4x32-10 on Python ints (Salmon et al., SC'11), independent of
    the tensor version in ``ops.attention``."""
    mask = 0xFFFFFFFF
    k0, k1 = key
    c0, c1, c2, c3 = c
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c0, 0xCD9E8D57 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0) & mask, p1 & mask, ((p0 >> 32) ^ c3 ^ k1) & mask, p0 & mask
        k0, k1 = (k0 + 0x9E3779B9) & mask, (k1 + 0xBB67AE85) & mask
    return c0, c1, c2, c3


@pytest.mark.parametrize("s", PAIR_SHAPES)
def test_plain_pair_backward_is_the_autograd_of_its_forward(s):
    q, k, v, g, bias = _pair_inputs(s, seed=s)
    seed = 0x1234_5678_9ABC + s
    leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    out = att.attention_dropout_ref(*leaves, PAIR_H, RATE, seed)
    want = torch.autograd.grad(out, leaves, g)
    got = att.attention_dropout_bwd_ref(q, k, v, bias, g, PAIR_H, RATE, seed)
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=1e-5, msg=name)
    # The autograd Function on CPU tensors is the plain pair.
    fn_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fn_out = att.fused_attention_dropout(*fn_leaves, bias, num_heads=PAIR_H, rate=RATE, seed=seed)
    torch.testing.assert_close(fn_out, out.detach(), rtol=0, atol=0)
    for a, w in zip(torch.autograd.grad(fn_out, fn_leaves, g), got[:3]):
        torch.testing.assert_close(a, w, rtol=0, atol=0)


@pytest.mark.parametrize("s", PAIR_SHAPES)
def test_plain_pair_applies_the_keyed_mask(s):
    b, seed = 2, 0xDEAD_BEEF_0000 + s
    zeros = torch.zeros(b, s, PAIR_H * PAIR_D)
    bias = torch.zeros(b, s)
    got = torch.empty(b, PAIR_H, s, s, dtype=torch.bool)
    for j0 in range(0, s, PAIR_D):  # one-hot V, 64 keys a call: out = keep * scale / s
        n = min(PAIR_D, s - j0)
        v = torch.zeros(b, s, PAIR_H, PAIR_D)
        v[:, torch.arange(j0, j0 + n), :, torch.arange(n)] = 1.0
        out = att.attention_dropout_ref(zeros, zeros, v.reshape(b, s, -1), bias, PAIR_H, RATE, seed)
        got[..., j0:j0 + n] = out.reshape(b, s, PAIR_H, PAIR_D)[..., :n].permute(0, 2, 1, 3) > 0
    keep = att.dropout_keep_mask_ref(seed, b, PAIR_H, s, s, RATE)
    assert torch.equal(got, keep)
    # Its bits, at sampled elements, from a scalar Philox4x32-10.
    t, keep_p = keep_threshold(RATE)
    rng = np.random.default_rng(s)
    for bi, h, i, j in zip(*(rng.integers(0, n, 64).tolist() for n in (b, PAIR_H, s, s))):
        words = _philox_scalar((j // 16, i, h, bi), (seed & 0xFFFFFFFF, seed >> 32))
        byte = (words[(j % 16) // 4] >> (8 * (j % 4))) & 0xFF
        assert bool(keep[bi, h, i, j]) == (byte >= t), (bi, h, i, j)
    frac = keep.float().mean().item()
    sigma = math.sqrt(keep_p * (1 - keep_p) / keep.numel())
    assert abs(frac - keep_p) < 5 * sigma, (frac, keep_p)


# ---------------------------------------------------------------------------
# Routing.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sq,skv,long", [(64, 64, False), (20, 36, False), (76, 76, True),
                                         (65, 20, True), (20, 597, True)])
def test_dropout_routing(sq, skv, long):
    fwd = att.dropout_forward_kernel(sq, skv, 64)
    bwd = att.dropout_backward_kernel(sq, skv, 64)
    if long:
        assert (fwd, bwd) == (att.fused_attention_dropout_long_cuda, att.fused_attention_dropout_long_bwd_cuda)
    else:
        assert (fwd, bwd) == (att.fused_attention_dropout_cuda, att.fused_attention_dropout_bwd_cuda)


def test_long_dropout_wrappers_refuse_cpu_tensors():
    q, k, v, g, bias = _pair_inputs(76, seed=0)
    counts = (att.fused_attention_dropout_long_cuda.launches, att.fused_attention_dropout_long_bwd_cuda.launches)
    with pytest.raises(ValueError, match="not CUDA"):
        att.fused_attention_dropout_long_cuda(q, k, v, bias, PAIR_H, RATE, 1)
    with pytest.raises(ValueError, match="not CUDA"):
        att.fused_attention_dropout_long_bwd_cuda(q, k, v, bias, g, PAIR_H, RATE, 1, torch.zeros(2, PAIR_H, 76, 2))
    assert (att.fused_attention_dropout_long_cuda.launches,
            att.fused_attention_dropout_long_bwd_cuda.launches) == counts


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", PAIR_SHAPES)
def test_long_dropout_kernels_match_plain_on_card(cuda, s, dtype):
    dt = getattr(torch, dtype)
    q, k, v, g, bias = (t.to(cuda) for t in _pair_inputs(s, seed=s, b=3))
    q, k, v, g = (t.to(dt) for t in (q, k, v, g))
    seed = 99 + s
    leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    counts = (att.fused_attention_dropout_long_cuda.launches, att.fused_attention_dropout_long_bwd_cuda.launches)
    out = att.fused_attention_dropout(*leaves, num_heads=PAIR_H, rate=RATE, seed=seed)
    grads = torch.autograd.grad(out, leaves, g)
    assert (att.fused_attention_dropout_long_cuda.launches,
            att.fused_attention_dropout_long_bwd_cuda.launches) == (counts[0] + 1, counts[1] + 1)
    want = att.attention_dropout_ref(q, k, v, bias, PAIR_H, RATE, seed)
    want_grads = att.attention_dropout_bwd_ref(q, k, v, bias, g, PAIR_H, RATE, seed)
    atol, rtol = (1e-4, 0.0) if dtype == "float32" else (3e-2, 1e-2)
    torch.testing.assert_close(out.float(), want.float(), atol=atol, rtol=rtol)
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), grads, want_grads):
        tol = (1e-3, 1e-4) if name == "dbias" and dtype == "bfloat16" else (atol, rtol)
        torch.testing.assert_close(a.float(), w.float(), atol=tol[0], rtol=tol[1], msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", PAIR_SHAPES)
def test_5l_routes_match_plain_and_rate_0_is_3l_on_card(cuda, s, dtype):
    # 5L on both routes (dbias: D by a sweep of its own; without: D from
    # 4L's dropped output) against the plain pair, and at rate 0 equal to
    # #3L on the same route bit for bit, with 4L equal to #2.
    dt = getattr(torch, dtype)
    q, k, v, g, bias = (t.to(cuda) for t in _pair_inputs(s, seed=s + 1, b=3))
    q, k, v, g = (t.to(dt) for t in (q, k, v, g))
    seed = 7 + s
    out, lse = att.fused_attention_dropout_long_cuda(q, k, v, bias, PAIR_H, RATE, seed, lse=True)
    want = att.attention_dropout_bwd_ref(q, k, v, bias, g, PAIR_H, RATE, seed)
    atol, rtol = (1e-4, 0.0) if dtype == "float32" else (3e-2, 1e-2)
    for kw in ({}, {"dbias": False, "out": out}):
        got = att.fused_attention_dropout_long_bwd_cuda(q, k, v, bias, g, PAIR_H, RATE, seed, lse, **kw)
        assert (got[3] is None) == bool(kw)
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            torch.testing.assert_close(a.float(), w.float(), atol=atol, rtol=rtol, msg=name)
    out0, lse0 = att.fused_attention_dropout_long_cuda(q, k, v, bias, PAIR_H, 0.0, seed, lse=True)
    out2, lse2 = att.fused_attention_long_cuda(q, k, v, bias, PAIR_H, lse=True)
    assert torch.equal(out0, out2) and torch.equal(lse0, lse2)
    for kw0, kw2 in (({}, {}), ({"dbias": False, "out": out0}, {"dbias": False, "out": out2})):
        got = att.fused_attention_dropout_long_bwd_cuda(q, k, v, bias, g, PAIR_H, 0.0, seed, lse0, **kw0)
        ref = att.fused_attention_long_bwd_cuda(q, k, v, bias, g, PAIR_H, lse2, **kw2)
        assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("bias_grad", [True, False])
@pytest.mark.parametrize("s", PAIR_SHAPES)
def test_5l_autograd_gives_dbias_only_to_a_bias_that_takes_one(cuda, s, bias_grad):
    # bf16 under autograd: a bias with requires_grad takes the exact route
    # and its gradient within the bf16 dbias bound; one without gets None
    # (5L takes D from 4L's saved output).  q, k, v's gradients match the
    # plain pair either way.
    q, k, v, g, bias = (t.to(cuda) for t in _pair_inputs(s, seed=s + 2, b=3))
    q, k, v, g = (t.bfloat16() for t in (q, k, v, g))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    tbias = bias.clone().requires_grad_(bias_grad)
    seed = 11 + s
    before = att.fused_attention_dropout_long_bwd_cuda.launches
    att.fused_attention_dropout(*leaves, tbias, num_heads=PAIR_H, rate=RATE, seed=seed).backward(g)
    assert att.fused_attention_dropout_long_bwd_cuda.launches == before + 1
    want = att.attention_dropout_bwd_ref(q, k, v, bias, g, PAIR_H, RATE, seed)
    for name, leaf, w in zip(("dq", "dk", "dv"), leaves, want):
        torch.testing.assert_close(leaf.grad.float(), w.float(), atol=3e-2, rtol=1e-2, msg=name)
    if bias_grad:
        torch.testing.assert_close(tbias.grad, want[3], atol=1e-3, rtol=1e-4)
    else:
        assert tbias.grad is None
