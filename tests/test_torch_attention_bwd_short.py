"""The short attention backward (#3, and #5 with dropout) as the one-pass
tensor-core body of ``csrc/attention_common.cuh`` computes it.

On the CPU, at LXMERT's full head width (12 heads of 64), batch 2, a
quarter of the keys masked and one fully masked row:

- a plain emulation of the body's roundings (dP from bf16 g and V summed
  in f32; P rounded to bf16 before dV; dS times 1/sqrt(d) rounded to bf16
  before dQ and dK; dbias from f32 dS, summed over each warp's 16 query
  rows, then over the warps and the heads in order) is held to
  ``attention_bwd_ref`` / ``attention_dropout_bwd_ref`` at 36x36 and
  20x36, and at 36x36 to ``jax.vjp`` through the JAX package's ``_fused``,
  whose custom_vjp runs the Pallas backward in interpret mode (as
  ``tests/test_torch_attention_grad.py`` runs it), under the card's
  bounds: 3e-2 + 1e-2 |plain| for dq, dk, dv and 1e-3 + 1e-4 |plain| for
  dbias (``chip_smoke.TOL``);
- the dropout mask as the body reads it: one Philox4x32-10 call per
  (query row, 16 keys) gives 16 keep bits, and each lane's bits for the
  accumulator elements it holds (mma.sync m16n8 fragments: row g or g +
  8, key 8 n + t or + 1) are ``dropout_keep_mask_ref``'s, each (row, key)
  of a warp's tile held by one lane once.

Tests marked ``cuda`` hold the kernels to their plain versions on the
card at ragged lengths and skip without one.
"""

import math

import numpy as np
import pytest
import torch

from rgqa_tpu_torch.ops import attention as att
from rgqa_tpu_torch.ops.dropout import keep_threshold

from test_torch_attention_fwd_short import UNITER, _uniter_bias
from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

H, D = 12, 64
E = H * D
BOUNDS = {"dq": (3e-2, 1e-2), "dk": (3e-2, 1e-2), "dv": (3e-2, 1e-2), "dbias": (1e-3, 1e-4)}
RATE, SEED = 0.1, 2**40 + 3
WARP_ROWS = 16  # query rows (phase 1) or keys (phase 2) per warp


@pytest.fixture(scope="module")
def jax_attention():
    pytest.importorskip("jax")
    from rgqa_tpu.ops import attention

    return attention


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(b, sq, skv, e=E, seed=0):
    """numpy f32 q, k, v, g (bf16-exact) and a (B, Skv) -10000 bias with a
    quarter of the keys masked and row b // 2 fully masked."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (
        torch.from_numpy(rng.standard_normal((b, s, e), dtype=np.float32)).bfloat16().float().numpy()
        for s in (sq, skv, skv, sq)
    )
    mask = (rng.random((b, skv)) > 0.25).astype(np.float32)
    mask[:, 0] = 1.0
    mask[b // 2] = 0.0
    return q, k, v, g, (1.0 - mask) * -10000.0


def _short_body(q, k, v, bias, g, heads, drop=None):
    """The bf16 body's arithmetic, step by step, on bf16 tensors: S and dP
    as f32 sums of exact products; the row softmax in f32; P_drop and
    round(dS scale) in bf16 for the dV, dQ and dK products; dbias as the
    kernel sums it (16 rows per warp, then warps, then heads in order)."""
    b, sq, e = q.shape
    skv = k.shape[1]
    d = e // heads
    scale = 1.0 / math.sqrt(d)
    qh, kh, vh, gh = (t.float().reshape(b, -1, heads, d).transpose(1, 2) for t in (q, k, v, g))
    p = torch.softmax(qh @ kh.transpose(-1, -2) * scale + bias[:, None, None, :], dim=-1)
    dp = gh @ vh.transpose(-1, -2)
    p_drop = p
    if drop is not None:
        keep, keep_scale = drop
        dp = torch.where(keep, dp * keep_scale, 0.0)
        p_drop = torch.where(keep, p * keep_scale, 0.0)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    ds_b = (ds * scale).bfloat16().float()
    dq = ds_b @ kh
    dk = ds_b.transpose(-1, -2) @ qh
    dv = p_drop.bfloat16().float().transpose(-1, -2) @ gh
    dbias = torch.zeros(b, skv)
    for h in range(heads):
        for r0 in range(0, sq, WARP_ROWS):
            dbias = dbias + ds[:, h, r0:r0 + WARP_ROWS].sum(1)

    def merge(t):
        return t.transpose(1, 2).reshape(b, -1, e).bfloat16()

    return merge(dq), merge(dk), merge(dv), dbias


def _assert_within(got, want):
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        atol, rtol = BOUNDS[name]
        assert torch.isfinite(a.float()).all(), name  # the fully masked row too
        err = (a.float() - w.float()).abs()
        assert bool((err <= atol + rtol * w.float().abs()).all()), (
            f"{name}: max |body - plain| {err.max().item():.3e} over {atol} + {rtol}|plain|")


@pytest.mark.parametrize("rate", [None, RATE])
@pytest.mark.parametrize("sq,skv", [(36, 36), (20, 36)])
def test_body_roundings_within_bounds_of_plain(sq, skv, rate):
    q, k, v, g, bias = (torch.from_numpy(a) for a in _inputs(2, sq, skv, seed=sq * 100 + skv))
    q, k, v, g = (t.bfloat16() for t in (q, k, v, g))
    if rate is None:
        want = att.attention_bwd_ref(q, k, v, bias, g, H)
        got = _short_body(q, k, v, bias, g, H)
    else:
        want = att.attention_dropout_bwd_ref(q, k, v, bias, g, H, rate, SEED)
        got = _short_body(q, k, v, bias, g, H, drop=att._drop(q, k, H, rate, SEED))
    _assert_within(got, want)


def test_body_roundings_within_bounds_of_pallas_backward(jax_attention):
    import jax
    import jax.numpy as jnp

    q, k, v, g, bias = _inputs(2, 36, 36, seed=3636)
    jq, jk, jv, jg = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, g))
    _, vjp = jax.vjp(lambda *a: jax_attention._fused(*a, H), jq, jk, jv, jnp.asarray(bias))
    want = [torch.from_numpy(np.array(w, np.float32)) for w in vjp(jg)]
    tq, tk, tv, tg = (torch.from_numpy(a).bfloat16() for a in (q, k, v, g))
    _assert_within(_short_body(tq, tk, tv, torch.from_numpy(bias), tg, H), want)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_bits_per_16_keys_give_the_mask(rate):
    # One Philox4x32-10 call per (row, 16 keys): bit s of word (i, c) keeps
    # key 16 c + s; lane l of warp w holds rows 16 w + l // 4 (+ 8) and
    # keys 8 n + 2 (l % 4) (+ 1) for n-tiles n, and reads bit (n % 2) 8 +
    # 2 (l % 4) (+ 1) of word (row, n // 2).
    b, sq, skv, seed = 2, 36, 36, 2**62 + 7
    t, _ = keep_threshold(rate)
    groups = (skv + 15) // 16
    bb, hh, ii, cc = torch.meshgrid(
        *(torch.arange(n, dtype=torch.int64) for n in (b, H, sq, groups)), indexing="ij")
    words = torch.stack(att._philox4x32_10(cc, ii, hh, bb, seed), dim=-1)  # (..., 4)
    bits = torch.zeros(b, H, sq, groups, dtype=torch.int64)
    for s in range(16):
        byte = (words[..., s // 4] >> (8 * (s % 4))) & 0xFF
        bits |= (byte >= t).long() << s
    want = att.dropout_keep_mask_ref(seed, b, H, sq, skv, rate)
    got = torch.zeros_like(want)
    seen = torch.zeros(sq, 64, dtype=torch.int64)
    for warp in range((sq + 15) // 16):
        for lane in range(32):
            g, tt = lane // 4, 2 * (lane % 4)
            for n in range(8):
                for e in range(4):
                    i, j = warp * 16 + g + 8 * (e >= 2), 8 * n + tt + (e & 1)
                    if i >= sq:
                        continue
                    seen[i, j] += 1
                    if j < skv:
                        bit = (n % 2) * 8 + tt + (e & 1)
                        got[:, :, i, j] = ((bits[:, :, i, n // 2] >> bit) & 1).bool()
    assert bool((seen == 1).all())
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# On the card: the kernels at ragged lengths (12 heads of 64, batch 7).
# ---------------------------------------------------------------------------

RAGGED = (1, 15, 17, 33, 64)
CARD_TOL = {"float32": (1e-4, 0.0), "bfloat16": (3e-2, 1e-2)}


def _card_inputs(cuda, b, sq, skv, dtype, seed=0):
    """As the model hands them; at UNITER's shape its mask (the text pads
    of each question between its words and the image keys)."""
    q, k, v, g, bias = _inputs(b, sq, skv, seed=seed)
    if (sq, skv) == UNITER:
        bias = _uniter_bias(b, seed)
    tq, tk, tv, tg = (torch.from_numpy(a).to(cuda, getattr(torch, dtype)) for a in (q, k, v, g))
    if sq == skv:  # self-attention: column views of one fused QKV product
        tq, tk, tv = torch.cat([tq, tk, tv], dim=-1).split(E, dim=-1)
    return tq, tk, tv, tg, torch.from_numpy(bias).to(cuda)


def _card_close(got, want, dtype):
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        atol, rtol = BOUNDS["dbias"] if name == "dbias" and dtype == "bfloat16" else CARD_TOL[dtype]
        assert a.dtype == w.dtype and torch.isfinite(a.float()).all(), name
        err = (a.float() - w.float()).abs()
        assert bool((err <= atol + rtol * w.float().abs()).all()), (
            f"{name}: max |kernel - plain| {err.max().item():.3e} over {atol} + {rtol}|plain|")


def _check_pair(q, k, v, g, bias, dtype):
    """#3 and #5 against their plain versions, reruns bit for bit, #5 at
    rate 0 == #3 bit for bit."""
    got = att.fused_attention_bwd_cuda(q, k, v, bias, g, H)
    _card_close(got, att.attention_bwd_ref(q, k, v, bias, g, H), dtype)
    drop = att.fused_attention_dropout_bwd_cuda(q, k, v, bias, g, H, RATE, SEED)
    _card_close(drop, att.attention_dropout_bwd_ref(q, k, v, bias, g, H, RATE, SEED), dtype)
    again = (att.fused_attention_bwd_cuda(q, k, v, bias, g, H),
             att.fused_attention_dropout_bwd_cuda(q, k, v, bias, g, H, RATE, SEED))
    for first, second in zip((got, drop), again):
        assert all(torch.equal(x, y) for x, y in zip(first, second))
    rate0 = att.fused_attention_dropout_bwd_cuda(q, k, v, bias, g, H, 0.0, SEED)
    assert all(torch.equal(x, y) for x, y in zip(rate0, got))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("skv", RAGGED)
@pytest.mark.parametrize("sq", RAGGED)
def test_short_bwd_kernels_match_plain_at_ragged_lengths_on_card(cuda, sq, skv, dtype):
    _check_pair(*_card_inputs(cuda, 7, sq, skv, dtype, seed=sq * 100 + skv), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [64, 256])
@pytest.mark.parametrize("sq,skv", [(20, 20), (36, 36), (20, 36), (36, 20), UNITER])
def test_short_bwd_kernels_match_plain_at_training_batches_on_card(cuda, sq, skv, batch):
    # The blocks' heads-per-block variant at LXMERT's shapes and the
    # batches the training step (32 + RP) and the smoke time.
    _check_pair(*_card_inputs(cuda, batch, sq, skv, "bfloat16", seed=batch + sq), "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [1, 3, 5])
def test_short_bwd_kernels_take_any_head_count_on_card(cuda, heads):
    # A block takes its row's heads in groups; a head count the group size
    # does not divide leaves a last group with fewer heads.
    q, k, v, g, bias = _card_inputs(cuda, 7, 36, 20, "bfloat16", seed=heads)
    q, k, v, g = (t[..., :heads * D].contiguous() for t in (q, k, v, g))
    got = att.fused_attention_bwd_cuda(q, k, v, bias, g, heads)
    _card_close(got, att.attention_bwd_ref(q, k, v, bias, g, heads), "bfloat16")
    drop = att.fused_attention_dropout_bwd_cuda(q, k, v, bias, g, heads, RATE, SEED)
    _card_close(drop, att.attention_dropout_bwd_ref(q, k, v, bias, g, heads, RATE, SEED), "bfloat16")
