"""The short attention forward (#1, and #4 with dropout) as the one-pass
tensor-core body of ``csrc/attention_common.cuh`` (``fwd_short_body``)
computes it.

On the CPU, at head width 64 (4 heads), batch 2, a quarter of the keys
masked and one fully masked row:

- a plain emulation of the body's roundings (S as f32 sums of exact
  bf16 products; scale and bias added in f32; the row max, the sum of
  exp(x - max) and one reciprocal per row; P = e * (1 / sum), dropped and
  scaled where the body applies the mask, rounded to bf16 before P V; O
  summed in f32 and rounded to bf16) is held to ``attention_natural_ref``
  / ``attention_dropout_ref`` at LXMERT's four shapes and a ragged pair,
  and to the JAX package's ``_fused`` (the Pallas ``_fused_kernel`` in
  interpret mode, as ``tests/test_torch_attention.py`` runs it), under
  the card's bf16 bound 3e-2 + 1e-2 |plain| (``chip_smoke.TOL``);
- the dropout mask as the forward's lanes read it: the four lanes of a
  quad hold query rows i and i + 8, split the quad's 2 x SKP / 16
  Philox4x32-10 calls (one per row and 16 keys) between them and pass
  the words round by shuffles, and each lane keeps one nibble per call
  (``keep_nibbles``): every (row, key) of a warp's strip is read by one
  lane once, each call drawn once, and the bits are
  ``dropout_keep_mask_ref``'s.

Tests marked ``cuda`` hold the kernels to their plain versions on the
card (ragged lengths, head counts, batches, strided views, reruns, rate
0 against #1) and skip without one.
"""

import math

import numpy as np
import pytest
import torch

from rgqa_tpu_torch.ops import attention as att
from rgqa_tpu_torch.ops.dropout import keep_threshold
from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

H, D = 4, 64
E = H * D
ATOL, RTOL = 3e-2, 1e-2  # bf16: the body rounds P to bf16 where the plain version keeps f32
RATE, SEED = 0.1, 2**40 + 3
SHAPES = [(20, 20), (36, 36), (20, 36), (36, 20)]
# UNITER's single stream, 20 text tokens + 36 RoI features.  On the card
# its keys are masked as UNITER's are (``_uniter_bias``): each question's
# text pads sit between its words and the image tokens.
UNITER, UNITER_TEXT = (56, 56), 20
WARP_ROWS = 16  # query rows of a warp's strip


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
    """numpy f32 q, k, v (bf16-exact) and a (B, Skv) -10000 bias with a
    quarter of the keys masked and row b // 2 fully masked."""
    rng = np.random.default_rng(seed)
    q, k, v = (
        torch.from_numpy(rng.standard_normal((b, s, e), dtype=np.float32)).bfloat16().float().numpy()
        for s in (sq, skv, skv)
    )
    mask = (rng.random((b, skv)) > 0.25).astype(np.float32)
    mask[:, 0] = 1.0
    mask[b // 2] = 0.0
    return q, k, v, (1.0 - mask) * -10000.0


def _short_body(q, k, v, bias, heads, drop=None):
    """The bf16 body's arithmetic on bf16 tensors: S from exact products
    summed in f32, x = S scale + bias, e = exp(x - max), P = e * (1 / sum),
    masked and scaled (``drop`` = (keep, keep_scale)), rounded to bf16; O
    summed in f32, rounded to bf16."""
    b, sq, e = q.shape
    d = e // heads
    qh, kh, vh = (t.float().reshape(b, -1, heads, d).transpose(1, 2) for t in (q, k, v))
    x = qh @ kh.transpose(-1, -2) * (1.0 / math.sqrt(d)) + bias[:, None, None, :]
    ex = torch.exp(x - x.amax(-1, keepdim=True))
    p = ex * (1.0 / ex.sum(-1, keepdim=True))
    if drop is not None:
        keep, keep_scale = drop
        p = torch.where(keep, p * keep_scale, 0.0)
    o = p.bfloat16().float() @ vh
    return o.transpose(1, 2).reshape(b, sq, e).bfloat16()


def _assert_within(got, want):
    assert torch.isfinite(got.float()).all()  # the fully masked row too
    err = (got.float() - want.float()).abs()
    assert bool((err <= ATOL + RTOL * want.float().abs()).all()), (
        f"max |body - plain| {err.max().item():.3e} over {ATOL} + {RTOL}|plain|")


@pytest.mark.parametrize("rate", [None, RATE])
@pytest.mark.parametrize("sq,skv", SHAPES + [(17, 33)])
def test_body_roundings_within_bounds_of_plain(sq, skv, rate):
    q, k, v, bias = (torch.from_numpy(a) for a in _inputs(2, sq, skv, seed=sq * 100 + skv))
    q, k, v = (t.bfloat16() for t in (q, k, v))
    if rate is None:
        want = att.attention_natural_ref(q, k, v, bias, H)
        got = _short_body(q, k, v, bias, H)
    else:
        want = att.attention_dropout_ref(q, k, v, bias, H, rate, SEED)
        got = _short_body(q, k, v, bias, H, drop=att._drop(q, k, H, rate, SEED))
    _assert_within(got, want)


@pytest.mark.parametrize("sq,skv", SHAPES)
def test_body_roundings_within_bounds_of_pallas_forward(jax_attention, sq, skv):
    import jax.numpy as jnp

    q, k, v, bias = _inputs(2, sq, skv, seed=sq * 10 + skv)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = torch.from_numpy(np.array(jax_attention._fused(jq, jk, jv, jnp.asarray(bias), H), np.float32))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    _assert_within(_short_body(tq, tk, tv, torch.from_numpy(bias), H), want)


def _keep_words(b, heads, sq, groups, seed, t):
    """keep_bits16 of every (b, h, row, 16-key group): bit s keeps key 16 c + s."""
    bb, hh, ii, cc = torch.meshgrid(
        *(torch.arange(n, dtype=torch.int64) for n in (b, heads, sq, groups)), indexing="ij")
    words = torch.stack(att._philox4x32_10(cc, ii, hh, bb, seed), dim=-1)  # (..., 4)
    bits = torch.zeros(b, heads, sq, groups, dtype=torch.int64)
    for s in range(16):
        byte = (words[..., s // 4] >> (8 * (s % 4))) & 0xFF
        bits |= (byte >= t).long() << s
    return bits


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("sq,skv", [(36, 36), (20, 20), (17, 64)])
def test_keep_nibbles_give_the_mask(sq, skv, rate):
    # keep_nibbles: quad lane ql draws calls k = ql, ql + 4 (k = hf kG + c:
    # row i + 8 hf, keys 16 c ..), every lane of the quad takes call k from
    # lane k % 4 and keeps bits t, t + 1, 8 + t, 9 + t of it (t = 2 ql) as
    # nibble k; accumulator element e of n-tile n reads bit (n % 2) 2 + (e
    # & 1) of nibble (e // 2) kG + n // 2.
    b, seed = 2, 2**62 + 7
    t, _ = keep_threshold(rate)
    kg = (skv + 15) // 16 if skv > 16 else 2  # SKP / 16, keys padded to at least 32
    words = _keep_words(b, H, sq + WARP_ROWS, kg, seed, t)  # rows past sq are drawn too
    want = att.dropout_keep_mask_ref(seed, b, H, sq, skv, rate)
    got = torch.zeros_like(want)
    seen = torch.zeros(sq, 8 * 2 * kg, dtype=torch.int64)
    drawn = torch.zeros(sq + WARP_ROWS, kg, dtype=torch.int64)
    for warp in range((sq + 15) // 16):
        for quad in range(8):
            i = warp * 16 + quad
            mine = {}  # (lane, slot) -> the word that lane drew
            for ql in range(4):
                for slot in range((2 * kg + 3) // 4):
                    k = ql + 4 * slot
                    if k < 2 * kg:
                        mine[ql, slot] = words[:, :, i + 8 * (k // kg), k % kg]
                        drawn[i + 8 * (k // kg), k % kg] += 1
            for ql in range(4):
                tt = 2 * ql
                nib = torch.zeros(b, H, dtype=torch.int64)
                for k in range(2 * kg):
                    w = mine[k % 4, k // 4]  # the shuffle from lane k % 4
                    nib |= (((w >> tt) & 3) | (((w >> (8 + tt)) & 3) << 2)) << (4 * k)
                for n in range(2 * kg):
                    for e in range(4):
                        row, j = i + 8 * (e >= 2), 8 * n + tt + (e & 1)
                        if row >= sq:
                            continue
                        seen[row, j] += 1
                        if j < skv:
                            bit = 4 * ((e >> 1) * kg + n // 2) + 2 * (n % 2) + (e & 1)
                            got[:, :, row, j] = ((nib >> bit) & 1).bool()
    assert bool((seen == 1).all())
    assert bool((drawn[:(sq + 15) // 16 * 16] == 1).all())
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# On the card: #1 and #4 against their plain versions (12 heads of 64 but
# where noted), rate 0 of #4 == #1 bit for bit, reruns bit for bit.
# ---------------------------------------------------------------------------

CARD_H = 12
CARD_E = CARD_H * D
RAGGED = (1, 15, 17, 33, 64)
CARD_TOL = {"float32": (2e-5, 0.0), "bfloat16": (ATOL, RTOL)}
DROP_TOL = {"float32": (1e-4, 0.0), "bfloat16": (ATOL, RTOL)}


def _uniter_bias(b, seed=0):
    """(B, 56) -10000 mask of UNITER's stream: question lengths 4-20, the
    pads after each question masked, the 36 image keys kept; row b // 2
    fully masked."""
    rng = np.random.default_rng(seed)
    mask = np.ones((b, UNITER[1]), np.float32)
    lengths = rng.integers(4, UNITER_TEXT + 1, b)
    mask[:, :UNITER_TEXT] = np.arange(UNITER_TEXT)[None, :] < lengths[:, None]
    mask[b // 2] = 0.0
    return (1.0 - mask) * -10000.0


def _card_inputs(cuda, b, sq, skv, dtype, e=CARD_E, seed=0):
    """q, k, v as the model hands them: column views of one fused QKV
    product (Sq == Skv) or q alone and k, v views of a KV product; at
    UNITER's shape its mask."""
    q, k, v, bias = _inputs(b, sq, skv, e=e, seed=seed)
    if (sq, skv) == UNITER:
        bias = _uniter_bias(b, seed)
    tq, tk, tv = (torch.from_numpy(a).to(cuda, getattr(torch, dtype)) for a in (q, k, v))
    if sq == skv:
        tq, tk, tv = torch.cat([tq, tk, tv], dim=-1).split(e, dim=-1)
    else:
        tk, tv = torch.cat([tk, tv], dim=-1).split(e, dim=-1)
    return tq, tk, tv, torch.from_numpy(bias).to(cuda)


def _card_close(got, want, tol):
    atol, rtol = tol
    assert got.dtype == want.dtype and torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs()
    assert bool((err <= atol + rtol * want.float().abs()).all()), (
        f"max |kernel - plain| {err.max().item():.3e} over {atol} + {rtol}|plain|")


def _check_pair(q, k, v, bias, heads, dtype):
    """#1 and #4 against their plain versions, reruns bit for bit, #4 at
    rate 0 == #1 bit for bit."""
    got = att.fused_attention_cuda(q, k, v, bias, heads)
    _card_close(got, att.attention_natural_ref(q, k, v, bias, heads), CARD_TOL[dtype])
    drop = att.fused_attention_dropout_cuda(q, k, v, bias, heads, RATE, SEED)
    _card_close(drop, att.attention_dropout_ref(q, k, v, bias, heads, RATE, SEED), DROP_TOL[dtype])
    assert torch.equal(att.fused_attention_cuda(q, k, v, bias, heads), got)
    assert torch.equal(att.fused_attention_dropout_cuda(q, k, v, bias, heads, RATE, SEED), drop)
    assert torch.equal(att.fused_attention_dropout_cuda(q, k, v, bias, heads, 0.0, SEED), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("skv", RAGGED)
@pytest.mark.parametrize("sq", RAGGED)
def test_short_fwd_kernels_match_plain_at_ragged_lengths_on_card(cuda, sq, skv, dtype):
    _check_pair(*_card_inputs(cuda, 7, sq, skv, dtype, seed=sq * 100 + skv), CARD_H, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [256, 64, 7])
@pytest.mark.parametrize("sq,skv", SHAPES + [UNITER])
def test_short_fwd_kernels_match_plain_at_model_batches_on_card(cuda, sq, skv, batch):
    _check_pair(*_card_inputs(cuda, batch, sq, skv, "bfloat16", seed=batch + sq), CARD_H, "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [1, 2, 3, 12])
@pytest.mark.parametrize("sq,skv", [(36, 20), (20, 36)])
def test_short_fwd_kernels_take_any_head_count_on_card(cuda, heads, sq, skv):
    # A block takes its row's heads in groups; a head count the group size
    # does not divide leaves a last group with fewer heads.
    q, k, v, bias = _card_inputs(cuda, 7, sq, skv, "bfloat16", e=heads * D, seed=heads)
    _check_pair(q, k, v, bias, heads, "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv", SHAPES + [UNITER])
def test_short_fwd_dropout_mask_reads_out_on_card(cuda, sq, skv):
    # q = k = 0 gives a uniform P, and a one-hot V reads the mask out:
    # out[b, i, h*D + j] = keep(b, h, i, j) * keep_scale / Skv.
    b = 7
    q = torch.zeros(b, sq, CARD_E, device=cuda, dtype=torch.bfloat16)
    k = torch.zeros(b, skv, CARD_E, device=cuda, dtype=torch.bfloat16)
    v = torch.zeros(b, skv, CARD_H, D, device=cuda)
    v[:, torch.arange(skv), :, torch.arange(skv)] = 1.0
    v = v.reshape(b, skv, CARD_E).bfloat16()
    bias = torch.zeros(b, skv, device=cuda)
    out = att.fused_attention_dropout_cuda(q, k, v, bias, CARD_H, 0.5, SEED)
    got = out.reshape(b, sq, CARD_H, D)[..., :skv].permute(0, 2, 1, 3) > 0
    assert torch.equal(got, att.dropout_keep_mask_ref(SEED, b, CARD_H, sq, skv, 0.5, device=cuda))
