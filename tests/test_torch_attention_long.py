"""Port parity for long streams: ``rgqa_tpu_torch.ops.attention`` beyond 64
tokens against the JAX package.

On the CPU the port's plain version (``attention_natural_ref``) is held
to the Pallas query-tiled kernel ``_fused_qblocked_raw`` and to the
full-sequence ``_fused_pallas_raw``, both in interpret mode (as
``tests/test_ops.py`` runs them), on the same numpy inputs: f32, batch
3, 2 heads of 16, Sq = Skv = 70 and Sq != Skv (65 x 130, 130 x 65),
with masked keys, atol 1e-5.  Row 1 is fully masked: its scores are
``x - 10000``, on the f32 grid of 2^-10 there, so two sums of the same
products in another order may land a grid step apart; that row is held
to two steps' effect on the output, ``2^-9 max|v|``.  The forward's
routing (``forward_kernel``) is a pure function, checked here.

The backward at long streams: ``attention_bwd_ref`` against ``jax.vjp``
through the JAX package's ``_fused``, whose custom_vjp runs the Pallas
backward ``_fused_bwd_pallas_raw`` in interpret mode (as
``tests/test_torch_attention_grad.py`` does at LXMERT's shapes), at
165x165, 65x185 and 185x65, batch 3, 2 heads of 8, one fully masked row:
atol 1e-4 in f32, 3e-2 in bf16 (dS is rounded to bf16 on both sides).
The port's ``autograd.Function`` on CPU tensors at those lengths equals
PyTorch's autograd through ``attention_natural_ref``; the backward's
routing (``backward_kernel``) is checked like the forward's.

Beyond 256 keys (ViLT at a 512 px image: 277 tokens; with 16 px patches:
597), where the JAX package runs its XLA attention and differentiates it:
the plain versions against ``_attention_natural_xla`` and its
``jax.vjp``, f32, batch 2, 2 heads of 8, atol 1e-5 forward and 1e-4
backward.  The kernels' tiling, emulated step by step in plain torch
(the key-tiled forward's online softmax and ``lse``; the backward's dQ
pass with its two sweeps over key tiles and its dK/dV pass over query
tiles, ragged last tiles and a fully masked row included), equals the
plain versions within 1e-5 in f32.  And the reason the backward's D
takes a sweep of its own: D from the forward's bf16 output would move
dbias past its bound at ViLT's widths.

The bf16 forward's order (``csrc/fused_attention_long.cu``: key tiles
of 64, the running max and sum, O rescaled, P rounded to bf16
unnormalised), emulated on bf16 inputs at 165, 185, 65 x 185 and 277
tokens, is held to the plain version and to the Pallas query-tiled
kernel in interpret mode within P's and the output's bf16 rounding.

Tests marked ``cuda`` hold the long-stream Hopper kernels
(``csrc/fused_attention_long.cu``, ``csrc/fused_attention_long_bwd.cu``)
to the plain versions at ViLT's shapes, either side of 256 keys, at
277 and 597 tokens and (the forward) across the bf16 body's grid on the
card, the backward's two runs bit for bit, the backward's route without
the bias gradient (D from the forward's output, no sweep) too, and the
autograd Function's choice of route by whether the bias takes a
gradient; they skip without one (run them there with
``python -m pytest --noconftest -m cuda tests/test_torch_attention_long.py``).
"""

import math

import numpy as np
import pytest
import torch

from rgqa_tpu_torch.ops import attention as att
from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

H, D = 2, 16
E = H * D
CPU_SHAPES = [(70, 70), (65, 130), (130, 65)]
# ViLT: 20 or 40 text tokens + 144 patches + CLS; cross shapes for the
# ragged query tiles.
CARD_SHAPES = [(165, 165), (185, 185), (65, 185), (185, 65)]
# Either side of 256 keys, where the f32 forward leaves its whole-row
# body for its key-tiled one; 277 and 597 tokens are ViLT at a 512 px
# image and with 16 px patches, with ragged pairs.
LIMIT_SHAPES = [(20, 256), (256, 256), (300, 257), (257, 257)]
BEYOND_SHAPES = [(277, 277), (597, 597), (20, 597), (597, 20)]
# The bf16 body's grid: 4 query tiles (two blocks of 2 warpgroups), 7
# (2 warpgroups, one idle in the last block) over a 65-key row (a last
# key tile of one key), and one key tile under two query tiles.
RING_SHAPES = [(200, 200), (400, 65), (128, 64)]
# The backward at ViLT's training stream and across ragged tiles.
BWD_SHAPES = [(165, 165), (65, 185), (185, 65)]
BWD_H, BWD_D = 2, 8
BWD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


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


FULLY_MASKED = 1


def _assert_matches(got, want, v):
    """``got`` within 1e-5 of ``want`` on the rows with a visible key,
    within two f32 grid steps at 1e4 on the fully masked row."""
    rows = np.arange(got.shape[0]) != FULLY_MASKED
    np.testing.assert_allclose(got[rows], want[rows], atol=1e-5)
    np.testing.assert_allclose(
        got[FULLY_MASKED], want[FULLY_MASKED], atol=2.0**-9 * np.abs(v).max()
    )


def _inputs(b, sq, skv, e=E, seed=0):
    """numpy f32 q, k, v and a (B, Skv) -10000 bias: the last quarter of
    each row's keys masked (pad patches), random holes, row
    ``FULLY_MASKED`` fully masked."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, e), dtype=np.float32)
    k = rng.standard_normal((b, skv, e), dtype=np.float32)
    v = rng.standard_normal((b, skv, e), dtype=np.float32)
    mask = (rng.random((b, skv)) > 0.2).astype(np.float32)
    mask[:, 0] = 1.0
    mask[:, -(skv // 4):] = 0.0
    mask[FULLY_MASKED] = 0.0
    return q, k, v, (1.0 - mask) * -10000.0


@pytest.mark.parametrize("sq,skv", CPU_SHAPES)
def test_plain_matches_query_tiled_pallas_kernel(jax_attention, sq, skv):
    import jax.numpy as jnp

    q, k, v, bias = _inputs(3, sq, skv, seed=sq + skv)
    bt, qt = jax_attention._fit_qblock(3, sq, skv, E, 4)
    assert bt > 0 and 0 < qt < sq  # the query-tiled grid, with query padding
    want = jax_attention._fused_qblocked_raw(*(jnp.asarray(a) for a in (q, k, v, bias)), H)
    got = att.attention_natural_ref(*(torch.from_numpy(a) for a in (q, k, v, bias)), H)
    assert torch.isfinite(got).all()  # the fully masked row stays finite
    _assert_matches(got.numpy(), np.asarray(want), v)


@pytest.mark.parametrize("sq,skv", CPU_SHAPES)
def test_plain_matches_full_sequence_pallas_kernel(jax_attention, sq, skv):
    import jax.numpy as jnp

    q, k, v, bias = _inputs(3, sq, skv, seed=sq * skv)
    want = jax_attention._fused_pallas_raw(*(jnp.asarray(a) for a in (q, k, v, bias)), H)
    got = att.attention_natural_ref(*(torch.from_numpy(a) for a in (q, k, v, bias)), H)
    _assert_matches(got.numpy(), np.asarray(want), v)


@pytest.mark.parametrize(
    "sq,skv,d,want",
    [
        (64, 64, 64, "fused_attention"),
        (20, 36, 64, "fused_attention"),
        (65, 65, 64, "fused_attention_long"),
        (165, 165, 64, "fused_attention_long"),
        (185, 185, 64, "fused_attention_long"),
        (20, 185, 64, "fused_attention_long"),
        (1000, 256, 64, "fused_attention_long"),
        # Beyond the old cap of 256 keys.
        (300, 257, 64, "fused_attention_long"),
        (277, 277, 64, "fused_attention_long"),
        (597, 597, 64, "fused_attention_long"),
        (20, 597, 64, "fused_attention_long"),
    ],
)
def test_forward_routing(sq, skv, d, want):
    assert att.forward_kernel(sq, skv, d) is getattr(att, f"{want}_cuda")


@pytest.mark.parametrize("sq,skv,d,match", [(185, 185, 96, "head dim")])
def test_forward_routing_raises_beyond_the_limits(sq, skv, d, match):
    with pytest.raises(ValueError, match=match):
        att.forward_kernel(sq, skv, d)


def test_cpu_dispatch_takes_plain_version_at_length():
    q, k, v, bias = (torch.from_numpy(a) for a in _inputs(2, 70, 130))
    counts = (att.fused_attention_cuda.launches, att.fused_attention_long_cuda.launches)
    got = att.fused_attention(q, k, v, bias[:, None, None, :], num_heads=H)
    torch.testing.assert_close(got, att.attention_natural_ref(q, k, v, bias, H), rtol=0, atol=0)
    assert (att.fused_attention_cuda.launches, att.fused_attention_long_cuda.launches) == counts


def test_long_wrapper_refuses_cpu_tensors():
    q, k, v, bias = (torch.from_numpy(a) for a in _inputs(2, 70, 70))
    before = att.fused_attention_long_cuda.launches
    with pytest.raises(ValueError, match="not CUDA"):
        att.fused_attention_long_cuda(q, k, v, bias, H)
    assert att.fused_attention_long_cuda.launches == before
    before = att.fused_attention_long_bwd_cuda.launches
    lse = torch.zeros(2, H, 70, 2)
    with pytest.raises(ValueError, match="not CUDA"):
        att.fused_attention_long_bwd_cuda(q, k, v, bias, q.clone(), H, lse)
    assert att.fused_attention_long_bwd_cuda.launches == before


# ---------------------------------------------------------------------------
# The backward at long streams (#3L's function).
# ---------------------------------------------------------------------------


def _bwd_inputs(sq, skv, seed):
    """numpy f32 q, k, v, g (batch 3, 2 heads of 8) and the masked bias."""
    q, k, v, bias = _inputs(3, sq, skv, e=BWD_H * BWD_D, seed=seed)
    g = np.random.default_rng(seed + 1).standard_normal(q.shape, dtype=np.float32)
    return q, k, v, g, bias


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv", BWD_SHAPES)
def test_bwd_ref_matches_pallas_backward_at_long_streams(jax_attention, sq, skv, dtype):
    import jax
    import jax.numpy as jnp

    q, k, v, g, bias = _bwd_inputs(sq, skv, seed=sq * 7 + skv)
    jdt = getattr(jnp, dtype)
    jq, jk, jv, jg = (jnp.asarray(a, jdt) for a in (q, k, v, g))
    fit = jax_attention._fit_bwd_block(3, sq, skv, BWD_H * BWD_D, jq.dtype.itemsize)
    assert fit[0] > 0  # the Pallas backward runs, not the XLA fallback
    _, vjp = jax.vjp(lambda *a: jax_attention._fused(*a, BWD_H), jq, jk, jv, jnp.asarray(bias))
    want = vjp(jg)
    tq, tk, tv, tg = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v, g))
    got = att.attention_bwd_ref(tq, tk, tv, torch.from_numpy(bias), tg, BWD_H)
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert a.dtype == (torch.float32 if name == "dbias" else tq.dtype), name
        assert torch.isfinite(a.float()).all(), name  # the fully masked row too
        np.testing.assert_allclose(
            a.float().numpy(), np.asarray(w, np.float32), atol=BWD_TOL[dtype], err_msg=name
        )


@pytest.mark.parametrize("sq,skv", BWD_SHAPES)
def test_function_matches_autograd_of_plain_forward_at_long_streams(sq, skv):
    q, k, v, g, bias = (torch.from_numpy(a) for a in _bwd_inputs(sq, skv, seed=3))
    inputs = [t.requires_grad_() for t in (q, k, v, bias)]
    counts = (att.fused_attention_bwd_cuda.launches, att.fused_attention_long_bwd_cuda.launches)
    got = torch.autograd.grad(att.fused_attention(*inputs, num_heads=BWD_H), inputs, g)
    want = torch.autograd.grad(att.attention_natural_ref(*inputs, BWD_H), inputs, g)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=1e-5)
    assert (att.fused_attention_bwd_cuda.launches,
            att.fused_attention_long_bwd_cuda.launches) == counts  # the CPU ran the plain pair


@pytest.mark.parametrize(
    "sq,skv,want",
    [
        (64, 64, "fused_attention_bwd"),
        (20, 36, "fused_attention_bwd"),
        (65, 20, "fused_attention_long_bwd"),
        (165, 165, "fused_attention_long_bwd"),
        (20, 185, "fused_attention_long_bwd"),
        (1000, 256, "fused_attention_long_bwd"),
        # Beyond the old cap of 256 keys.
        (165, 257, "fused_attention_long_bwd"),
        (300, 257, "fused_attention_long_bwd"),
        (277, 277, "fused_attention_long_bwd"),
        (597, 597, "fused_attention_long_bwd"),
        (597, 20, "fused_attention_long_bwd"),
    ],
)
def test_backward_routing(sq, skv, want):
    assert att.backward_kernel(sq, skv, 64) is getattr(att, f"{want}_cuda")


@pytest.mark.parametrize("sq,skv,d,match", [(185, 185, 96, "head dim")])
def test_backward_routing_raises_beyond_the_limits(sq, skv, d, match):
    with pytest.raises(ValueError, match=match):
        att.backward_kernel(sq, skv, d)


# ---------------------------------------------------------------------------
# Beyond 256 keys: the plain versions against the JAX package's XLA
# attention, and the kernels' tiling emulated in plain torch.
# ---------------------------------------------------------------------------

XLA_SHAPES = [(277, 277), (597, 597)]


@pytest.mark.parametrize("sq,skv", XLA_SHAPES)
def test_plain_matches_xla_attention_beyond_256(jax_attention, sq, skv):
    import jax.numpy as jnp

    q, k, v, g, bias = _bwd_inputs(sq, skv, seed=sq)
    q, k, v, g = (x[:2] for x in (q, k, v, g))
    bias = bias[:2]
    want = jax_attention._attention_natural_xla(*(jnp.asarray(a) for a in (q, k, v, bias)), BWD_H)
    got = att.attention_natural_ref(*(torch.from_numpy(a) for a in (q, k, v, bias)), BWD_H)
    _assert_matches(got.numpy(), np.asarray(want), v)


@pytest.mark.parametrize("sq,skv", XLA_SHAPES)
def test_bwd_ref_matches_xla_vjp_beyond_256(jax_attention, sq, skv):
    import jax
    import jax.numpy as jnp

    q, k, v, g, bias = (x[:2] for x in _bwd_inputs(sq, skv, seed=sq + 1))
    _, vjp = jax.vjp(lambda *a: jax_attention._attention_natural_xla(*a, BWD_H),
                     *(jnp.asarray(a) for a in (q, k, v, bias)))
    want = vjp(jnp.asarray(g))
    got = att.attention_bwd_ref(*(torch.from_numpy(a) for a in (q, k, v, bias, g)), BWD_H)
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert torch.isfinite(a).all(), name  # the fully masked row too
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-4, err_msg=name)


KV_TILE, Q_TILE, STEP = 64, 64, 16  # the kernels' key and query tiles, and a warp's step


def _split_heads(t, h):
    b, s, e = t.shape
    return t.reshape(b, s, h, e // h).transpose(1, 2)  # (B, H, S, D)


def _merge_heads(t):
    b, h, s, d = t.shape
    return t.transpose(1, 2).reshape(b, s, h * d)


def _tiled_forward(scores, vh, p_dtype=None):
    """The key-tiled forward (csrc/fused_attention_long.cu), f32, from the
    (B, H, Sq, Skv) scores: an online softmax over key tiles of 64, O
    rescaled when the row max moves, O / l at the end; (O, stats), stats
    (B, H, Sq, 2) = (m, log(l)), the kernels' row statistics.  With
    ``p_dtype`` (bf16: the bf16 body's order) each tile's unnormalised P
    is rounded to it before the PV product, its row sum taken before."""
    m = torch.full(scores.shape[:3], -math.inf)
    l = torch.zeros(scores.shape[:3])
    o = torch.zeros(scores.shape[:3] + vh.shape[-1:])
    for k0 in range(0, scores.shape[-1], KV_TILE):
        s = scores[..., k0:k0 + KV_TILE]
        mn = torch.maximum(m, s.amax(-1))
        c = torch.exp(m - mn)
        p = torch.exp(s - mn[..., None])
        l = l * c + p.sum(-1)
        if p_dtype is not None:
            p = p.to(p_dtype).float()
        o = o * c[..., None] + p @ vh[:, :, k0:k0 + KV_TILE]
        m = mn
    return o / l[..., None], torch.stack([m, torch.log(l)], dim=-1)


def _tiled_backward(scores, dps, lse, qh, kh, gh):
    """The backward's two passes (csrc/fused_attention_long_bwd.cu), f32,
    tile by tile in the kernels' order, from the scores and dP = g V^T:
    the dQ pass per query tile sweeps the key tiles for D, then again for
    dS and dQ, 16 keys at a step; the dK/dV pass per key tile walks the
    query tiles, 16 queries at a step, for dV, dK and the column sums of
    dS; dbias adds the heads in order."""
    b, h, sq, d = qh.shape
    skv = kh.shape[2]
    scale = 1.0 / math.sqrt(d)

    def probs(i0, i1, j0, j1):
        st = lse[:, :, i0:i1, None]
        p = torch.exp((scores[:, :, i0:i1, j0:j1] - st[..., 0]) - st[..., 1])
        return p, dps[:, :, i0:i1, j0:j1]

    dq, dsum = torch.zeros(qh.shape), torch.zeros(qh.shape[:3])
    for i0 in range(0, sq, Q_TILE):
        i1 = min(i0 + Q_TILE, sq)
        dd = torch.zeros(b, h, i1 - i0)
        for j0 in range(0, skv, STEP):  # first sweep: D
            p, dp = probs(i0, i1, j0, j0 + STEP)
            dd = dd + (p * dp).sum(-1)
        dsum[:, :, i0:i1] = dd
        acc = torch.zeros(b, h, i1 - i0, d)
        for j0 in range(0, skv, STEP):  # second sweep: dS and dQ
            p, dp = probs(i0, i1, j0, j0 + STEP)
            acc = acc + (p * (dp - dd[..., None]) * scale) @ kh[:, :, j0:j0 + STEP]
        dq[:, :, i0:i1] = acc
    dk, dv, part = torch.zeros(kh.shape), torch.zeros(kh.shape), torch.zeros(b, h, skv)
    for j0 in range(0, skv, KV_TILE):
        j1 = min(j0 + KV_TILE, skv)
        for i0 in range(0, sq, STEP):
            p, dp = probs(i0, i0 + STEP, j0, j1)
            ds = p * (dp - dsum[:, :, i0:i0 + STEP, None])
            dv[:, :, j0:j1] += p.transpose(-1, -2) @ gh[:, :, i0:i0 + STEP]
            dk[:, :, j0:j1] += (ds * scale).transpose(-1, -2) @ qh[:, :, i0:i0 + STEP]
            part[:, :, j0:j1] += ds.sum(-2)
    dbias = part[:, 0]
    for hh in range(1, h):
        dbias = dbias + part[:, hh]
    return dq, dk, dv, dbias


@pytest.mark.parametrize("sq,skv", [(277, 277), (597, 597), (300, 257), (20, 597), (597, 20)])
def test_tiled_algorithm_matches_plain_versions(sq, skv):
    # The scores and dP as the plain versions compute them (the fully
    # masked row's scores sit on the f32 grid of 2^-10 at -1e4, where
    # products summed in another order would land on other steps); what
    # the kernels tile, emulated on top.
    q, k, v, g, bias = (torch.from_numpy(x[:2]) for x in _bwd_inputs(sq, skv, seed=sq * skv))
    qh, kh, vh, gh = (_split_heads(t, BWD_H) for t in (q, k, v, g))
    products = torch.einsum("bhqd,bhkd->bhqk", qh, kh)
    mask = bias[:, None, None, :]
    o, lse = _tiled_forward(products / math.sqrt(BWD_D) + mask, vh)
    torch.testing.assert_close(_merge_heads(o), att.attention_natural_ref(q, k, v, bias, BWD_H),
                               rtol=0, atol=1e-5)
    want_lse = torch.logsumexp((products / math.sqrt(BWD_D) + mask).double(), dim=-1)
    torch.testing.assert_close(lse.double().sum(-1), want_lse, rtol=0, atol=1e-5)
    # The backward's scores as attention_bwd_ref takes them (times 1 /
    # sqrt(d), where the forward divides: another rounding at d = 8; the
    # kernels compute one form in both) and their statistics.
    scores = products * (1.0 / math.sqrt(BWD_D)) + mask
    _, stats = _tiled_forward(scores, vh)
    dq, dk, dv, dbias = _tiled_backward(scores, gh @ vh.transpose(-1, -2), stats, qh, kh, gh)
    want = att.attention_bwd_ref(q, k, v, bias, g, BWD_H)
    got = (_merge_heads(dq), _merge_heads(dk), _merge_heads(dv), dbias)
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a, w, rtol=0, atol=1e-5, msg=name)


# The bf16 forward at ViLT's streams (165 / 185 training / serving, 65 x
# 185 ragged, 277 at 512 px), 2 heads of 16, batch 3 with a fully
# masked row.
BF16_SHAPES = [(165, 165), (185, 185), (65, 185), (277, 277)]


@pytest.mark.parametrize("sq,skv", BF16_SHAPES)
def test_bf16_ring_order_matches_plain_and_pallas(jax_attention, sq, skv):
    # The bf16 body's order emulated on bf16 inputs: products in f32, the
    # scores scaled and biased, key tiles of 64 with the running max and
    # sum, O rescaled, P rounded to bf16 unnormalised, O / l rounded to
    # bf16.  Against the plain version, which keeps P in f32: P's
    # rounding (2^-9 relative) moves a row by at most 2^-9 max|v|, and
    # the outputs' own rounding by a bf16 step (at most 2^-7 |out|); the
    # fully masked row's scores sit on the f32 grid of 2^-10 at -1e4,
    # another 2^-9 max|v| (``_assert_matches``).  The Pallas kernel rounds
    # P normalised: the same bound.
    import jax.numpy as jnp

    q, k, v, bias = _inputs(3, sq, skv, seed=sq * 3 + skv)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    tbias = torch.from_numpy(bias)
    qh, kh, vh = (_split_heads(t.float(), H) for t in (tq, tk, tv))
    scores = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * (1.0 / math.sqrt(D)) + tbias[:, None, None, :]
    o, _ = _tiled_forward(scores, vh, torch.bfloat16)
    got = _merge_heads(o).bfloat16().float()
    assert torch.isfinite(got).all()
    vmax = float(tv.float().abs().max())
    plain = att.attention_natural_ref(tq, tk, tv, tbias, H).float()
    bt, _ = jax_attention._fit_qblock(3, sq, skv, E, 2)
    assert bt > 0  # the query-tiled grid
    pallas = torch.from_numpy(np.array(jax_attention._fused_qblocked_raw(
        *(jnp.asarray(a.float().numpy(), jnp.bfloat16) for a in (tq, tk, tv)), jnp.asarray(bias), H
    ).astype(jnp.float32)))
    rows = torch.arange(3) != FULLY_MASKED
    for want in (plain, pallas):
        err = (got - want).abs()
        assert bool((err[rows] <= 2.0**-9 * vmax + 2.0**-7 * want[rows].abs()).all())
        assert bool((err[FULLY_MASKED] <= 2.0**-8 * vmax + 2.0**-7 * want[FULLY_MASKED].abs()).all())


def test_d_from_the_bf16_output_would_break_the_dbias_bound():
    # ViLT's widths (12 heads of 64), bf16 inputs, pad-patch masks: D from
    # the forward's bf16 output, rowsum(g o), against D = rowsum(dP P) in
    # f32, as dbias sees it; the card's bound for bf16 dbias is 1e-3 +
    # 1e-4 |plain| (chip_smoke.TOL).  Hence the dQ pass's first sweep.
    rng = np.random.default_rng(0)
    b, s, heads = 8, 165, 12
    q, k, v, g = (torch.from_numpy(rng.standard_normal((b, s, 768), dtype=np.float32))
                  .bfloat16().float() for _ in range(4))
    _, _, _, bias = _inputs(b, s, s, e=768, seed=1)
    bias = torch.from_numpy(bias)
    qh, kh, vh, gh = (_split_heads(t, heads) for t in (q, k, v, g))
    p = torch.softmax(qh @ kh.transpose(-1, -2) / 8 + bias[:, None, None, :], dim=-1)
    dp = gh @ vh.transpose(-1, -2)
    d_exact = (p * dp).sum(-1, keepdim=True)
    d_bf16 = (gh * (p @ vh).bfloat16().float()).sum(-1, keepdim=True)
    dbias = (p * (dp - d_exact)).sum((1, 2))
    err = ((p * (dp - d_bf16)).sum((1, 2)) - dbias).abs()
    assert bool((err > 1e-3 + 1e-4 * dbias.abs()).any())


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv", CARD_SHAPES + LIMIT_SHAPES + BEYOND_SHAPES + RING_SHAPES)
def test_long_kernel_matches_plain_on_card(cuda, sq, skv, dtype):
    # ViLT widths: 12 heads of 64; ragged batch 7 with a fully masked row;
    # q, k, v as column views of one fused projection (row stride 3E).
    e = 768
    q, k, v, bias = _inputs(7, sq, skv, e=e, seed=sq + skv)
    kv = np.concatenate([k, v], axis=-1)
    tq = torch.from_numpy(q).to(cuda, getattr(torch, dtype))
    tk, tv = torch.from_numpy(kv).to(cuda, getattr(torch, dtype)).split(e, dim=-1)
    tbias = torch.from_numpy(bias).to(cuda)
    counts = (att.fused_attention_cuda.launches, att.fused_attention_long_cuda.launches)
    got = att.fused_attention(tq, tk, tv, tbias, num_heads=12)
    want = att.attention_natural_ref(tq, tk, tv, tbias, 12)
    torch.cuda.synchronize()
    assert (att.fused_attention_cuda.launches, att.fused_attention_long_cuda.launches) == (
        counts[0], counts[1] + 1)
    assert got.dtype == tq.dtype and torch.isfinite(got).all()
    # bf16: 3e-2 plus one bf16 step of outputs above 4 (P is rounded to
    # bf16 in the kernel, kept in f32 by the plain version).
    atol, rtol = {"float32": (2e-5, 0.0), "bfloat16": (3e-2, 1e-2)}[dtype]
    assert ((got.float() - want.float()).abs() <= atol + rtol * want.float().abs()).all()
    # The row statistics change nothing in the output.
    out, lse = att.fused_attention_long_cuda(tq, tk, tv, tbias, 12, lse=True)
    assert torch.equal(out, got) and lse.shape == (7, 12, sq, 2) and torch.isfinite(lse).all()


# (atol, rtol) of the backward on the card, as the short backward's
# (tests/test_torch_attention_grad.py): bf16 3e-2 plus one bf16 step of
# outputs above 4; dbias from bf16 inputs sums 12 x Sq terms of
# tensor-core P, hence 1e-3 + 1e-4 |plain|.
BWD_CARD_TOL = {"float32": (1e-4, 0.0), "bfloat16": (3e-2, 1e-2), "dbias_bf16": (1e-3, 1e-4)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv", CARD_SHAPES + LIMIT_SHAPES + BEYOND_SHAPES)
def test_long_bwd_kernel_matches_plain_on_card(cuda, sq, skv, dtype):
    # 12 heads of 64, batch 7 with a fully masked row; self-attention q, k,
    # v as column views of one fused QKV product (row stride 3E).
    e = 768
    q, k, v, bias = _inputs(7, sq, skv, e=e, seed=sq * skv)
    g = np.random.default_rng(sq).standard_normal(q.shape, dtype=np.float32)
    tdt = getattr(torch, dtype)
    if sq == skv:
        tq, tk, tv = torch.from_numpy(np.concatenate([q, k, v], -1)).to(cuda, tdt).split(e, -1)
    else:
        tq = torch.from_numpy(q).to(cuda, tdt)
        tk, tv = torch.from_numpy(np.concatenate([k, v], -1)).to(cuda, tdt).split(e, -1)
    tg, tbias = torch.from_numpy(g).to(cuda, tdt), torch.from_numpy(bias).to(cuda)
    _, lse = att.fused_attention_long_cuda(tq, tk, tv, tbias, 12, lse=True)
    before = att.fused_attention_long_bwd_cuda.launches
    got = att.fused_attention_long_bwd_cuda(tq, tk, tv, tbias, tg, 12, lse)
    want = att.attention_bwd_ref(tq, tk, tv, tbias, tg, 12)
    torch.cuda.synchronize()
    assert att.fused_attention_long_bwd_cuda.launches == before + 1
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert a.dtype == w.dtype and torch.isfinite(a.float()).all(), name
        atol, rtol = BWD_CARD_TOL["dbias_bf16" if name == "dbias" and dtype == "bfloat16" else dtype]
        err = (a.float() - w.float()).abs()
        assert bool((err <= atol + rtol * w.float().abs()).all()), (
            f"{name}: max |kernel - plain| {err.max().item():.3e} over {atol} + {rtol}|plain|")
    again = att.fused_attention_long_bwd_cuda(tq, tk, tv, tbias, tg, 12, lse)
    for a, b in zip(got, again):
        assert torch.equal(a, b)  # deterministic: no float atomics


@pytest.mark.cuda
def test_long_streams_raise_where_no_kernel_exists(cuda):
    # 300 x 257 (past the old cap of 256 keys) runs through #2 and #3L and
    # matches the plain versions under autograd.
    q, k, v, bias = _inputs(2, 300, 257, e=768, seed=5)
    g = torch.from_numpy(np.random.default_rng(6).standard_normal(q.shape, dtype=np.float32)).to(cuda)
    inputs = [torch.from_numpy(x).to(cuda).requires_grad_() for x in (q, k, v, bias)]
    counts = (att.fused_attention_long_cuda.launches, att.fused_attention_long_bwd_cuda.launches)
    got = att.fused_attention(*inputs, num_heads=12)
    got_grads = torch.autograd.grad(got, inputs, g)
    assert (att.fused_attention_long_cuda.launches,
            att.fused_attention_long_bwd_cuda.launches) == (counts[0] + 1, counts[1] + 1)
    want = att.attention_natural_ref(*inputs, 12)
    want_grads = torch.autograd.grad(want, inputs, g)
    assert ((got - want).abs() <= 2e-5).all()
    for a, w in zip(got_grads, want_grads):
        assert ((a - w).abs() <= 1e-4).all()
    # The backward at 165 tokens reaches #3L; attention dropout there
    # reaches 4L and 5L (no stream raises since they were ported).
    q = torch.zeros(2, 165, 768, device=cuda, requires_grad=True)
    before = att.fused_attention_long_bwd_cuda.launches
    att.fused_attention(q, q, q, None, num_heads=12).sum().backward()
    assert att.fused_attention_long_bwd_cuda.launches == before + 1
    drops = (att.fused_attention_dropout_long_cuda.launches,
             att.fused_attention_dropout_long_bwd_cuda.launches)
    att.fused_attention_dropout(q, q, q, None, num_heads=12, rate=0.1, seed=1).sum().backward()
    assert (att.fused_attention_dropout_long_cuda.launches,
            att.fused_attention_dropout_long_bwd_cuda.launches) == (drops[0] + 1, drops[1] + 1)


def _card_bwd_inputs(cuda, b, sq, skv, dtype, seed):
    """q, k, v (column views of one fused product), g and the bias on the
    card, 12 heads of 64, as test_long_bwd_kernel_matches_plain_on_card
    makes them."""
    e = 768
    q, k, v, bias = _inputs(b, sq, skv, e=e, seed=seed)
    g = np.random.default_rng(seed + 1).standard_normal(q.shape, dtype=np.float32)
    tdt = getattr(torch, dtype)
    if sq == skv:
        tq, tk, tv = torch.from_numpy(np.concatenate([q, k, v], -1)).to(cuda, tdt).split(e, -1)
    else:
        tq = torch.from_numpy(q).to(cuda, tdt)
        tk, tv = torch.from_numpy(np.concatenate([k, v], -1)).to(cuda, tdt).split(e, -1)
    return tq, tk, tv, torch.from_numpy(g).to(cuda, tdt), torch.from_numpy(bias).to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv", [(76, 76)] + CARD_SHAPES + BEYOND_SHAPES)
def test_long_bwd_without_dbias_matches_plain_on_card(cuda, sq, skv, dtype):
    # The route every model path runs: D = rowsum(g o out) from the
    # forward's output instead of a sweep, no bias gradient.
    tq, tk, tv, tg, tbias = _card_bwd_inputs(cuda, 7, sq, skv, dtype, seed=sq * skv)
    out, lse = att.fused_attention_long_cuda(tq, tk, tv, tbias, 12, lse=True)
    before = att.fused_attention_long_bwd_cuda.launches
    got = att.fused_attention_long_bwd_cuda(tq, tk, tv, tbias, tg, 12, lse, dbias=False, out=out)
    want = att.attention_bwd_ref(tq, tk, tv, tbias, tg, 12)
    torch.cuda.synchronize()
    assert att.fused_attention_long_bwd_cuda.launches == before + 1
    assert got[3] is None
    atol, rtol = BWD_CARD_TOL[dtype]
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == w.dtype and torch.isfinite(a.float()).all(), name
        err = (a.float() - w.float()).abs()
        assert bool((err <= atol + rtol * w.float().abs()).all()), (
            f"{name}: max |kernel - plain| {err.max().item():.3e} over {atol} + {rtol}|plain|")
    again = att.fused_attention_long_bwd_cuda(tq, tk, tv, tbias, tg, 12, lse, dbias=False, out=out)
    assert all(torch.equal(a, b) for a, b in zip(got[:3], again[:3]))
    with pytest.raises(ValueError, match="dbias=False takes the forward's output"):
        att.fused_attention_long_bwd_cuda(tq, tk, tv, tbias, tg, 12, lse, dbias=False)
    with pytest.raises(ValueError, match="out is taken only with dbias=False"):
        att.fused_attention_long_bwd_cuda(tq, tk, tv, tbias, tg, 12, lse, out=out)


@pytest.mark.cuda
@pytest.mark.parametrize("bias_grad", [True, False])
@pytest.mark.parametrize("sq,skv", [(76, 76), (165, 165)])
def test_long_autograd_takes_the_exact_route_for_a_bias_gradient(cuda, sq, skv, bias_grad):
    # A bias that takes a gradient gets it from the exact route (D's sweep),
    # within the bf16 dbias bound; one that does not gets None, and #3L
    # takes D from the saved output.  q, k, v's gradients match the plain
    # pair either way.
    tq, tk, tv, tg, tbias = _card_bwd_inputs(cuda, 3, sq, skv, "bfloat16", seed=sq + 11)
    leaves = [t.detach().clone().requires_grad_() for t in (tq, tk, tv)]
    bias = tbias.clone().requires_grad_(bias_grad)
    before = att.fused_attention_long_bwd_cuda.launches
    att.fused_attention(*leaves, bias, num_heads=12).backward(tg)
    assert att.fused_attention_long_bwd_cuda.launches == before + 1
    want = att.attention_bwd_ref(tq, tk, tv, tbias, tg, 12)
    atol, rtol = BWD_CARD_TOL["bfloat16"]
    for name, leaf, w in zip(("dq", "dk", "dv"), leaves, want):
        err = (leaf.grad.float() - w.float()).abs()
        assert bool((err <= atol + rtol * w.float().abs()).all()), name
    if bias_grad:
        atol, rtol = BWD_CARD_TOL["dbias_bf16"]
        err = (bias.grad - want[3]).abs()
        assert bool((err <= atol + rtol * want[3].abs()).all()), err.max().item()
    else:
        assert bias.grad is None
