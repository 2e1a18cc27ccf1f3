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

Tests marked ``cuda`` hold the long-stream Hopper kernels
(``csrc/fused_attention_long.cu``, ``csrc/fused_attention_long_bwd.cu``)
to the plain versions at ViLT's shapes and at their limit of 256 keys on
the card, the backward's two runs bit for bit, and skip without one (run
them there with
``python -m pytest --noconftest -m cuda tests/test_torch_attention_long.py``).
"""

import numpy as np
import pytest
import torch

from rgqa_tpu_torch.ops import attention as att

H, D = 2, 16
E = H * D
CPU_SHAPES = [(70, 70), (65, 130), (130, 65)]
# ViLT: 20 or 40 text tokens + 144 patches + CLS; cross shapes for the
# ragged query tiles.
CARD_SHAPES = [(165, 165), (185, 185), (65, 185), (185, 65)]
# Up to the long kernel's limit of 256 keys: the bf16 body's widest score
# registers (32 tiles of 8 keys) and the f32 body's largest shared memory.
LIMIT_SHAPES = [(20, 256), (256, 256)]
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
    ],
)
def test_forward_routing(sq, skv, d, want):
    assert att.forward_kernel(sq, skv, d) is getattr(att, f"{want}_cuda")


@pytest.mark.parametrize("sq,skv,d,match", [(300, 257, 64, "257"), (185, 185, 96, "head dim")])
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
    with pytest.raises(ValueError, match="not CUDA"):
        att.fused_attention_long_bwd_cuda(q, k, v, bias, q.clone(), H)
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
    ],
)
def test_backward_routing(sq, skv, want):
    assert att.backward_kernel(sq, skv, 64) is getattr(att, f"{want}_cuda")


@pytest.mark.parametrize("sq,skv,d,match", [(165, 257, 64, "257"), (185, 185, 96, "head dim")])
def test_backward_routing_raises_beyond_the_limits(sq, skv, d, match):
    with pytest.raises(ValueError, match=match):
        att.backward_kernel(sq, skv, d)


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv", CARD_SHAPES + LIMIT_SHAPES)
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


# (atol, rtol) of the backward on the card, as the short backward's
# (tests/test_torch_attention_grad.py): bf16 3e-2 plus one bf16 step of
# outputs above 4; dbias from bf16 inputs sums 12 x Sq terms of
# tensor-core P, hence 1e-3 + 1e-4 |plain|.
BWD_CARD_TOL = {"float32": (1e-4, 0.0), "bfloat16": (3e-2, 1e-2), "dbias_bf16": (1e-3, 1e-4)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv", CARD_SHAPES + LIMIT_SHAPES)
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
    before = att.fused_attention_long_bwd_cuda.launches
    got = att.fused_attention_long_bwd_cuda(tq, tk, tv, tbias, tg, 12)
    want = att.attention_bwd_ref(tq, tk, tv, tbias, tg, 12)
    torch.cuda.synchronize()
    assert att.fused_attention_long_bwd_cuda.launches == before + 1
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert a.dtype == w.dtype and torch.isfinite(a.float()).all(), name
        atol, rtol = BWD_CARD_TOL["dbias_bf16" if name == "dbias" and dtype == "bfloat16" else dtype]
        err = (a.float() - w.float()).abs()
        assert bool((err <= atol + rtol * w.float().abs()).all()), (
            f"{name}: max |kernel - plain| {err.max().item():.3e} over {atol} + {rtol}|plain|")
    again = att.fused_attention_long_bwd_cuda(tq, tk, tv, tbias, tg, 12)
    for a, b in zip(got, again):
        assert torch.equal(a, b)  # deterministic: no float atomics


@pytest.mark.cuda
def test_long_streams_raise_where_no_kernel_exists(cuda):
    q = torch.zeros(2, 300, 768, device=cuda)
    with pytest.raises(ValueError, match="257"):
        att.fused_attention(q, q[:, :257], q[:, :257], None, num_heads=12)
    # The backward at 165 tokens reaches #3L; attention dropout has no
    # long-stream kernel.
    q = torch.zeros(2, 165, 768, device=cuda, requires_grad=True)
    before = att.fused_attention_long_bwd_cuda.launches
    att.fused_attention(q, q, q, None, num_heads=12).sum().backward()
    assert att.fused_attention_long_bwd_cuda.launches == before + 1
    with pytest.raises(NotImplementedError, match="long-stream dropout pair is not ported"):
        att.fused_attention_dropout(q, q, q, None, num_heads=12, rate=0.1, seed=1)
