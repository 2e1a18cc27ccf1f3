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

Tests marked ``cuda`` hold the long-stream Hopper kernel
(``csrc/fused_attention_long.cu``) to the plain version at ViLT's
shapes and at its limit of 256 keys on the card and skip without one (run them there with
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


@pytest.mark.cuda
def test_long_streams_raise_where_no_kernel_exists(cuda):
    q = torch.zeros(2, 300, 768, device=cuda)
    with pytest.raises(ValueError, match="257"):
        att.fused_attention(q, q[:, :257], q[:, :257], None, num_heads=12)
    q = torch.zeros(2, 165, 768, device=cuda, requires_grad=True)
    out = att.fused_attention(q, q, q, None, num_heads=12)
    with pytest.raises(NotImplementedError, match="ViLT training"):
        out.sum().backward()
    with pytest.raises(NotImplementedError, match="ViLT training"):
        att.fused_attention_dropout(q, q, q, None, num_heads=12, rate=0.1, seed=1)
