"""Port parity: the attention backward (#3) and the dropout pair (#4, #5).

On the CPU:
- ``attention_bwd_ref`` against ``jax.vjp`` through the JAX package's
  ``_fused``, whose custom_vjp runs the Pallas backward
  ``_fused_bwd_pallas_raw`` in interpret mode (as ``tests/test_ops.py``
  runs it), at LXMERT's four attention shapes with a ragged batch and a
  fully masked row, at CLIP's 50 x 50 with a zero bias and at the 64 x 64
  limit: atol 1e-4 in f32 (the bar of ``tests/test_ops.py``), 3e-2 in
  bf16 (dS is rounded to bf16 on both sides, so a rounding flip moves a
  gradient by one bf16 step); at those two shapes the plain dropout pair
  at rate 0 against the same JAX kernels (1e-5 forward, 1e-4 gradients);
- the port's ``autograd.Function`` on CPU tensors against PyTorch's
  autograd through ``attention_natural_ref``, and ``gradcheck`` of the
  plain pairs in f64;
- the dropout contract (its Pallas kernels have no CPU lowering,
  ``tests/test_ops.py``): rate 0 equals the deterministic pair exactly,
  seeds decide the mask, the kept fraction is within 5 sigma of
  (256 - t) / 256, the backward replays the forward's mask
  (``<g, out> == <dv, v>``), and ``dropout_keep_mask_ref`` equals a
  scalar Philox4x32-10 written out here, which pins the bit function the
  CUDA source must reproduce.

Tests marked ``cuda`` hold the kernels to their plain versions on the card
at LXMERT's widths and skip without one.
"""

import math

import numpy as np
import pytest
import torch

from rgqa_tpu_torch.ops import attention as att
from rgqa_tpu_torch.ops.dropout import keep_threshold
from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

H, D = 4, 8
E = H * D
SHAPES = [(20, 20), (36, 36), (20, 36), (36, 20)]  # lang self, visn self, cross both ways
CLIP = (50, 50)  # CLIP ViT-B/32's vision stream: 49 patches + CLS, no mask
LIMIT = (64, 64)  # the short kernels' longest streams
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


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
    """numpy f32 q, k, v, g and a (B, Skv) -10000 bias with row 0 fully masked."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, e), dtype=np.float32)
    k = rng.standard_normal((b, skv, e), dtype=np.float32)
    v = rng.standard_normal((b, skv, e), dtype=np.float32)
    g = rng.standard_normal((b, sq, e), dtype=np.float32)
    mask = (rng.random((b, skv)) > 0.3).astype(np.float32)
    mask[:, -1] = 1.0
    mask[0] = 0.0
    return q, k, v, g, (1.0 - mask) * -10000.0


def _torch(arrays, dtype, device="cpu"):
    return [torch.from_numpy(a).to(device=device, dtype=dtype) for a in arrays]


def _oracle_inputs(sq, skv):
    q, k, v, g, bias = _inputs(5, sq, skv, seed=sq * 100 + skv)
    if (sq, skv) == CLIP:
        bias = np.zeros_like(bias)
    return q, k, v, g, bias


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv", SHAPES + [CLIP, LIMIT])
def test_bwd_ref_matches_pallas_backward(jax_attention, sq, skv, dtype):
    import jax
    import jax.numpy as jnp

    q, k, v, g, bias = _oracle_inputs(sq, skv)
    jdt = getattr(jnp, dtype)
    jq, jk, jv, jg = (jnp.asarray(a, jdt) for a in (q, k, v, g))
    _, vjp = jax.vjp(lambda *a: jax_attention._fused(*a, H), jq, jk, jv, jnp.asarray(bias))
    want = vjp(jg)
    tq, tk, tv, tg = _torch((q, k, v, g), getattr(torch, dtype))
    got = att.attention_bwd_ref(tq, tk, tv, torch.from_numpy(bias), tg, H)
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert a.dtype == (torch.float32 if name == "dbias" else tq.dtype), name
        assert torch.isfinite(a.float()).all(), name  # the fully masked row too
        np.testing.assert_allclose(
            a.float().numpy(), np.asarray(w, np.float32), atol=TOL[dtype], err_msg=name
        )


@pytest.mark.parametrize("sq,skv", [CLIP, LIMIT])
def test_plain_dropout_pair_at_rate_zero_matches_pallas(jax_attention, sq, skv):
    # The dropout Pallas kernels have no CPU lowering; at rate 0 the pair
    # is the deterministic function, held to the Pallas forward and the
    # vjp through its backward (interpret mode), f32.
    import jax
    import jax.numpy as jnp

    q, k, v, g, bias = _oracle_inputs(sq, skv)
    jq, jk, jv, jg, jb = (jnp.asarray(a) for a in (q, k, v, g, bias))
    want_out, vjp = jax.vjp(lambda *a: jax_attention._fused(*a, H), jq, jk, jv, jb)
    want = vjp(jg)
    tq, tk, tv, tg, tb = _torch((q, k, v, g, bias), torch.float32)
    out = att.attention_dropout_ref(tq, tk, tv, tb, H, 0.0, 99)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=1e-5)
    got = att.attention_dropout_bwd_ref(tq, tk, tv, tb, tg, H, 0.0, 99)
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-4, err_msg=name)


@pytest.mark.parametrize("sq,skv", [CLIP, LIMIT])
def test_plain_dropout_backward_replays_the_mask_at(sq, skv):
    # <g, out> == <dv, v> at rate 0.5 (see the test below), f32.
    q, k, v, g, bias = _torch(_oracle_inputs(sq, skv), torch.float32)
    out = att.attention_dropout_ref(q, k, v, bias, H, 0.5, 4321)
    dv = att.attention_dropout_bwd_ref(q, k, v, bias, g, H, 0.5, 4321)[2]
    lhs = float((out.double() * g.double()).sum())
    rhs = float((dv.double() * v.double()).sum())
    np.testing.assert_allclose(lhs, rhs, rtol=2e-3)


@pytest.mark.parametrize("sq,skv", SHAPES)
def test_function_matches_autograd_of_plain_forward(sq, skv):
    q, k, v, g, bias = _torch(_inputs(3, sq, skv, seed=7), torch.float32)
    inputs = [t.requires_grad_() for t in (q, k, v, bias)]
    got = torch.autograd.grad(att.fused_attention(*inputs, num_heads=H), inputs, g)
    want = torch.autograd.grad(att.attention_natural_ref(*inputs, H), inputs, g)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("rate", [None, 0.3])
def test_gradcheck_plain_pairs_in_f64(rate):
    q, k, v, _, bias = _torch(_inputs(2, 5, 7, e=6, seed=2), torch.float64)
    bias = bias / 10000.0 * 3.0  # a smooth mask: gradcheck differentiates it too
    inputs = tuple(t.requires_grad_() for t in (q, k, v, bias))
    if rate is None:
        fn = lambda *a: att._FusedAttention.apply(*a, 2)  # noqa: E731
    else:
        fn = lambda *a: att._FusedAttentionDropout.apply(*a, 2, rate, 99)  # noqa: E731
    assert torch.autograd.gradcheck(fn, inputs)


# ---------------------------------------------------------------------------
# Dropout (#4, #5): the contract.
# ---------------------------------------------------------------------------


def _drop_grads(rate, seed, dtype=torch.float32, b=4, sq=20, skv=36):
    q, k, v, g, bias = _torch(_inputs(b, sq, skv, seed=3), dtype)
    inputs = [t.requires_grad_() for t in (q, k, v, bias)]
    out = att.fused_attention_dropout(*inputs, num_heads=H, rate=rate, seed=seed)
    return out, torch.autograd.grad(out, inputs, g), (q, k, v, g, bias)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_rate_zero_equals_the_deterministic_pair(dtype):
    out, grads, (q, k, v, g, bias) = _drop_grads(0.0, 1234, dtype)
    want = att.attention_natural_ref(q, k, v, bias, H)
    want_grads = att.attention_bwd_ref(q, k, v, bias, g, H)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    for a, w in zip(grads, want_grads):
        torch.testing.assert_close(a, w, rtol=0, atol=0)


def test_dropout_seed_determinism_and_variation():
    a, ga, _ = _drop_grads(0.5, 1234)
    b, gb, _ = _drop_grads(0.5, 1234)
    c, _, _ = _drop_grads(0.5, 77)
    assert torch.equal(a, b)
    for x, y in zip(ga, gb):
        assert torch.equal(x, y)
    assert not torch.allclose(a, c)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_kept_fraction(rate):
    keep = att.dropout_keep_mask_ref(2**33 + 5, 16, 12, 36, 36, rate)
    t, keep_p = keep_threshold(rate)
    n = keep.numel()
    sigma = math.sqrt(keep_p * (1 - keep_p) / n)
    assert abs(keep.float().mean().item() - keep_p) < 5 * sigma


def test_dropout_backward_replays_the_mask():
    # The output is linear in v with matrix P_drop, so <g, out> == <dv, v>
    # holds iff the backward applies the forward's mask.
    out, (_, _, dv, _), (_, _, v, g, _) = _drop_grads(0.5, 4321, b=8)
    lhs = float((out.detach().double() * g.double()).sum())
    rhs = float((dv.double() * v.detach().double()).sum())
    np.testing.assert_allclose(lhs, rhs, rtol=2e-3)


def _philox_scalar(counter, seed):
    m0, m1, w0, w1, mask = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85, 0xFFFFFFFF
    c0, c1, c2, c3 = counter
    k0, k1 = seed & mask, seed >> 32
    for _ in range(10):
        p0, p1 = m0 * c0, m1 * c2
        c0, c1, c2, c3 = (p1 >> 32) ^ c1 ^ k0, p1 & mask, (p0 >> 32) ^ c3 ^ k1, p0 & mask
        k0, k1 = (k0 + w0) & mask, (k1 + w1) & mask
    return c0, c1, c2, c3


def _keep_scalar(seed, b, h, i, j, t):
    words = _philox_scalar((j // 16, i, h, b), seed)
    byte = (words[(j % 16) // 4] >> (8 * (j % 4))) & 0xFF
    return byte >= t


@pytest.mark.parametrize("seed", [0, 1234, 2**62 + 2**40 + 99, 2**63 - 1])
def test_keep_mask_matches_scalar_philox(seed):
    b, h, sq, skv, rate = 3, 5, 6, 37, 0.3
    t, _ = keep_threshold(rate)
    keep = att.dropout_keep_mask_ref(seed, b, h, sq, skv, rate)
    want = np.array([
        [[[_keep_scalar(seed, bi, hi, i, j, t) for j in range(skv)] for i in range(sq)]
         for hi in range(h)] for bi in range(b)
    ])
    np.testing.assert_array_equal(keep.numpy(), want)


def test_plain_dropout_applies_the_mask():
    q, k, v, _, bias = _torch(_inputs(2, 20, 36, seed=4), torch.float32)
    rate, seed = 0.25, 5
    keep = att.dropout_keep_mask_ref(seed, 2, H, 20, 36, rate)
    probs = torch.softmax(
        torch.einsum("bqhd,bkhd->bhqk", q.reshape(2, 20, H, D), k.reshape(2, 36, H, D))
        / math.sqrt(D) + bias[:, None, None, :], dim=-1,
    )
    want = torch.einsum("bhqk,bkhd->bqhd", torch.where(keep, probs * (256 / 192), 0.0),
                        v.reshape(2, 36, H, D)).reshape(2, 20, E)
    got = att.attention_dropout_ref(q, k, v, bias, H, rate, seed)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_kernel_wrappers_refuse_cpu_tensors():
    q, k, v, g, bias = _torch(_inputs(2, 20, 20), torch.float32)
    calls = [
        (att.fused_attention_bwd_cuda, (q, k, v, bias, g, H)),
        (att.fused_attention_dropout_cuda, (q, k, v, bias, H, 0.1, 1)),
        (att.fused_attention_dropout_bwd_cuda, (q, k, v, bias, g, H, 0.1, 1)),
    ]
    for fn, args in calls:
        before = fn.launches
        with pytest.raises(ValueError, match="not CUDA"):
            fn(*args)
        assert fn.launches == before


# ---------------------------------------------------------------------------
# On the card: 12 heads of 64, strided q/k/v as the model hands them.
# ---------------------------------------------------------------------------

# (atol, rtol).  bf16: 3e-2 plus one bf16 step of outputs above 4, as the
# forward.  dbias is f32 in both; from bf16 inputs its P comes from
# tensor-core scores (summation order differs from the plain version's),
# and it sums 12 x Sq terms of up to ~10, hence 1e-3 + 1e-4 |plain|.
CARD_TOL = {"float32": (1e-4, 0.0), "bfloat16": (3e-2, 1e-2), "dbias_bf16": (1e-3, 1e-4)}


def _card_inputs(cuda, sq, skv, dtype, b=7):
    e = 768
    q, k, v, g, bias = _inputs(b, sq, skv, e=e, seed=sq + skv)
    tq, tk, tv, tg = _torch((q, k, v, g), getattr(torch, dtype), cuda)
    # Self-attention q/k/v are column views of one fused QKV product.
    if sq == skv:
        qkv = torch.cat([tq, tk, tv], dim=-1)
        tq, tk, tv = qkv.split(e, dim=-1)
    return tq, tk, tv, tg, torch.from_numpy(bias).to(cuda)


def _close(got, want, dtype, name=""):
    """Assert |got - want| <= atol + rtol |want|, naming the worst error."""
    atol, rtol = CARD_TOL["dbias_bf16" if name == "dbias" and dtype == "bfloat16" else dtype]
    err = (got.float() - want.float()).abs()
    ok = bool((err <= atol + rtol * want.float().abs()).all())
    assert ok, f"{name}: max |kernel - plain| {err.max().item():.3e} over {atol} + {rtol}|plain|"
    return ok


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv", SHAPES)
def test_bwd_kernel_matches_plain_on_card(cuda, sq, skv, dtype):
    q, k, v, g, bias = _card_inputs(cuda, sq, skv, dtype)
    before = att.fused_attention_bwd_cuda.launches
    got = att.fused_attention_bwd_cuda(q, k, v, bias, g, 12)
    want = att.attention_bwd_ref(q, k, v, bias, g, 12)
    torch.cuda.synchronize()
    assert att.fused_attention_bwd_cuda.launches == before + 1
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert a.dtype == w.dtype and torch.isfinite(a.float()).all(), name
        assert _close(a, w, dtype, name)
    again = att.fused_attention_bwd_cuda(q, k, v, bias, g, 12)
    for a, b in zip(got, again):
        assert torch.equal(a, b)  # deterministic: no float atomics


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv", SHAPES)
def test_dropout_kernels_match_plain_on_card(cuda, sq, skv, dtype):
    q, k, v, g, bias = _card_inputs(cuda, sq, skv, dtype)
    rate, seed = 0.1, 2**40 + 3
    out = att.fused_attention_dropout_cuda(q, k, v, bias, 12, rate, seed)
    assert _close(out, att.attention_dropout_ref(q, k, v, bias, 12, rate, seed), dtype)
    got = att.fused_attention_dropout_bwd_cuda(q, k, v, bias, g, 12, rate, seed)
    want = att.attention_dropout_bwd_ref(q, k, v, bias, g, 12, rate, seed)
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert _close(a, w, dtype, name)
    # Rate 0 is the deterministic pair, bit for bit.
    assert torch.equal(
        att.fused_attention_dropout_cuda(q, k, v, bias, 12, 0.0, seed),
        att.fused_attention_cuda(q, k, v, bias, 12),
    )
    for a, b in zip(
        att.fused_attention_dropout_bwd_cuda(q, k, v, bias, g, 12, 0.0, seed),
        att.fused_attention_bwd_cuda(q, k, v, bias, g, 12),
    ):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [32, 256])
@pytest.mark.parametrize("sq,skv", [CLIP, LIMIT])
def test_f32_bwd_and_dropout_kernels_match_plain_on_card_at_batch(cuda, sq, skv, b):
    # #3 / #4 / #5's f32 bodies at CLIP's 50 x 50 (zero bias) and the 64 x
    # 64 limit, batch 32 and 256.
    q, k, v, g, bias = _card_inputs(cuda, sq, skv, "float32", b=b)
    if (sq, skv) == CLIP:
        bias = torch.zeros_like(bias)
    rate, seed = 0.1, 2**40 + 7
    pairs = [
        (att.fused_attention_bwd_cuda(q, k, v, bias, g, 12), att.attention_bwd_ref(q, k, v, bias, g, 12)),
        ((att.fused_attention_dropout_cuda(q, k, v, bias, 12, rate, seed),),
         (att.attention_dropout_ref(q, k, v, bias, 12, rate, seed),)),
        (att.fused_attention_dropout_bwd_cuda(q, k, v, bias, g, 12, rate, seed),
         att.attention_dropout_bwd_ref(q, k, v, bias, g, 12, rate, seed)),
    ]
    torch.cuda.synchronize()
    for got, want in pairs:
        for name, a, w in zip(("dq", "dk", "dv", "dbias") if len(got) == 4 else ("out",), got, want):
            assert torch.isfinite(a).all(), name
            assert _close(a, w, "float32", name)


@pytest.mark.cuda
def test_autograd_functions_launch_the_kernels_on_card(cuda):
    q, k, v, g, bias = _card_inputs(cuda, 20, 36, "bfloat16")
    counters = (att.fused_attention_cuda, att.fused_attention_bwd_cuda,
                att.fused_attention_dropout_cuda, att.fused_attention_dropout_bwd_cuda)
    before = [c.launches for c in counters]
    inputs = [t.detach().requires_grad_() for t in (q, k, v)]
    att.fused_attention(*inputs, bias, num_heads=12).backward(g)
    att.fused_attention_dropout(*inputs, bias, num_heads=12, rate=0.1, seed=5).backward(g)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [1, 1, 1, 1]
