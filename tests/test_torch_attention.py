"""Port parity: ``rgqa_tpu_torch.ops.attention`` against the JAX package.

On the CPU the port's plain version is held to the Pallas kernel
``_fused_pallas_raw`` run in interpret mode (as ``tests/test_ops.py``
runs it) and to the XLA reference, on the same numpy inputs, at
LXMERT's four attention shapes with a ragged batch and a fully masked
row, at CLIP's 50 x 50 with a zero bias (its vision tower passes no
mask) and at the short kernels' 64 x 64 limit: atol 1e-5 in f32, 3e-2 in
bf16 (the Pallas kernel rounds P to bf16 before PV, the plain version
keeps it in f32).

Tests marked ``cuda`` hold the Hopper kernel to the plain version on the
card and skip without one (run them there with ``python -m pytest
--noconftest -m cuda tests/test_torch_attention.py``).
"""

import numpy as np
import pytest
import torch

from rgqa_tpu_torch.ops import attention as att
from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

H, D = 4, 8
E = H * D
SHAPES = [(20, 20), (36, 36), (20, 36), (36, 20)]  # lang self, visn self, cross both ways
CLIP = (50, 50)  # CLIP ViT-B/32's vision stream: 49 patches + CLS, no mask
LIMIT = (64, 64)  # the short kernels' longest streams
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


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
    """numpy f32 q, k, v and a (B, Skv) -10000 bias with row 0 fully masked."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, e), dtype=np.float32)
    k = rng.standard_normal((b, skv, e), dtype=np.float32)
    v = rng.standard_normal((b, skv, e), dtype=np.float32)
    mask = (rng.random((b, skv)) > 0.3).astype(np.float32)
    mask[:, -1] = 1.0
    mask[0] = 0.0
    return q, k, v, (1.0 - mask) * -10000.0


def _to_torch(arrays, dtype):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv", SHAPES + [CLIP, LIMIT])
def test_plain_matches_pallas_kernel(jax_attention, sq, skv, dtype):
    import jax.numpy as jnp

    q, k, v, bias = _inputs(5, sq, skv, seed=sq * 100 + skv)
    if (sq, skv) == CLIP:
        bias = np.zeros_like(bias)
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v))
    want = jax_attention._fused_pallas_raw(jq, jk, jv, jnp.asarray(bias), H)
    tq, tk, tv = _to_torch((q, k, v), getattr(torch, dtype))
    got = att.attention_natural_ref(tq, tk, tv, torch.from_numpy(bias), H)
    assert got.dtype == getattr(torch, dtype)
    assert torch.isfinite(got).all()  # the fully masked row stays finite
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=TOL[dtype]
    )


@pytest.mark.parametrize("b", [1, 7])
def test_plain_matches_xla_reference(jax_attention, b):
    import jax.numpy as jnp

    q, k, v, bias = _inputs(b, 36, 20, seed=b)
    want = jax_attention._attention_natural_xla(
        *(jnp.asarray(a) for a in (q, k, v, bias)), H
    )
    got = att.attention_natural_ref(*_to_torch((q, k, v, bias), torch.float32), H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_bias_vector_forms_match_jax(jax_attention):
    import jax.numpy as jnp

    _, _, _, bias = _inputs(3, 4, 9)
    tb = torch.from_numpy(bias)
    cases = [
        (None, None),
        (tb, jnp.asarray(bias)),
        (tb[:, None, None, :].to(torch.bfloat16), jnp.asarray(bias, jnp.bfloat16)[:, None, None, :]),
        (tb[:1], jnp.asarray(bias[:1])),  # broadcast over the batch
    ]
    for tbias, jbias in cases:
        got = att.bias_vector(tbias, 3, 9)
        want = jax_attention.bias_vector(jbias, 3, 9)
        assert got.dtype == torch.float32 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cpu_dispatch_takes_plain_version():
    q, k, v, bias = _to_torch(_inputs(4, 20, 36), torch.float32)
    before = att.fused_attention_cuda.launches
    want = att.attention_natural_ref(q, k, v, bias, H)
    for force_xla in (False, True):
        got = att.fused_attention(q, k, v, bias[:, None, None, :], num_heads=H, force_xla=force_xla)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert att.fused_attention_cuda.launches == before


def test_strided_qkv_views_match_contiguous():
    # The model hands the kernel column slices of one fused QKV product.
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((3, 20, 3 * E), dtype=np.float32))
    q, k, v = qkv.split(E, dim=-1)
    assert q.stride(1) == 3 * E
    got = att.fused_attention(q, k, v, None, num_heads=H)
    want = att.fused_attention(q.contiguous(), k.contiguous(), v.contiguous(), None, num_heads=H)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_kernel_wrapper_refuses_cpu_tensors():
    # No fallback: the kernel's wrapper raises rather than run the plain version.
    q, k, v, bias = _to_torch(_inputs(2, 20, 20), torch.float32)
    before = att.fused_attention_cuda.launches
    with pytest.raises(ValueError, match="not CUDA"):
        att.fused_attention_cuda(q, k, v, bias, H)
    assert att.fused_attention_cuda.launches == before


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv", SHAPES)
def test_kernel_matches_plain_on_card(cuda, sq, skv, dtype):
    # LXMERT widths: 12 heads of 64; ragged batch 7 with a fully masked row.
    e = 768
    q, k, v, bias = _inputs(7, sq, skv, e=e, seed=sq + skv)
    tq, tk, tv = (t.to(cuda) for t in _to_torch((q, k, v), getattr(torch, dtype)))
    tbias = torch.from_numpy(bias).to(cuda)
    before = att.fused_attention_cuda.launches
    got = att.fused_attention(tq, tk, tv, tbias, num_heads=12)
    want = att.attention_natural_ref(tq, tk, tv, tbias, 12)
    torch.cuda.synchronize()
    assert att.fused_attention_cuda.launches == before + 1
    assert got.dtype == tq.dtype and torch.isfinite(got).all()
    # bf16: 3e-2 plus one bf16 step of outputs above 4 (P is rounded to
    # bf16 in the kernel, kept in f32 by the plain version).
    atol, rtol = {"float32": (2e-5, 0.0), "bfloat16": (3e-2, 1e-2)}[dtype]
    assert ((got.float() - want.float()).abs() <= atol + rtol * want.float().abs()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("b", [32, 256])
@pytest.mark.parametrize("sq,skv", [CLIP, LIMIT])
def test_f32_kernel_matches_plain_on_card_at_batch(cuda, sq, skv, b):
    # The f32 body at CLIP's 50 x 50 (zero bias) and the 64 x 64 limit,
    # at the batches that change its grid (query tiles at 32, one tile a
    # (row, head) at 256); q, k, v column views of one fused QKV product.
    e = 768
    q, k, v, bias = _inputs(b, sq, skv, e=e, seed=b + sq)
    if (sq, skv) == CLIP:
        bias = np.zeros_like(bias)
    qkv = torch.from_numpy(np.concatenate([q, k, v], axis=-1)).to(cuda)
    tq, tk, tv = qkv.split(e, dim=-1)
    tbias = torch.from_numpy(bias).to(cuda)
    got = att.fused_attention_cuda(tq, tk, tv, tbias, 12)
    want = att.attention_natural_ref(tq, tk, tv, tbias, 12)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 2e-5


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take(cuda):
    # Beyond 64 tokens the forward takes the long-stream kernel; the short
    # kernel's own wrapper refuses them.
    q = torch.zeros(2, 65, 768, device=cuda)
    with pytest.raises(ValueError, match="exceed"):
        att.fused_attention_cuda(q, q, q, torch.zeros(2, 65, device=cuda), 12)
    h = torch.zeros(2, 20, 768, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        att.fused_attention(h, h, h, None, num_heads=12)
