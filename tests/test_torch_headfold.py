"""Port parity: ``rgqa_tpu_torch.experiments.headfold_exp`` against the
JAX experiment ``experiments/headfold_exp.py``.

On the CPU the plain version ``headfold_ref`` is held to the TPU bodies
``_concat_kernel`` (variant ``concat``) and ``_scratch_kernel``
(``scratch``) themselves, run in Pallas interpret mode over the whole
batch (``grid=(1,)``; the TPU wrapper's padding to multiples of 8 is a
lowering constraint that interpret mode does not have), on the same numpy
inputs: B = 2, E = 768 in 12 heads, f32, each row with its last keys
padded (-10000); atol 1e-5.  Every shape of the script (56x56, 36x36,
20x36, 36x20, 20x20) with every (variant, F) it runs.  The plain version
is also held to #1's plain version (the shipped form, F = 1), and the
entry point runs on the CPU.

Tests marked ``cuda`` hold the Hopper kernel to the plain version on the
card (``python -m pytest --noconftest -m cuda tests/test_torch_headfold.py``)
and skip without one.
"""

import functools

import numpy as np
import pytest
import torch

from rgqa_tpu_torch.experiments import headfold_exp as port
from rgqa_tpu_torch.ops import attention as att

E, H, D = 768, 12, 64
TOL = 1e-5


@pytest.fixture(scope="module")
def jax_exp():
    pytest.importorskip("jax")
    from experiments import headfold_exp

    return headfold_exp


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry point would run on it")


def _inputs(b, sq, skv, seed=0):
    """numpy f32 q, k, v and a (B, Skv) -10000 bias on each row's last keys
    (a quarter to a half; no fully masked row on the CPU, see
    tests/test_torch_xfuse.py)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, E), dtype=np.float32) for s in (sq, skv, skv))
    keep = np.ones((b, skv), np.float32)
    for row in range(b):
        keep[row, skv - skv * (row % 3 + 1) // 4:] = 0.0
    return q, k, v, (1.0 - keep) * -10000.0


def _t(arrays, device="cpu", dtype=torch.float32):
    q, k, v, m = (torch.from_numpy(a).to(device) for a in arrays)
    return q.to(dtype), k.to(dtype), v.to(dtype), m


@pytest.mark.parametrize("variant,fold", port.CANDIDATES, ids=lambda x: str(x))
@pytest.mark.parametrize("sq,skv", port.SHAPES, ids=lambda x: str(x))
def test_plain_matches_the_tpu_body(jax_exp, sq, skv, variant, fold):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    q, k, v, m = _inputs(2, sq, skv, seed=sq * 100 + skv)
    if variant == "concat":
        order = port.head_order(H, fold, variant)
        groups = [tuple(order[i:i + fold]) for i in range(0, H, fold)]
        assert groups == [(0, 2), (4, 6), (8, 10), (1, 3), (5, 7), (9, 11)]  # the script's (:154)
        kernel = functools.partial(jax_exp._concat_kernel, groups=groups, sq=sq, skv=skv)
        scratch = []
    else:
        kernel = functools.partial(jax_exp._scratch_kernel, fold=fold, sq=sq, skv=skv)
        scratch = [pltpu.VMEM((2, fold * s, D), jnp.float32) for s in (sq, skv, skv)]
    want = pl.pallas_call(
        kernel, grid=(1,), interpret=True, scratch_shapes=scratch,
        out_shape=jax.ShapeDtypeStruct(q.shape, jnp.float32),
    )(q, k, v, m)
    got = port.headfold_ref(*_t((q, k, v, m)), fold, variant)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("sq,skv", port.SHAPES, ids=lambda x: str(x))
def test_plain_matches_the_shipped_attention(sq, skv):
    """Every (variant, F) computes #1's function (F = 1)."""
    args = _t(_inputs(3, sq, skv, seed=7))
    want = att.attention_natural_ref(*args, H)
    for variant, fold in port.CANDIDATES:
        torch.testing.assert_close(port.headfold_ref(*args, fold, variant), want, atol=TOL, rtol=0)


def test_head_orders_and_refusals():
    assert port.head_order(H, 3, "scratch") == list(range(H))
    assert port.head_order(H, 2, "concat") == [0, 2, 4, 6, 8, 10, 1, 3, 5, 7, 9, 11]
    for fold, variant in ((5, "scratch"), (4, "concat"), (2, "lane")):
        with pytest.raises(ValueError):
            port.head_order(H, fold, variant)
    args = _t(_inputs(2, 20, 20))
    with pytest.raises(ValueError, match="not CUDA"):
        port.headfold_cuda(*args, 2)
    assert torch.equal(port.headfold(*args, 3), port.headfold_ref(*args, 3))
    assert port.headfold_cuda.launches == 0


def test_main_runs_on_the_cpu(capsys):
    res = port.main(["--device", "cpu", "--batch", "2", "--iters", "1"])
    assert len(res["rows"]) == len(port.SHAPES) * (1 + len(port.CANDIDATES))
    assert all(r["us"] is None for r in res["rows"])
    assert max(r["max_abs_diff"] for r in res["rows"]) < TOL
    assert res["launches"] == {"headfold": 0}
    assert capsys.readouterr().out.strip().splitlines()[-1] == 'launches {"headfold": 0}'


def test_main_raises_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        port.main(["--batch", "2"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("sq,skv", port.SHAPES, ids=lambda x: str(x))
def test_kernel_matches_plain_on_the_card(cuda, sq, skv, dtype):
    q, k, v, m = _inputs(7, sq, skv, seed=3)
    m[3] = -10000.0  # a fully masked row stays finite
    args = _t((q, k, v, m), cuda, dtype)
    atol, rtol = (2e-5, 0.0) if dtype == torch.float32 else (3e-2, 1e-2)
    shipped = att.fused_attention_cuda(*args, H)
    for variant, fold in port.CANDIDATES:
        before = port.headfold_cuda.launches
        got = port.headfold(*args, fold, variant)
        assert port.headfold_cuda.launches == before + 1
        torch.testing.assert_close(got.float(), port.headfold_ref(*args, fold, variant).float(),
                                   atol=atol, rtol=rtol)
        torch.testing.assert_close(got.float(), shipped.float(), atol=atol, rtol=rtol)
