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
entry point runs on the CPU.  The bf16 body's plan (``fold_plan``: tiles
of whole heads, at most 64 stacked query rows, each against a key window
of its own heads) covers every row's head and fits ``wgmma``; the plain
version computed tile by tile over those windows
(``headfold_window_ref``) equals the TPU bodies and the stacked plain
version, a fully masked row included.

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


@functools.lru_cache(maxsize=None)
def _tpu_body(sq, skv, variant, fold):
    """The inputs and the TPU body's output on them (Pallas interpret mode,
    the whole batch in one grid step); one run per case and process."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from experiments import headfold_exp as jax_exp

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
    return (q, k, v, m), np.asarray(want)


@pytest.mark.parametrize("variant,fold", port.CANDIDATES, ids=lambda x: str(x))
@pytest.mark.parametrize("sq,skv", port.SHAPES, ids=lambda x: str(x))
def test_plain_matches_the_tpu_body(jax_exp, sq, skv, variant, fold):
    args, want = _tpu_body(sq, skv, variant, fold)
    got = port.headfold_ref(*_t(args), fold, variant)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("variant,fold", port.CANDIDATES, ids=lambda x: str(x))
@pytest.mark.parametrize("sq,skv", port.SHAPES, ids=lambda x: str(x))
def test_window_plain_matches_the_tpu_body(jax_exp, sq, skv, variant, fold):
    """Each tile over its key window only, against the TPU body's stacked
    product over every key of the group."""
    args, want = _tpu_body(sq, skv, variant, fold)
    got = port.headfold_window_ref(*_t(args), fold, variant)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("sq,skv", port.SHAPES, ids=lambda x: str(x))
def test_window_plain_matches_the_stacked_plain(sq, skv):
    """Dropping the keys outside each tile's window changes nothing: every
    (variant, F), with a fully masked row (its own-head scores near
    -10000, the dropped ones near -1e9)."""
    q, k, v, m = _inputs(3, sq, skv, seed=11)
    m[1] = -10000.0
    args = _t((q, k, v, m))
    for variant, fold in port.CANDIDATES:
        got = port.headfold_window_ref(*args, fold, variant)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, port.headfold_ref(*args, fold, variant), atol=TOL, rtol=0)


def _check_plan(sq, skv, fold):
    """The plan's tiles hold whole heads, at most 64 rows, and cover the
    stack in order; each row's own head lies in its tile's window, which
    lies in the group; N fits wgmma (a multiple of 8, at most 256) and P
    V's 16-key steps."""
    plan = port.fold_plan(sq, skv, fold)
    assert plan.keys == plan.heads * skv and 1 <= plan.heads <= fold
    assert plan.n % 16 == 0 and plan.keys <= plan.n < plan.keys + 16 and plan.n <= port.MAX_WINDOW_KEYS
    rows = plan.heads * sq
    assert rows <= port.TILE_ROWS
    assert [q0 for q0, _, _ in plan.tiles] == list(range(0, fold * sq, rows))
    for q0, n_rows, h0 in plan.tiles:
        assert n_rows == min(rows, fold * sq - q0)
        assert 0 <= h0 and h0 + plan.heads <= fold
        for r in range(q0, q0 + n_rows):
            assert h0 <= r // sq < h0 + plan.heads, (q0, r)
    return plan


@pytest.mark.parametrize("variant,fold", port.CANDIDATES, ids=lambda x: str(x))
@pytest.mark.parametrize("sq,skv", port.SHAPES, ids=lambda x: str(x))
def test_fold_plan_fits_wgmma(sq, skv, variant, fold):
    port.head_order(H, fold, variant)
    plan = _check_plan(sq, skv, fold)
    assert plan.heads == (1 if sq > 32 else min(fold, 3))  # the experiment's 20-row heads: 3 to a tile
    assert plan.heads <= -(-(port.TILE_ROWS - 1) // sq) + 1


def test_fold_plan_at_every_length():
    """Every Sq, Skv <= 64 the wrapper takes, at every F: the plan covers
    the stack within wgmma's shapes, so the bf16 body refuses none; the
    window narrows below 64 // Sq heads only where their keys would pass
    256."""
    for fold in port.FOLDS:
        for sq in range(1, 65):
            for skv in range(1, 65):
                assert _check_plan(sq, skv, fold).heads == min(fold, 64 // sq, 256 // skv)


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
@pytest.mark.parametrize("batch", [7, 384])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("sq,skv", port.SHAPES, ids=lambda x: str(x))
def test_kernel_matches_plain_on_the_card(cuda, sq, skv, dtype, batch):
    q, k, v, m = _inputs(batch, sq, skv, seed=3)
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("sq,skv,fold", [(8, 64, 6), (13, 50, 4), (64, 64, 2), (3, 17, 6), (33, 7, 3)],
                         ids=lambda x: str(x))
def test_kernel_matches_plain_at_other_lengths(cuda, sq, skv, fold, dtype):
    """Beyond the experiment's shapes: windows narrowed to 256 keys (8x64,
    F = 6: 4 heads a tile, the last tile's window shifted back), a whole
    group in one tile (13x50, 3x17), one head a tile (64x64, 33x7)."""
    q, k, v, m = _inputs(5, sq, skv, seed=4)
    m[2] = -10000.0
    args = _t((q, k, v, m), cuda, dtype)
    atol, rtol = (2e-5, 0.0) if dtype == torch.float32 else (3e-2, 1e-2)
    got = port.headfold(*args, fold)
    torch.testing.assert_close(got.float(), port.headfold_ref(*args, fold).float(), atol=atol, rtol=rtol)
