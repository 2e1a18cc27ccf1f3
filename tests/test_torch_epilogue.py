"""Port parity: ``rgqa_tpu_torch.experiments.epilogue_exp`` against the
JAX experiment ``experiments/epilogue_exp.py``.

On the CPU the plain version ``epi_fused_ref`` is held to the TPU body
``_epi_kernel`` itself, run in Pallas interpret mode over the whole batch
(``grid=(1,)``), on the same numpy inputs (the script's: q, k, v, res
normal, W, b, beta 0.02 x normal, gamma 1 + 0.02 x normal): B = 2, E = 768
in 12 heads, f32, each row with its last keys padded (-10000), at the
script's four shapes; atol 1e-4 (LayerNorm over sums taken in another
order).  The plain version is also held to ``split``, the shipped form
(#1's plain version, ``torch.addmm``, the residual add, the port's
LayerNorm), and the entry point runs on the CPU.

The bf16 body's plan (``epi_plan``: key windows of whole batch rows per
64-row block) is held to a brute-force walk of every block: each output
row in exactly one window, each window at most 96 keys (within
``wgmma``'s 256) of whole segments, the shared memory within 227 KB.

Tests marked ``cuda`` hold the Hopper kernel to the plain version on the
card (``python -m pytest --noconftest -m cuda tests/test_torch_epilogue.py``)
and skip without one: LXMERT's four shapes and the edges of the bf16
body's layout (one row or one key, a window of one segment, a block that
is one segment, rows that straddle blocks), batches 1, 7 and 130 (the
last block runs past the output's end), q, k, v contiguous or as column
views of one fused product, padded keys and a fully masked row.
"""

import functools

import numpy as np
import pytest
import torch

from rgqa_tpu_torch.experiments import epilogue_exp as port
from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

E, H = 768, 12
TOL = 1e-4


@pytest.fixture(scope="module")
def jax_exp():
    pytest.importorskip("jax")
    from experiments import epilogue_exp

    return epilogue_exp


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry point would run on it")


def _inputs(b, sq, skv, device="cpu", dtype=torch.float32, seed=0):
    """The script's inputs from a numpy generator, then each row's last
    keys (a quarter to a half) padded with a -10000 bias."""
    args = list(port.make_inputs(b, sq, skv, device, dtype, np.random.default_rng(seed)))
    keys = torch.arange(skv, device=device)
    for row in range(b):
        args[3][row, keys >= skv - skv * (row % 3 + 1) // 4] = -10000.0
    return args


@pytest.mark.parametrize("sq,skv", port.SHAPES, ids=lambda x: str(x))
def test_plain_matches_the_tpu_body(jax_exp, sq, skv):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    q, k, v, m, res, w, b, g, be = (a.numpy() for a in _inputs(2, sq, skv, seed=sq + skv))
    want = pl.pallas_call(
        functools.partial(jax_exp._epi_kernel, num_heads=H, head_dim=E // H), grid=(1,),
        interpret=True, out_shape=jax.ShapeDtypeStruct(q.shape, jnp.float32),
    )(q, k, v, m, res, w, b.reshape(1, -1), g.reshape(1, -1), be.reshape(1, -1))
    got = port.epi_fused_ref(*(torch.from_numpy(a) for a in (q, k, v, m, res, w, b, g, be)))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("sq,skv", port.SHAPES, ids=lambda x: str(x))
def test_plain_matches_the_shipped_split(sq, skv):
    q, k, v, m, res, w, b, g, be = _inputs(3, sq, skv, seed=1)
    with torch.no_grad():
        want = port.split(q, k, v, m, res, w, b, port.layer_norm(g, be))
    torch.testing.assert_close(port.epi_fused_ref(q, k, v, m, res, w, b, g, be), want, atol=TOL, rtol=0)


def test_wrapper_dispatch_and_refusals():
    args = _inputs(2, 20, 36)
    assert torch.equal(port.epi_fused(*args), port.epi_fused_ref(*args))
    with pytest.raises(ValueError, match="not CUDA"):
        port.epi_fused_cuda(*args)
    assert port.epi_fused_cuda.launches == 0


def test_main_runs_on_the_cpu(capsys):
    res = port.main(["--device", "cpu", "--batch", "2", "--iters", "1"])
    assert len(res["rows"]) == 2 * len(port.SHAPES) and all(r["us"] is None for r in res["rows"])
    assert max(r["max_abs_diff"] for r in res["rows"]) < TOL
    assert res["launches"] == {"epi_fused": 0}
    assert capsys.readouterr().out.strip().splitlines()[-1] == 'launches {"epi_fused": 0}'


def test_main_raises_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        port.main(["--batch", "2"])


EDGE_SHAPES = ((1, 1), (1, 64), (7, 13), (16, 16), (33, 64), (64, 64), (64, 1))
PLAN_BATCHES = (1, 7, 130, 384)


def _windows(plan, batch, sq, blk):
    """Block ``blk``'s key windows as ``csrc/epilogue.cu`` walks them
    (``per_window`` consecutive batch rows of the block at a time): per
    window its batch rows and its query rows, block-relative [c0, c1)."""
    total, r0 = batch * sq, blk * port.ROWS
    r1 = min(r0 + port.ROWS, total)
    segs = list(range(r0 // sq, (r1 - 1) // sq + 1))
    return [(segs[w:w + plan.per_window], max(r0, segs[w] * sq) - r0,
             min(r1, (segs[min(w + plan.per_window, len(segs)) - 1] + 1) * sq) - r0)
            for w in range(0, len(segs), plan.per_window)]


@pytest.mark.parametrize("sq,skv", port.SHAPES + EDGE_SHAPES, ids=lambda x: str(x))
def test_plan_covers_every_row_once_in_whole_segment_windows(sq, skv):
    for batch in PLAN_BATCHES:
        plan = port.epi_plan(batch, sq, skv)
        total = batch * sq
        assert plan.blocks * port.ROWS >= total > (plan.blocks - 1) * port.ROWS
        assert plan.keys % 16 == 0 and 16 <= plan.keys <= port.MAX_WINDOW_KEYS <= 256
        assert plan.per_window * skv <= plan.keys and plan.smem <= port.SMEM_MAX
        covered = []
        widest = 0
        for blk in range(plan.blocks):
            r0 = blk * port.ROWS
            rows = list(range(r0, min(r0 + port.ROWS, total)))
            segs = sorted({r // sq for r in rows})  # the block's batch rows, by brute force
            widest = max(widest, len(segs))
            windows = _windows(plan, batch, sq, blk)
            assert [b for w, _, _ in windows for b in w] == segs  # whole segments, each once, in order
            for w, c0, c1 in windows:
                assert len(w) <= plan.per_window and len(w) * skv <= plan.keys
                # the window's query rows are exactly the block's rows of its segments
                assert list(range(r0 + c0, r0 + c1)) == [r for r in rows if r // sq in w]
                covered += range(r0 + c0, r0 + c1)
        assert covered == list(range(total))
        assert widest == plan.segments


def test_plan_windows_at_lxmerts_shapes():
    # One window a head at 20x20 and 36x20; two at 36x36 (three batch rows
    # of 36 keys: 108 > 96) and 20x36 (four of 36: two windows of 72);
    # N = 80 / 80 / 80 / 64 keys.
    plans = [port.epi_plan(384, sq, skv) for sq, skv in port.SHAPES]
    assert [(p.segments, p.per_window, p.keys) for p in plans] == [(4, 4, 80), (3, 2, 80), (4, 2, 80), (3, 3, 64)]
    assert [p.blocks for p in plans] == [120, 216, 120, 216]


@pytest.mark.parametrize("keys", range(16, port.MAX_WINDOW_KEYS + 1, 16))
def test_shared_memory_fits_the_block(keys):
    # The tile (96 KB), the ring of five 24 KB W slices or the attention
    # buffers, whichever is larger, the barriers and partial sums.
    nbytes = port.epi_smem_bytes(keys)
    assert 96 * 1024 + 5 * 24 * 1024 < nbytes <= port.SMEM_MAX


def _fused_views(args, sq, skv):
    """q, k, v as column views of one (B, S, 3E) product when Sq == Skv,
    else q alone and k, v views of one (B, Skv, 2E) product."""
    q, k, v = args[:3]
    if sq == skv:
        q, k, v = torch.cat([q, k, v], -1).split(E, -1)
    else:
        k, v = torch.cat([k, v], -1).split(E, -1)
    assert k.stride(1) in (2 * E, 3 * E)
    return [q, k, v, *args[3:]]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "fused"])
@pytest.mark.parametrize("batch", [1, 7, 130])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("sq,skv", port.SHAPES + EDGE_SHAPES, ids=lambda x: str(x))
def test_kernel_matches_plain_on_the_card(cuda, sq, skv, dtype, batch, layout):
    # Batches 7 and 130: the rows of the last block run past the output's end.
    args = _inputs(batch, sq, skv, cuda, dtype, seed=2)
    args[3][batch // 2] = -10000.0  # a fully masked row stays finite
    if layout == "fused":
        args = _fused_views(args, sq, skv)
    atol, rtol = (1e-4, 0.0) if dtype == torch.float32 else (3e-2, 1e-2)
    before = port.epi_fused_cuda.launches
    got = port.epi_fused(*args)
    assert port.epi_fused_cuda.launches == before + 1
    torch.testing.assert_close(got.float(), port.epi_fused_ref(*args).float(), atol=atol, rtol=rtol)
