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

Tests marked ``cuda`` hold the Hopper kernel to the plain version on the
card (``python -m pytest --noconftest -m cuda tests/test_torch_epilogue.py``)
and skip without one.
"""

import functools

import numpy as np
import pytest
import torch

from rgqa_tpu_torch.experiments import epilogue_exp as port

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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("sq,skv", port.SHAPES, ids=lambda x: str(x))
def test_kernel_matches_plain_on_the_card(cuda, sq, skv, dtype):
    # Batch 7: the rows of the last block run past the output's end.
    args = _inputs(7, sq, skv, cuda, dtype, seed=2)
    args[3][3] = -10000.0  # a fully masked row stays finite
    atol, rtol = (1e-4, 0.0) if dtype == torch.float32 else (3e-2, 1e-2)
    before = port.epi_fused_cuda.launches
    got = port.epi_fused(*args)
    assert port.epi_fused_cuda.launches == before + 1
    torch.testing.assert_close(got.float(), port.epi_fused_ref(*args).float(), atol=atol, rtol=rtol)
