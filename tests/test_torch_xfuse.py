"""Port parity: ``rgqa_tpu_torch.experiments.xfuse_exp`` against the JAX
experiment ``experiments/xfuse_exp.py``.

On the CPU the plain versions (``dual_pair_ref``, ``cat_call_ref``) are
held to the TPU bodies ``_dual_kernel`` and ``_cat_kernel`` themselves,
run in Pallas interpret mode over the whole batch (``grid=(1,)``), on the
same numpy inputs: B = 2, E = 768 in 12 heads, f32, each row with its
last keys padded (-10000); atol 1e-5.  Both pairs of
the script (cross: 20x36 + 36x20; self: 20x20 + 36x36) and both cat
modes.  The plain versions are also held to the shipped form, two calls
of #1's plain version, and the entry point runs on the CPU.

Tests marked ``cuda`` hold the Hopper kernels to the plain versions on the
card (``python -m pytest --noconftest -m cuda tests/test_torch_xfuse.py``)
and skip without one.
"""

import numpy as np
import pytest
import torch

from rgqa_tpu_torch.experiments import xfuse_exp as port
from rgqa_tpu_torch.ops import attention as att
from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

E, H = 768, 12
SL, SV = 20, 36
# (Sq, Skv) of problem a and of problem b, and the cat mode that computes the pair.
PAIRS = {"cross": (((SL, SV), (SV, SL)), "xor"), "self": (((SL, SL), (SV, SV)), "diag")}
TOL = 1e-5


@pytest.fixture(scope="module")
def jax_exp():
    pytest.importorskip("jax")
    from experiments import xfuse_exp

    return xfuse_exp


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry point would run on it")


def _problem(b, sq, skv, seed):
    """numpy f32 q, k, v and a (B, Skv) bias with padded keys (-10000):
    each row's last keys, a quarter to a half of them.  No row is fully
    masked here: its scores sit near -10000, where f32 steps are 1e-3, so
    two products that differ in the last bit (numpy's and XLA's sums) can
    round apart by more than the bound; the card tests and the smoke hold
    the kernels to the plain versions with such a row."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, E), dtype=np.float32) for s in (sq, skv, skv))
    keep = np.ones((b, skv), np.float32)
    for row in range(b):
        keep[row, skv - skv * (row % 3 + 1) // 4:] = 0.0
    return q, k, v, (1.0 - keep) * -10000.0


def _pair(label, b=2):
    (sa, sb), _ = PAIRS[label]
    return _problem(b, *sa, seed=1) + _problem(b, *sb, seed=2)


def _t(arrays, device="cpu", dtype=torch.float32):
    """Torch tensors of (q, k, v, bias) groups: q, k, v in ``dtype``, each
    bias (every fourth array) in f32."""
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=torch.float32 if i % 4 == 3 else dtype)
            for i, a in enumerate(arrays)]


def _concat(a_args, b_args, mode):
    """The concatenated stream [language; vision] of a pair: for the cross
    pair (xor) stream a's keys are the vision ones."""
    qa, ka, va, ma = a_args
    qb, kb, vb, mb = b_args
    if mode == "xor":
        ka, kb, va, vb, ma, mb = kb, ka, vb, va, mb, ma
    return [np.concatenate(p, axis=1) for p in ((qa, qb), (ka, kb), (va, vb), (ma, mb))]


@pytest.mark.parametrize("label", sorted(PAIRS))
def test_dual_plain_matches_the_tpu_body(jax_exp, label):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    args = _pair(label)
    outs = pl.pallas_call(
        jax_exp._dual_kernel, grid=(1,), interpret=True,
        out_shape=(jax.ShapeDtypeStruct(args[0].shape, jnp.float32),
                   jax.ShapeDtypeStruct(args[4].shape, jnp.float32)),
    )(*args)
    got = port.dual_pair_ref(*_t(args))
    for g, w in zip(got, outs):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=0)


@pytest.mark.parametrize("label", sorted(PAIRS))
def test_cat_plain_matches_the_tpu_body(jax_exp, label):
    import functools

    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    args = _pair(label)
    mode = PAIRS[label][1]
    q, k, v, m = _concat(args[:4], args[4:], mode)
    want = pl.pallas_call(
        functools.partial(jax_exp._cat_kernel, split=SL, mode=mode), grid=(1,), interpret=True,
        out_shape=jax.ShapeDtypeStruct(q.shape, jnp.float32),
    )(q, k, v, m)
    got = port.cat_call_ref(*_t((q, k, v, m)), SL, mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("label", sorted(PAIRS))
def test_plain_versions_match_the_shipped_pair(label):
    """Both forms against two calls of #1's plain version."""
    args = _pair(label, b=3)
    ta, tb = _t(args[:4]), _t(args[4:])
    want = (att.attention_natural_ref(*ta, H), att.attention_natural_ref(*tb, H))
    dual = port.dual_pair_ref(*ta, *tb)
    cat = port.cat_call_ref(*_t(_concat(args[:4], args[4:], PAIRS[label][1])), SL, PAIRS[label][1])
    for got in (dual, (cat[:, :SL], cat[:, SL:])):
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=TOL, rtol=0)


def test_cat_struct_is_the_tpu_mask():
    s = port.cat_struct(5, 2, "xor")
    assert s[0, 2] == 0 and s[0, 1] == -1e9 and s[3, 0] == 0 and s[3, 4] == -1e9
    d = port.cat_struct(5, 2, "diag")
    assert d[0, 1] == 0 and d[0, 2] == -1e9 and d[3, 4] == 0 and d[3, 0] == -1e9


def test_public_functions_take_the_plain_versions_on_the_cpu():
    args = _t(_pair("cross"))
    for g, w in zip(port.dual_pair(*args), port.dual_pair_ref(*args)):
        assert torch.equal(g, w)
    q, k, v, m = _t(_concat(_pair("self")[:4], _pair("self")[4:], "diag"))
    assert torch.equal(port.cat_call(q, k, v, m, SL, "diag"), port.cat_call_ref(q, k, v, m, SL, "diag"))
    assert port.dual_pair_cuda.launches == 0 and port.cat_call_cuda.launches == 0


def test_wrappers_refuse_what_the_kernel_does_not_take():
    args = _t(_pair("cross"))
    with pytest.raises(ValueError, match="not CUDA"):
        port.dual_pair_cuda(*args)
    q, k, v, m = _t(_concat(_pair("self")[:4], _pair("self")[4:], "diag"))
    with pytest.raises(ValueError, match="mode"):
        port.cat_call_ref(q, k, v, m, SL, "both")
    with pytest.raises(ValueError, match="split"):
        port.cat_call(q, k, v, m, 0, "xor")


def test_main_runs_on_the_cpu(capsys):
    res = port.main(["--device", "cpu", "--batch", "2", "--iters", "1"])
    assert len(res["rows"]) == 8 and all(r["us"] is None for r in res["rows"])
    assert max(r["max_abs_diff"] for r in res["rows"]) < TOL
    assert res["launches"] == {"dual_pair": 0, "cat_call": 0}
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("launches ")


def test_main_raises_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        port.main(["--batch", "2"])


def _card_bound(dtype):
    return (2e-5, 0.0) if dtype == torch.float32 else (3e-2, 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("label", sorted(PAIRS))
def test_kernels_match_plain_on_the_card(cuda, label, dtype):
    args = _pair(label, b=7)
    args[3][3] = args[7][3] = -10000.0  # a fully masked row stays finite
    ta, tb = _t(args[:4], cuda, dtype), _t(args[4:], cuda, dtype)
    atol, rtol = _card_bound(dtype)
    before = port.dual_pair_cuda.launches
    for g, w in zip(port.dual_pair(*ta, *tb), port.dual_pair_ref(*ta, *tb)):
        torch.testing.assert_close(g.float(), w.float(), atol=atol, rtol=rtol)
    assert port.dual_pair_cuda.launches == before + 1
    # dual runs #1's body on each problem: the same bits as two #1 calls.
    for g, w in zip(port.dual_pair(*ta, *tb), (att.fused_attention_cuda(*ta, H), att.fused_attention_cuda(*tb, H))):
        assert torch.equal(g, w)
    mode = PAIRS[label][1]
    q, k, v, m = _t(_concat(args[:4], args[4:], mode), cuda, dtype)
    torch.testing.assert_close(port.cat_call(q, k, v, m, SL, mode).float(),
                               port.cat_call_ref(q, k, v, m, SL, mode).float(), atol=atol, rtol=rtol)
