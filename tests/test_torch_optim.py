"""Port parity: every ``--optim`` and ``--bf16_moments`` against the JAX
package's ``make_optimizer``, on the CPU.

The same f32 parameters and the same sequence of 10 gradients go through
the JAX optax transformation and the port's ``torch.optim.Optimizer``:
the parameters agree within rtol 1e-6 (atol 1e-7, for elements that an
update brings near zero: ``tests/test_torch_train.py``'s BertAdam bar)
after every update, for ``adam``,
``adamw``, ``adamax``, ``sgd``, ``rms`` and BertAdam (``bert``), each on
gradients of unit size and on gradients of 1e-5 (where ``nu`` is small:
``optax.rmsprop`` adds eps inside the square root, ``torch.optim.RMSprop``
outside, and decays by 0.99 where optax decays by 0.9; a test shows the
torch class leaving the bar there).  With ``--bf16_moments`` the stored
moments are bf16 and within one bf16 ulp of the JAX state's, and the
parameters within rtol 1e-6.  The runner's resume restores each
optimizer's state: a two-epoch run's second epoch equals one epoch
resumed from the first epoch's ``LAST``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from rgqa_tpu_torch.config import OptimConfig
from rgqa_tpu_torch.data.synthetic import SyntheticSpec, make_synthetic_gqa
from rgqa_tpu_torch.runner import GQARunner
from rgqa_tpu_torch.train import optimizer
from test_torch_slice import SPEC, _cfg
from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

N_UPDATES = 10
SHAPES = {"w": (5, 7), "b": (7,), "ln": (3,)}
NAMES = ["adam", "adamw", "adamax", "sgd", "rms", "bert"]


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


def _sequence(scale: float, seed: int = 0):
    rng = np.random.default_rng(seed)
    init = {k: rng.standard_normal(s, dtype=np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.standard_normal(s, dtype=np.float32) * scale).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(N_UPDATES)]
    return init, grads


def _jax_run(init, grads, cfg):
    """The JAX ``make_optimizer(cfg)`` over ``grads``: (params after each
    update, the final state)."""
    import optax
    from rgqa_tpu.config import OptimConfig as JaxOptimConfig
    from rgqa_tpu.train.optimizer import make_optimizer as jax_make_optimizer

    tx = jax_make_optimizer(JaxOptimConfig(name=cfg.name, lr=cfg.lr, bf16_moments=cfg.bf16_moments),
                            N_UPDATES)
    params = dict(init)
    state = tx.init(params)
    trail = []
    for g in grads:
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
        trail.append({k: np.asarray(v) for k, v in params.items()})
    return trail, state


def _port_run(init, grads, opt_factory):
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = opt_factory(list(params.values()))
    trail = []
    for g in grads:
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        trail.append({k: p.detach().numpy().copy() for k, p in params.items()})
    return trail, opt, params


@pytest.mark.parametrize("scale", [1.0, 1e-5], ids=["unit", "small_nu"])
@pytest.mark.parametrize("name", NAMES)
def test_each_optim_matches_jax_over_10_updates(jax, name, scale):
    init, grads = _sequence(scale)
    cfg = OptimConfig(name=name, lr=1e-2)
    want, _ = _jax_run(init, grads, cfg)
    got, opt, _ = _port_run(init, grads, lambda ps: optimizer.make_optimizer(cfg, ps, t_total=N_UPDATES))
    for i, (g, w) in enumerate(zip(got, want)):
        for k in SHAPES:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-6, atol=1e-7, err_msg=f"{name} update {i + 1} {k}")
    moved = max(float(np.abs(got[-1][k] - init[k]).max()) for k in SHAPES)
    assert moved > 0, moved  # every rule moves the parameters
    kind = {"adam": optimizer.OptaxAdam, "adamw": optimizer.OptaxAdam, "adamax": torch.optim.Adamax,
            "sgd": torch.optim.SGD, "rms": optimizer.OptaxRMSprop, "bert": optimizer.BertAdam}[name]
    assert type(opt) is kind


def test_torch_rmsprop_is_not_optax_rmsprop_where_nu_is_small(jax):
    # Why --optim rms is written out: at optax's lr and eps, but with
    # torch's decay and eps placement, the trajectory leaves the bar.
    init, grads = _sequence(1e-5)
    want, _ = _jax_run(init, grads, OptimConfig(name="rms", lr=1e-2))
    got, _, _ = _port_run(init, grads, lambda ps: torch.optim.RMSprop(ps, lr=1e-2, eps=1e-8))
    gap = max(float(np.abs(got[-1][k] - want[-1][k]).max() / np.abs(want[-1][k]).max()) for k in SHAPES)
    assert gap > 1e-3, gap


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    ax = np.maximum(np.abs(x.astype(np.float32)), np.float32(np.finfo(np.float32).tiny))
    return np.exp2(np.floor(np.log2(ax)) - 7).astype(np.float32)


@pytest.mark.parametrize("scale", [1.0, 1e-5], ids=["unit", "small_nu"])
def test_bf16_moments_match_jax(jax, scale):
    init, grads = _sequence(scale, seed=1)
    cfg = OptimConfig(lr=1e-2, bf16_moments=True)
    want, jstate = _jax_run(init, grads, cfg)
    got, opt, params = _port_run(init, grads, lambda ps: optimizer.make_optimizer(cfg, ps, t_total=N_UPDATES))
    for i, (g, w) in enumerate(zip(got, want)):
        for k in SHAPES:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-6, atol=1e-7, err_msg=f"update {i + 1} {k}")
    for moment in ("mu", "nu"):
        jm = getattr(jstate, moment)
        for k, p in params.items():
            m = opt.state[p][moment]
            assert m.dtype == torch.bfloat16
            w = np.asarray(jm[k]).astype(np.float32)
            assert np.asarray(jm[k]).dtype.name == "bfloat16"
            gap = np.abs(m.float().numpy() - w)
            assert (gap <= _bf16_ulp(w)).all(), (moment, k, float(gap.max()))
    assert opt.param_groups[0]["count"] == N_UPDATES == int(jstate.count)


def test_make_optimizer_refuses_an_unknown_name():
    with pytest.raises(ValueError, match="unknown optimizer 'lamb'"):
        optimizer.make_optimizer(OptimConfig(name="lamb"), [torch.nn.Parameter(torch.zeros(2))])


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("optim") / "gqa")
    make_synthetic_gqa(path, SyntheticSpec(**dict(SPEC, n_train=32)))
    return path


@pytest.mark.parametrize("name, bf16", [(n, False) for n in NAMES[:-1]] + [("bert", True)])
def test_resume_restores_each_optimizer(root, tmp_path, name, bf16):
    import dataclasses

    def runner(out, epochs):
        cfg = _cfg(root, str(tmp_path / out))
        # BertAdam at a constant rate: its warmup schedule spans the run.
        optim = OptimConfig(name=name, lr=3e-3, bf16_moments=bf16, schedule="warmup_constant", warmup=0.0)
        train = dataclasses.replace(cfg.train, epochs=epochs, optim=optim)
        return GQARunner(dataclasses.replace(cfg, train=train), device="cpu")

    whole = runner("whole", 2).train()
    runner("parts", 1).train()
    resumed = runner("parts", 1)
    state = torch.load(str(tmp_path / "parts" / "LAST.state.pt"), weights_only=True)
    history = resumed.train(resume="LAST")
    np.testing.assert_allclose(history["loss"][0], whole["loss"][1], rtol=1e-6)
    moments = [v for s in state["optimizer"]["state"].values() for v in s.values()
               if isinstance(v, torch.Tensor) and v.dim() > 0]
    assert bool(moments) == (name != "sgd")  # plain SGD keeps no state
    assert all(m.dtype == (torch.bfloat16 if bf16 else torch.float32) for m in moments)
