"""Port parity: slice 2's training pieces against the JAX package.

The same numpy inputs go through the JAX function and its counterpart in
the port:

- ``bce_answer_loss`` (rtol 1e-6), the schedules, ``BertAdam`` over 12
  updates with warmup, including the zero update of step 1 (rtol 1e-6:
  f32 rounding of the same formulas), ``global_norm_clip`` and
  ``rp_augment`` (exact, given the JAX key chain's shift);
- the bf16-compute model with f32 master weights against flax's
  ``dtype=bfloat16`` model on the same f32 params (logits within 5e-2:
  both round every product to bf16, in different orders);
- the 12-step trajectory: a tiny ``LxmertForGQA`` in f32 with dropout 0
  and RP pairing, the JAX ``make_train_step`` on its params and the
  port's step on ``from_jax_params`` of the same params, on the same 12
  batches with the shift of each step taken from the JAX key chain:
  losses within rtol 1e-4 (``tests/test_train.py``'s bar), final params
  within atol 1e-4.

And the hidden-dropout contract of ``cheap_dropout``, which has no JAX
counterpart to compare bits with.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from rgqa_tpu_torch.checkpoint.convert import from_jax_params
from rgqa_tpu_torch.config import EncoderConfig, ModelConfig, OptimConfig
from rgqa_tpu_torch.models.zoo import build_model, example_batch
from rgqa_tpu_torch.ops.dropout import DropoutRng, HiddenDropout, cheap_dropout
from rgqa_tpu_torch.train import losses, optimizer, step as tstep
from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

N_STEPS = 12


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


def _cfg(dropout=0.0, num_answers=7):
    enc = EncoderConfig(
        hidden_size=32, num_heads=4, intermediate_size=64, vocab_size=128,
        l_layers=1, x_layers=1, r_layers=1, num_objects=10, visual_feat_dim=48,
        hidden_dropout=dropout, attention_dropout=dropout,
    )
    return ModelConfig(backbone="lxmert", encoder=enc, num_answers=num_answers, max_text_len=12)


def _train_batch(cfg, b, seed):
    batch = example_batch(cfg, b, seed=seed)
    rng = np.random.default_rng(seed + 100)
    lengths = rng.integers(4, cfg.max_text_len + 1, b)
    pad = np.arange(cfg.max_text_len)[None, :] >= lengths[:, None]
    batch["input_ids"][pad] = 0
    batch["input_mask"][pad] = 0
    target = np.zeros((b, cfg.num_answers), np.float32)
    target[np.arange(b), rng.integers(0, cfg.num_answers, b)] = rng.random(b, dtype=np.float32)
    batch["target"] = target
    batch["id_mask"] = (rng.random(b) > 0.3).astype(np.float32)
    return batch


def _tensors(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Pieces.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_bce_answer_loss_matches_jax(jax, seed):
    from rgqa_tpu.train import losses as jlosses

    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((9, 23), dtype=np.float32) * 4
    targets = (rng.random((9, 23)) > 0.8).astype(np.float32) * rng.random((9, 23), dtype=np.float32)
    mask = (rng.random(9) > 0.5).astype(np.float32)
    for row_mask in (None, mask):
        want = jlosses.bce_answer_loss(logits, targets, row_mask)
        got = losses.bce_answer_loss(
            torch.from_numpy(logits), torch.from_numpy(targets),
            None if row_mask is None else torch.from_numpy(row_mask),
        )
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(
        losses.optax_sigmoid_bce(torch.from_numpy(logits), torch.from_numpy(targets)).numpy(),
        np.asarray(jlosses.optax_sigmoid_bce(logits, targets)), rtol=1e-6, atol=1e-7,
    )


@pytest.mark.parametrize("name", ["warmup_linear", "warmup_constant", "warmup_cosine"])
def test_schedules_match_jax(jax, name):
    from rgqa_tpu.train import optimizer as jopt

    for warmup in (0.1, 0.0, 0.002):
        for x in np.linspace(0.0, 1.2, 49, dtype=np.float32):
            want = float(getattr(jopt, name)(x, warmup))
            np.testing.assert_allclose(float(getattr(optimizer, name)(x, warmup)), want, rtol=1e-6)


def test_bert_adam_matches_jax_over_12_updates(jax):
    import optax

    from rgqa_tpu.train.optimizer import bert_adam

    rng = np.random.default_rng(0)
    shapes = {"w": (5, 7), "b": (7,), "ln": (3,)}
    init = {k: rng.standard_normal(s, dtype=np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s, dtype=np.float32) for k, s in shapes.items()}
             for _ in range(N_STEPS)]
    lr = 1e-2

    tx = bert_adam(lr, warmup=0.1, t_total=N_STEPS)
    jparams = dict(init)
    jstate = tx.init(jparams)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = optimizer.make_optimizer(OptimConfig(lr=lr), list(params.values()), t_total=N_STEPS)
    for i, g in enumerate(grads):
        updates, jstate = tx.update(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"step {i + 1} {k}")
            if i == 0:  # lr 0 under warmup: the first update is zero
                np.testing.assert_array_equal(p.detach().numpy(), init[k])
    assert opt.param_groups[0]["count"] == N_STEPS == int(jstate.count)


def test_make_optimizer_refuses_what_is_not_ported():
    # Every --optim of the JAX package is ported (tests/test_torch_optim.py
    # holds each to optax); an unknown name still raises, naming it.
    params = [torch.nn.Parameter(torch.zeros(2))]
    with pytest.raises(ValueError, match="unknown optimizer 'adagrad'"):
        optimizer.make_optimizer(OptimConfig(name="adagrad"), params)
    assert isinstance(optimizer.make_optimizer(OptimConfig(name="adam"), params), optimizer.OptaxAdam)
    opt = optimizer.make_optimizer(OptimConfig(bf16_moments=True), params)
    params[0].grad = torch.ones(2)
    opt.step()
    assert opt.state[params[0]]["mu"].dtype == torch.bfloat16


@pytest.mark.parametrize("scale", [0.01, 100.0])  # under and over the 5.0 clip
def test_global_norm_clip_matches_jax(jax, scale):
    from rgqa_tpu.train.step import global_norm_clip

    rng = np.random.default_rng(1)
    grads = {k: rng.standard_normal(s, dtype=np.float32) * scale for k, s in
             {"a": (4, 6), "b": (6,), "c": (2, 3, 5)}.items()}
    want = global_norm_clip(grads, 5.0)
    params = {k: torch.nn.Parameter(torch.zeros(v.shape)) for k, v in grads.items()}
    for k, p in params.items():
        p.grad = torch.from_numpy(grads[k].copy())
    tstep.global_norm_clip(list(params.values()), 5.0)
    for k, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-8)


def test_rp_augment_matches_jax(jax):
    from rgqa_tpu.train.step import rp_augment as jax_rp_augment

    batch = _train_batch(_cfg(), 6, seed=3)
    key = jax.random.PRNGKey(5)
    want = jax_rp_augment({k: jax.numpy.asarray(v) for k, v in batch.items()}, key)
    shift = int(jax.random.randint(key, (), 1, 6))
    got = tstep.rp_augment(_tensors(batch), shift)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_rp_augment_matches_jax_on_a_vilt_u8_batch(jax):
    # The u8 wire's four pixel fields pair with the rolled text like the
    # RoI fields: each image stays in its row.
    from rgqa_tpu.train.step import rp_augment as jax_rp_augment

    cfg = ModelConfig(backbone="vilt", encoder=_cfg().encoder, num_answers=7, max_text_len=6,
                      vilt_patch_size=16, vilt_image_size=64)
    batch = example_batch(cfg, 6, seed=2, pixel_wire="u8")
    batch["target"] = np.random.default_rng(2).random((6, 7), dtype=np.float32)
    batch["id_mask"] = np.ones(6, np.float32)
    key = jax.random.PRNGKey(8)
    want = jax_rp_augment({k: jax.numpy.asarray(v) for k, v in batch.items()}, key)
    shift = int(jax.random.randint(key, (), 1, 6))
    got = tstep.rp_augment(_tensors(batch), shift)
    assert got.keys() == want.keys() >= {"pixels_u8", "pixel_rect", "pixel_mask"}
    for k in want:
        assert got[k].shape[0] == 12, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_bf16_compute_with_f32_masters_matches_flax(jax):
    from rgqa_tpu.models.zoo import build_model as jax_build_model

    cfg = _cfg()
    batch = _train_batch(cfg, 5, seed=1)
    jmodel, jforward = jax_build_model(cfg, use_bf16=True)
    args = [batch[k] for k in ("input_ids", "input_mask", "segment_ids", "feats", "boxes")]
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0), *args)["params"])
    want = jforward(params, batch, deterministic=True)

    model, forward = build_model(cfg, use_bf16=True, device="cpu", train=True)
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    model.load_state_dict(from_jax_params(params), strict=True)
    model.eval()
    with torch.no_grad():
        got = forward(_tensors(batch))
    assert got["logits"].dtype == torch.bfloat16
    for key in ("logits", "pooled"):
        np.testing.assert_allclose(
            got[key].float().numpy(), np.asarray(want[key], np.float32), atol=5e-2, err_msg=key
        )


# ---------------------------------------------------------------------------
# The 12-step trajectory.
# ---------------------------------------------------------------------------


def test_twelve_step_rp_trajectory_matches_jax(jax):
    from rgqa_tpu.config import OptimConfig as JaxOptimConfig
    from rgqa_tpu.models.zoo import build_model as jax_build_model
    from rgqa_tpu.train import create_train_state, make_optimizer as jax_make_optimizer
    from rgqa_tpu.train import make_train_step as jax_make_train_step

    cfg, b, lr = _cfg(), 6, 2e-3
    batches = [_train_batch(cfg, b, seed=i) for i in range(N_STEPS)]
    jmodel, jforward = jax_build_model(cfg)
    args = [batches[0][k] for k in ("input_ids", "input_mask", "segment_ids", "feats", "boxes")]
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0), *args)["params"])

    state = create_train_state(params, jax_make_optimizer(JaxOptimConfig(lr=lr), N_STEPS))
    jstep = jax_make_train_step(jforward, sample_pair=True, grad_clip=5.0, donate=False)
    key = jax.random.PRNGKey(0)
    jax_losses, shifts = [], []
    for batch in batches:
        key, sub = jax.random.split(key)
        _, aug = jax.random.split(sub)
        shifts.append(int(jax.random.randint(aug, (), 1, b)))
        state, aux = jstep(state, {k: jax.numpy.asarray(v) for k, v in batch.items()}, sub)
        jax_losses.append(float(aux["loss"]))

    model, forward = build_model(cfg, device="cpu", train=True)
    model.load_state_dict(from_jax_params(params), strict=True)
    opt = optimizer.make_optimizer(OptimConfig(lr=lr), model.parameters(), t_total=N_STEPS)
    step = tstep.make_train_step(forward, opt, sample_pair=True, grad_clip=5.0, rng=DropoutRng())
    port_losses = [step(_tensors(batch), shift=s)["loss"].item() for batch, s in zip(batches, shifts)]

    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-4)
    assert port_losses[0] != port_losses[-1]  # the weights moved
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, state.params))
    got = model.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-4, err_msg=k)


def test_train_step_output_and_plain_switch():
    cfg = _cfg(dropout=0.1)
    model, forward = build_model(cfg, device="cpu", train=True)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batch = _tensors(_train_batch(cfg, 4, seed=9))
    outs = []
    for use_fused in (None, False):  # on the CPU both run the plain versions
        model.load_state_dict(init)
        opt = optimizer.make_optimizer(OptimConfig(lr=1e-3), model.parameters(), t_total=3)
        rng = DropoutRng(device=torch.Generator().manual_seed(3), host=torch.Generator().manual_seed(4))
        step = tstep.make_train_step(forward, opt, sample_pair=True, rng=rng, use_fused=use_fused)
        outs.append([step(batch) for _ in range(3)])
    for a, b in zip(*outs):
        assert a["score"].shape == a["label"].shape == (8,)  # RP doubles the rows
        torch.testing.assert_close(a["loss"], b["loss"], rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_train_step_launches_the_kernels_on_card(dropout):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from rgqa_tpu_torch.ops import attention as att

    cfg = _cfg(dropout=dropout)
    model, forward = build_model(cfg, use_bf16=True, device="cuda", train=True)
    opt = optimizer.make_optimizer(OptimConfig(lr=1e-3), model.parameters(), t_total=2)
    step = tstep.make_train_step(forward, opt, sample_pair=True, rng=DropoutRng())
    batch = {k: v.cuda() for k, v in _tensors(_train_batch(cfg, 4, seed=2)).items()}
    wrappers = (att.fused_attention_cuda, att.fused_attention_bwd_cuda,
                att.fused_attention_dropout_cuda, att.fused_attention_dropout_bwd_cuda)
    before = [w.launches for w in wrappers]
    out = step(batch)
    torch.cuda.synchronize()
    # 1/1/1 layers: 6 attention calls; the last cross layer's vision stream
    # (2 calls) does not reach the loss, so 4 backward launches.
    counts = [w.launches - b for w, b in zip(wrappers, before)]
    assert counts == ([6, 4, 0, 0] if dropout == 0.0 else [0, 0, 6, 4])
    assert torch.isfinite(out["loss"])


# ---------------------------------------------------------------------------
# Hidden dropout: the contract.
# ---------------------------------------------------------------------------


def test_cheap_dropout_contract():
    x = torch.randn(200, 300, generator=torch.Generator().manual_seed(0))
    assert cheap_dropout(x, 0.0) is x
    assert cheap_dropout(x, 0.001) is x  # rounds to t = 0
    assert torch.equal(cheap_dropout(x, 1.0), torch.zeros_like(x))
    assert torch.equal(cheap_dropout(x, 255.6 / 256), torch.zeros_like(x))  # t = 256
    for rate in (0.1, 0.5):
        t = round(rate * 256)
        keep_p = (256 - t) / 256
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            out = cheap_dropout(xd, rate, torch.Generator().manual_seed(1))
            kept = out != 0
            assert torch.equal(out[kept], (xd * (256 / (256 - t)))[kept])
            sigma = math.sqrt(keep_p * (1 - keep_p) / x.numel())
            assert abs(kept.float().mean().item() - keep_p) < 5 * sigma
        a = cheap_dropout(x, rate, torch.Generator().manual_seed(7))
        b = cheap_dropout(x, rate, torch.Generator().manual_seed(7))
        c = cheap_dropout(x, rate, torch.Generator().manual_seed(8))
        assert torch.equal(a, b) and not torch.equal(a, c)


def test_hidden_dropout_module_follows_training_mode():
    x = torch.randn(64, 64)
    drop = HiddenDropout(0.5)
    assert drop.eval()(x) is x
    assert HiddenDropout(0.0).train()(x) is x
    rng = DropoutRng(device=torch.Generator().manual_seed(2))
    out = drop.train()(x, rng)
    assert 0 < (out == 0).float().mean().item() < 1


def test_dropout_rng_draws_on_the_host_and_round_trips():
    rng = DropoutRng(device=torch.Generator().manual_seed(0), host=torch.Generator().manual_seed(1))
    state = rng.state()
    draws = [rng.seed(), rng.shift(6), rng.seed()]
    assert all(isinstance(d, int) for d in draws) and 1 <= draws[1] <= 5
    assert 0 <= draws[0] < 2**63
    rng.load_state(state)
    assert [rng.seed(), rng.shift(6), rng.seed()] == draws


def test_runner_config_gate_names_unported_training_flags(tmp_path):
    from rgqa_tpu_torch.config import parse_cli
    from rgqa_tpu_torch.runner import GQARunner

    # What stays unported (tests/test_torch_train_strategies.py runs the
    # strategies, optimizers and initialisations this gate once named).
    orbax = tmp_path / "orbax_snapshot"
    orbax.mkdir()
    for flags, match in [
        (["--strategy", "adv", "--backbone", "vilt"], "--strategy adv on --backbone vilt"),
        (["--strategy", "poem", "--backbone", "caps"], "--strategy poem on --backbone caps"),
        (["--train_chunk", "2"], "--train_chunk"),
        (["--loadLXMERT", str(orbax)], "--loadLXMERT an orbax"),
        (["--loadLXMERTQA", str(orbax)], "--loadLXMERTQA an orbax"),
        (["--strategy", "distill_online", "--teacher_path", str(orbax)], "--teacher_path an orbax"),
    ]:
        cfg, _ = parse_cli(["--synthetic", "--data_root", str(tmp_path), *flags])
        with pytest.raises(NotImplementedError, match=match):
            GQARunner(cfg, device="cpu")
    # The same training flags do not stop an evaluation runner.
    cfg, _ = parse_cli(["--synthetic", "--data_root", str(tmp_path / "gqa"), "--mceLoss",
                        "--chart", "--output", str(tmp_path / "out"), "--llayers", "1",
                        "--xlayers", "1", "--rlayers", "1", "--hidden_size", "32",
                        "--num_heads", "4"])
    runner = GQARunner(cfg, init_train=False, device="cpu")
    assert runner.train_set is None and runner.cfg.train.chart
