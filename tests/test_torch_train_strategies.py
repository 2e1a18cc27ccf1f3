"""Port parity: the train CLI's remaining strategies against the JAX
package, on the CPU.

Each step goes through the JAX function and its counterpart in the port
with the same weights (a tiny ``LxmertForGQA`` in f32 at dropout 0, the
JAX init converted by ``from_jax_params``), the same batches and, where
JAX draws, the JAX key chain's draws handed to the port (as
``tests/test_torch_strategies.py`` does):

- VILLA (``--strategy adv``): ``normalize_step`` / ``project`` against
  the JAX ``_normalize_step`` / ``_project`` (l2 and linf, ``max_norm``
  0 and > 0; rtol 1e-6), and a 6-step loss trajectory of
  ``make_adv_train_step`` (three inner passes, the projection active) at
  rtol 1e-4 (``tests/test_train.py``'s bar);
- the dual-loader min-max (``resampling`` / ``poem``, weighted, and
  ``woods``): per step ``loss_pos``, ``loss_neg`` and the weight
  gradients against JAX ``make_minmax_step`` over 5 steps with the
  weights updated on both sides (rtol 1e-4), WOODS's zero gradient, the
  sampling weights and ``sample_negative_indices``' draws (equal);
- ``distill_online``: ``blend_targets`` against the formula, and a 6-step
  trajectory against JAX ``make_online_distill_step`` given JAX's mixup
  draws (rtol 1e-4);
- ``weighted_rp_loss`` (``--strategy weight``): a 6-step trajectory
  against JAX ``make_train_step(weighted_rp=True)`` (rtol 1e-4), the
  caption-overlap similarity and the CLIP similarity (a tiny HF CLIP
  checkpoint, the root's CLIP pixel pack) against the JAX scorer's
  embeddings;
- the runner: ``resampling`` and ``weight`` two-epoch
  histories against the JAX runner's from the same ``.pth`` (rtol 1e-4;
  the same shuffle and negative draws and roll shifts from one numpy
  generator), and the train CLI with the flags of each of
  ``scripts/lxmert/train/{adv,resampling,poem,woods,distill_online,weight}.sh``
  at tiny width (finite losses, a ``LAST.pth`` that loads back whole),
  and ``resampling`` on UNITER, ViLT and BUTD (where JAX ``train_minmax``
  runs); the refusals that stay.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import torch

from rgqa_tpu_torch.checkpoint.convert import from_jax_params, load_reference_pth, to_reference_state_dict
from rgqa_tpu_torch.config import EncoderConfig, ModelConfig, OptimConfig, parse_cli
from rgqa_tpu_torch.data.synthetic import SyntheticSpec, make_synthetic_gqa
from rgqa_tpu_torch.models.zoo import build_model
from rgqa_tpu_torch.ops.dropout import DropoutRng
from rgqa_tpu_torch.runner import GQARunner
from rgqa_tpu_torch.train import adversarial, dual_loader, online_distill, optimizer, step as tstep
from test_torch_slice import ENC, SPEC, _cfg
from test_torch_strategies import _batch_dims, _encoded, _jax_draws, _jnp, _tensors
from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

N_STEPS = 6
B = 6
LR = 2e-3
ENC0 = dict(ENC, hidden_dropout=0.0, attention_dropout=0.0)


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("train_strategies") / "gqa")
    make_synthetic_gqa(path, SyntheticSpec(**SPEC))
    return path


def _model_cfg(answers):
    return ModelConfig(backbone="lxmert", encoder=EncoderConfig(**ENC0), num_answers=answers, max_text_len=12)


def _jax_init(jax, cfg, batch, seed=0):
    """(JAX forward, numpy params) of a tiny LxmertForGQA from ``seed``."""
    from rgqa_tpu.models.zoo import build_model as jax_build_model

    jmodel, jforward = jax_build_model(cfg)
    args = [batch[k] for k in ("input_ids", "input_mask", "segment_ids", "feats", "boxes")]
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(seed), *args)["params"])
    return jforward, params


def _jax_state(params):
    from rgqa_tpu.config import OptimConfig as JaxOptimConfig
    from rgqa_tpu.train import create_train_state, make_optimizer as jax_make_optimizer

    return create_train_state(params, jax_make_optimizer(JaxOptimConfig(lr=LR), N_STEPS))


def _port_model(cfg, params):
    model, forward = build_model(cfg, device="cpu", train=True)
    model.load_state_dict(from_jax_params(params), strict=True)
    opt = optimizer.make_optimizer(OptimConfig(lr=LR), model.parameters(), t_total=N_STEPS)
    return model, forward, opt


def _batches(enc, n=N_STEPS, seed=7):
    rng = np.random.default_rng(seed)
    return [enc.gather_batch(rng.choice(len(enc), B, replace=False), with_target=True) for _ in range(n)]


# ---------------------------------------------------------------------------
# VILLA.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm_type", ["l2", "linf"])
@pytest.mark.parametrize("max_norm", [0.0, 0.3])
def test_normalize_and_project_match_jax(jax, norm_type, max_norm):
    from rgqa_tpu.train.adversarial import _normalize_step, _project

    rng = np.random.default_rng(3)
    grad = rng.standard_normal((4, 5, 6), dtype=np.float32)
    delta = rng.standard_normal((4, 5, 6), dtype=np.float32)
    grad[1] = 0.0  # a row with no gradient: the 1e-8 floor
    np.testing.assert_allclose(adversarial.normalize_step(torch.from_numpy(grad), 0.05, norm_type).numpy(),
                               np.asarray(_normalize_step(grad, 0.05, norm_type)), rtol=1e-6, atol=0)
    got = adversarial.project(torch.from_numpy(delta), max_norm, norm_type).numpy()
    np.testing.assert_allclose(got, np.asarray(_project(delta, max_norm, norm_type)), rtol=1e-6, atol=0)
    if max_norm:  # the projection bites on these draws
        assert not np.array_equal(got, delta)


ADV_CASES = {
    "l2": dict(lr_txt=0.1, lr_img=0.1, max_norm=0.0, norm_type="l2"),
    "l2_projected": dict(lr_txt=0.1, lr_img=0.1, max_norm=0.05, norm_type="l2"),
    "linf_projected": dict(lr_txt=0.01, lr_img=0.01, max_norm=0.005, norm_type="linf"),
}


@pytest.mark.parametrize("case", list(ADV_CASES))
def test_adv_trajectory_matches_jax(jax, root, case):
    from rgqa_tpu.train.adversarial import AdvConfig as JaxAdvConfig
    from rgqa_tpu.train.adversarial import make_adv_train_step as jax_adv_step

    enc = _encoded(root)
    cfg = _model_cfg(enc.num_answers - 1)
    batches = _batches(enc)
    jforward, params = _jax_init(jax, cfg, batches[0])
    kw = dict(steps=3, kl_weight=1.5, **ADV_CASES[case])
    shape_of = lambda b: (*b["input_ids"].shape, ENC["hidden_size"])  # noqa: E731
    jstep = jax_adv_step(jforward, shape_of, JaxAdvConfig(**kw), grad_clip=5.0, donate=False)
    state, key, want = _jax_state(params), jax.random.PRNGKey(0), []
    for batch in batches:
        key, sub = jax.random.split(key)
        state, aux = jstep(state, _jnp(jax, batch), sub)
        want.append(float(aux["loss"]))

    _, forward, opt = _port_model(cfg, params)
    step = adversarial.make_adv_train_step(forward, opt, shape_of, adversarial.AdvConfig(**kw), grad_clip=5.0,
                                           rng=DropoutRng())
    got = [step(_tensors(batch))["loss"].item() for batch in batches]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[0] != got[-1]


def test_adv_clean_forward_draws_no_dropout_mask(root):
    # Dropout on: the clean forward runs in eval mode (no draw from the
    # host generator); each inner pass draws its masks.
    enc = _encoded(root)
    cfg = dataclasses.replace(_model_cfg(enc.num_answers - 1), encoder=EncoderConfig(**ENC))
    model, forward = build_model(cfg, device="cpu", train=True)
    opt = optimizer.make_optimizer(OptimConfig(lr=LR), model.parameters(), t_total=2)
    calls = []
    rng = DropoutRng(device=torch.Generator().manual_seed(0), host=torch.Generator().manual_seed(0))
    seed = rng.seed
    rng.seed = lambda: calls.append(model.training) or seed()
    batch = _tensors(_batches(enc, 1)[0])
    wrapped = lambda b, **kw: calls.append(("forward", kw.get("deterministic"))) or forward(b, **kw)  # noqa: E731
    step = adversarial.make_adv_train_step(wrapped, opt, lambda b: (*b["input_ids"].shape, ENC["hidden_size"]),
                                           adversarial.AdvConfig(steps=2), rng=rng)
    out = step(batch)
    forwards = [c for c in calls if isinstance(c, tuple)]
    assert forwards == [("forward", True), ("forward", False), ("forward", False)]
    first_inner = calls.index(("forward", False))
    assert not any(c is True or c is False for c in calls[:first_inner])  # no mask before the inner passes
    assert any(c is True for c in calls[first_inner:])
    assert torch.isfinite(out["loss"]) and model.training


# ---------------------------------------------------------------------------
# The dual-loader min-max.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weighted", [True, False], ids=["resampling", "woods"])
def test_minmax_steps_match_jax(jax, root, weighted):
    from rgqa_tpu.train.dual_loader import NegativeWeights as JaxWeights
    from rgqa_tpu.train.dual_loader import make_minmax_step as jax_minmax_step
    from rgqa_tpu.train.dual_loader import sample_negative_indices as jax_sample

    pos_enc, neg_enc = _encoded(root, "train"), _encoded(root, "train,train_uq")
    cfg = _model_cfg(pos_enc.num_answers - 1)
    pos_batches = _batches(pos_enc, 5)
    jforward, params = _jax_init(jax, cfg, pos_batches[0])
    jstep = jax_minmax_step(jforward, weighted=weighted, grad_clip=5.0, donate=False)
    _, forward, opt = _port_model(cfg, params)
    step = dual_loader.make_minmax_step(forward, opt, weighted=weighted, grad_clip=5.0, rng=DropoutRng())
    jw, pw = JaxWeights(len(neg_enc), 0.5), dual_loader.NegativeWeights(len(neg_enc), 0.5)
    state, key = _jax_state(params), jax.random.PRNGKey(0)
    jrng, prng = np.random.default_rng(4), np.random.default_rng(4)
    for i, pos in enumerate(pos_batches):
        jsw, psw = jw.sampling_weights(), pw.sampling_weights()
        np.testing.assert_allclose(psw, jsw, rtol=1e-6, err_msg=f"sampling weights {i}")
        wids = jax_sample(jrng, jsw, B)
        np.testing.assert_array_equal(dual_loader.sample_negative_indices(prng, jsw, B), wids)
        neg = neg_enc.gather_batch(wids, with_target=True)
        key, sub = jax.random.split(key)
        state, jg, jaux = jstep(state, jw.values, _jnp(jax, pos), _jnp(jax, neg), jax.numpy.asarray(wids), sub)
        pg, paux = step(pw.values, _tensors(pos), _tensors(neg), torch.from_numpy(wids))
        for name in ("loss_pos", "loss_neg", "loss"):
            np.testing.assert_allclose(paux[name].item(), float(jaux[name]), rtol=1e-4, err_msg=f"{name} {i}")
        if weighted:
            np.testing.assert_allclose(pg.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-9, err_msg=f"w grads {i}")
            assert float(pg.abs().max()) > 0
            jw.apply(jg)
            pw.apply(pg)
        else:
            assert not pg.any() and not np.asarray(jg).any()
    np.testing.assert_allclose(pw.values.numpy(), np.asarray(jw.values), rtol=1e-4, atol=1e-9)
    assert bool(pw.values.any()) == weighted


def test_softplus_is_jax_softplus(jax):
    x = np.array([-40.0, -3.0, -1e-3, 0.0, 0.5, 19.0, 21.0, 60.0], np.float32)
    np.testing.assert_allclose(dual_loader.softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(x)), rtol=1e-6)


# ---------------------------------------------------------------------------
# Online distillation.
# ---------------------------------------------------------------------------


def test_blend_targets_takes_the_teacher_on_out_of_domain_rows():
    rng = np.random.default_rng(0)
    target = np.zeros((5, 7), np.float32)
    target[0, 2] = 1.0  # in domain
    target[1, 3] = 0.6  # mass below 1: out of domain
    target[2, :2] = 0.5  # mass 1: in domain
    teacher = rng.standard_normal((5, 7)).astype(np.float32)
    got = online_distill.blend_targets(torch.from_numpy(target), torch.from_numpy(teacher), 0.3).numpy()
    soft = 1.0 / (1.0 + np.exp(-teacher))
    want = np.where((target.sum(-1) < 1.0)[:, None], 0.3 * soft + 0.7 * target, target)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_array_equal(got[[0, 2]], target[[0, 2]])


def test_distill_online_trajectory_matches_jax(jax, root):
    from rgqa_tpu.train.online_distill import make_online_distill_step as jax_distill_step

    enc = _encoded(root)
    cfg = _model_cfg(enc.num_answers - 1)
    batches = _batches(enc)
    jforward, params = _jax_init(jax, cfg, batches[0])
    _, teacher_params = _jax_init(jax, cfg, batches[0], seed=1)
    kw = dict(lam=0.5, mixup_mode="mixup_v1", mixup_alpha=1.0, mixup_beta=5.0)
    jstep = jax_distill_step(jforward, jforward, grad_clip=5.0, donate=False, **kw)
    state, key, want, draws = _jax_state(params), jax.random.PRNGKey(0), [], []
    for batch in batches:
        key, sub = jax.random.split(key)
        _, aug = jax.random.split(sub)
        draws.append(_jax_draws(jax, aug, "mixup_v1", *_batch_dims(batch), 1.0, 5.0))
        state, aux = jstep(state, teacher_params, _jnp(jax, batch), sub)
        want.append(float(aux["loss"]))

    _, forward, opt = _port_model(cfg, params)
    teacher, teacher_forward = build_model(cfg, device="cpu")
    teacher.load_state_dict(from_jax_params(teacher_params), strict=True)
    step = online_distill.make_online_distill_step(forward, teacher_forward, opt, grad_clip=5.0,
                                                   rng=DropoutRng(), **kw)
    got = [step(_tensors(batch), draws=d)["loss"].item() for batch, d in zip(batches, draws)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[0] != got[-1] and not teacher.training


# ---------------------------------------------------------------------------
# CLIP-weighted RP.
# ---------------------------------------------------------------------------


def test_weighted_rp_trajectory_matches_jax(jax, root):
    from rgqa_tpu.train import make_train_step as jax_make_train_step

    enc = _encoded(root)
    cfg = _model_cfg(enc.num_answers - 1)
    batches = _batches(enc)
    rng = np.random.default_rng(2)
    shifts = [int(rng.integers(1, B)) for _ in batches]
    weights = []
    for _ in batches:
        w = np.exp(rng.standard_normal(B).astype(np.float32))
        weights.append((w / w.sum()).astype(np.float32))
    jforward, params = _jax_init(jax, cfg, batches[0])
    jstep = jax_make_train_step(jforward, weighted_rp=True, grad_clip=5.0, donate=False)
    state, key, want = _jax_state(params), jax.random.PRNGKey(0), []
    for batch, shift, w in zip(batches, shifts, weights):
        key, sub = jax.random.split(key)
        jb = dict(_jnp(jax, batch), neg_shift=jax.numpy.asarray(shift, jax.numpy.int32),
                  neg_weights=jax.numpy.asarray(w))
        state, aux = jstep(state, jb, sub)
        want.append(float(aux["loss"]))

    _, forward, opt = _port_model(cfg, params)
    step = tstep.make_train_step(forward, opt, weighted_rp=True, grad_clip=5.0, rng=DropoutRng())
    got = [step(_tensors(b), shift=s, neg_weights=torch.from_numpy(w))["loss"].item()
           for b, s, w in zip(batches, shifts, weights)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[0] != got[-1]


@pytest.fixture(scope="module")
def runner_root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("train_strategies_runner") / "gqa")
    make_synthetic_gqa(path, SyntheticSpec(**dict(SPEC, n_train=24)))
    return path


@pytest.fixture(scope="module")
def init_pth(jax, runner_root, tmp_path_factory):
    """A tiny LXMERT ``.pth`` from a JAX runner's seeded init, which both
    runners load."""
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.runner import GQARunner as JaxRunner
    from rgqa_tpu.runner import np_params

    tmp = tmp_path_factory.mktemp("train_strategies_init")
    jax_runner = JaxRunner(_runner_cfg(runner_root, str(tmp / "init"), jax_config), init_train=False)
    pth = str(tmp / "init.pth")
    torch.save(to_reference_state_dict(from_jax_params(np_params(jax_runner.params)), l_layers=1, x_layers=1,
                                       r_layers=1), pth)
    return pth


def _runner_cfg(root, out, config=None, **train_kw):
    """``tests/test_torch_slice.py``'s tiny run at dropout 0, batch 8, two
    epochs, with ``train_kw``."""
    import rgqa_tpu_torch.config as port_config

    c = config or port_config
    cfg = _cfg(root, out, config)
    enc = c.EncoderConfig(**ENC0)
    data = dataclasses.replace(cfg.data, train_pos="train", train_neg="train,train_uq", valid_splits="valid")
    train = dataclasses.replace(cfg.train, batch_size=8, epochs=2, optim=c.OptimConfig(lr=3e-3), **train_kw)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, encoder=enc), data=data, train=train)


@pytest.mark.parametrize("strategy", ["resampling", "weight"])
def test_runner_history_matches_the_jax_runner(jax, runner_root, init_pth, tmp_path, strategy):
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.runner import GQARunner as JaxRunner

    jcfg = dataclasses.replace(_runner_cfg(runner_root, str(tmp_path / "jax"), jax_config, strategy=strategy),
                               load=init_pth)
    want = JaxRunner(jcfg).train()
    pcfg = dataclasses.replace(_runner_cfg(runner_root, str(tmp_path / "port"), strategy=strategy), load=init_pth)
    got = GQARunner(pcfg, device="cpu").train()
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["valid"], want["valid"], rtol=0, atol=1e-6)
    assert got["loss"][0] != got["loss"][1]
    with open(tmp_path / "port" / "log.log") as f:
        assert f.read().count("Train Loss") == 2


def test_caption_overlap_similarity_matches_the_jax_runner(jax, runner_root, init_pth, tmp_path):
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.runner import GQARunner as JaxRunner

    jcfg = dataclasses.replace(_runner_cfg(runner_root, str(tmp_path / "jax"), jax_config, strategy="weight"),
                               load=init_pth)
    pcfg = dataclasses.replace(_runner_cfg(runner_root, str(tmp_path / "port"), strategy="weight"), load=init_pth)
    jax_runner, runner = JaxRunner(jcfg), GQARunner(pcfg, device="cpu")
    qids = list(runner.train_set.question_ids[:8])
    neg = qids[-3:] + qids[:-3]
    got = runner._weight_similarity()(qids, neg)
    np.testing.assert_array_equal(got, jax_runner._weight_similarity()(qids, neg))
    assert got.dtype == np.float32 and got.any()


def test_clip_similarity_matches_the_jax_scorer(jax, runner_root, tmp_path):
    from rgqa_tpu.scorers.clip import ClipScorer as JaxClipScorer
    from rgqa_tpu_torch.data.images import PixelPack

    from test_torch_clip import write_clip_dir

    clip_dir = write_clip_dir(tmp_path / "clip")
    cfg = dataclasses.replace(_runner_cfg(runner_root, str(tmp_path / "port"), strategy="weight"))
    cfg = dataclasses.replace(cfg, ood=dataclasses.replace(cfg.ood, clip_path=clip_dir))
    runner = GQARunner(cfg, device="cpu")
    similarity = runner._weight_similarity()
    qids = list(runner.train_set.question_ids[:8])
    neg = qids[-3:] + qids[:-3]
    got = similarity(qids, neg)
    pack = PixelPack(os.path.join(runner_root, "pixels_clip_32"))
    ds = runner.dataset
    jscorer = JaxClipScorer(clip_dir, batch_size=8)
    img = jscorer.image_embeds([pack.load_u8(ds.id2datum[q]["img_id"])[0] for q in qids])
    txt = jscorer.text_embeds([ds.id2datum[q]["sent"] for q in neg])
    want = np.sum(np.asarray(img) * np.asarray(txt), -1) * jscorer.logit_scale
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert len(set(np.round(got, 4))) > 1
    np.testing.assert_array_equal(similarity(qids, neg), got)  # the cached embeddings give the same


# ---------------------------------------------------------------------------
# The train CLI with the scripts' flags.
# ---------------------------------------------------------------------------


TINY = ["--device", "cpu", "--fp32", "--llayers", "1", "--xlayers", "1", "--rlayers", "1", "--hidden_size", "32",
        "--num_heads", "4", "--batchSize", "16", "--epochs", "1"]
MINMAX_FLAGS = ["--train_pos", "GQAUQ_train_questions_unsup", "--train_neg", "GQAUQ_train_questions_unsup_hard",
                "--lr_w", "0.1"]
SCRIPTS = {
    "adv": ["--train", "GQAUQ_train_questions_unsup,GQAUQ_valid_questions_unsup", "--strategy", "adv",
            "--adv_steps", "3", "--adv_lr_txt", "1e-3", "--adv_lr_img", "1e-3", "--adv_kl_weight", "1.5"],
    "resampling": ["--strategy", "resampling", *MINMAX_FLAGS],
    "poem": ["--strategy", "poem", *MINMAX_FLAGS],
    "woods": ["--strategy", "woods", *MINMAX_FLAGS],
    "distill_online": ["--strategy", "distill_online", "--mixup_mode", "mixup_v1", "--lam", "0.5"],
    "weight": ["--train", "GQAUQ_train_questions_unsup,GQAUQ_valid_questions_unsup", "--strategy", "weight"],
}


@pytest.fixture(scope="module")
def cli_root(tmp_path_factory):
    """The CLI's synthetic root and a vanilla run's ``LAST.pth`` (the
    distillation teacher)."""
    from rgqa_tpu_torch.cli import train

    tmp = tmp_path_factory.mktemp("train_strategies_cli")
    root = str(tmp / "gqa")
    train.main(["--synthetic", "--data_root", root, "--output", str(tmp / "vanilla"), *TINY])
    return root, str(tmp / "vanilla" / "LAST")


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_train_cli_runs_each_script(cli_root, tmp_path, script, capsys):
    from rgqa_tpu_torch.cli import train

    root, teacher = cli_root
    out = str(tmp_path / script)
    argv = ["--synthetic", "--data_root", root, "--lr", "1e-5", "--output", out, *TINY, *SCRIPTS[script]]
    if script == "distill_online":
        argv += ["--teacher_path", teacher]  # the script's vanilla/BEST: <path>.pth is read
    history = train.main(argv)
    assert len(history["loss"]) == 1 and np.isfinite(history["loss"]).all()
    _, missing, unused = load_reference_pth(os.path.join(out, "LAST.pth"), l_layers=1, x_layers=1, r_layers=1)
    assert not missing and not unused
    if script == "weight":  # no CLIP here: the root's captions weight the pairs
        assert "UNIFORM" not in capsys.readouterr().err


BACKBONES = {
    "uniter": ["--backbone", "uniter", "--fp32", "--num_layers", "1", "--hidden_size", "32", "--num_heads", "4"],
    "vilt": ["--backbone", "vilt", "--fp32", "--num_layers", "1", "--hidden_size", "32", "--num_heads", "4",
             "--vilt_image_size", "64", "--vilt_patch_size", "16", "--no_randaug"],
    "butd": ["--backbone", "butd"],
}


@pytest.mark.parametrize("backbone", list(BACKBONES))
def test_minmax_cli_runs_where_the_jax_trainer_runs(cli_root, tmp_path, backbone):
    # JAX train_minmax runs on LXMERT, UNITER, ViLT and BUTD (and fails on
    # the caption matcher, which the port refuses by name).
    from rgqa_tpu_torch.cli import train

    root, _ = cli_root
    out = str(tmp_path / backbone)
    history = train.main(["--synthetic", "--data_root", root, "--output", out, "--device", "cpu", "--batchSize",
                          "16", "--epochs", "1", "--strategy", "resampling", *MINMAX_FLAGS, *BACKBONES[backbone]])
    assert len(history["loss"]) == 1 and np.isfinite(history["loss"]).all()
    assert os.path.isfile(os.path.join(out, "LAST.pth"))


def test_runner_refuses_what_stays_unported(cli_root, tmp_path):
    root, teacher = cli_root
    base = ["--synthetic", "--data_root", root, "--output", str(tmp_path / "o"), *TINY[2:]]
    orbax = tmp_path / "orbax_snapshot"
    orbax.mkdir()
    for flags, match in [
        (["--train_chunk", "2"], "--train_chunk"),
        (["--eval_chunk", "2"], "--eval_chunk"),
        (["--feed_int8"], "--feed_int8"),
        (["--strategy", "adv", "--backbone", "uniter"], "--strategy adv on --backbone uniter"),
        (["--strategy", "adv", "--backbone", "butd"], "--strategy adv on --backbone butd"),
        (["--strategy", "poem", "--backbone", "caps"], "--strategy poem on --backbone caps"),
        (["--strategy", "distill_online", "--teacher_path", str(orbax)], "--teacher_path an orbax"),
        (["--loadLXMERTQA", str(orbax)], "--loadLXMERTQA an orbax"),
        (["--loadLXMERT", str(orbax)], "--loadLXMERT an orbax"),
    ]:
        cfg, _ = parse_cli(base + flags)
        with pytest.raises(NotImplementedError, match=match):
            GQARunner(cfg, device="cpu")
    cfg, _ = parse_cli(base + ["--strategy", "woods", *MINMAX_FLAGS])
    with pytest.raises(NotImplementedError, match="resume under --strategy woods"):
        GQARunner(cfg, device="cpu").train(resume="LAST")
    cfg, _ = parse_cli(base + ["--strategy", "distill_online"])
    with pytest.raises(ValueError, match="needs --teacher_path"):
        GQARunner(cfg, device="cpu").train()


def test_update_weight_model_without_weight_warns(cli_root, tmp_path):
    root, _ = cli_root
    cfg, _ = parse_cli(["--synthetic", "--data_root", root, "--output", str(tmp_path / "o"), *TINY[2:],
                        "--update_weight_model"])
    runner = GQARunner(cfg, device="cpu")
    with pytest.warns(RuntimeWarning, match="CLIP weight model will NOT be trained"):
        runner.train()
