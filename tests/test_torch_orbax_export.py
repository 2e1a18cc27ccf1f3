"""The orbax-to-``.pth`` export (``orbax_to_pth.py``) against the JAX package.

For each kind of snapshot the JAX package writes, a JAX runner or its own
``save_checkpoint`` writes a tiny snapshot, ``orbax_to_pth.py`` exports
it, and the port's loader, or its CLI with ``--load`` / ``--loadLXMERT``
/ ``--clip_path`` / ``--teacher_path``, gives the JAX package's outputs
from the orbax directory (logits within 1e-4, confidences within 3e-5):

- GQA LXMERT, a JAX runner's train state (step 2, seeded moments) saved
  as ``LAST``: the port's evaluate CLI with ``--load <run>/LAST`` against the
  JAX runner that reads the orbax directory (the JAX evaluate CLI's
  path); ``--teacher_path <run>/LAST`` takes ``LAST.pth``;
- GQA UNITER, ViLT, BUTD and the caption matcher, an NLVR2 model and
  LXMERT's pretraining model (``<dir>_LXRT.pth``, which the match
  scorer's ``--loadLXMERT <dir>`` reads): forwards on the same batch;
- VQA from the JAX VQA runner's params: the minival score and dump of
  ``--load <dir>``;
- CLIP: ``clip_params/`` as the JAX ``--update_weight_model`` export
  writes it (``jax_params/`` and the HF files, no ``.bin``): the port's
  ``ClipScorer`` on the exported ``.bin`` against the JAX ``ClipScorer``,
  which reads ``jax_params/``; the adversary's train state
  (``LAST_clip``) as ``LAST_clip.pth``, which ``load_clip_state`` reads
  strictly, its Adam moments bit for bit;
- a GQA train state: the exported moments equal the optax state bit for
  bit in f32, and the first step after the port runner's resume
  (``GQARunner._train_state("LAST")``) equals the JAX package's first
  step after its own resume, on the same batch at dropout 0 (loss within
  rtol 1e-4, the step's update within 1e-3 of its size);
- an orbax directory without its export is still refused, by every flag,
  naming the command.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from rgqa_tpu_torch import config as port_config
from rgqa_tpu_torch.checkpoint.convert import from_jax_params, load_reference_pth
from rgqa_tpu_torch.data.synthetic import SyntheticSpec, make_synthetic_gqa
from rgqa_tpu_torch.models.zoo import build_model, load_pretraining
from rgqa_tpu_torch.runner import GQARunner

from test_torch_train import _tensors
from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import orbax_to_pth  # noqa: E402

SPEC = dict(n_images=6, n_train=16, n_valid=8, n_testdev=20, num_boxes=10, feat_dim=48, seed=5)
RUN_ENC = dict(hidden_size=32, num_heads=4, intermediate_size=64, l_layers=1, x_layers=1, r_layers=1,
               num_objects=10, visual_feat_dim=48, hidden_dropout=0.0, attention_dropout=0.0)
LOGIT_TOL, CONF_TOL = 1e-4, 3e-5
EPOCHS = 5  # the run's schedule: t_total = its steps per epoch x EPOCHS
# Tiny configurations of the other GQA backbones (the port's ModelConfig
# fields; the JAX package's are the same).
MODELS = {
    "uniter": dict(encoder=dict(hidden_size=32, num_heads=4, intermediate_size=64, vocab_size=200, num_layers=2,
                                num_objects=6, visual_feat_dim=40, visual_pos_dim=7),
                   num_answers=9, max_text_len=10),
    "vilt": dict(encoder=dict(hidden_size=32, num_heads=4, intermediate_size=64, vocab_size=256, num_layers=2),
                 num_answers=7, max_text_len=6, vilt_patch_size=16, vilt_image_size=64),
    "butd": dict(encoder=dict(num_objects=6, visual_feat_dim=40), num_answers=9, butd_vocab_size=50,
                 butd_embed_dim=16, butd_hidden_dim=24),
    "caps": dict(encoder=dict(hidden_size=32, num_heads=4, intermediate_size=64, vocab_size=200, num_layers=2),
                 num_answers=1, max_text_len=12),
}
LXMERT_ENC = dict(hidden_size=32, num_heads=4, intermediate_size=64, vocab_size=128, l_layers=1, x_layers=1,
                  r_layers=1, num_objects=10, visual_feat_dim=48)
INPUTS = ("input_ids", "input_mask", "segment_ids", "feats", "boxes")


@pytest.fixture(scope="module")
def jax():
    jax = pytest.importorskip("jax")
    pytest.importorskip("orbax.checkpoint")
    return jax


def _cfg(c, backbone, kw):
    kw = dict(kw)
    return c.ModelConfig(backbone=backbone, encoder=c.EncoderConfig(**kw.pop("encoder")), **kw)


def _save(jax, directory, name, params) -> str:
    from rgqa_tpu.checkpoint.orbax_io import save_checkpoint

    return save_checkpoint(str(directory), name, jax.tree_util.tree_map(np.asarray, params))


def _port_params(sd_path, backbone, **depths):
    sd, missing, unused = load_reference_pth(sd_path, backbone=backbone, **depths)
    assert not missing and not unused, (missing[:3], unused[:3])
    return sd


# ---------------------------------------------------------------------------
# GQA LXMERT from the JAX train CLI: --load, --teacher_path, the train state.
# ---------------------------------------------------------------------------


def _run_cfg(c, root, out, **kw):
    """The tiny GQA run's RunConfig, the port's or (``c``) the JAX package's."""
    return c.RunConfig(
        model=c.ModelConfig(backbone="lxmert", encoder=c.EncoderConfig(**RUN_ENC), max_text_len=12),
        train=c.TrainConfig(batch_size=8, use_bf16=False, seed=7, sample_pair=True, epochs=EPOCHS, dropout=0.0),
        ood=c.OODConfig(scorer="msp"),
        data=c.DataConfig(data_root=root, test_splits="testdev", synthetic=True),
        output=out, **kw)


@pytest.fixture(scope="module")
def jax_run(jax, tmp_path_factory):
    """A JAX GQA runner's train state (BertAdam, dropout 0) at step 2 with
    seeded moments, saved as the runner saves it (``LAST``, beside the
    runner's ``run_config.json``), and exported: (root, run dir, the JAX
    runner, the files written)."""
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.checkpoint.orbax_io import save_checkpoint
    from rgqa_tpu.runner import GQARunner as JaxRunner
    from rgqa_tpu.train import create_train_state, make_optimizer as jax_make_optimizer

    tmp = tmp_path_factory.mktemp("orbax_gqa")
    root, run = str(tmp / "gqa"), str(tmp / "run")
    make_synthetic_gqa(root, SyntheticSpec(**SPEC))
    jrunner = JaxRunner(_run_cfg(jax_config, root, run), init_train=False)
    state = create_train_state(jrunner.params, jax_make_optimizer(jrunner.cfg.train.optim, 1))
    rng = np.random.default_rng(0)
    moments = {
        "mu": jax.tree_util.tree_map(lambda p: (1e-3 * rng.standard_normal(p.shape)).astype(np.float32), state.params),
        "nu": jax.tree_util.tree_map(lambda p: rng.uniform(1e-6, 1e-4, p.shape).astype(np.float32), state.params),
    }
    opt_state = state.opt_state._replace(count=np.int32(2), **moments)
    state = state.replace(step=2, opt_state=opt_state)
    save_checkpoint(run, "LAST", state)
    written = orbax_to_pth.main([os.path.join(run, "LAST")])
    return root, run, jrunner, written


def test_gqa_snapshot_exports_beside_itself(jax_run):
    _, run, _, written = jax_run
    assert written == [os.path.join(run, "LAST.pth"), os.path.join(run, "LAST.state.pt")]
    keys = torch.load(os.path.join(run, "LAST.pth"), weights_only=True)
    assert "lxrt_encoder.model.bert.encoder.layer.0.attention.self.query.weight" in keys


def test_load_of_the_orbax_directory_scores_as_the_jax_runner(jax_run, tmp_path):
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.data.dataset import GQADataset as JaxDataset
    from rgqa_tpu.runner import GQARunner as JaxRunner

    from rgqa_tpu_torch.data.dataset import GQADataset

    root, run, _, _ = jax_run
    last = os.path.join(run, "LAST")
    # --load <run>/LAST: the JAX runner reads the orbax directory, the
    # port's its export.
    jrunner = JaxRunner(_run_cfg(jax_config, root, str(tmp_path / "jax"), load=last), init_train=False)
    want = jrunner.ood_evaluate(jrunner._encode(JaxDataset(root, "testdev", add_uq=True)),
                                dump=str(tmp_path / "jax.json"))
    runner = GQARunner(_run_cfg(port_config, root, str(tmp_path / "port"), load=last), init_train=False,
                       device="cpu")
    got = runner.ood_evaluate(runner._encode(GQADataset(root, "testdev", add_uq=True)),
                              dump=str(tmp_path / "port.json"))
    assert got.keys() == want.keys()
    with open(tmp_path / "jax.json") as f:
        jrows = {r["questionId"]: r for r in json.load(f)}
    with open(tmp_path / "port.json") as f:
        rows = {r["questionId"]: r for r in json.load(f)}
    assert rows.keys() == jrows.keys() and len(rows) > 10
    for qid, row in rows.items():
        assert row["prediction"] == jrows[qid]["prediction"], qid
        assert abs(row["confidence"] - jrows[qid]["confidence"]) <= CONF_TOL, qid


def test_teacher_path_takes_the_export(jax_run, tmp_path):
    from rgqa_tpu_torch.distill import teacher_pth

    root, run, _, _ = jax_run
    last = os.path.join(run, "LAST")
    assert teacher_pth(last) == last + ".pth"
    cfg = _run_cfg(port_config, root, str(tmp_path / "o"), teacher_path=last)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, strategy="distill_online"))
    GQARunner(cfg, init_train=False, device="cpu")  # check_ported passes the exported directory


def test_train_state_resumes_the_jax_run(jax, jax_run, tmp_path):
    from rgqa_tpu.checkpoint.orbax_io import load_checkpoint
    from rgqa_tpu.train import create_train_state, make_optimizer as jax_make_optimizer
    from rgqa_tpu.train import make_train_step as jax_make_train_step

    from rgqa_tpu_torch.data.dataset import GQADataset
    from rgqa_tpu_torch.train import step as tstep

    root, run, jrunner, _ = jax_run
    raw = jax.tree_util.tree_map(np.asarray, load_checkpoint(run, "LAST"))
    state = torch.load(os.path.join(run, "LAST.state.pt"), weights_only=True)
    # The moments, bit for bit, under the port model's parameter order.
    port_dir = tmp_path / "port_run"
    shutil.copytree(run, port_dir)
    runner = GQARunner(_run_cfg(port_config, root, str(port_dir)), device="cpu")
    names = [n for n, _ in runner.model.named_parameters()]
    for key in ("mu", "nu"):
        want = from_jax_params(raw["opt_state"][key])
        for i, name in enumerate(names):
            assert torch.equal(state["optimizer"]["state"][i][key], want[name]), (key, name)
    assert state["step"] == int(raw["step"]) == state["optimizer"]["param_groups"][0]["count"] == 2
    # The first step after each package's resume (the JAX runner's: the
    # restored step, params and moments), on one batch and RP shift.
    optimizer, rng, _, steps = runner._train_state("LAST")
    assert steps == 2
    batch = runner._encode(GQADataset(root, "train", add_uq=True), train=True).gather_batch(
        np.arange(8), with_target=True)
    t_total = len(runner.train_set) // 8 * EPOCHS  # the schedule of both runners' train()
    jstate = create_train_state(jrunner.params, jax_make_optimizer(jrunner.cfg.train.optim, t_total))
    restored = load_checkpoint(run, "LAST", template=jstate)
    jstate = jstate.replace(step=restored["step"], params=restored["params"], opt_state=restored["opt_state"])
    jstep = jax_make_train_step(jrunner.forward, sample_pair=True, grad_clip=5.0, donate=False)
    key = jax.random.PRNGKey(5)
    shift = int(jax.random.randint(jax.random.split(key)[1], (), 1, 8))
    jstate, aux = jstep(jstate, {k: jax.numpy.asarray(v) for k, v in batch.items()}, key)
    before = {k: v.detach().clone() for k, v in runner.model.named_parameters()}
    step = tstep.make_train_step(runner.forward, optimizer, sample_pair=True, grad_clip=5.0, rng=rng)
    loss = step(_tensors(batch), shift=shift)["loss"].item()
    np.testing.assert_allclose(loss, float(aux["loss"]), rtol=1e-4)
    after = from_jax_params(jax.tree_util.tree_map(np.asarray, jstate.params))
    for name, value in runner.model.named_parameters():
        want, got = after[name] - before[name], value.detach() - before[name]
        scale = float(want.abs().max())
        assert scale > 0, name
        torch.testing.assert_close(got, want, rtol=0, atol=1e-3 * scale, msg=name)


@pytest.mark.parametrize("optim", ["adam", "adamw", "rms", "sgd"])
def test_train_state_of_each_optim_loads_into_the_port_optimizer(jax, jax_run, tmp_path, optim):
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.checkpoint.orbax_io import save_checkpoint
    from rgqa_tpu.config import dump_run_config
    from rgqa_tpu.train import create_train_state, make_optimizer as jax_make_optimizer

    from rgqa_tpu_torch.train.optimizer import make_optimizer

    root, _, jrunner, _ = jax_run
    run = str(tmp_path / "run")
    jcfg = _run_cfg(jax_config, root, run)
    jcfg = jcfg.replace(train=dataclasses.replace(jcfg.train, optim=dataclasses.replace(jcfg.train.optim,
                                                                                         name=optim)))
    dump_run_config(jcfg, run)
    state = create_train_state(jrunner.params, jax_make_optimizer(jcfg.train.optim, 1))
    rng = np.random.default_rng(1)
    seeded = jax.tree_util.tree_map(
        lambda x: rng.uniform(0, 1, np.shape(x)).astype(np.float32) if np.ndim(x) else x, state.opt_state)
    save_checkpoint(run, "LAST", state.replace(step=4, opt_state=seeded))
    orbax_to_pth.main([os.path.join(run, "LAST")])
    exported = torch.load(os.path.join(run, "LAST.state.pt"), weights_only=True)
    model, _ = build_model(_run_cfg(port_config, root, run).model, device="meta")
    opt = make_optimizer(port_config.OptimConfig(name=optim), [p for _, p in model.named_parameters()])
    opt.load_state_dict(exported["optimizer"])  # the layout the port's resume loads
    assert exported["step"] == 4
    if optim == "sgd":
        assert exported["optimizer"]["state"] == {}
        return
    names = [n for n, _ in model.named_parameters()]
    for key in ("mu", "nu") if optim != "rms" else ("nu",):
        want = from_jax_params(getattr(seeded[0], key))  # optax's chain: scale_by_adam / _rms first
        for i, name in enumerate(names):
            assert torch.equal(exported["optimizer"]["state"][i][key], want[name]), (key, name)


# ---------------------------------------------------------------------------
# The other kinds, each from its own snapshot.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backbone", list(MODELS))
def test_gqa_backbone_export_gives_the_jax_forward(jax, backbone, tmp_path):
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.models.zoo import build_model as jax_build_model, example_batch as jax_example_batch

    jcfg = _cfg(jax_config, backbone, MODELS[backbone])
    batch = jax_example_batch(jcfg, 3, seed=2)
    jmodel, jforward = jax_build_model(jcfg)
    keys = ("token_ids", "feats", "boxes") if backbone == "butd" else (
        ("input_ids", "input_mask", "pixels") if backbone == "vilt" else (
            ("input_ids", "input_mask", "segment_ids") if backbone == "caps" else INPUTS))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(1), *[jax.numpy.asarray(batch[k]) for k in keys])["params"]
    snap = _save(jax, tmp_path, "BEST", params)
    assert orbax_to_pth.main([snap]) == [snap + ".pth"]
    logits = jax.jit(lambda p, b: jforward(p, b, deterministic=True)["logits"])(params, batch)
    want = np.asarray(logits, np.float32)
    pcfg = _cfg(port_config, backbone, MODELS[backbone])
    model, forward = build_model(pcfg, device="cpu")
    enc = pcfg.encoder
    model.load_state_dict(_port_params(snap + ".pth", backbone, num_layers=enc.num_layers), strict=True)
    with torch.no_grad():
        got = forward(_tensors(batch), deterministic=True)["logits"].float().numpy()
    np.testing.assert_allclose(got.reshape(want.shape), want, rtol=0, atol=LOGIT_TOL)


def _lxmert_batch(jax_config, b=3):
    from rgqa_tpu.models.zoo import example_batch as jax_example_batch

    return jax_example_batch(jax_config.ModelConfig(encoder=jax_config.EncoderConfig(**LXMERT_ENC), max_text_len=8),
                             b, seed=4)


def test_nlvr2_export_gives_the_jax_forward(jax, tmp_path):
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.models.nlvr2 import Nlvr2Model as JaxNlvr2

    from rgqa_tpu_torch.models.nlvr2 import Nlvr2Model

    one = _lxmert_batch(jax_config, 4)
    args = [one["input_ids"][:2], one["input_mask"][:2], one["segment_ids"][:2],
            one["feats"].reshape(2, 2, 10, 48), one["boxes"].reshape(2, 2, 10, 4)]
    jmodel = JaxNlvr2(jax_config.EncoderConfig(**LXMERT_ENC))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(2), *args)["params"]
    snap = _save(jax, tmp_path, "BEST", params)
    assert orbax_to_pth.main([snap]) == [snap + ".pth"]
    model = Nlvr2Model(port_config.EncoderConfig(**LXMERT_ENC))
    model.load_state_dict(_port_params(snap + ".pth", "nlvr2", l_layers=1, x_layers=1, r_layers=1), strict=True)
    with torch.no_grad():
        got = model.eval()(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args))["logits"].numpy()
    want = jax.jit(jmodel.apply)({"params": params}, *args)["logits"]
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=LOGIT_TOL)


def test_pretraining_export_is_what_load_lxmert_reads(jax, tmp_path):
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.models.lxmert import LxmertPretraining as JaxPretraining

    batch = _lxmert_batch(jax_config)
    args = [batch[k] for k in INPUTS]
    jmodel = JaxPretraining(jax_config.EncoderConfig(**LXMERT_ENC), num_answers=7)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(3), *args)["params"]
    snap = _save(jax, tmp_path, "BEST_EVAL_LOSS", params)
    assert orbax_to_pth.main([snap]) == [snap + "_LXRT.pth"]
    _, forward = load_pretraining(snap, port_config.EncoderConfig(**LXMERT_ENC), device="cpu")
    want = jax.jit(jmodel.apply)({"params": params}, *args)
    with torch.no_grad():
        got = forward(_tensors(batch), deterministic=True)
    for key in ("matched", "qa", "pooled"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=LOGIT_TOL, err_msg=key)


def test_vqa_export_scores_as_the_jax_runner(jax, tmp_path):
    from rgqa_tpu import config as jax_config
    from rgqa_tpu import vqa_task as jax_vqa
    from rgqa_tpu.runner import np_params

    from rgqa_tpu_torch.data.synthetic import make_synthetic_vqa
    from rgqa_tpu_torch.vqa_task import VQARunner

    root = str(tmp_path / "vqa")
    make_synthetic_vqa(root, SyntheticSpec(n_images=12, n_train=16, n_valid=16, n_testdev=8, seed=3))
    argv = ["--data_root", root, "--fp32", "--llayers", "1", "--xlayers", "1", "--rlayers", "1", "--hidden_size",
            "32", "--num_heads", "4", "--batchSize", "8", "--test", "minival"]
    jrunner = jax_vqa.VQARunner(jax_config.parse_cli(argv + ["--output", str(tmp_path / "j")])[0],
                                init_train=False)
    snap = _save(jax, tmp_path, "BEST", np_params(jrunner.params))
    assert orbax_to_pth.main([snap]) == [snap + ".pth"]
    want = jrunner.evaluate("minival", dump=str(tmp_path / "jax.json"))
    runner = VQARunner(port_config.parse_cli(argv + ["--device", "cpu", "--load", snap, "--output",
                                                     str(tmp_path / "p")])[0], init_train=False, device="cpu")
    got = runner.evaluate("minival", dump=str(tmp_path / "port.json"))
    assert got == pytest.approx(want, abs=1e-9)
    with open(tmp_path / "jax.json") as f, open(tmp_path / "port.json") as g:
        assert json.load(g) == json.load(f)


def test_clip_export_scores_as_the_jax_scorer(jax, tmp_path):
    from rgqa_tpu.scorers.clip import ClipScorer as JaxScorer

    from rgqa_tpu_torch.scorers.clip import ClipScorer

    from test_torch_clip import ATOL, HF_CONFIG, RTOL, SENTENCES, _jax_clip, write_clip_dir

    src = write_clip_dir(tmp_path / "src")
    _, params = _jax_clip(src, HF_CONFIG)
    # A trained adversary's export: the HF files and jax_params/, no .bin.
    out = tmp_path / "run" / "clip_params"
    out.mkdir(parents=True)
    for name in ("config.json", "vocab.json", "merges.txt"):
        shutil.copy(os.path.join(src, name), out / name)
    moved = jax.tree_util.tree_map(lambda x: np.asarray(x) * np.float32(1.01), params)
    _save(jax, out, "jax_params", moved)
    with pytest.raises(NotImplementedError, match="--clip_path an orbax snapshot directory.*orbax_to_pth.py"):
        ClipScorer(str(out), device="cpu")
    assert orbax_to_pth.main([str(out)]) == [str(out / "pytorch_model.bin")]
    port, jax_scorer = ClipScorer(str(out), batch_size=4, device="cpu"), JaxScorer(str(out), backend="jax",
                                                                                     batch_size=4)
    rows = list(np.random.default_rng(3).integers(0, 256, (len(SENTENCES), 32, 32, 3), np.uint8))
    np.testing.assert_allclose(port.scores(rows, SENTENCES), jax_scorer.scores(rows, SENTENCES), rtol=RTOL,
                               atol=ATOL)
    assert port.logit_scale == pytest.approx(jax_scorer.logit_scale, rel=1e-6)

    # The adversary's train state (<output>/LAST_clip: the JAX runner's
    # create_train_state(params, optax.adam(1e-5)), here with seeded
    # moments at step 3) -> LAST_clip.pth, which the port's resume reads.
    import optax
    from rgqa_tpu.train import create_train_state

    from rgqa_tpu_torch.checkpoint.convert import load_clip_state
    from rgqa_tpu_torch.models.clip import ClipModel, clip_config_from_hf
    from rgqa_tpu_torch.train.optimizer import OptaxAdam

    state = create_train_state(moved, optax.adam(1e-5))
    rng = np.random.default_rng(4)
    adam = state.opt_state[0]._replace(
        count=np.int32(3),
        mu=jax.tree_util.tree_map(lambda p: rng.standard_normal(p.shape).astype(np.float32), moved),
        nu=jax.tree_util.tree_map(lambda p: rng.uniform(0, 1, p.shape).astype(np.float32), moved))
    snap = _save(jax, tmp_path / "run", "LAST_clip", state.replace(step=3, opt_state=(adam, *state.opt_state[1:])))
    assert orbax_to_pth.main([snap]) == [snap + ".pth"]
    model = ClipModel(clip_config_from_hf(HF_CONFIG))
    opt = OptaxAdam(model.parameters(), lr=1e-5)
    assert load_clip_state(snap + ".pth", model, opt) == 3
    want = {k: from_jax_params(getattr(adam, k), "clip") for k in ("mu", "nu")}
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), from_jax_params(moved, "clip")[name], rtol=0, atol=0)
        for k in ("mu", "nu"):
            assert torch.equal(opt.state[p][k], want[k][name]), (k, name)
        assert opt.state[p]["count"] == 3


# ---------------------------------------------------------------------------
# Without the export.
# ---------------------------------------------------------------------------


def test_orbax_directories_without_export_are_refused(jax, jax_run, tmp_path):
    from rgqa_tpu_torch.distill import teacher_pth

    root, run, _, _ = jax_run
    snap = str(tmp_path / "SNAP")
    shutil.copytree(os.path.join(run, "LAST"), snap)  # an orbax directory, no SNAP.pth
    cfg = _run_cfg(port_config, root, str(tmp_path / "o"))
    distill = cfg.replace(train=dataclasses.replace(cfg.train, strategy="distill_online"), teacher_path=snap)
    command = f"orbax_to_pth.py {snap}"
    for flag, run_cfg in (("--load", cfg.replace(load=snap)), ("--teacher_path", distill),
                          ("--loadLXMERT", cfg.replace(load_lxmert=snap)),
                          ("--loadLXMERTQA", cfg.replace(load_lxmert_qa=snap))):
        with pytest.raises(NotImplementedError, match=f"{flag} an orbax snapshot directory") as err:
            GQARunner(run_cfg, init_train=flag == "--teacher_path", device="cpu")
        assert command in str(err.value)
    with pytest.raises(NotImplementedError, match="--teacher_path an orbax snapshot directory"):
        teacher_pth(snap)
    with pytest.raises(NotImplementedError, match="--loadLXMERT an orbax snapshot directory"):
        load_pretraining(snap, port_config.EncoderConfig(**LXMERT_ENC), device="cpu")
