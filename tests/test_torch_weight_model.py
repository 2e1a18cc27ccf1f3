"""Port parity: ``--strategy weight --update_weight_model`` (the CLIP
weight model trained beside the answerer) against the JAX package, on
the CPU, in f32 at dropout 0.

- the joint step (``train.step.make_weighted_clip_train_step``) against
  JAX ``make_weighted_clip_train_step`` over 12 steps from the same tiny
  LXMERT and tiny CLIP weights, with the same batches, roll shifts and
  uint8 anchor pixels: ``loss`` and ``loss_w`` per step (rtol 1e-4) and
  both parameter trees after the last step (rtol 1e-4, with atol 1e-6
  for the elements twelve updates bring near zero: the largest such gap
  is ~4e-7 at values ~1e-3);
- the joint step's model update equals the frozen-weight weighted-RP
  update fed the same softmax weights (as ``tests/test_clip.py`` holds
  it for JAX);
- the runner end to end on a root with JPEGs and a CLIP pack packed from
  them: the JAX runner decodes the JPEGs, the port reads the pack; the
  per-step ``loss`` / ``loss_w`` of both runs (rtol 1e-4);
- ``resume`` restores the CLIP params and Adam state of ``LAST_clip.pth``
  exactly, and warns without it;
- the exported ``clip_params/`` loads in the port's ``ClipScorer`` and
  the JAX one with the same cosines (rtol 1e-5), params moved off the
  source's;
- the refusals of this mode (no ``--clip_path``; no pixels);
- ``tools/strategy_steps.py``'s ``weight_model`` step (the profile's and
  the smoke's) is the joint step.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import torch

from rgqa_tpu_torch.config import OptimConfig
from rgqa_tpu_torch.data.synthetic import BASE_IMAGES, SyntheticSpec, make_synthetic_gqa
from rgqa_tpu_torch.data.tsv import PackedFeatures
from rgqa_tpu_torch.models.clip import clip_config_from_hf, example_inputs
from rgqa_tpu_torch.ops.dropout import DropoutRng
from rgqa_tpu_torch.runner import GQARunner
from rgqa_tpu_torch.scorers.clip import ClipScorer
from rgqa_tpu_torch.train import optimizer, step as tstep
from test_torch_clip import HF_CONFIG, write_clip_dir
from test_torch_slice import CLI_SPEC, SPEC
from test_torch_strategies import _encoded, _jnp, _tensors
from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)
from test_torch_train_strategies import _jax_init, _model_cfg, _port_model, _runner_cfg

N_STEPS = 12
B = 6
LR = 2e-3
TEMPERATURE = 0.5


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


@pytest.fixture(scope="module")
def clip_dir(tmp_path_factory):
    return write_clip_dir(tmp_path_factory.mktemp("weight_model_clip") / "ckpt", seed=4)


@pytest.fixture(scope="module")
def steps_inputs(tmp_path_factory):
    """(batches with CLIP inputs, roll shifts), one numpy seed."""
    root = str(tmp_path_factory.mktemp("weight_model") / "gqa")
    make_synthetic_gqa(root, SyntheticSpec(**SPEC))
    enc = _encoded(root)
    rng = np.random.default_rng(11)
    ccfg = clip_config_from_hf(HF_CONFIG)
    batches, shifts = [], []
    for i in range(N_STEPS):
        batch = enc.gather_batch(rng.choice(len(enc), B, replace=False), with_target=True)
        ids, mask, pixels = example_inputs(ccfg, B, seed=100 + i)
        batches.append(dict(batch, clip_ids=ids, clip_mask=mask, clip_pixels=pixels))
        shifts.append(int(rng.integers(1, B)))
    return batches, shifts


def _jax_clip(clip_dir):
    from rgqa_tpu.scorers.clip import ClipScorer as JaxClipScorer

    return JaxClipScorer(clip_dir, backend="jax", batch_size=B, use_bf16=False)


def _jax_clip_similarity(jax, scorer):
    """The JAX runner's ``clip_similarity`` (``rgqa_tpu/runner.py:785-802``)."""
    from rgqa_tpu.models.clip import ClipModel
    from rgqa_tpu.ops.pixels import clip_normalize_jnp

    jnp = jax.numpy

    def clip_similarity(clip_params, ids, mask, pixels):
        if pixels.dtype == jnp.uint8:
            pixels = clip_normalize_jnp(pixels)
        sim = scorer.model.apply({"params": clip_params}, ids, mask, pixels, method=ClipModel.cosine)
        return sim * jnp.exp(jax.lax.stop_gradient(clip_params["logit_scale"].astype(jnp.float32)))

    return clip_similarity


def _jax_batch(jax, batch, shift):
    jb = {k: v for k, v in batch.items() if k != "clip_pixels"}
    return dict(_jnp(jax, jb), pixels=jax.numpy.asarray(batch["clip_pixels"]),
                neg_shift=jax.numpy.asarray(shift, jax.numpy.int32))


def _port_clip(clip_dir):
    scorer = ClipScorer(clip_dir, device="cpu")
    scorer.model.train()
    return scorer.model, optimizer.OptaxAdam(scorer.model.parameters(), lr=1e-5)


def test_joint_step_matches_jax(jax, clip_dir, steps_inputs, tmp_path):
    import optax

    from rgqa_tpu.config import OptimConfig as JaxOptimConfig
    from rgqa_tpu.train import create_train_state, make_optimizer as jax_make_optimizer
    from rgqa_tpu.train.step import make_weighted_clip_train_step as jax_joint_step
    from rgqa_tpu_torch.checkpoint.convert import from_jax_params

    batches, shifts = steps_inputs
    cfg = _model_cfg(batches[0]["target"].shape[1])
    jforward, params = _jax_init(jax, cfg, batches[0])
    scorer = _jax_clip(clip_dir)
    state = create_train_state(params, jax_make_optimizer(JaxOptimConfig(lr=LR), N_STEPS))
    clip_state = create_train_state(scorer.params, optax.adam(1e-5))
    jstep = jax_joint_step(jforward, _jax_clip_similarity(jax, scorer), temperature=TEMPERATURE, donate=False)
    key, want = jax.random.PRNGKey(0), []
    for batch, shift in zip(batches, shifts):
        key, sub = jax.random.split(key)
        state, clip_state, aux = jstep(state, clip_state, _jax_batch(jax, batch, shift), sub)
        want.append((float(aux["loss"]), float(aux["loss_w"])))

    model, forward, _ = _port_model(cfg, params)
    opt = optimizer.make_optimizer(OptimConfig(lr=LR), model.parameters(), t_total=N_STEPS)
    clip_model, clip_opt = _port_clip(clip_dir)
    init_clip = {k: v.clone() for k, v in clip_model.state_dict().items()}
    step = tstep.make_weighted_clip_train_step(forward, clip_model, opt, clip_opt, temperature=TEMPERATURE,
                                               rng=DropoutRng())
    got = []
    for batch, shift in zip(batches, shifts):
        aux = step(_tensors(batch), shift)
        got.append((aux["loss"].item(), aux["loss_w"].item()))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert len({round(w, 6) for _, w in got}) > 1

    for k, v in from_jax_params(jax.tree_util.tree_map(np.asarray, state.params)).items():
        np.testing.assert_allclose(model.state_dict()[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-6, err_msg=k)
    # The port's CLIP params into a JAX tree through the JAX importer, leaf
    # by leaf against JAX's.
    from rgqa_tpu.checkpoint.torch_import import import_clip

    path = str(tmp_path / "port_clip.bin")
    torch.save(clip_model.state_dict(), path)
    template = jax.tree_util.tree_map(np.asarray, clip_state.params)
    mine, missing, _ = import_clip(template, path, vision_layers=2, text_layers=2)
    assert not missing
    leaves = jax.tree_util.tree_leaves_with_path(clip_state.params)
    mine_leaves = dict(jax.tree_util.tree_leaves_with_path(mine))
    for path, leaf in leaves:
        np.testing.assert_allclose(np.asarray(mine_leaves[path]), np.asarray(leaf), rtol=1e-4, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))
    sd = clip_model.state_dict()
    assert any(not torch.equal(sd[k], init_clip[k]) for k in sd)  # CLIP moved


def test_joint_step_model_update_equals_the_frozen_weight_step(clip_dir, steps_inputs):
    batches, shifts = steps_inputs
    batch, shift = _tensors(batches[0]), shifts[0]
    cfg = _model_cfg(batch["target"].shape[1])
    from rgqa_tpu_torch.models.zoo import build_model
    from rgqa_tpu_torch.ops.pixels import clip_normalize

    model, forward = build_model(cfg, device="cpu", train=True)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    clip_model, clip_opt = _port_clip(clip_dir)
    with torch.no_grad():
        sim = clip_model.cosine(torch.roll(batch["clip_ids"], shift, 0), torch.roll(batch["clip_mask"], shift, 0),
                                clip_normalize(batch["clip_pixels"])) * torch.exp(clip_model.logit_scale)
        w = torch.softmax(sim / TEMPERATURE, dim=0)
    opt = optimizer.make_optimizer(OptimConfig(name="adam", lr=LR), model.parameters(), t_total=10)
    joint = tstep.make_weighted_clip_train_step(forward, clip_model, opt, clip_opt, temperature=TEMPERATURE)
    aux = joint(batch, shift)
    joint_params = {k: v.clone() for k, v in model.state_dict().items()}

    model.load_state_dict(init)
    opt = optimizer.make_optimizer(OptimConfig(name="adam", lr=LR), model.parameters(), t_total=10)
    frozen = tstep.make_train_step(forward, opt, weighted_rp=True)
    faux = frozen(batch, shift=shift, neg_weights=w)
    np.testing.assert_allclose(aux["loss"].item(), faux["loss"].item(), rtol=1e-6)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(joint_params[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-7, err_msg=k)
    assert any(not torch.equal(joint_params[k], init[k]) for k in init)


# ---------------------------------------------------------------------------
# The runner.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jpeg_root(tmp_path_factory):
    """A synthetic root with its base images as JPEGs under ``images/`` and
    the CLIP pack packed from them at the tiny CLIP's 32 px
    (``data.images.pack_pixels(transform="clip")``, what ``prepare_data
    --pack_pixels images --pixel_transform clip`` runs)."""
    pytest.importorskip("PIL")
    from PIL import Image

    from rgqa_tpu_torch.data.images import pack_pixels

    root = str(tmp_path_factory.mktemp("weight_model_runner") / "gqa")
    make_synthetic_gqa(root, SyntheticSpec(**dict(SPEC, n_train=24)))
    base = np.load(os.path.join(root, BASE_IMAGES))
    os.makedirs(os.path.join(root, "images"))
    for img_id, image in zip(PackedFeatures(os.path.join(root, "features")).img_ids, base):
        Image.fromarray(image).save(os.path.join(root, "images", f"{img_id}.jpg"))
    pack_pixels(os.path.join(root, "images"), os.path.join(root, "pixels_clip_32"), size=32, transform="clip")
    return root


@pytest.fixture(scope="module")
def init_pth(jax, jpeg_root, tmp_path_factory):
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.runner import GQARunner as JaxRunner
    from rgqa_tpu.runner import np_params
    from rgqa_tpu_torch.checkpoint.convert import from_jax_params, to_reference_state_dict

    tmp = tmp_path_factory.mktemp("weight_model_init")
    jax_runner = JaxRunner(_runner_cfg(jpeg_root, str(tmp / "init"), jax_config), init_train=False)
    pth = str(tmp / "init.pth")
    torch.save(to_reference_state_dict(from_jax_params(np_params(jax_runner.params)), l_layers=1, x_layers=1,
                                       r_layers=1), pth)
    return pth


def _wm_cfg(root, out, clip_path, config=None, **kw):
    cfg = _runner_cfg(root, out, config, strategy="weight", update_weight_model=True, **kw)
    return dataclasses.replace(cfg, ood=dataclasses.replace(cfg.ood, clip_path=clip_path, temperature=TEMPERATURE))


def _recording(module, name, record, unpack):
    """``module.name`` wrapped so each step's (loss, loss_w) is appended
    to ``record``."""
    make = getattr(module, name)

    def factory(*args, **kw):
        step = make(*args, **kw)

        def recorded(*a, **k):
            out = step(*a, **k)
            aux = unpack(out)
            record.append((float(aux["loss"]), float(aux["loss_w"])))
            return out

        return recorded

    return factory


def test_runner_steps_match_the_jax_runner(jax, jpeg_root, init_pth, clip_dir, tmp_path, monkeypatch):
    import rgqa_tpu.train as jax_train
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.runner import GQARunner as JaxRunner
    import rgqa_tpu_torch.runner as port_runner

    want, got = [], []
    monkeypatch.setattr(jax_train, "make_weighted_clip_train_step",
                        _recording(jax_train, "make_weighted_clip_train_step", want, lambda out: out[2]))
    monkeypatch.setattr(port_runner, "make_weighted_clip_train_step",
                        _recording(port_runner, "make_weighted_clip_train_step", got, lambda out: out))
    jcfg = dataclasses.replace(_wm_cfg(jpeg_root, str(tmp_path / "jax"), clip_dir, jax_config), load=init_pth)
    jhist = JaxRunner(jcfg).train_weight_model()
    pcfg = dataclasses.replace(_wm_cfg(jpeg_root, str(tmp_path / "port"), clip_dir), load=init_pth)
    runner = GQARunner(pcfg, device="cpu")
    pack, _ = runner._clip_pack(ClipScorer(clip_dir, device="cpu"), os.path.join(jpeg_root, "images"))
    assert pack is not None  # the port reads the pack, JAX the JPEGs
    hist = runner.train()
    assert len(got) == len(want) >= 4
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=1e-4)
    out = tmp_path / "port"
    assert {"LAST.pth", "LAST.state.pt", "LAST_clip.pth", "clip_params"} <= set(os.listdir(out))
    assert not (out / "clip_pixels_u8.npy").exists()


@pytest.fixture(scope="module")
def trained(jpeg_root, clip_dir, tmp_path_factory):
    """A port run of two epochs on the tiny root: (its output, the runner's
    captured CLIP model and optimizer at the end)."""
    import rgqa_tpu_torch.runner as port_runner

    out = str(tmp_path_factory.mktemp("weight_model_trained") / "run")
    captured = {}
    make = port_runner.make_weighted_clip_train_step

    def factory(forward, clip_model, opt, clip_opt, **kw):
        captured.update(clip_model=clip_model, clip_opt=clip_opt)
        return make(forward, clip_model, opt, clip_opt, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(port_runner, "make_weighted_clip_train_step", factory)
    try:
        GQARunner(_wm_cfg(jpeg_root, out, clip_dir), device="cpu").train()
    finally:
        mp.undo()
    return out, captured


def test_resume_restores_the_clip_side(jpeg_root, clip_dir, trained, monkeypatch):
    import rgqa_tpu_torch.runner as port_runner

    out, first = trained
    seen = {}
    make = port_runner.make_weighted_clip_train_step

    def factory(forward, clip_model, opt, clip_opt, **kw):
        seen["params"] = {k: v.clone() for k, v in clip_model.state_dict().items()}
        seen["state"] = {id_: {k: (v.clone() if torch.is_tensor(v) else v) for k, v in s.items()}
                         for id_, s in enumerate(clip_opt.state[p] for p in clip_model.parameters())}
        raise StopIteration  # the restored state is all this test reads

    monkeypatch.setattr(port_runner, "make_weighted_clip_train_step", factory)
    cfg = _wm_cfg(jpeg_root, out, clip_dir)
    with pytest.raises(StopIteration):
        GQARunner(cfg, device="cpu").train(resume="LAST")
    want = first["clip_model"].state_dict()
    assert seen["params"].keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(seen["params"][k], v), k
    for i, p in enumerate(first["clip_model"].parameters()):
        s = first["clip_opt"].state[p]
        assert seen["state"][i]["count"] == s["count"] > 0
        assert torch.equal(seen["state"][i]["mu"], s["mu"]) and torch.equal(seen["state"][i]["nu"], s["nu"])

    os.rename(os.path.join(out, "LAST_clip.pth"), os.path.join(out, "LAST_clip.moved"))
    try:
        with pytest.warns(RuntimeWarning, match="no LAST_clip.pth checkpoint"), pytest.raises(StopIteration):
            GQARunner(cfg, device="cpu").train(resume="LAST")
    finally:
        os.rename(os.path.join(out, "LAST_clip.moved"), os.path.join(out, "LAST_clip.pth"))


def test_exported_clip_params_load_in_both_packages(jax, jpeg_root, clip_dir, trained):
    out, _ = trained
    export = os.path.join(out, "clip_params")
    assert {"config.json", "vocab.json", "merges.txt", "pytorch_model.bin"} <= set(os.listdir(export))
    texts = ["is there a red apple on the table?", "what color is the dog?", "the cat", "what is this"]
    pixels = list(example_inputs(clip_config_from_hf(HF_CONFIG), len(texts), seed=9)[2])
    got = ClipScorer(export, device="cpu").scores(pixels, texts)
    want = np.asarray(_jax_clip(export).scores(pixels, texts))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    source = ClipScorer(clip_dir, device="cpu")
    trained_sd = ClipScorer(export, device="cpu").model.state_dict()
    assert any(not torch.equal(v, trained_sd[k]) for k, v in source.model.state_dict().items())
    assert not np.array_equal(source.scores(pixels, texts), got)


def test_the_mode_needs_clip_and_pixels(jpeg_root, clip_dir, tmp_path):
    cfg = _wm_cfg(jpeg_root, str(tmp_path / "a"), None)
    with pytest.raises(RuntimeError, match="--update_weight_model needs --clip_path"):
        GQARunner(cfg, device="cpu").train()
    # No pack and no JPEGs: a root of the port's generator has neither at 32 px.
    root = str(tmp_path / "bare")
    make_synthetic_gqa(root, SyntheticSpec(**SPEC))
    os.remove(os.path.join(root, BASE_IMAGES))  # nothing to write a synthetic pack from
    cfg = _wm_cfg(root, str(tmp_path / "b"), clip_dir)
    with pytest.raises(RuntimeError, match="--update_weight_model has no pixels for .* needs .*JPEGs"):
        GQARunner(cfg, device="cpu").train()


def test_train_cli_writes_the_weight_model(clip_dir, tmp_path):
    """The train CLI on a synthetic root (36 x 2048 RoIs, the CLI's width),
    its CLIP pack written from the root's base images."""
    from rgqa_tpu_torch.checkpoint.convert import load_reference_pth
    from rgqa_tpu_torch.cli import train

    root, out = str(tmp_path / "gqa"), str(tmp_path / "cli")
    make_synthetic_gqa(root, SyntheticSpec(**CLI_SPEC))
    history = train.main(["--synthetic", "--data_root", root, "--output", out, "--device", "cpu", "--fp32",
                          "--llayers", "1", "--xlayers", "1", "--rlayers", "1", "--hidden_size", "32",
                          "--num_heads", "4", "--batchSize", "8", "--epochs", "1", "--strategy", "weight",
                          "--update_weight_model", "--clip_path", clip_dir])
    assert np.isfinite(history["loss"]).all()
    _, missing, unused = load_reference_pth(os.path.join(out, "LAST.pth"), l_layers=1, x_layers=1, r_layers=1)
    assert not missing and not unused
    assert os.path.isfile(os.path.join(out, "LAST_clip.pth"))
    assert ClipScorer(os.path.join(out, "clip_params"), device="cpu").scores(
        list(example_inputs(clip_config_from_hf(HF_CONFIG), 2, seed=1)[2]), ["a dog", "the cat"]).shape == (2,)


def test_the_profiled_step_is_the_joint_step(clip_dir, steps_inputs):
    from rgqa_tpu_torch.models.zoo import build_model
    from rgqa_tpu_torch.tools.strategy_steps import make_strategy_step, strategy_inputs, with_clip_inputs

    batches, _ = steps_inputs
    cfg = _model_cfg(batches[0]["target"].shape[1])
    plain = {k: v for k, v in _tensors(batches[0]).items() if not k.startswith("clip_")}
    batch = with_clip_inputs(plain, clip_config_from_hf(HF_CONFIG), seed=3)
    assert batch["clip_pixels"].dtype == torch.uint8 and batch["clip_ids"].shape == (B, 12)
    (args,) = strategy_inputs("weight_model", [batch])
    losses = []
    for make in ("helper", "direct"):
        model, forward = build_model(cfg, device="cpu", train=True)
        clip_model, clip_opt = _port_clip(clip_dir)
        opt = optimizer.make_optimizer(OptimConfig(name="adam", lr=LR), model.parameters())
        if make == "helper":
            step = make_strategy_step("weight_model", forward, opt, rng=DropoutRng(), clip_model=clip_model)
        else:
            step = tstep.make_weighted_clip_train_step(forward, clip_model, opt, clip_opt, rng=DropoutRng())
        losses.append([step(*args)["loss_w"].item() for _ in range(2)])
    assert losses[0] == losses[1]
