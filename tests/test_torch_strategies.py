"""Port parity: the single-loader training strategies against the JAX
package, on the CPU.

The same numpy inputs go through the JAX function and its counterpart in
the port:

- the losses: ``mce_answer_loss`` (with and without a row mask),
  ``energy_of_logits`` (softplus sum and logsumexp),
  ``energy_regularizer`` and ``branched_loss`` (BCE and MCE): rtol 1e-6;
- ``EncodedGQA``'s TreeMix spans (``data/parse.py``) and the
  ``--uq_as_class`` targets (``keep_uq_target``) on the synthetic root:
  equal arrays;
- every augmentation mode of JAX ``mixup_augment``, with the draws of the
  JAX key chain (the splits of ``rgqa_tpu/train/step.py``: the coin
  ``:241-242``, TreeMix ``:114``, perturb ``:260``, weighted sums
  ``:269``, the RoI swap ``:281``) handed to the port's ``mixup_apply``:
  gathers, selects and targets equal (atol 0), the weighted sums' blends
  within rtol 1e-6; both sides of ``treemix_both``'s coin, the
  ``uq_as_class`` targets, TreeMix's window fallback (no spans; BUTD's
  ``token_ids``) and tied uniforms (the kept subset is the stable double
  argsort's); on UNITER's stream the splice keeps to the text positions;
- the 12-step loss trajectory of the port's ``make_train_step`` against
  JAX ``make_train_step``: a tiny ``LxmertForGQA`` in f32 at dropout 0,
  the same weights and batches, the JAX step's draws (``step.py:389``)
  handed to the port, losses within rtol 1e-4 (``tests/test_train.py``'s
  bar) for ``mixup_v1``, ``treemix_v2`` with spans, ``--branched``,
  ``--branched_layer``, the energy hinge with ``--mceLoss`` and
  ``--uq_as_class`` with ``mixup_v1``.

And the train CLI with each new flag (LXMERT's, UNITER's and BUTD's
mixup, TreeMix's coin, the branched heads, energy with MCE,
``--uq_as_class`` with ``--chart``): a ``BEST.pth`` that loads back with
no key missing or unused, and the chart pickles.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import pytest
import torch

from rgqa_tpu_torch.checkpoint.convert import from_jax_params, load_reference_pth
from rgqa_tpu_torch.config import EncoderConfig, ModelConfig, OptimConfig, parse_cli
from rgqa_tpu_torch.data import dataset, tokenizer, tsv
from rgqa_tpu_torch.data.synthetic import SyntheticSpec, make_synthetic_gqa
from rgqa_tpu_torch.models.zoo import build_model
from rgqa_tpu_torch.ops.dropout import DropoutRng
from rgqa_tpu_torch.runner import GQARunner
from rgqa_tpu_torch.train import losses, optimizer, step as tstep
from test_torch_slice import ENC, SPEC
from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

N_STEPS = 12
MAX_LEN = 12
ALPHA, BETA = 2.0, 5.0
MODES = ["mixup_v1", "mixup_v2", "mixup_v3", "vis", "perturb", "weighted_sum", "weighted_sum_v2",
         "treemix", "treemix_v1", "treemix_v2"]


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("strategies") / "gqa")
    make_synthetic_gqa(path, SyntheticSpec(**SPEC))
    return path


def _encoded(root, split="train,train_uq", keep_uq_target=False, backbone="lxmert", jax_side=False):
    if jax_side:
        from rgqa_tpu.data import GQADataset, PackedFeatures, WordPieceTokenizer
        from rgqa_tpu.data.dataset import EncodedGQA
        from rgqa_tpu.data.tokenizer import load_vocab

        tok = WordPieceTokenizer(load_vocab(os.path.join(root, "vocab.txt")))
        return EncodedGQA(GQADataset(root, split, add_uq=True), PackedFeatures(os.path.join(root, "features")),
                          tokenizer=tok, max_text_len=MAX_LEN, backbone=backbone,
                          keep_uq_target=keep_uq_target)
    tok = tokenizer.WordPieceTokenizer(tokenizer.load_vocab(os.path.join(root, "vocab.txt")))
    return dataset.EncodedGQA(dataset.GQADataset(root, split, add_uq=True),
                              tsv.PackedFeatures(os.path.join(root, "features")), tokenizer=tok,
                              max_text_len=MAX_LEN, backbone=backbone, keep_uq_target=keep_uq_target)


def _tensors(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _jnp(jax, batch):
    return {k: jax.numpy.asarray(v) for k, v in batch.items()}


def _jax_draws(jax, key, mode, b, n, k, alpha=ALPHA, beta=BETA) -> dict:
    """The draws JAX ``mixup_augment(batch, key, ...)`` makes, from the
    same key splits, as the port's ``draw_mixup`` returns them."""
    jr = jax.random

    def t(x):
        return torch.from_numpy(np.array(x))

    if mode == "treemix_both":
        coin_rng, aug = jr.split(key)
        coin = bool(jr.bernoulli(coin_rng))
        return {"coin": coin, **_jax_draws(jax, aug, "treemix_v2" if coin else "mixup_v2", b, n, k, alpha, beta)}
    if mode.startswith("treemix"):
        prop_rng, pos_rng, roll_rng, pick_a, pick_p = jr.split(key, 5)
        draws = {"prop": t(jr.beta(prop_rng, alpha, beta, (b,))), "pos_u": t(jr.uniform(pos_rng, (b,))),
                 "shift": int(jr.randint(roll_rng, (), 1, b))}
        if k:
            draws["gumbel_a"], draws["gumbel_p"] = t(jr.gumbel(pick_a, (b, k))), t(jr.gumbel(pick_p, (b, k)))
        return draws
    if mode == "perturb":
        perm_rng, _ = jr.split(key)
        return {"perm": t(jr.permutation(perm_rng, n))}
    if mode.startswith("weighted_sum"):
        prop_rng, roll_rng = jr.split(key)
        return {"prop": t(jr.beta(prop_rng, alpha, beta, (b, 1, 1))).reshape(b),
                "shift": int(jr.randint(roll_rng, (), 1, b))}
    prop_rng, sub_rng, roll_rng = jr.split(key, 3)
    return {"prop": t(jr.beta(prop_rng, alpha, beta, (b,))), "u": t(jr.uniform(sub_rng, (b, n))),
            "shift": int(jr.randint(roll_rng, (), 1, b))}


def _batch_dims(batch):
    text = batch.get("input_ids", batch.get("token_ids"))
    spans = batch.get("parse_spans")
    return text.shape[0], batch["feats"].shape[1], 0 if spans is None else spans.shape[1]


def _assert_same(got, want, *, blend_rtol=0.0):
    assert got.keys() == want.keys()
    for k in want:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape, k
        assert got[k].numpy().dtype == w.dtype, k
        if k == "feats" and blend_rtol:
            np.testing.assert_allclose(got[k].numpy(), w, rtol=blend_rtol, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)


def _apply_both(jax, batch, key, mode, **kw):
    from rgqa_tpu.train.step import mixup_augment as jax_mixup

    want = jax_mixup(_jnp(jax, batch), key, ALPHA, BETA, mode, **kw)
    draws = _jax_draws(jax, key, mode, *_batch_dims(batch))
    got = tstep.mixup_apply(_tensors(batch), draws, mode, **kw)
    return got, want, draws


# ---------------------------------------------------------------------------
# The losses.
# ---------------------------------------------------------------------------


def _loss_inputs(seed, b=9, a=17):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((b, a)) * 3).astype(np.float32)
    target = np.zeros((b, a), np.float32)
    target[np.arange(b), rng.integers(0, a, b)] = rng.random(b, dtype=np.float32)
    target[0] = 0.0  # a pseudo-UQ row: the argmax of zeros is answer 0
    target[1, :3] = 0.5  # tied maxima: the first wins
    id_mask = (rng.random(b) > 0.4).astype(np.float32)
    conf = rng.standard_normal(b).astype(np.float32)
    return logits, target, id_mask, conf


@pytest.mark.parametrize("seed", [0, 1])
def test_losses_match_jax(jax, seed):
    from rgqa_tpu.train import losses as jl

    logits, target, id_mask, conf = _loss_inputs(seed)
    jn = jax.numpy
    tl, tt, tm, tc = (torch.from_numpy(x) for x in (logits, target, id_mask, conf))
    cases = {
        "mce": (losses.mce_answer_loss(tl, tt), jl.mce_answer_loss(jn.asarray(logits), jn.asarray(target))),
        "mce_masked": (losses.mce_answer_loss(tl, tt, row_mask=tm),
                       jl.mce_answer_loss(jn.asarray(logits), jn.asarray(target), row_mask=jn.asarray(id_mask))),
    }
    for mce in (False, True):
        cases[f"energy_of_logits_{mce}"] = (losses.energy_of_logits(tl, mce=mce),
                                            jl.energy_of_logits(jn.asarray(logits), mce=mce))
        # Margins at which both hinges are active on these logits.
        for m_in, m_out in ((-6.0, 0.0), (25.0, -2.0)):
            cases[f"energy_{mce}_{m_in}"] = (
                losses.energy_regularizer(tl, tm, m_in, m_out, mce=mce),
                jl.energy_regularizer(jn.asarray(logits), jn.asarray(id_mask), m_in, m_out, mce=mce))
        cases[f"branched_{mce}"] = (
            losses.branched_loss(tl, tc, tt, tm, mce=mce),
            jl.branched_loss(jn.asarray(logits), jn.asarray(conf), jn.asarray(target), jn.asarray(id_mask),
                             mce=mce))
    for name, (got, want) in cases.items():
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0, err_msg=name)
    assert float(cases["energy_True_-6.0"][0]) > 0 and float(cases["energy_False_25.0"][0]) > 0


# ---------------------------------------------------------------------------
# The encoded split: TreeMix spans and UQ targets.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("keep_uq_target", [False, True])
def test_encoded_spans_and_uq_targets_match_jax(jax, root, keep_uq_target):
    port = _encoded(root, keep_uq_target=keep_uq_target)
    ref = _encoded(root, keep_uq_target=keep_uq_target, jax_side=True)
    for name in ("parse_spans", "parse_span_words", "parse_n_words"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name), err_msg=name)
    assert (port.parse_n_words > 0).sum() >= 8  # the train rows' parses are usable
    idx = np.arange(len(port))
    got, want = port.gather_batch(idx, with_target=True), ref.gather_batch(idx, with_target=True)
    assert got.keys() == want.keys() >= {"parse_spans", "target", "id_mask"}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["target"].shape[1] == port.num_answers - (0 if keep_uq_target else 1)
    # BUTD and the caption branch carry no spans; a split without parses neither.
    assert _encoded(root, "testdev").parse_spans is None


# ---------------------------------------------------------------------------
# The augmentations, given JAX's draws.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def batches(root):
    """A batch with spans and one with UQ targets kept, 8 rows each."""
    idx = np.array([0, 3, 5, 7, 9, 11, 13, 17])
    plain = _encoded(root).gather_batch(idx, with_target=True)
    uq = _encoded(root, keep_uq_target=True).gather_batch(np.array([0, 2, 4, 6, 8, 16, 17, 18]), with_target=True)
    assert uq["target"][:, -1].any() and not uq["target"][:, -1].all()
    return plain, uq


@pytest.mark.parametrize("mode", MODES)
def test_mixup_apply_matches_jax(jax, batches, mode):
    for seed in (0, 1):
        got, want, _ = _apply_both(jax, batches[0], jax.random.PRNGKey(seed), mode)
        _assert_same(got, want, blend_rtol=1e-6 if mode.startswith("weighted_sum") else 0.0)
        assert got["target"].shape[0] == 16 and not got["id_mask"][8:].any()


def _coin_keys(jax, want_sides=(True, False)):
    """Keys whose ``treemix_both`` coin comes up each way."""
    found = {}
    for seed in range(64):
        key = jax.random.PRNGKey(seed)
        coin = bool(jax.random.bernoulli(jax.random.split(key)[0]))
        found.setdefault(coin, key)
        if set(found) == set(want_sides):
            return [found[s] for s in want_sides]
    raise AssertionError("no key for each side of the coin")


@pytest.mark.parametrize("uq_as_class", [False, True])
def test_treemix_both_matches_jax_on_both_sides_of_the_coin(jax, batches, uq_as_class):
    batch = batches[1] if uq_as_class else batches[0]
    for side, key in zip((True, False), _coin_keys(jax)):
        got, want, draws = _apply_both(jax, batch, key, "treemix_both", uq_as_class=uq_as_class)
        assert draws["coin"] is side
        _assert_same(got, want)


@pytest.mark.parametrize("mode", ["mixup_v1", "mixup_v2", "mixup_v3", "vis"])
def test_uq_as_class_targets_match_jax(jax, batches, mode):
    got, want, _ = _apply_both(jax, batches[1], jax.random.PRNGKey(4), mode, uq_as_class=True)
    _assert_same(got, want)
    pet = got["target"][8:]
    assert torch.all(pet[:, -1] > 0)  # every appended row carries UQ mass


@pytest.mark.parametrize("mode", ["treemix_v1", "treemix_v2"])
def test_treemix_window_fallback_matches_jax(jax, batches, mode):
    # Without spans (a split with no parses), and on BUTD's front-padded
    # token_ids (no input_mask), the splice is the Beta-wide window.
    batch = {k: v for k, v in batches[0].items() if not k.startswith("parse_")}
    got, want, _ = _apply_both(jax, batch, jax.random.PRNGKey(2), mode)
    _assert_same(got, want)
    butd = {k: v for k, v in batch.items() if k not in ("input_ids", "input_mask", "segment_ids")}
    butd["token_ids"] = np.random.default_rng(1).integers(0, 50, (8, 14)).astype(np.int32)
    got, want, _ = _apply_both(jax, butd, jax.random.PRNGKey(3), mode)
    _assert_same(got, want)
    assert not torch.equal(got["token_ids"][8:], got["token_ids"][:8])


def test_treemix_on_uniter_keeps_text_and_roi_positions_apart(root):
    # UNITER's stream is [text (20, padded mid-stream) | 36 RoIs]: the
    # splice touches the text fields only, its input_mask stays a prefix
    # of the text positions, and the RoI fields are the anchors'.
    enc = _encoded(root, backbone="uniter")
    batch = _tensors(enc.gather_batch(np.arange(8), with_target=True))
    draws = tstep.draw_mixup(batch, "treemix_v2", ALPHA, BETA, torch.Generator().manual_seed(5))
    out = tstep.mixup_apply(batch, draws, "treemix_v2")
    mask = out["input_mask"][8:]
    assert torch.equal(mask, torch.sort(mask, dim=1, descending=True).values)  # a prefix mask
    assert not torch.equal(out["input_ids"][8:], batch["input_ids"])
    for k in ("feats", "boxes"):
        assert torch.equal(out[k][8:], batch[k]) and out[k].shape[-1] == batch[k].shape[-1]
    assert batch["boxes"].shape[-1] == 7
    cfg = ModelConfig(backbone="uniter", encoder=EncoderConfig(**dict(ENC, num_layers=1)), num_answers=5,
                      max_text_len=MAX_LEN)
    model, forward = build_model(cfg, device="cpu")
    with torch.no_grad():
        logits = forward(out)["logits"]
    assert logits.shape == (16, 5) and torch.isfinite(logits).all()


def test_tied_uniforms_keep_the_stable_argsort_subset(jax, batches):
    from rgqa_tpu.train.step import mixup_augment as jax_mixup

    batch = batches[0]
    key = jax.random.PRNGKey(6)
    draws = _jax_draws(jax, key, "mixup_v1", *_batch_dims(batch))
    u = torch.floor(draws["u"] * 3) / 3  # three values: ties in every row
    draws["u"] = u
    with pytest.MonkeyPatch.context() as mp:  # JAX's step draws the same tied uniforms
        mp.setattr(jax.random, "uniform", lambda *a, **kw: jax.numpy.asarray(u.numpy()))
        want = jax_mixup(_jnp(jax, batch), key, ALPHA, BETA, "mixup_v1")
    got = tstep.mixup_apply(_tensors(batch), draws, "mixup_v1")
    _assert_same(got, want)


def test_draw_mixup_draws_on_the_host_and_reproduces(batches):
    batch = _tensors(batches[0])
    for mode in MODES + ["treemix_both"]:
        host = torch.Generator().manual_seed(3)
        a = tstep.draw_mixup(batch, mode, ALPHA, BETA, host)
        b = tstep.draw_mixup(batch, mode, ALPHA, BETA, torch.Generator().manual_seed(3))
        assert a.keys() == b.keys()
        for k in a:
            assert (torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor) else a[k] == b[k]), (mode, k)
            if isinstance(a[k], torch.Tensor):
                assert a[k].device.type == "cpu"
        if mode.startswith("treemix") and "coin" not in a:
            assert a["gumbel_a"].shape == (8, batch["parse_spans"].shape[1])
        out = tstep.mixup_apply(batch, a, mode)
        assert out["target"].shape[0] == 16
    prop = tstep.draw_mixup(batch, "mixup_v1", 1.0, 5.0, torch.Generator().manual_seed(0))["prop"]
    assert prop.dtype == torch.float32 and 0 < float(prop.mean()) < 0.5  # Beta(1, 5) has mean 1/6


# ---------------------------------------------------------------------------
# The 12-step trajectories.
# ---------------------------------------------------------------------------


TRAJECTORIES = {
    "mixup_v1": dict(step=dict(mixup_mode="mixup_v1", mixup_alpha=1.0, mixup_beta=5.0)),
    "treemix_v2": dict(step=dict(mixup_mode="treemix_v2", mixup_alpha=1.0, mixup_beta=1.0)),
    "branched": dict(step=dict(branched=True), model=dict(branched=True)),
    "branched_layer": dict(step=dict(branched=True), model=dict(branched_layers=True)),
    # Margins at which both hinges bite on a random init's logits.
    "energy_mce": dict(step=dict(loss="mce", energy=True, m_in=-6.0, m_out=0.0)),
    "uq_as_class": dict(step=dict(mixup_mode="mixup_v1", mixup_alpha=1.0, mixup_beta=5.0, uq_as_class=True),
                        keep_uq=True),
}


@pytest.mark.parametrize("case", list(TRAJECTORIES))
def test_twelve_step_trajectory_matches_jax(jax, root, case):
    from rgqa_tpu.config import OptimConfig as JaxOptimConfig
    from rgqa_tpu.models.zoo import build_model as jax_build_model
    from rgqa_tpu.train import create_train_state, make_optimizer as jax_make_optimizer
    from rgqa_tpu.train import make_train_step as jax_make_train_step

    spec = TRAJECTORIES[case]
    kw = spec["step"]
    enc = _encoded(root, keep_uq_target=spec.get("keep_uq", False))
    answers = enc.num_answers - (0 if spec.get("keep_uq") else 1)
    enc_cfg = EncoderConfig(**ENC, hidden_dropout=0.0, attention_dropout=0.0)
    cfg = ModelConfig(backbone="lxmert", encoder=enc_cfg, num_answers=answers,
                      max_text_len=MAX_LEN, **spec.get("model", {}))
    b, lr = 6, 2e-3
    rng = np.random.default_rng(7)
    batches = [enc.gather_batch(rng.choice(len(enc), b, replace=False), with_target=True)
               for _ in range(N_STEPS)]
    jmodel, jforward = jax_build_model(cfg)
    args = [batches[0][k] for k in ("input_ids", "input_mask", "segment_ids", "feats", "boxes")]
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0), *args)["params"])

    state = create_train_state(params, jax_make_optimizer(JaxOptimConfig(lr=lr), N_STEPS))
    jstep = jax_make_train_step(jforward, grad_clip=5.0, donate=False, **kw)
    key = jax.random.PRNGKey(0)
    jax_losses, draws = [], []
    for batch in batches:
        key, sub = jax.random.split(key)
        _, aug = jax.random.split(sub)
        draws.append(_jax_draws(jax, aug, kw["mixup_mode"], *_batch_dims(batch), kw["mixup_alpha"],
                                kw["mixup_beta"]) if "mixup_mode" in kw else None)
        state, aux = jstep(state, _jnp(jax, batch), sub)
        jax_losses.append(float(aux["loss"]))

    model, forward = build_model(cfg, device="cpu", train=True)
    model.load_state_dict(from_jax_params(params), strict=True)
    opt = optimizer.make_optimizer(OptimConfig(lr=lr), model.parameters(), t_total=N_STEPS)
    step = tstep.make_train_step(forward, opt, grad_clip=5.0, rng=DropoutRng(), **kw)
    port_losses = [step(_tensors(batch), draws=d)["loss"].item() for batch, d in zip(batches, draws)]

    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-4)
    assert port_losses[0] != port_losses[-1]  # the weights moved


# ---------------------------------------------------------------------------
# The train CLI with each new flag.
# ---------------------------------------------------------------------------


TINY = ["--fp32", "--llayers", "1", "--xlayers", "1", "--rlayers", "1", "--hidden_size", "32",
        "--num_heads", "4"]
CLI_CASES = {
    "mixup_v1": ["--mixup_mode", "mixup_v1", "--mixup_beta", "5", *TINY],
    "treemix_both": ["--mixup_mode", "treemix_both", *TINY],
    "branched": ["--branched", *TINY],
    "branched_layer": ["--branched_layer", *TINY],
    "energy_mce": ["--scorer", "energy", "--m_in", "25", "--m_out", "0", "--mceLoss", *TINY],
    # scripts/lxmert/train/ood_trainonly.sh's flags, with --chart.
    "uq_as_class_chart": ["--uq_as_class", "--chart", "--train", "GQAUQ_train_questions_unsup,valid", *TINY],
    "uniter_mixup": ["--backbone", "uniter", "--mixup_mode", "mixup_v1", "--mixup_beta", "5", "--fp32",
                     "--num_layers", "1", "--hidden_size", "32", "--num_heads", "4"],
    "butd_mixup": ["--backbone", "butd", "--mixup_mode", "mixup_v1", "--mixup_beta", "5"],
}


@pytest.fixture(scope="module")
def cli_root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("strategies_cli") / "gqa")
    make_synthetic_gqa(path)
    return path


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_train_cli_writes_a_best_pth_that_loads_back(cli_root, tmp_path, case):
    from rgqa_tpu_torch.cli import train

    out = str(tmp_path / "snap")
    # A learning rate at which every case's validation accuracy rises
    # above zero (BEST.pth is written on a better one).
    argv = ["--synthetic", "--data_root", cli_root, "--epochs", "2", "--batchSize", "32", "--lr", "3e-3",
            "--device", "cpu", "--output", out, *CLI_CASES[case]]
    history = train.main(argv)
    assert len(history["loss"]) == 2 and np.isfinite(history["loss"]).all()
    assert os.path.isfile(os.path.join(out, "BEST.pth")), history
    cfg, _ = parse_cli(argv)
    runner = GQARunner(cfg, init_train=False, device="cpu")
    enc = runner.model_cfg.encoder
    _, missing, unused = load_reference_pth(
        os.path.join(out, "BEST.pth"), backbone=runner.model_cfg.backbone, l_layers=enc.l_layers,
        x_layers=enc.x_layers, r_layers=enc.r_layers, num_layers=enc.num_layers,
        branched=runner.model_cfg.branched)
    assert not missing and not unused
    assert runner.load(os.path.join(out, "BEST.pth")) == []
    if case == "uq_as_class_chart":
        # The UQ answer is a class of the head, and each epoch's chart
        # holds every trained question: (score, gold label, answer).
        raw = torch.load(os.path.join(out, "BEST.pth"), map_location="cpu", weights_only=True)
        assert raw["logit_fc.3.weight"].shape[0] == runner.dataset.num_answers
        for epoch in (0, 1):
            with open(os.path.join(out, "chart", f"epoch_{epoch}.pkl"), "rb") as f:
                chart = pickle.load(f)
            ds = dataset.GQADataset(cli_root, "GQAUQ_train_questions_unsup,valid", add_uq=True)
            assert len(chart) == len(ds) // 32 * 32
            for qid, (score, label, answer) in chart.items():
                assert 0.0 <= score <= 1.0 and label == ds.id2datum[qid]["label"]
                assert answer in ds.label2ans
    else:
        assert not os.path.isdir(os.path.join(out, "chart"))


def test_runner_wires_the_strategy_flags(cli_root, tmp_path):
    # The step the runner builds takes the flags as JAX runner.py:621-640:
    # the energy hinge only under --scorer energy with --m_in nonzero.
    argv = ["--synthetic", "--data_root", cli_root, "--device", "cpu", "--output", str(tmp_path), *TINY]
    seen = {}

    def spy(*a, **kw):
        seen.update(kw)
        raise StopIteration

    for flags, want in [
        (["--scorer", "energy", "--m_in", "25"], dict(energy=True, m_in=25.0, loss="bce")),
        (["--scorer", "energy", "--m_in", "0"], dict(energy=False)),
        (["--m_in", "25"], dict(energy=False)),
        (["--mceLoss", "--branched_layer"], dict(loss="mce", branched=True)),
        (["--mixup_mode", "weighted_sum", "--mixup_alpha", "2", "--lam1", "0.6", "--lam2", "0.1",
          "--uq_as_class"], dict(mixup_mode="weighted_sum", mixup_alpha=2.0, lam1=0.6, lam2=0.1,
                                 uq_as_class=True)),
    ]:
        cfg, _ = parse_cli(argv + flags)
        runner = GQARunner(cfg, device="cpu")
        seen.clear()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr("rgqa_tpu_torch.runner.make_train_step", spy)
            with pytest.raises(StopIteration):
                runner.train()
        assert {k: seen[k] for k in want} == want, flags
    assert runner.model_cfg.num_answers == runner.dataset.num_answers  # --uq_as_class: UQ is a class
