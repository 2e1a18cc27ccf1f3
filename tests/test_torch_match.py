"""The LXMERT match scorer on the CPU: the port's pretraining heads,
``model_LXRT.pth`` loader, ``match_ood_evaluate`` and ``--scorer match``
against the JAX package's, on the same weights.

One random pretraining checkpoint in the reference layout (``bert.*``,
``cls.*`` with the tied decoder weight, ``obj_predict_head.*``,
``answer_head.logit_fc.*``) is written from the port's seeded init at
the tiny width of ``tests/test_torch_slice.py`` (its LayerNorm
parameters moved off the init, its encoder's products and matched head
scaled up so the match probabilities spread); the JAX package reads it through
``import_lxmert_pretraining``.  Bounds: f32, rtol 2e-4 / atol 2e-5 on
every output of the forward (``matched``, ``qa``, ``mlm``, ``visn``,
``pooled``); equal answers and confidences within 1e-5 (1e-4 through the
4-dp prediction JSON) for the scoring path, whose answers come from a
tiny GQA answerer loaded from a ``.pth`` on both sides.

Also: the key-map copy equals its original; ``from_jax_params`` of the
JAX tree and the ``.pth`` loader give the same weights; the checkpoint
loads back with no key missing or unused; under ``--bf16`` the scores
take the JAX feed's bf16-rounded feats; ``make_match_scorer`` with an
answerer labels from its logits, as the JAX one; and the refusals (an orbax
``--loadLXMERT`` directory, a checkpoint with a missing key, ``--scorer
match`` without ``--loadLXMERT`` or without ``--load``, and ``--scorer
clip`` / ``match`` / ``frcnn`` in the serve CLI).  ``--scorer match``
runs in a subprocess with jax and the JAX package blocked.
"""

from __future__ import annotations

import io
import json

import numpy as np
import pytest
import torch

from rgqa_tpu_torch import config as port_config
from rgqa_tpu_torch.checkpoint import torch_import as port_import
from rgqa_tpu_torch.checkpoint.convert import from_jax_params, load_reference_pth, to_reference_state_dict
from rgqa_tpu_torch.cli import evaluate, serve
from rgqa_tpu_torch.data.dataset import GQADataset
from rgqa_tpu_torch.data.synthetic import SyntheticSpec, make_synthetic_gqa
from rgqa_tpu_torch.models.lxmert import LxmertPretraining
from rgqa_tpu_torch.models.zoo import example_batch, init_weights, load_pretraining
from rgqa_tpu_torch.runner import GQARunner

from test_torch_slice import CLI_SPEC, ENC, SPEC, TINY_FLAGS
from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

RTOL, ATOL = 2e-4, 2e-5
CONF_ATOL = 1e-5
LAYERS = dict(l_layers=1, x_layers=1, r_layers=1)


def write_pretraining_pth(path, enc: port_config.EncoderConfig, seed=0) -> str:
    """A reference ``model_LXRT.pth`` from the port's seeded init."""
    model = LxmertPretraining(enc)
    gen = torch.Generator().manual_seed(seed)
    init_weights(model, gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "LayerNorm" in name or "_ln" in name or "layer_norm" in name or name.endswith("logit_fc.2.weight"):
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
            if name.startswith("lxmert.") and name.endswith("weight") and p.dim() == 2 and "embeddings" not in name:
                p.mul_(10.0)  # pooled features that depend on the input (see _varied)
        model.cls.seq_relationship.weight.mul_(5.0)
        model.cls.predictions.bias.normal_(generator=gen)
    torch.save(to_reference_state_dict(model.state_dict(), backbone="lxmert_pretrain", l_layers=enc.l_layers,
                                       x_layers=enc.x_layers, r_layers=enc.r_layers), path)
    return str(path)


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """(the .pth, the JAX model, its params) at the tiny width."""
    pytest.importorskip("jax")
    import jax

    from rgqa_tpu.checkpoint import import_lxmert_pretraining
    from rgqa_tpu.config import EncoderConfig as JaxEncoderConfig
    from rgqa_tpu.models.lxmert import LxmertPretraining as JaxPretraining

    path = write_pretraining_pth(tmp_path_factory.mktemp("pretrain") / "model_LXRT.pth",
                                 port_config.EncoderConfig(**ENC))
    jmodel = JaxPretraining(JaxEncoderConfig(**ENC))
    batch = example_batch(port_config.ModelConfig(encoder=port_config.EncoderConfig(**ENC), max_text_len=12), 2)
    shapes = jax.eval_shape(lambda *a: jmodel.init(jax.random.PRNGKey(0), *a), batch["input_ids"],
                            batch["input_mask"], batch["segment_ids"], batch["feats"], batch["boxes"])["params"]
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    params, missing, unused = import_lxmert_pretraining(template, path, **LAYERS)
    assert not missing and not unused
    return path, jmodel, params


@pytest.mark.parametrize("layers", [(9, 5, 5), (1, 1, 1), (2, 3, 4)])
def test_pretrain_key_map_copy_matches_the_original(layers):
    from rgqa_tpu.checkpoint import torch_import as jax_import

    assert port_import.lxmert_pretrain_key_map(*layers) == jax_import.lxmert_pretrain_key_map(*layers)


def test_checkpoint_loads_whole_and_equals_from_jax_params(pretrained):
    path, _, params = pretrained
    raw = torch.load(path, weights_only=True)
    assert "cls.predictions.decoder.weight" in raw and "bert.encoder.x_layers.0.visn_self_att.self.query.weight" in raw
    sd, missing, unused = load_reference_pth(path, backbone="lxmert_pretrain", **LAYERS)
    assert missing == [] and unused == []
    want = LxmertPretraining(port_config.EncoderConfig(**ENC)).state_dict()
    assert sd.keys() == want.keys()
    assert {"cls.seq_relationship.weight", "cls.predictions.bias", "obj_predict_head.decoder_dict.attr.weight",
            "answer_head.logit_fc.3.bias", "lxmert.x_layers.0.cross_att.query.weight"} <= sd.keys()
    got = from_jax_params(params, "lxmert_pretrain")
    assert from_jax_params(params).keys() == got.keys()  # the tree names itself
    assert got.keys() == sd.keys()
    for key in sd:
        torch.testing.assert_close(got[key], sd[key], rtol=0, atol=0, msg=key)
    # Written back, the reference file again (the tied decoder from the word table).
    back = to_reference_state_dict(sd, backbone="lxmert_pretrain", **LAYERS)
    assert back.keys() == raw.keys()
    for key in raw:
        torch.testing.assert_close(back[key], raw[key], rtol=0, atol=0, msg=key)


def test_pretraining_forward_matches_jax(pretrained):
    path, jmodel, params = pretrained
    model, forward = load_pretraining(path, port_config.EncoderConfig(**ENC), device="cpu")
    batch = example_batch(port_config.ModelConfig(encoder=port_config.EncoderConfig(**ENC), max_text_len=12), 6,
                          seed=3)
    batch["input_mask"][:, 7:] = 0  # padded text
    batch["input_mask"][2, 4:] = 0
    want = jmodel.apply({"params": params}, batch["input_ids"], batch["input_mask"], batch["segment_ids"],
                        batch["feats"], batch["boxes"])
    with torch.no_grad():
        got = forward({k: torch.from_numpy(v) for k, v in batch.items()}, deterministic=True)
    for key in ("matched", "qa", "mlm", "pooled"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=RTOL, atol=ATOL, err_msg=key)
    for key in ("obj", "attr", "feat"):
        np.testing.assert_allclose(got["visn"][key].numpy(), np.asarray(want["visn"][key]), rtol=RTOL,
                                   atol=ATOL, err_msg=key)
    with torch.no_grad():
        score = model.match_score(*(torch.from_numpy(batch[k]) for k in
                                    ("input_ids", "input_mask", "segment_ids", "feats", "boxes")))
    want_score = jmodel.apply({"params": params}, batch["input_ids"], batch["input_mask"], batch["segment_ids"],
                              batch["feats"], batch["boxes"], method=type(jmodel).match_score)
    np.testing.assert_allclose(score.numpy(), np.asarray(want_score), rtol=RTOL, atol=ATOL)
    assert 0.01 < float(score.min()) and float(score.max()) < 0.99 and float(score.std()) > 1e-2
    assert not model.training


# ---------------------------------------------------------------------------
# The scoring path.
# ---------------------------------------------------------------------------


def _cfg(root, out, config=None, *, bf16=False, **kw):
    c = config or port_config
    return c.RunConfig(
        model=c.ModelConfig(backbone="lxmert", encoder=c.EncoderConfig(**ENC), max_text_len=12),
        train=c.TrainConfig(batch_size=16, use_bf16=bf16, seed=11),
        ood=c.OODConfig(scorer="match"),
        data=c.DataConfig(data_root=root, test_splits="testdev", synthetic=True),
        output=out,
        **kw,
    )


@pytest.fixture(scope="module")
def env(tmp_path_factory, pretrained):
    """A synthetic root, a GQA answerer's ``.pth`` from a JAX runner, and
    runner pairs loaded with it."""
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.runner import GQARunner as JaxRunner
    from rgqa_tpu.runner import np_params

    from test_torch_scoring_slice import _pth, _spread

    tmp = tmp_path_factory.mktemp("match")
    root = str(tmp / "gqa")
    make_synthetic_gqa(root, SyntheticSpec(**SPEC))
    seed_runner = JaxRunner(_cfg(root, str(tmp / "seed"), jax_config), init_train=False)
    gqa = _pth(tmp, "gqa", _spread(np_params(seed_runner.params)))

    def runners(bf16):
        tag = "bf16" if bf16 else "f32"
        kw = dict(bf16=bf16, load=gqa, load_lxmert=pretrained[0])
        return (JaxRunner(_cfg(root, str(tmp / f"jax_{tag}"), jax_config, **kw), init_train=False),
                GQARunner(_cfg(root, str(tmp / f"port_{tag}"), **kw), init_train=False, device="cpu"))

    return root, tmp, gqa, runners


def _jax_match(jax_runner, root, params, dump):
    from rgqa_tpu.data import GQADataset as JaxDataset

    return jax_runner.match_ood_evaluate(jax_runner._encode(JaxDataset(root, "testdev", add_uq=True)), params,
                                         dump=dump)


def _rows(path):
    with open(path) as f:
        return {r["questionId"]: (r["prediction"], r["confidence"]) for r in json.load(f)}


def test_match_ood_evaluate_matches_the_jax_runner(env, pretrained):
    root, tmp, _, runners = env
    path, _, params = pretrained
    jax_runner, runner = runners(bf16=False)
    want = _jax_match(jax_runner, root, params, str(tmp / "jax.json"))
    _, forward = load_pretraining(path, runner.model_cfg.encoder, device="cpu")
    got = runner.match_ood_evaluate(runner._encode(GQADataset(root, "testdev", add_uq=True)), forward,
                                    dump=str(tmp / "port.json"))
    assert got.keys() == want.keys() and {"auaf", "fpr@0.95acc", "full_acc"} <= got.keys()
    prows, jrows = _rows(tmp / "port.json"), _rows(tmp / "jax.json")
    assert list(prows) == list(jrows) and len(prows) == SPEC["n_testdev"]
    assert {q: a for q, (a, _) in prows.items()} == {q: a for q, (a, _) in jrows.items()}
    np.testing.assert_allclose([c for _, c in prows.values()], [c for _, c in jrows.values()], atol=1e-4)
    assert len({c for _, c in prows.values()}) > 5
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-12, err_msg=key)


def test_match_scores_take_the_bf16_feed(env, pretrained):
    """Under ``--bf16`` the JAX feed hands the f32 pretraining model
    bf16-rounded feats; the port rounds them likewise.  The answerer's
    bf16 answers are not compared here (the packages round a bf16 model
    at other places); the f32 match scores are, at full precision."""
    from rgqa_tpu.data import GQADataset as JaxDataset
    from rgqa_tpu.scorers import make_match_scorer as jax_make_match_scorer
    from rgqa_tpu_torch.scorers import make_match_scorer

    root, tmp, _, runners = env
    path, jmodel, params = pretrained
    jax_runner, runner = runners(bf16=True)
    jforward = lambda p, batch, deterministic=True: jmodel.apply(  # noqa: E731
        {"params": p}, batch["input_ids"], batch["input_mask"], batch["segment_ids"], batch["feats"],
        batch["boxes"])
    jstep = jax_make_match_scorer(jforward)
    want = []
    for _, out, real in jax_runner._map_eval(jax_runner._encode(JaxDataset(root, "testdev", add_uq=True)),
                                             lambda p, b: jstep((p, None), b), params=params):
        want.append(np.asarray(out["score"])[:real])
    _, forward = load_pretraining(path, runner.model_cfg.encoder, device="cpu")
    got = [out["score"][:real] for _, out, real in
           runner._map_eval(runner._encode(GQADataset(root, "testdev", add_uq=True)), make_match_scorer(forward),
                            ("score",))]
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(want), rtol=0, atol=CONF_ATOL)
    exact = [out["score"][:real] for _, out, real in
             runner._map_eval(runner._encode(GQADataset(root, "testdev", add_uq=True)),
                              lambda b: make_match_scorer(forward)(b), ("score",))]
    assert not np.array_equal(np.concatenate(exact), np.concatenate(got))  # the rounding is seen


def test_match_scorer_with_an_answerer_matches_jax(env, pretrained):
    """``make_match_scorer(forward, answer_forward)``: the labels from the
    answerer's logits, the score from the matched head, on one batch."""
    from rgqa_tpu.data import GQADataset as JaxDataset
    from rgqa_tpu.data import batch_iterator as jax_batches
    from rgqa_tpu.scorers import make_match_scorer as jax_make_match_scorer
    from rgqa_tpu_torch.data.batching import batch_iterator
    from rgqa_tpu_torch.scorers import make_match_scorer

    root, _, _, runners = env
    path, jmodel, params = pretrained
    jax_runner, runner = runners(bf16=False)
    jforward = lambda p, batch, deterministic=True: jmodel.apply(  # noqa: E731
        {"params": p}, batch["input_ids"], batch["input_mask"], batch["segment_ids"], batch["feats"],
        batch["boxes"])
    _, jbatch, _ = next(iter(jax_batches(jax_runner._encode(JaxDataset(root, "testdev", add_uq=True)), 16)))
    want = jax_make_match_scorer(jforward, jax_runner.forward)((params, jax_runner.params), jbatch)
    _, batch, _ = next(iter(batch_iterator(runner._encode(GQADataset(root, "testdev", add_uq=True)), 16)))
    _, forward = load_pretraining(path, runner.model_cfg.encoder, device="cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = make_match_scorer(forward, runner.forward)(tbatch)
    np.testing.assert_array_equal(got["label"].numpy(), np.asarray(want["label"]))
    np.testing.assert_allclose(got["score"].numpy(), np.asarray(want["score"]), rtol=0, atol=CONF_ATOL)
    qa = make_match_scorer(forward)(tbatch)  # the labels of the pretraining QA head
    assert not torch.equal(qa["label"], got["label"]) and torch.equal(qa["score"], got["score"])


def test_cli_scorer_match_matches_the_jax_runner(tmp_path, pretrained):
    """``--scorer match`` through the port's evaluate CLI, against the JAX
    runner built by the JAX CLI's parser on the same flags (the JAX CLI
    reads ``--loadLXMERT`` as an orbax snapshot, so its runner is handed
    the imported tree)."""
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.runner import GQARunner as JaxRunner
    from rgqa_tpu.runner import np_params

    from test_torch_scoring_slice import _pth, _spread

    path, _, _ = pretrained
    root = str(tmp_path / "gqa")
    make_synthetic_gqa(root, SyntheticSpec(**CLI_SPEC))
    flags = [f for f in TINY_FLAGS if f not in ("--device", "cpu")]
    base = ["--synthetic", "--data_root", root, "--test", "testdev", *flags]
    cfg, _ = jax_config.parse_cli(base + ["--output", str(tmp_path / "init")])
    gqa = _pth(tmp_path, "gqa", _spread(np_params(JaxRunner(cfg, init_train=False).params)))
    # The CLI's pretraining model is at the CLI's width: 36 x 2048 feats.
    enc = port_config.EncoderConfig(hidden_size=32, num_heads=4, intermediate_size=128, **LAYERS)
    cli_pth = write_pretraining_pth(tmp_path / "cli_LXRT.pth", enc, seed=4)
    argv = base + ["--load", gqa, "--scorer", "match", "--loadLXMERT", cli_pth]
    got = evaluate.main(argv + ["--output", str(tmp_path / "port"), "--device", "cpu"])["testdev"]
    jcfg, _ = jax_config.parse_cli(argv + ["--output", str(tmp_path / "jax")])
    jax_runner = JaxRunner(jcfg, init_train=False)
    assert jax_runner.model_cfg.encoder.intermediate_size == enc.intermediate_size
    import jax

    from rgqa_tpu.checkpoint import import_lxmert_pretraining
    from rgqa_tpu.models.lxmert import LxmertPretraining as JaxPretraining

    jmodel = JaxPretraining(jax_runner.model_cfg.encoder)
    b = example_batch(port_config.ModelConfig(encoder=enc), 1)
    shapes = jax.eval_shape(lambda *a: jmodel.init(jax.random.PRNGKey(0), *a), b["input_ids"], b["input_mask"],
                            b["segment_ids"], b["feats"], b["boxes"])["params"]
    params, missing, _ = import_lxmert_pretraining(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes), cli_pth, **LAYERS)
    assert not missing
    want = _jax_match(jax_runner, root, params, str(tmp_path / "jax.json"))
    prows, jrows = _rows(tmp_path / "port" / "testdev_predict.json"), _rows(tmp_path / "jax.json")
    assert list(prows) == list(jrows) and len(prows) == CLI_SPEC["n_testdev"]
    assert {q: a for q, (a, _) in prows.items()} == {q: a for q, (a, _) in jrows.items()}
    np.testing.assert_allclose([c for _, c in prows.values()], [c for _, c in jrows.values()], atol=1e-4)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-12, err_msg=key)


def test_pretraining_refusals(pretrained, tmp_path):
    path, _, _ = pretrained
    enc = port_config.EncoderConfig(**ENC)
    snapshot = tmp_path / "orbax_snapshot"
    snapshot.mkdir()
    with pytest.raises(NotImplementedError, match="orbax snapshot"):
        load_pretraining(str(snapshot), enc, device="cpu")
    sd = torch.load(path, weights_only=True)
    del sd["cls.seq_relationship.bias"]
    torch.save(sd, tmp_path / "broken.pth")
    with pytest.raises(ValueError, match="missing keys.*seq_relationship"):
        load_pretraining(str(tmp_path / "broken.pth"), enc, device="cpu")


@pytest.mark.parametrize(
    "extra, error, match",
    [
        (["--scorer", "match"], SystemExit, "--scorer match needs --loadLXMERT"),
        # Without --load the JAX runner would initialise the answerer from
        # --loadLXMERT: not ported.
        (["--scorer", "match", "--loadLXMERT", "x.pth"], NotImplementedError, "--loadLXMERT"),
    ],
    ids=["no_loadLXMERT", "no_load"],
)
def test_cli_refuses_by_name(tmp_path, extra, error, match):
    with pytest.raises(error, match=match):
        evaluate.main(["--synthetic", "--data_root", str(tmp_path / "gqa"), "--test", "testdev",
                       "--output", str(tmp_path / "out"), *TINY_FLAGS, *extra])


@pytest.mark.parametrize("scorer", ["clip", "match", "frcnn"])
def test_serve_refuses_what_the_jax_serve_cannot_build(tmp_path, scorer):
    with pytest.raises(SystemExit, match=f"--scorer {scorer} is not served"):
        serve.main(["--synthetic", "--data_root", str(tmp_path / "gqa"), "--test", "testdev", "--output",
                    str(tmp_path / "out"), "--scorer", scorer, *TINY_FLAGS], stdin=io.StringIO(""),
                   stdout=io.StringIO())


def test_training_still_refuses_loadLXMERT(pretrained, tmp_path):
    # --loadLXMERT on a training runner is ported (the pretrained encoder,
    # tests/test_torch_pretrained_init.py); beside --load, --load wins, as
    # in the JAX runner's _load_initial_weights.
    path, _, _ = pretrained
    root = str(tmp_path / "gqa")
    make_synthetic_gqa(root, SyntheticSpec(**SPEC))
    base = GQARunner(_cfg(root, str(tmp_path / "a")), init_train=True, device="cpu")
    with torch.no_grad():
        for p in base.model.parameters():
            p.add_(0.01)
    gqa_pth = base.save("A")
    runner = GQARunner(_cfg(root, str(tmp_path / "out"), load=gqa_pth, load_lxmert=path), init_train=True,
                       device="cpu")
    got, want = runner.model.state_dict(), base.model.state_dict()
    assert got.keys() == want.keys()
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0, msg=key)


def test_scorer_match_runs_with_jax_blocked(tmp_path):
    """The evaluate CLI's ``--scorer match`` in a subprocess with jax,
    flax, orbax and the JAX package blocked, on weights the port writes."""
    from test_torch_port_rules import _run_jax_free

    root = str(tmp_path / "gqa")
    make_synthetic_gqa(root, SyntheticSpec(**CLI_SPEC))
    flags = ["--synthetic", "--data_root", root, "--test", "testdev", *TINY_FLAGS]
    cfg, _ = port_config.parse_cli(flags + ["--output", str(tmp_path / "init")])
    runner = GQARunner(cfg, init_train=False, device="cpu")
    gqa = runner.save("gqa")
    enc = port_config.EncoderConfig(hidden_size=32, num_heads=4, intermediate_size=128, **LAYERS)
    pth = write_pretraining_pth(tmp_path / "model_LXRT.pth", enc, seed=2)
    out = str(tmp_path / "out")
    res = _run_jax_free("cli.evaluate", flags + ["--load", gqa, "--scorer", "match", "--loadLXMERT", pth,
                                                 "--output", out], tmp_path)
    assert {"auaf", "fpr@0.95acc", "full_acc"} <= set(res["keys"])
    assert len(_rows(tmp_path / "out" / "testdev_predict.json")) == CLI_SPEC["n_testdev"]
