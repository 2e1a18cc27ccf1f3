"""Port parity: the rejection scorers of ``rgqa_tpu_torch.scorers``
against ``rgqa_tpu.scorers``, function by function, on the CPU.

A tiny ``LxmertForGQA`` (hidden 32, 4 heads, 1 / 2 / 1 layers, 7
answers; the answer and confidence heads scaled up so the labels are not
near ties) is initialised by the JAX package and loaded into the port
through ``from_jax_params``; both scorers see one numpy batch.  Bounds,
all in f32:

- msp, energy, branched (mix off and on, ``--branched`` and
  ``--branched_layer``), ``ensemble_merge``: labels equal, scores to rtol
  1e-5 (``SCORE_RTOL``).
- ODIN and noised Mahalanobis at T 1000 and noise 1e-2: the perturbed
  feats and boxes equal wherever the port's input gradient is above
  round-off (``GRAD_ROUNDOFF`` of its largest magnitude; where it is
  below, the sign may flip between the two packages' summation orders),
  labels equal, scores within ``ODIN_ATOL`` / ``MAHA_RTOL``.
- ``fit_estimator``'s mean and precision, ``_gaussian_scores``: rtol 1e-5
  (precision 1e-4: a ``pinvh`` of a float32 covariance).
- ``calibrate_tau`` / ``apply_tau``: equal.
- MC-dropout: the vote against the JAX scorer's rule bit for bit, both
  fed the same per-pass labels (drawn from three classes, so ties occur)
  through a stub forward; at dropout 0 label and score equal MSP's; at
  0.1 the passes differ and the score is the mean of their max sigmoid.

The attention backward calls an input gradient makes, and the dropout
forward calls of an MC-dropout pass, are counted here through the plain
versions the CPU runs (the card's launch counts in ``chip_smoke.py``
follow the same rule).
"""

from __future__ import annotations

import collections

import numpy as np
import pytest
import torch

from rgqa_tpu_torch import scorers as port
from rgqa_tpu_torch.checkpoint.convert import from_jax_params
from rgqa_tpu_torch.models.zoo import build_model
from rgqa_tpu_torch.ops import attention as att
from rgqa_tpu_torch.scorers import maha as port_maha
from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

jax = pytest.importorskip("jax")
jnp = jax.numpy

from rgqa_tpu import scorers as ref  # noqa: E402
from rgqa_tpu.config import EncoderConfig, ModelConfig  # noqa: E402
from rgqa_tpu.models.zoo import build_model as jax_build_model, example_batch  # noqa: E402
from rgqa_tpu.scorers import maha as ref_maha  # noqa: E402

SCORE_RTOL = 1e-5
ODIN_ATOL = 1e-6  # sigmoid(logits / 1000): the logits' f32 gap over 4000
MAHA_RTOL = 1e-4  # Gaussian scores ~1e2-1e3 from an f32 precision matrix
GRAD_ROUNDOFF = 1e-4
B = 6


def _cfg(**kw) -> ModelConfig:
    enc = EncoderConfig(
        hidden_size=32, num_heads=4, intermediate_size=64, vocab_size=256, l_layers=1,
        x_layers=2, r_layers=1, num_objects=6, visual_feat_dim=16,
        hidden_dropout=kw.pop("dropout", 0.0), attention_dropout=kw.pop("att_dropout", 0.0),
    )
    return ModelConfig(backbone="lxmert", encoder=enc, num_answers=7, max_text_len=6,
                       project_size=8, **kw)


def _pair(cfg: ModelConfig):
    """(jax forward, jax params, port model, port forward, numpy batch)."""
    model, jax_forward = jax_build_model(cfg)
    batch = example_batch(cfg, batch_size=B, seed=3)
    batch["input_mask"][2:, 4:] = 0
    args = [jnp.asarray(batch[k]) for k in ("input_ids", "input_mask", "segment_ids", "feats", "boxes")]
    params = jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(0), *args)["params"])
    params = jax.tree_util.tree_map(np.array, params)  # writable copies
    # Spread the logits (no near-tie labels) but keep them below ~5: a
    # confident logit rounds the ODIN loss gradient to 0 in f32.
    params["answer_head"]["logits"]["kernel"] *= 10.0
    for head in ("conf_head", "layer_conf"):
        if head in params:
            leaf = params[head]["logits"] if head == "conf_head" else params[head]
            leaf["kernel"] *= 30.0
    port_model, port_forward = build_model(cfg, device="cpu")
    port_model.load_state_dict(from_jax_params(params), strict=True)
    return jax_forward, params, port_model, port_forward, batch


@pytest.fixture(scope="module")
def plain():
    return _pair(_cfg())


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _same(got, want, rtol=SCORE_RTOL, atol=0.0):
    np.testing.assert_array_equal(got["label"].numpy(), np.asarray(want["label"]))
    np.testing.assert_allclose(got["score"].numpy(), np.asarray(want["score"]), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["msp", "energy"])
def test_msp_and_energy_match_jax(plain, name):
    jf, params, _, pf, batch = plain
    want = ref.make_scorer(name, jf)(params, _jb(batch))
    got = port.make_scorer(name, pf)(_tb(batch))
    _same(got, want)
    if name == "msp":
        np.testing.assert_allclose(got["probs"].numpy(), np.asarray(want["probs"]), rtol=SCORE_RTOL)


@pytest.mark.parametrize("head", ["branched", "branched_layers"])
@pytest.mark.parametrize("mix", [False, True], ids=["conf", "mix"])
def test_branched_matches_jax(head, mix):
    jf, params, model, pf, batch = _pair(_cfg(**{head: True}))
    want = ref.make_scorer("branched", jf, mix=mix)(params, _jb(batch))
    got = port.make_scorer("branched", pf, mix=mix)(_tb(batch))
    _same(got, want)
    assert not model.training


@pytest.mark.parametrize("method", ["mean", "multiply", "product"])
def test_ensemble_merge_matches_jax(method):
    rng = np.random.default_rng(4)
    probs = [rng.random((9, 11), dtype=np.float32) for _ in range(3)]
    want = ref.ensemble_merge([jnp.asarray(p) for p in probs], method)
    got = port.ensemble_merge([torch.from_numpy(p) for p in probs], method)
    _same(got, want)
    np.testing.assert_allclose(got["probs"].numpy(), np.asarray(want["probs"]), rtol=SCORE_RTOL)
    with pytest.raises(ValueError, match="unknown ensemble method"):
        port.ensemble_merge([torch.from_numpy(p) for p in probs], "max")


# ---------------------------------------------------------------------------
# Input-gradient scorers: ODIN and noised Mahalanobis.
# ---------------------------------------------------------------------------


def _recording_jax(jf):
    """The JAX forward, keeping the (feats, boxes) of each call in the
    order the program runs them (the rescore pass's last)."""
    seen = []

    def record(feats, boxes):
        seen.append((np.asarray(feats), np.asarray(boxes)))

    def forward(params, batch, **kw):
        jax.debug.callback(record, batch["feats"], batch["boxes"], ordered=True)
        return jf(params, batch, **kw)

    return forward, seen


def _recording_port(pf):
    """The port's forward, keeping each call's (feats, boxes) and the
    gradient that reaches the differentiated ones."""
    seen, grads = [], {}

    def forward(batch, **kw):
        feats, boxes = batch["feats"], batch["boxes"]
        if feats.requires_grad:
            feats.register_hook(lambda g: grads.__setitem__("feats", g.detach().clone()))
            boxes.register_hook(lambda g: grads.__setitem__("boxes", g.detach().clone()))
        else:
            seen.append((feats.detach().numpy().copy(), boxes.detach().numpy().copy()))
        return pf(batch, **kw)

    return forward, seen, grads


def _count_calls(monkeypatch, name):
    calls = collections.Counter()
    fn = getattr(att, name)

    def counted(*a, **k):
        calls[name] += 1
        return fn(*a, **k)

    monkeypatch.setattr(att, name, counted)
    return calls


def _check_perturbation(jax_seen, port_seen, grads, noise):
    """The rescore inputs: equal wherever |g| is above round-off."""
    (jfeats, jboxes), = jax_seen[-1:]
    (pfeats, pboxes), = port_seen[-1:]
    for key, got, want in (("feats", pfeats, jfeats), ("boxes", pboxes, jboxes)):
        g = grads[key].numpy()
        assert np.abs(g).max() > 0, f"no gradient reached {key}"
        differ = got != want
        np.testing.assert_array_equal(np.abs(got - want)[differ] > noise, True)  # a flipped sign
        assert np.all(np.abs(g[differ]) <= GRAD_ROUNDOFF * np.abs(g).max()), key
        assert differ.mean() <= 0.01, f"{key}: {differ.sum()} of {differ.size} elements differ"


# An input gradient runs the backward of every attention on a path from
# the RoI inputs to the pooled output: each vision layer's, each cross
# layer's four but in the last one its vision pair (its output feeds
# nothing pooled): r + 4 (x - 1) + 2.
def _bwd_calls(cfg) -> int:
    e = cfg.encoder
    return e.r_layers + 4 * (e.x_layers - 1) + 2


def test_odin_matches_jax(plain, monkeypatch):
    jf, params, model, pf, batch = plain
    jforward, jseen = _recording_jax(jf)
    pforward, pseen, grads = _recording_port(pf)
    want = ref.make_scorer("odin", jforward, temperature=1000.0, noise=1e-2)(params, _jb(batch))
    jax.effects_barrier()
    calls = _count_calls(monkeypatch, "attention_bwd_ref")
    scorer = port.make_scorer("odin", pforward, temperature=1000.0, noise=1e-2)
    got = scorer(_tb(batch))
    assert scorer.needs_f32_inputs
    assert calls["attention_bwd_ref"] == _bwd_calls(_cfg()) == 7
    _check_perturbation(jseen, pseen, grads, 1e-2)
    _same(got, want, rtol=0.0, atol=ODIN_ATOL)
    assert not model.training
    msp = port.make_scorer("msp", pf)(_tb(batch))
    assert not torch.allclose(got["score"], msp["score"])


def _pooled_batches(forward, params, batch, seed=0, n=4):
    rng = np.random.default_rng(seed)
    pooled = np.asarray(forward(params, _jb(batch), deterministic=True)["pooled"], np.float32)
    out = []
    for _ in range(n):
        f = pooled + 0.3 * rng.standard_normal(pooled.shape).astype(np.float32)
        t = np.zeros((B, 7), np.float32)
        t[np.arange(B), rng.integers(0, 7, B)] = 1.0
        t[0, (int(t[0].argmax()) + 1) % 7] = 0.5  # a two-class row
        out.append((f, t))
    return out


def test_fit_estimator_and_gaussian_scores_match_jax(plain):
    jf, params, _, _, batch = plain
    batches = _pooled_batches(jf, params, batch)
    want = ref_maha.fit_estimator(batches, num_classes=7, feat_dim=32)
    got = port_maha.fit_estimator(batches, num_classes=7, feat_dim=32, device="cpu")
    assert got.class_mean.dtype == got.precision.dtype == torch.float32
    np.testing.assert_allclose(got.class_mean.numpy(), np.asarray(want.class_mean), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got.precision.numpy(), np.asarray(want.precision), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(want.precision)).max())
    feats = batches[0][0]
    np.testing.assert_allclose(
        port_maha._gaussian_scores(torch.from_numpy(feats), got.class_mean, got.precision).numpy(),
        np.asarray(ref_maha._gaussian_scores(jnp.asarray(feats), want.class_mean, want.precision)),
        rtol=1e-5, atol=1e-5 * np.abs(np.asarray(want.precision)).max(),
    )


@pytest.mark.parametrize("noise", [0.0, 1e-2], ids=["plain", "noised"])
def test_maha_scorer_matches_jax(plain, noise, monkeypatch):
    jf, params, model, pf, batch = plain
    est = ref_maha.fit_estimator(_pooled_batches(jf, params, batch), num_classes=7, feat_dim=32)
    port_est = port_maha.estimator_from_numpy(np.asarray(est.class_mean), np.asarray(est.precision), "cpu")
    jforward, jseen = _recording_jax(jf)
    pforward, pseen, grads = _recording_port(pf)
    want = ref.make_scorer("maha", jforward, estimator=est, noise=noise)(params, _jb(batch))
    jax.effects_barrier()
    calls = _count_calls(monkeypatch, "attention_bwd_ref")
    got = port.make_scorer("maha", pforward, estimator=port_est, noise=noise)(_tb(batch))
    assert calls["attention_bwd_ref"] == (_bwd_calls(_cfg()) if noise else 0)
    if noise:
        _check_perturbation(jseen, pseen, grads, noise)
    _same(got, want, rtol=MAHA_RTOL)
    assert not model.training


def test_roi_scorers_refuse_a_batch_without_feats(plain):
    _, _, _, pf, batch = plain
    pixels_only = {k: v for k, v in _tb(batch).items() if k not in ("feats", "boxes")}
    for scorer in (port.make_scorer("odin", pf),
                   port.make_scorer("maha", pf, estimator=port_maha.MahaEstimator(None, None),
                                    noise=1e-3)):
        with pytest.raises(NotImplementedError, match="feats and boxes"):
            scorer(pixels_only)


# ---------------------------------------------------------------------------
# Calibration.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_calibrate_and_apply_tau_match_jax(seed):
    rng = np.random.default_rng(seed)
    answers = ["yes", "no", "red", "cat", "UQ"]
    targets = [answers[i] for i in rng.integers(0, 5, 200)]
    preds = [t if rng.random() < 0.7 else answers[rng.integers(0, 4)] for t in targets]
    scores = rng.random(200).tolist()
    for acc in (0.3, 0.5, 0.6):
        want = ref.calibrate_tau(targets, preds, scores, acc)
        assert port.calibrate_tau(targets, preds, scores, acc) == want
        q2a = {f"q{i}": (p, s) for i, (p, s) in enumerate(zip(preds, scores))}
        q2a["q_list"] = ["dog", 0.9, "extra"]
        assert port.apply_tau(q2a, want) == ref.apply_tau(q2a, want)
    with pytest.raises(ValueError, match="not reachable"):
        port.calibrate_tau(targets, preds, scores, 1.0)


# ---------------------------------------------------------------------------
# MC-dropout.
# ---------------------------------------------------------------------------

SEEDS = (0, 1, 2, 3, 4)


def _vote_rule(labels: np.ndarray) -> np.ndarray:
    """The rule as words say it: the most frequent label, ties to the
    first pass's answer, then to the lower class index."""
    out = []
    for col in labels.T:
        counts = collections.Counter(col.tolist())
        top = max(counts.values())
        tied = [c for c, n in counts.items() if n == top]
        out.append(col[0] if col[0] in tied else min(tied))
    return np.asarray(out)


@pytest.mark.parametrize("seed", range(4))
def test_majority_vote_follows_the_rule(seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 3, (5, 64))
    got = port.majority_vote(torch.from_numpy(labels)).numpy()
    np.testing.assert_array_equal(got, _vote_rule(labels))


def test_dropout_vote_matches_jax_bit_for_bit():
    rng = np.random.default_rng(7)
    n_cls, b = 6, 96
    labels = rng.integers(0, 3, (len(SEEDS), b))  # few classes: ties
    height = rng.random((len(SEEDS), b)).astype(np.float32) * 4.0 + 0.5
    logits = np.full((len(SEEDS), b, n_cls), -3.0, np.float32)
    logits[np.arange(len(SEEDS))[:, None], np.arange(b)[None, :], labels] = height

    key0 = jax.random.key(SEEDS[0], impl="rbg")
    for s in SEEDS[1:]:
        key0 = jax.random.fold_in(key0, s)
    pass_keys = jnp.stack([jax.random.key_data(jax.random.fold_in(key0, i)) for i in range(len(SEEDS))])

    def jax_stub(params, batch, *, deterministic=True, rng=None):
        hit = jnp.all(pass_keys == jax.random.key_data(rng)[None], axis=-1)
        return {"logits": jnp.asarray(logits)[jnp.argmax(hit)]}

    def port_stub(batch, *, deterministic=None, rng=None):
        assert deterministic is False
        return {"logits": torch.from_numpy(logits[SEEDS.index(rng.host.initial_seed())])}

    want = ref.make_scorer("dropout", jax_stub, seed_list=SEEDS)(None, {"x": jnp.zeros((b,))})
    got = port.make_scorer("dropout", port_stub, seed_list=SEEDS)({"x": torch.zeros(b)})
    ties = sum(max(collections.Counter(c.tolist()).values()) * 2 <= len(SEEDS) + 1 for c in labels.T)
    assert ties > 10
    np.testing.assert_array_equal(got["label"].numpy(), np.asarray(want["label"]))
    np.testing.assert_array_equal(got["label"].numpy(), _vote_rule(labels))
    np.testing.assert_allclose(got["score"].numpy(), np.asarray(want["score"]), rtol=1e-6)


def test_dropout_at_rate_zero_is_msp(plain, monkeypatch):
    _, _, model, pf, batch = plain
    calls = _count_calls(monkeypatch, "attention_dropout_ref")
    got = port.make_scorer("dropout", pf, seed_list=(0, 1, 2))(_tb(batch))
    msp = port.make_scorer("msp", pf)(_tb(batch))
    torch.testing.assert_close(got["label"], msp["label"], rtol=0, atol=0)
    torch.testing.assert_close(got["score"], msp["score"], rtol=1e-6, atol=0)
    assert calls["attention_dropout_ref"] == 0  # rate 0: no dropout call
    assert not model.training


def test_dropout_passes_differ_and_average(monkeypatch):
    cfg = _cfg(dropout=0.1, att_dropout=0.1)
    _, _, model, pf, batch = _pair(cfg)
    passes, modes = [], []

    def forward(b, **kw):
        modes.append(model.training)
        out = pf(b, **kw)
        modes.append(model.training)
        passes.append(torch.sigmoid(out["logits"].float()))
        return out

    dcalls = _count_calls(monkeypatch, "attention_dropout_ref")
    fcalls = _count_calls(monkeypatch, "attention_natural_ref")
    scorer = port.make_scorer("dropout", forward, seed_list=SEEDS)
    got = scorer(_tb(batch))
    e = cfg.encoder
    assert dcalls["attention_dropout_ref"] == len(SEEDS) * (e.l_layers + e.r_layers + 4 * e.x_layers)
    assert fcalls["attention_natural_ref"] == 0
    assert modes == [False] * (2 * len(SEEDS)) and not model.training
    stack = torch.stack(passes)
    assert not torch.equal(stack[0], stack[1])
    torch.testing.assert_close(got["score"], stack.amax(-1).mean(0), rtol=0, atol=0)
    np.testing.assert_array_equal(got["label"].numpy(), _vote_rule(stack.argmax(-1).numpy()))
    again = scorer(_tb(batch))  # the passes reseed per batch
    torch.testing.assert_close(again["score"], got["score"], rtol=0, atol=0)
    stoch = pf(_tb(batch), deterministic=False)
    assert not model.training and stoch["logits"].shape == (B, 7)
