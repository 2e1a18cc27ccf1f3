"""Port parity: LXMERT pretraining (``rgqa_tpu_torch.pretrain``, the
trainer and ``cli.pretrain``) against the JAX package, on the CPU.

The JAX step draws its masks with ``jax.random`` inside its jit; the port
draws them on the host (``draw_pretrain_masks``) and hands them to the
step.  So the port is held in two parts:

- the draw, by its rates on a large batch, each within 5 sigma: the
  selected fraction of the maskable tokens and of the RoIs, the 80 / 10 /
  10 split of both, the flip rate, ``shift`` in [1, B), and that no
  special id or padding is ever selected;
- the step, given JAX's own draws (:func:`jax_draws` replays the JAX
  runner's key chain: ``key, sub = split(key)`` a step, ``split(sub, 4)``,
  ``PRNGKey(0)`` for every eval batch): the masked inputs and labels equal
  JAX's ``matched_swap`` / ``mask_words`` / ``mask_objects`` bit for bit
  (word masking on the swapped ids and mask); ``pretrain_loss`` against
  JAX's on the same logits (rtol 1e-6); ``LxmertPretraining`` from JAX
  params against JAX at dropout 0 (pooled rtol 2e-4 / atol 2e-5, the bar
  of ``tests/test_torch_import.py``); 3 steps' parts and the final
  parameters, the tied word table among them (rtol 1e-4, atol 1e-6); a
  2-epoch ``PretrainRunner`` history against JAX's ``PretrainRunner`` with
  the port's draws replaced by the replay (rtol 1e-4).

Also: the two-source root with ``--qaSets mscoco`` (the answer table and
every row's answer id equal JAX's, ``tests/test_pretrain.py``), and the
refusal of ``--wordMaskRate`` / ``--objMaskRate`` off 0.15, which the JAX
runner parses and ignores.  Everything at hidden 32, 4 heads, 1 / 1 / 1
layers, 10 RoIs of 48, 12 text tokens, batch 16.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from rgqa_tpu_torch import config as port_config
from rgqa_tpu_torch.checkpoint.convert import from_jax_params
from rgqa_tpu_torch.models.lxmert import LxmertPretraining
from rgqa_tpu_torch.pretrain import draw_pretrain_masks, pretrain_loss
from rgqa_tpu_torch.pretrain.trainer import ALL_TASKS, PretrainRunner, apply_pretrain_masks, make_pretrain_step
from rgqa_tpu_torch.train.optimizer import make_optimizer
from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

ENC = dict(hidden_size=32, num_heads=4, intermediate_size=64, vocab_size=128, l_layers=1, x_layers=1,
           r_layers=1, num_objects=10, visual_feat_dim=48, hidden_dropout=0.0, attention_dropout=0.0)
SPEC = dict(n_images=16, n_train=48, n_valid=32, n_testdev=8, num_boxes=10, feat_dim=48, seed=4)
B, T, K, ANSWERS = 16, 12, 10, 39
RTOL = 1e-4


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


def jax_draws(jax, key, b, t, k, vocab, tasks=ALL_TASKS) -> dict:
    """The draws of the JAX step's ``loss_fn(rng=key)``: its
    ``split(key, 4)`` and each masking function's own splits, as the
    port's ``draws`` dict."""
    r_m, r_w, r_o, _ = jax.random.split(key, 4)
    out = {}
    if "matched" in tasks:
        r_flip, r_shift = jax.random.split(r_m)
        out["flip"] = torch.from_numpy(np.asarray(jax.random.bernoulli(r_flip, 0.5, (b,))))
        out["shift"] = int(jax.random.randint(r_shift, (), 1, b))
    if "mask_lm" in tasks:
        r_sel, r_kind, r_rand = jax.random.split(r_w, 3)
        out["word_sel"] = torch.from_numpy(np.asarray(jax.random.uniform(r_sel, (b, t))))
        out["word_kind"] = torch.from_numpy(np.asarray(jax.random.uniform(r_kind, (b, t))))
        out["word_rand"] = torch.from_numpy(np.asarray(jax.random.randint(r_rand, (b, t), 0, vocab)))
    if {"obj", "attr", "feat"} & set(tasks):
        r_sel, r_kind, r_pick = jax.random.split(r_o, 3)
        out["obj_sel"] = torch.from_numpy(np.asarray(jax.random.uniform(r_sel, (b, k))))
        out["obj_kind"] = torch.from_numpy(np.asarray(jax.random.uniform(r_kind, (b, k))))
        out["obj_pick"] = torch.from_numpy(np.asarray(jax.random.randint(r_pick, (b, k), 0, b * k)))
    return out


def random_batch(seed: int, b: int = B, t: int = T) -> dict:
    """A pretraining host batch: [CLS] words [SEP] then padding (lengths
    4..t), a few special ids inside, RoIs, detector ids, answers (-1 on
    some rows)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, ENC["vocab_size"], (b, t)).astype(np.int32)
    lengths = rng.integers(4, t + 1, b)
    mask = (np.arange(t)[None] < lengths[:, None]).astype(np.int32)
    ids[:, 0] = 2
    ids[np.arange(b), lengths - 1] = 3
    ids[mask == 0] = 0
    ids[1, 2] = 1  # an [UNK] inside the text: never masked
    return {
        "input_ids": ids, "input_mask": mask, "segment_ids": np.zeros((b, t), np.int32),
        "feats": rng.standard_normal((b, K, ENC["visual_feat_dim"]), dtype=np.float32),
        "boxes": rng.random((b, K, 4), dtype=np.float32),
        "obj_id": rng.integers(0, 1600, (b, K)).astype(np.int32),
        "attr_id": rng.integers(0, 400, (b, K)).astype(np.int32),
        "ans": np.where(rng.random(b) < 0.25, -1, rng.integers(0, ANSWERS, b)).astype(np.int32),
    }


def tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# The draw, by its rates.
# ---------------------------------------------------------------------------


def within(got: float, p: float, n: int, what: str) -> None:
    sigma = (p * (1 - p) / n) ** 0.5
    assert abs(got - p) <= 5 * sigma, f"{what}: {got} vs {p} (5 sigma {5 * sigma:.4f}, n {n})"


def test_draw_rates_and_splits():
    batch = tensors(random_batch(0, b=1024, t=32))
    gen = torch.Generator().manual_seed(3)
    draws = draw_pretrain_masks(batch, ALL_TASKS, vocab_size=ENC["vocab_size"], generator=gen)
    m = apply_pretrain_masks(batch, dict(draws, flip=torch.zeros(1024, dtype=torch.bool)), mask_id=4)
    ids, labels = batch["input_ids"], m["lm_labels"]
    maskable = (batch["input_mask"] > 0) & ~torch.isin(ids, torch.arange(5, dtype=ids.dtype))
    selected = labels >= 0
    assert not (selected & ~maskable).any()  # no special id, no padding
    assert torch.equal(labels[selected], ids[selected])
    n = int(selected.sum())
    within(n / int(maskable.sum()), 0.15, int(maskable.sum()), "selected words")
    out = m["input_ids"][selected]
    kind = draws["word_kind"][selected]
    within(float((out == 4).float().mean()), 0.8, n, "[MASK]")
    within(float((kind >= 0.9).float().mean()), 0.1, n, "kept words")
    assert torch.equal(out[kind >= 0.9], ids[selected][kind >= 0.9])
    random = (kind >= 0.8) & (kind < 0.9)
    within(float(random.float().mean()), 0.1, n, "random words")
    assert torch.equal(out[random], draws["word_rand"][selected][random].to(out.dtype))
    assert torch.equal(m["input_ids"][~selected], ids[~selected])

    feats, masked, fmask = batch["feats"], m["feats"], m["feat_mask"].bool()
    nk = fmask.numel()
    within(float(fmask.float().mean()), 0.15, nk, "selected RoIs")
    zeroed = (masked == 0).all(-1) & fmask
    swapped = ~(masked == feats).all(-1) & ~zeroed
    within(float(zeroed.sum() / fmask.sum()), 0.8, int(fmask.sum()), "zeroed RoIs")
    within(float(swapped.sum() / fmask.sum()), 0.1, int(fmask.sum()), "swapped RoIs")
    assert torch.equal(masked[~fmask], feats[~fmask]) and not swapped[~fmask].any()
    pool = feats.reshape(-1, feats.shape[-1])
    assert torch.equal(masked[swapped], pool[draws["obj_pick"][swapped]])

    flips, shifts = [], []
    for _ in range(400):
        d = draw_pretrain_masks(tensors(random_batch(1, b=8)), ("matched",), vocab_size=8, generator=gen)
        assert set(d) == {"flip", "shift"}
        flips.append(d["flip"])
        shifts.append(d["shift"])
    within(float(torch.cat(flips).float().mean()), 0.5, 3200, "flip rate")
    assert set(shifts) == set(range(1, 8))


# ---------------------------------------------------------------------------
# The step's pieces against JAX's.
# ---------------------------------------------------------------------------


def _jax_masked(jax, batch: dict, key) -> dict:
    """JAX ``loss_fn``'s masking, with its functions and key splits (one jit)."""
    return jax.jit(_jax_masking)({k: batch[k] for k in ("input_ids", "input_mask", "segment_ids", "ans",
                                                        "feats")}, key)


def _jax_masking(batch, key):
    import jax
    import jax.numpy as jnp

    from rgqa_tpu.pretrain.masking import mask_objects, mask_words, matched_swap

    r_m, r_w, r_o, _ = jax.random.split(key, 4)
    ids, mask, seg, ans = (batch[k] for k in ("input_ids", "input_mask", "segment_ids", "ans"))
    ids, mask, seg, matched, ans = matched_swap(r_m, ids, mask, seg, ans)
    maskable = (mask > 0) & ~jnp.isin(ids, jnp.asarray((0, 1, 2, 3, 4)))
    ids, lm_labels = mask_words(r_w, ids, maskable, mask_rate=0.15, vocab_size=ENC["vocab_size"], mask_id=4)
    feats = batch["feats"]
    masked, feat_mask = mask_objects(r_o, feats, feats.reshape(-1, feats.shape[-1]))
    return {"input_ids": ids, "input_mask": mask, "segment_ids": seg, "ans": ans, "matched": matched,
            "lm_labels": lm_labels, "feats": masked, "feat_mask": feat_mask}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masks_from_jax_draws_equal_jax_masking(jax, seed):
    batch = random_batch(10 + seed)
    key = jax.random.fold_in(jax.random.PRNGKey(5), seed)
    want = _jax_masked(jax, batch, key)
    got = apply_pretrain_masks(tensors(batch), jax_draws(jax, key, B, T, K, ENC["vocab_size"]), mask_id=4)
    assert 0 < int(want["matched"].sum()) < B and (np.asarray(want["lm_labels"]) >= 0).any()
    for name, value in want.items():
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(value), err_msg=name)


def test_pretrain_loss_parts_match_jax(jax):
    from rgqa_tpu.pretrain.losses import pretrain_loss as jax_pretrain_loss

    rng = np.random.default_rng(0)
    out = {"mlm": rng.standard_normal((B, T, 300), dtype=np.float32) * 3,
           "matched": rng.standard_normal((B, 2), dtype=np.float32),
           "qa": rng.standard_normal((B, ANSWERS), dtype=np.float32),
           "visn": {"obj": rng.standard_normal((B, K, 1600), dtype=np.float32),
                    "attr": rng.standard_normal((B, K, 400), dtype=np.float32),
                    "feat": rng.standard_normal((B, K, 48), dtype=np.float32)}}
    labels = {
        "lm_labels": np.where(rng.random((B, T)) < 0.2, rng.integers(0, 300, (B, T)), -1).astype(np.int32),
        "matched": rng.integers(0, 2, B).astype(np.int32),
        "obj_labels": rng.integers(0, 1600, (B, K)).astype(np.int32),
        "attr_labels": rng.integers(0, 400, (B, K)).astype(np.int32),
        "feat_target": rng.standard_normal((B, K, 48), dtype=np.float32) * 2,
        "feat_mask": (rng.random((B, K)) < 0.15).astype(np.float32),
        "ans": np.where(rng.random(B) < 0.3, -1, rng.integers(0, ANSWERS, B)).astype(np.int32),
    }
    want_total, want = jax_pretrain_loss(out, **labels)
    t = {k: torch.from_numpy(v) for k, v in out.items() if k != "visn"}
    t["visn"] = {k: torch.from_numpy(v) for k, v in out["visn"].items()}
    got_total, got = pretrain_loss(t, **{k: torch.from_numpy(v) for k, v in labels.items()})
    assert list(got) == list(want) == list(ALL_TASKS)
    for name in want:
        np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=1e-6, err_msg=name)
    np.testing.assert_allclose(float(got_total), float(want_total), rtol=1e-6)
    # Every label ignored: the masked CE is 0, not NaN.
    _, none = pretrain_loss(t, lm_labels=torch.full((B, T), -1), tasks=("mask_lm",))
    assert float(none["mask_lm"]) == 0.0


@pytest.fixture(scope="module")
def jax_pretraining(jax):
    """(JAX model, its f32 params as numpy)."""
    from rgqa_tpu.config import EncoderConfig as JaxEncoderConfig
    from rgqa_tpu.models.lxmert import LxmertPretraining as JaxPretraining

    jmodel = JaxPretraining(JaxEncoderConfig(**ENC), num_answers=ANSWERS)
    b = random_batch(0, b=2)  # the JAX runner's init shapes: its eager ops are then compiled once
    args = [b[k] for k in ("input_ids", "input_mask", "segment_ids", "feats", "boxes")]
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(1), *args)["params"])
    return jmodel, params


def _port_model(params) -> LxmertPretraining:
    model = LxmertPretraining(port_config.EncoderConfig(**ENC), num_answers=ANSWERS)
    model.load_state_dict(from_jax_params(params, backbone="lxmert_pretrain"), strict=True)
    return model.eval()


def test_pretraining_model_matches_jax(jax_pretraining):
    jmodel, params = jax_pretraining
    batch = random_batch(3, b=2)  # the init's shapes: JAX's eager ops are compiled already
    args = [batch[k] for k in ("input_ids", "input_mask", "segment_ids", "feats", "boxes")]
    want = jmodel.apply({"params": params}, *args)
    with torch.no_grad():
        got = _port_model(params)(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got["pooled"].numpy(), np.asarray(want["pooled"]), rtol=2e-4, atol=2e-5)
    for name in ("mlm", "matched", "qa"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=2e-4, atol=2e-5, err_msg=name)
    for name in ("obj", "attr", "feat"):
        np.testing.assert_allclose(got["visn"][name].numpy(), np.asarray(want["visn"][name]), rtol=2e-4,
                                   atol=2e-5, err_msg=name)


def test_three_steps_with_jax_masks_match_jax(jax, jax_pretraining):
    from rgqa_tpu.config import OptimConfig as JaxOptimConfig
    from rgqa_tpu.pretrain.trainer import make_pretrain_step as jax_make_pretrain_step
    from rgqa_tpu.train import create_train_state, make_optimizer as jax_make_optimizer

    jmodel, params = jax_pretraining
    steps, lr = 3, 1e-3
    batches = [random_batch(20 + i) for i in range(steps)]
    jstep, _ = jax_make_pretrain_step(jmodel, jax_make_optimizer(JaxOptimConfig(lr=lr), steps), donate=False)
    state = create_train_state(params, jax_make_optimizer(JaxOptimConfig(lr=lr), steps))
    model = _port_model(params)
    opt = make_optimizer(port_config.OptimConfig(lr=lr), model.parameters(), t_total=steps)
    step, _ = make_pretrain_step(model, opt, mask_id=4, grad_clip=5.0)
    key = jax.random.PRNGKey(9)
    for i, batch in enumerate(batches):
        key, sub = jax.random.split(key)
        state, jparts = jstep(state, {k: jax.numpy.asarray(v) for k, v in batch.items()}, sub)
        parts = step(tensors(batch), jax_draws(jax, sub, B, T, K, ENC["vocab_size"]))
        assert list(parts) == list(ALL_TASKS) and set(jparts) == set(parts)  # jit sorts its dict keys
        for name, value in jparts.items():
            np.testing.assert_allclose(float(parts[name]), float(value), rtol=RTOL, err_msg=f"step {i} {name}")
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, state.params), backbone="lxmert_pretrain")
    got = model.state_dict()
    assert set(got) == set(want)
    moved = 0
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), rtol=RTOL, atol=1e-6, err_msg=name)
        moved += not torch.equal(value, from_jax_params(params, backbone="lxmert_pretrain")[name])
    assert moved > len(want) // 2
    # The tied decoder's gradient reached the word table.
    table = "lxmert.embeddings.word_embeddings.weight"
    assert not torch.equal(got[table], from_jax_params(params, backbone="lxmert_pretrain")[table])


# ---------------------------------------------------------------------------
# The runners.
# ---------------------------------------------------------------------------


def _run_cfg(c, root, out, epochs=2, **data_kw):
    return c.RunConfig(
        model=c.ModelConfig(backbone="lxmert", encoder=c.EncoderConfig(**ENC), max_text_len=T),
        train=c.TrainConfig(batch_size=B, epochs=epochs, use_bf16=False, seed=6, dropout=0.0,
                            optim=c.OptimConfig(lr=1e-3)),
        data=c.DataConfig(data_root=root, synthetic=True, **data_kw),
        output=out,
    )


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    from rgqa_tpu_torch.data.synthetic import SyntheticSpec, make_synthetic_gqa

    path = str(tmp_path_factory.mktemp("pretrain") / "gqa")
    make_synthetic_gqa(path, SyntheticSpec(**SPEC))
    return path


def test_runner_history_matches_jax_runner_with_jax_masks(jax, jax_pretraining, root, tmp_path, capsys,
                                                          monkeypatch):
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.pretrain import PretrainRunner as JaxRunner
    from rgqa_tpu.runner import np_params

    # The JAX runner's orbax snapshots are not compared (the port writes
    # .pth files): skip their writes, most of its run time here.
    monkeypatch.setattr("rgqa_tpu.pretrain.trainer.save_checkpoint", lambda *a, **k: None)

    jax_runner = JaxRunner(_run_cfg(jax_config, root, str(tmp_path / "jax")))
    runner = PretrainRunner(_run_cfg(port_config, root, str(tmp_path / "port")), device="cpu")
    runner.model.load_state_dict(from_jax_params(np_params(jax_runner.params), backbone="lxmert_pretrain"))
    chain = [jax.random.PRNGKey(6)]

    def replay_train(batch, generator):
        chain[0], sub = jax.random.split(chain[0])
        return jax_draws(jax, sub, *batch["input_ids"].shape, K, ENC["vocab_size"])

    runner.train_draws = replay_train
    runner.eval_draws = lambda batch: jax_draws(jax, jax.random.PRNGKey(0), *batch["input_ids"].shape, K,
                                                ENC["vocab_size"])
    want = jax_runner.train()
    capsys.readouterr()
    got = runner.train()
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("Epoch")]
    assert len(got["train"]) == len(got["eval"]) == 2 and lines[1].startswith("Epoch 01: train {'mask_lm': ")
    for epoch in range(2):
        assert list(got["train"][epoch]) == list(ALL_TASKS) and set(want["train"][epoch]) == set(ALL_TASKS)
        for name, value in want["train"][epoch].items():
            np.testing.assert_allclose(got["train"][epoch][name], value, rtol=RTOL, err_msg=f"{epoch} {name}")
    np.testing.assert_allclose(got["eval"], want["eval"], rtol=RTOL)
    assert got["eval"][0] != got["eval"][1]
    out = tmp_path / "port"
    for name in ("BEST_EVAL_LOSS_LXRT.pth", "Epoch00_LXRT.pth", "Epoch01_LXRT.pth"):
        assert (out / name).is_file(), name
    # The last epoch's file is the runner's weights in the reference layout.
    saved = torch.load(out / "Epoch01_LXRT.pth", weights_only=True)
    torch.testing.assert_close(saved["bert.embeddings.word_embeddings.weight"],
                               runner.model.lxmert.embeddings.word_embeddings.weight, rtol=0, atol=0)
    torch.testing.assert_close(saved["cls.predictions.decoder.weight"],
                               saved["bert.embeddings.word_embeddings.weight"], rtol=0, atol=0)


def test_two_source_root_with_qa_sets_matches_jax(jax, tmp_path):
    from rgqa_tpu import config as jax_config
    from rgqa_tpu.pretrain import PretrainRunner as JaxRunner

    from rgqa_tpu_torch.data.synthetic import SyntheticSpec, make_synthetic_gqa

    root = str(tmp_path / "gqa")
    make_synthetic_gqa(root, SyntheticSpec(**SPEC))
    with open(os.path.join(root, "trainval_label2ans.json")) as f:
        answers = json.load(f)
    half = len(answers) // 2
    all_ans = ([{"ans": a, "dsets": ["mscoco"]} for a in answers[:half]]
               + [{"ans": a, "dsets": ["vgnococo"]} for a in answers[half:-2]]
               + [{"ans": a, "dsets": ["mscoco", "vgnococo"]} for a in answers[-2:]])
    with open(os.path.join(root, "all_ans.json"), "w") as f:
        json.dump(all_ans, f)
    kw = dict(train_splits="train,valid", valid_splits="valid", qa_sets=" MSCOCO")
    jax_runner = JaxRunner(_run_cfg(jax_config, root, str(tmp_path / "jax"), **kw))
    runner = PretrainRunner(_run_cfg(port_config, root, str(tmp_path / "port"), **kw), device="cpu")
    kept = answers[:half] + answers[-2:]
    assert runner.answer_table.all_answers() == jax_runner.answer_table.all_answers() == kept
    assert runner.model.answer_head.logit_fc[3].out_features == len(kept)
    assert len(runner.train_set) == len(jax_runner.train_set)
    got = runner.answer_ids(runner.train_set)
    want = jax_runner._ans_cache[jax_runner.train_set]
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).any() and (got == -1).any()
    np.testing.assert_array_equal(runner.answer_ids(runner.valid_set), jax_runner._answer_ids(jax_runner.valid_set))


def test_special_ids_are_the_vocabularys(root, tmp_path):
    """BERT's vocabulary puts [UNK] [CLS] [SEP] [MASK] at 100-103 (the JAX
    runner's step keeps 0-4, the synthetic vocabulary's): the runner
    masks by the vocabulary's ids, and on the synthetic root they are
    0-4, as in JAX."""
    import shutil

    bert = str(tmp_path / "bert")
    shutil.copytree(root, bert)
    words = open(os.path.join(root, "vocab.txt")).read().split("\n")
    specials = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    assert words[:5] == specials
    layout = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + specials[1:] + words[5:]
    with open(os.path.join(bert, "vocab.txt"), "w") as f:
        f.write("\n".join(layout))
    runner = PretrainRunner(_run_cfg(port_config, bert, str(tmp_path / "o")), device="cpu")
    assert runner.special_ids == (0, 100, 101, 102, 103) and runner.mask_id == 103
    assert PretrainRunner(_run_cfg(port_config, root, str(tmp_path / "s")), device="cpu").special_ids == (0, 1, 2, 3, 4)
    batch = tensors(random_batch(2, b=256))
    ids = batch["input_ids"]
    ids[:, 1] = 101  # BERT's [CLS] / [SEP] / [UNK] inside the text
    ids[:, 2] = 102
    ids[:, 3] = 100
    draws = draw_pretrain_masks(batch, ALL_TASKS, vocab_size=128, generator=torch.Generator().manual_seed(0))
    m = apply_pretrain_masks(batch, draws, mask_id=103, special_ids=runner.special_ids)
    assert not (m["lm_labels"][:, 1:4] >= 0).any() and (m["lm_labels"] >= 0).any()
    m = apply_pretrain_masks(batch, draws, mask_id=103)  # the JAX default ids would mask them
    assert (m["lm_labels"][:, 1:4] >= 0).any()


@pytest.mark.parametrize("flag", ["--wordMaskRate", "--objMaskRate"])
def test_mask_rate_flags_off_015_are_refused(flag, root, tmp_path):
    from rgqa_tpu_torch.cli import pretrain

    tiny = ["--device", "cpu", "--fp32", "--llayers", "1", "--xlayers", "1", "--rlayers", "1", "--hidden_size",
            "32", "--num_heads", "4", "--batchSize", "16", "--epochs", "1"]
    fresh = str(tmp_path / "fresh")
    with pytest.raises(NotImplementedError, match=flag):
        pretrain.main(["--synthetic", "--data_root", fresh, "--output", str(tmp_path / "o"), flag, "0.3", *tiny])
    assert not os.path.exists(fresh)  # refused before any work
    cfg, ns = port_config.parse_cli(["--data_root", root, "--output", str(tmp_path / "ok"), flag, "0.15", *tiny])
    runner = PretrainRunner(cfg, device=ns.device, word_mask_rate=ns.word_mask_rate,
                            obj_mask_rate=ns.obj_mask_rate)  # 0.15, given: the rate the run masks at
    assert runner.tasks == ALL_TASKS
