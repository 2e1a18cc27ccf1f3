"""Port parity: NLVR2 (``rgqa_tpu_torch.models.nlvr2`` and
``rgqa_tpu_torch.nlvr2_task``) against the JAX package, on the CPU.

- ``Nlvr2Model`` carried from JAX params (``from_jax_params`` reads the
  tree's ``fc1`` / ``ln`` / ``fc2``) against the JAX model: logits and
  pooled features within atol 2e-5, on two pairs whose sentences and
  masks differ, so a fold that pairs a sentence with the other pair's
  image (``tile`` for ``repeat``) fails.
- A 1-epoch ``Nlvr2Runner`` from the JAX runner's init, f32, dropout 0,
  on the rows of ``tests/test_tasks.py`` (48 pairs over the synthetic
  root's images, 32 train, 16 valid, batch 8): the loss and the valid
  accuracy within rtol 1e-4, the final weights within rtol 1e-4 / atol
  1e-6; ``evaluate`` equal and the ``dump_csv`` lines equal, identifiers
  where rows carry them.
- ``BEST.pth`` / ``LAST.pth``: the reference NLVR2 names
  (``lxrt_encoder.model.bert.*``, ``logit_fc.{0,2,3}``), read back whole
  through ``load_reference_pth``; rows whose images the pack lacks are
  dropped; a short final batch is padded and ``real`` counts it.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from rgqa_tpu_torch import config as port_config
from rgqa_tpu_torch.checkpoint.convert import from_jax_params, load_reference_pth
from rgqa_tpu_torch.data.synthetic import SyntheticSpec, make_synthetic_gqa
from rgqa_tpu_torch.models.nlvr2 import Nlvr2Model
from rgqa_tpu_torch.nlvr2_task import Nlvr2Runner
from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

ENC = dict(hidden_size=32, num_heads=4, intermediate_size=64, l_layers=1, x_layers=1, r_layers=1,
           num_objects=36, visual_feat_dim=2048, hidden_dropout=0.0, attention_dropout=0.0)
RTOL = 1e-4


def nlvr2_rows() -> list:
    """``tests/test_tasks.py``'s NLVR2 rows; every third carries an
    ``identifier`` (the dump writes it in place of the uid)."""
    rng = np.random.default_rng(0)
    img_ids = [f"img{i:05d}" for i in range(16)]
    rows = []
    for i in range(48):
        a, b = rng.choice(16, 2, replace=False)
        rows.append({"uid": f"nlvr-{i:04d}", "img0": img_ids[a], "img1": img_ids[b],
                     "sent": "the left image contains a dog", "label": int(rng.integers(2))})
        if i % 3 == 0:
            rows[-1]["identifier"] = f"dev-{i}-0"
    return rows


def _cfg(c, root, out):
    return c.RunConfig(
        model=c.ModelConfig(backbone="lxmert", encoder=c.EncoderConfig(**ENC), max_text_len=12),
        train=c.TrainConfig(batch_size=8, epochs=1, optim=c.OptimConfig(lr=1e-3), use_bf16=False, seed=3),
        data=c.DataConfig(data_root=root, synthetic=True),
        output=out,
    )


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(tmp, JAX runner, its history, port runner, its history, the JAX init)."""
    pytest.importorskip("jax")
    import jax

    from rgqa_tpu import config as jax_config
    from rgqa_tpu import nlvr2_task as jax_nlvr2
    from rgqa_tpu.runner import np_params

    tmp = tmp_path_factory.mktemp("nlvr2")
    root = str(tmp / "gqa")
    make_synthetic_gqa(root, SyntheticSpec(n_images=16, n_train=64, n_valid=16, n_testdev=32))
    rows = nlvr2_rows()
    splits = {"train": rows[:32], "valid": rows[32:]}
    jax_runner = jax_nlvr2.Nlvr2Runner(_cfg(jax_config, root, str(tmp / "jax")), splits)
    init = jax.tree_util.tree_map(np.asarray, np_params(jax_runner.params))
    runner = Nlvr2Runner(_cfg(port_config, root, str(tmp / "port")), splits, device="cpu")
    runner.model.load_state_dict(from_jax_params(init), strict=True)
    # The JAX runner's orbax snapshots are not compared: skip their writes.
    saves = jax_nlvr2.save_checkpoint
    jax_nlvr2.save_checkpoint = lambda *a, **k: None
    try:
        want = jax_runner.train()
    finally:
        jax_nlvr2.save_checkpoint = saves
    got = runner.train()
    return tmp, jax_runner, want, runner, got, init


def test_model_matches_jax(both):
    _, jax_runner, _, _, _, init = both
    batch = jax_runner.splits["train"].gather_batch(np.arange(2))  # the init's shapes
    rng = np.random.default_rng(1)
    batch["input_ids"] = rng.integers(5, 100, batch["input_ids"].shape).astype(np.int32)
    batch["input_mask"][1, 6:] = 0  # the two pairs' sentences and masks differ
    args = [batch[k] for k in ("input_ids", "input_mask", "segment_ids", "feats", "boxes")]
    want = jax_runner.model.apply({"params": init}, *args)
    model = Nlvr2Model(port_config.EncoderConfig(**ENC))
    model.load_state_dict(from_jax_params(init, backbone="nlvr2"), strict=True)
    with torch.no_grad():
        got = model.eval()(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args))
    assert got["logits"].shape == (2, 2) and got["pooled"].shape == (2, 64)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), rtol=0, atol=2e-5)
    np.testing.assert_allclose(got["pooled"].numpy(), np.asarray(want["pooled"]), rtol=0, atol=2e-5)
    # The fold: row 2i + j is pair i's sentence with its image j.
    enc = model.lxmert(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        np.repeat(batch["input_ids"], 2, 0), np.repeat(batch["input_mask"], 2, 0),
        np.repeat(batch["segment_ids"], 2, 0), batch["feats"].reshape(4, 36, -1), batch["boxes"].reshape(4, 36, 4))))
    torch.testing.assert_close(got["pooled"], enc["pooled"].reshape(2, -1).detach())


def test_runner_trajectory_matches_jax(both):
    _, jax_runner, want, runner, got, _ = both
    np.testing.assert_allclose(got["loss"], [float(x) for x in want["loss"]], rtol=RTOL)
    np.testing.assert_allclose(got["valid"], want["valid"], rtol=RTOL)
    from rgqa_tpu.runner import np_params

    final = from_jax_params(np_params(jax_runner.params), backbone="nlvr2")
    mine = runner.model.state_dict()
    assert set(mine) == set(final)
    for name, value in final.items():
        np.testing.assert_allclose(mine[name].numpy(), value.numpy(), rtol=RTOL, atol=1e-6, err_msg=name)


def test_evaluate_and_dump_csv_match_jax(both):
    tmp, jax_runner, _, runner, _, _ = both
    assert runner.evaluate("valid") == jax_runner.evaluate("valid")
    assert runner.predict("valid") == jax_runner.predict("valid")
    jax_runner.dump_csv("valid", str(tmp / "jax.csv"))
    runner.dump_csv("valid", str(tmp / "port.csv"))
    lines = (tmp / "port.csv").read_text().splitlines()
    assert lines == (tmp / "jax.csv").read_text().splitlines()
    assert len(lines) == 16 and lines[1].startswith("dev-33-0,") and lines[0].startswith("nlvr-0032,")
    assert {l.split(",")[1] for l in lines} <= {"True", "False"}


def test_checkpoints_and_batches(both):
    tmp, _, _, runner, _, _ = both
    saved = torch.load(tmp / "port" / "LAST.pth", weights_only=True)
    assert "lxrt_encoder.model.bert.encoder.layer.0.attention.self.query.weight" in saved
    assert saved["logit_fc.0.weight"].shape == (64, 64) and saved["logit_fc.3.weight"].shape == (2, 64)
    torch.testing.assert_close(saved["logit_fc.2.weight"], runner.model.ln.weight.detach(), rtol=0, atol=0)
    sd, missing, unused = load_reference_pth(str(tmp / "port" / "LAST.pth"), backbone="nlvr2", l_layers=1,
                                             x_layers=1, r_layers=1)
    assert missing == unused == []
    for key, value in runner.model.state_dict().items():  # the whole model, under nlvr2_key_map's names
        torch.testing.assert_close(sd[key], value, rtol=0, atol=0)
    assert (tmp / "port" / "BEST.pth").is_file()

    rows = nlvr2_rows()[:5] + [dict(nlvr2_rows()[5], img1="missing")]
    kept = Nlvr2Runner(_cfg(port_config, runner.cfg.data.data_root, str(tmp / "small")), {"x": rows},
                       device="cpu").splits["x"]
    assert len(kept) == 5 and kept.norm_boxes.min() >= 0 and kept.norm_boxes.max() <= 1
    items = list(runner._batches(kept, 4))
    assert [real for _, _, real in items] == [4, 1] and items[1][1]["feats"].shape == (4, 2, 36, 2048)
    assert torch.equal(items[1][1]["input_ids"][3], items[1][1]["input_ids"][0])  # padded by its last row
    assert list(runner._batches(kept, 4, drop_last=True))[-1][2] == 4
