"""Port parity: the dry-run entry (``rgqa_tpu_torch/entry.py``) against the
JAX package's ``__graft_entry__.py``.

- ``entry(cfg, device="cpu")`` at the JAX dry run's tiny LXMERT (2 / 1 / 1
  layers x 64, 8 RoIs, 16 answers), on the JAX model's weights
  (``from_jax_params``) and the same ``example_batch``, against the JAX
  entry's forward (``fwd(params, batch)``, written out at that config):
  MSP scores at rtol 2e-4 / atol 2e-5 and equal answers in f32; in bf16
  the scores within 3e-2, the answers equal on the rows whose f32 top-2
  margin exceeds 3e-2 (both round every product to bf16, in other
  orders).
- ``dryrun_multichip(2, device="cpu")``, two gloo ranks: its loss within
  2e-7 of one process at the same global batch (4 rows), the same
  answers and scores, the JAX dry run's assertions (finite loss, labels
  of shape (2n,), finite scores) inside the ranks.
- The default ``entry()`` builds the full-width LXMERT (9 / 5 / 5 x 768,
  1842 answers, 20 tokens, 36 x 2048 RoIs, batch 8): checked on the
  meta device, without running it.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from rgqa_tpu_torch import entry as port_entry
from rgqa_tpu_torch.checkpoint.convert import from_jax_params
from rgqa_tpu_torch.config import ModelConfig

from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

INPUTS = ("input_ids", "input_mask", "segment_ids", "feats", "boxes")


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


def _jax_config():
    from rgqa_tpu import config as jax_config

    c = port_entry.tiny_config()
    return jax_config.ModelConfig(backbone="lxmert", encoder=jax_config.EncoderConfig(**port_entry.TINY_ENCODER),
                                  num_answers=c.num_answers, max_text_len=c.max_text_len)


@pytest.fixture(scope="module")
def jax_entry(jax):
    """The JAX entry at the tiny config: (params as numpy, batch, the f32
    forward's (label, score, top-2 margin), the bf16 forward's (label,
    score))."""
    import jax.numpy as jnp
    from rgqa_tpu.models.zoo import build_model, example_batch

    cfg = _jax_config()
    batch = example_batch(cfg, batch_size=8, seed=0)
    model, _ = build_model(cfg, use_bf16=True)
    params = model.init(jax.random.PRNGKey(0), *[jnp.asarray(batch[k]) for k in INPUTS])["params"]

    def fwd(bf16):
        _, forward = build_model(cfg, use_bf16=bf16)
        out = forward(params, {k: jnp.asarray(v) for k, v in batch.items()}, deterministic=True)
        probs = np.asarray(jax.nn.sigmoid(out["logits"].astype(jnp.float32)))
        return np.argmax(probs, axis=-1), np.max(probs, axis=-1), probs

    f32, bf16 = fwd(False), fwd(True)
    top2 = np.sort(f32[2], axis=-1)[:, -2:]
    return jax.tree_util.tree_map(np.asarray, params), batch, f32[:2] + (top2[:, 1] - top2[:, 0],), bf16[:2]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_entry_matches_the_jax_entry(jax_entry, dtype):
    params, batch, (label32, score32, margin), (label16, score16) = jax_entry
    bf16 = dtype == "bfloat16"
    fwd, (model, pbatch) = port_entry.entry(port_entry.tiny_config(), device="cpu", use_bf16=bf16)
    for k in INPUTS:
        np.testing.assert_array_equal(pbatch[k].numpy(), batch[k], err_msg=k)
    model.load_state_dict(from_jax_params(params), strict=True)
    label, score = fwd(model, pbatch)
    assert label.shape == (8,) and score.dtype == torch.float32
    if bf16:
        np.testing.assert_allclose(score.numpy(), score16, atol=3e-2, rtol=0)
        decided = margin > 3e-2
        np.testing.assert_array_equal(label.numpy()[decided], label16[decided])
    else:
        np.testing.assert_allclose(score.numpy(), score32, rtol=2e-4, atol=2e-5)
        np.testing.assert_array_equal(label.numpy(), label32)


def test_dryrun_on_two_ranks_is_the_one_process_step():
    cfg = port_entry.tiny_config()
    one = port_entry.dryrun_step(cfg, 4, device=torch.device("cpu"))
    two = port_entry.dryrun_multichip(2, device="cpu", seconds=120.0)
    assert (two["world"], two["backend"], two["step"]) == (2, "gloo", 1)
    assert abs(two["loss"] - one["loss"]) <= 2e-7, (two["loss"], one["loss"])
    assert two["label"] == one["label"] and len(two["label"]) == 4
    np.testing.assert_allclose(two["score"], one["score"], rtol=1e-5)


def test_default_entry_is_full_width_lxmert():
    fwd, (model, batch) = port_entry.entry(device="meta")
    assert callable(fwd)
    assert tuple(batch["input_ids"].shape) == (8, 20)
    assert tuple(batch["feats"].shape) == (8, 36, 2048) and tuple(batch["boxes"].shape) == (8, 36, 4)
    cfg = ModelConfig(backbone="lxmert")
    assert (cfg.encoder.l_layers, cfg.encoder.x_layers, cfg.encoder.r_layers, cfg.num_answers) == (9, 5, 5, 1842)
    params = dict(model.named_parameters())
    assert all(p.device.type == "meta" for p in params.values())
    assert sum(p.numel() for p in params.values()) == 211_952_178  # compute_param's LXMERT
    depth = {stack: 1 + max(int(k.split(".")[2]) for k in params if k.startswith(f"lxmert.{stack}."))
             for stack in ("lang_layers", "visn_layers", "x_layers")}
    assert depth == {"lang_layers": 9, "visn_layers": 5, "x_layers": 5}
    assert params["answer_head.logits.weight"].shape == (1842, 1536)
