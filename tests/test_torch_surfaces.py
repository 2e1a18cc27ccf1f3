"""Port parity: the small CLIs ported with slice 19, on the CPU.

- ``rgqa_tpu_torch.metrics.compute_accfpr`` prints and returns the same
  metric dict as ``rgqa_tpu.metrics.compute_accfpr`` on synthetic
  dataset and prediction JSONs (``fpr88.9`` popped, as the public
  reference CLI), with and without ``--tau``; and the reference's golden
  example where the reference checkout is present (``conftest.py``'s
  ``reference_dir``; skipped without it);
- ``rgqa_tpu_torch.cli.compute_param`` counts each backbone of the JAX
  package's ``BACKBONES`` as ``rgqa_tpu.cli.compute_param`` does, on the
  ``meta`` device (nothing allocated).
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from rgqa_tpu_torch.cli import compute_param
from rgqa_tpu_torch.metrics import compute_accfpr
from test_torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)



@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


def _files(tmp_path, seed: int, n: int = 400):
    """A dataset JSON (a third UQ) and a prediction JSON whose confidences
    lean toward the answerable rows."""
    rng = np.random.default_rng(seed)
    answers = ["yes", "no", "red", "two", "cat"]
    rows, preds = [], []
    for i in range(n):
        uq = rng.random() < 1 / 3
        gold = "UQ" if uq else str(rng.choice(answers))
        rows.append({"img_id": f"img{i % 20}", "question_id": f"q{i}", "sent": "what is it ?",
                     "label": {gold: 1.0}})
        pred = gold if (not uq and rng.random() < 0.6) else str(rng.choice(answers))
        conf = float(np.clip(rng.normal(0.35 if uq else 0.65, 0.2), 0, 1))
        preds.append({"questionId": f"q{i}", "prediction": pred, "confidence": round(conf, 4)})
    data, pred = tmp_path / "data.json", tmp_path / "predict.json"
    data.write_text(json.dumps(rows))
    pred.write_text(json.dumps(preds, indent=4, sort_keys=True))
    return str(data), str(pred)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("tau", [None, "0.3"])
def test_compute_accfpr_prints_the_jax_dict(jax, tmp_path, capsys, seed, tau):
    from rgqa_tpu.metrics.compute_accfpr import main as jax_main

    argv = list(_files(tmp_path, seed)) + (["--tau", tau] if tau else [])
    got = compute_accfpr.main(argv)
    printed = capsys.readouterr().out
    want = jax_main(argv)
    assert got == want and printed == capsys.readouterr().out
    assert "fpr88.9" not in got and {"auaf", "fpr@0.95acc", "full_acc"} <= set(got)


def test_compute_accfpr_reference_golden(jax, reference_dir):
    from rgqa_tpu.metrics.compute_accfpr import main as jax_main

    argv = [str(reference_dir / "compute_accfpr" / name) for name in ("example.json", "example_predict.json")]
    got = compute_accfpr.main(argv)
    assert got == jax_main(argv) and "fpr88.9" not in got


def _jax_backbones():
    from rgqa_tpu.models.zoo import BACKBONES

    return sorted(BACKBONES)


@pytest.mark.parametrize("backbone", ["butd", "caps", "lxmert", "uniter", "vilt"])
def test_compute_param_counts_as_jax(jax, backbone):
    from rgqa_tpu.cli.compute_param import count_params as jax_count

    assert backbone in _jax_backbones() and sorted(compute_param.BACKBONES) == _jax_backbones()
    assert compute_param.count_params(backbone) == jax_count(backbone)


def test_compute_param_cli_prints_every_backbone(capsys):
    counts = compute_param.main([])
    out = capsys.readouterr().out
    assert list(counts) == list(compute_param.BACKBONES)
    for name, n in counts.items():
        assert f"{name}: {n:,} trainable parameters" in out
    assert counts["lxmert"] == 211_952_178  # 9 / 5 / 5 x 768, 1842 answers
