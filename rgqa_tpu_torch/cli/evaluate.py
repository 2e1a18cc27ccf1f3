"""Evaluation CLI (port of ``rgqa_tpu/cli/evaluate.py``, msp branch).

Runs MSP rejection scoring over one or more test splits and writes
``<output>/<split>_predict.json`` (the compute_accfpr-compatible
prediction contract) plus ``<output>/<split>_result.json`` with the
metric dict.  It takes the JAX CLI's flags (the port's copy of
``parse_cli``); every scorer but msp, ensembles and ``--target_acc`` are
not ported yet and exit with a message.  It runs on the card
(``--device cuda``, the default; raises without one) unless given
``--device cpu``.

Example:
    python -m rgqa_tpu_torch.cli.evaluate --synthetic --data_root /tmp/gqa \
        --test testdev --scorer msp --output /tmp/gqa_out
"""

from __future__ import annotations

import json
import os

from rgqa_tpu_torch.config import RunConfig, parse_cli
from rgqa_tpu_torch.data.dataset import GQADataset
from rgqa_tpu_torch.runner import GQARunner


def parse_args(argv=None) -> tuple[RunConfig, str]:
    """The JAX CLI's flags -> (``RunConfig``, ``--device``); exits on what
    is not ported."""
    cfg, ns = parse_cli(argv)
    if not cfg.data.test_splits:
        raise SystemExit("--test <split[,split...]> is required")
    if cfg.load and "," in cfg.load:
        raise SystemExit("ensemble scoring (--load a,b,...) is not ported yet")
    if cfg.ood.scorer != "msp":
        raise SystemExit(f"--scorer {cfg.ood.scorer} is not ported yet; the port has msp")
    if ns.target_acc is not None:
        raise SystemExit("--target_acc (calibrated threshold) is not ported yet")
    return cfg, ns.device


def main(argv=None) -> dict:
    cfg, device = parse_args(argv)
    runner = GQARunner(cfg, init_train=False, device=device)
    all_results = {}
    for split in cfg.data.test_splits.split(","):
        encoded = runner._encode(GQADataset(cfg.data.data_root, split, add_uq=True))
        dump = os.path.join(cfg.output, f"{split}_predict.json")
        results = runner.ood_evaluate(encoded, dump=dump)
        all_results[split] = results
        with open(os.path.join(cfg.output, f"{split}_result.json"), "w") as f:
            json.dump(results, f, indent=2)
        print(split, json.dumps(results))
    return all_results


if __name__ == "__main__":
    main()
