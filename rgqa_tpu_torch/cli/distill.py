"""Distillation data-generation CLI (port of ``rgqa_tpu/cli/distill.py``;
reference ``src/tasks/gqa_distill.py``).

Loads a teacher (``--load``, a ``.pth``), samples ``--n_candidates``
re-paired candidates, scores them with ``--passes`` MC-dropout passes at
``--dropout`` (kernel #4 on the card), selects pseudo-AQ / UQ by the
cartography thresholds (``--tau_aq_c``, ``--tau_aq_v``, ``--tau_uq_c``,
``--tau_uq_v``; ``--balance``) and writes the student split
``<data_root>/<output_name>.json``.  With ``--teacher_path a,b,c`` it
writes the ensemble teachers' product-of-sigmoids pseudo-labels of the
``--train`` splits instead (each a ``.pth``, or the path less ``.pth``;
an orbax snapshot directory through its ``orbax_to_pth.py`` export).  A student then trains
on the split through ``rgqa_tpu_torch.cli.train --train <output_name>``.
It runs on the card unless given ``--device cpu``, and on N ranks under
``python -m torch.distributed.run --nproc_per_node N`` (each rank scores
its rows of every global batch, ``--batchSize``; rank 0 writes the
split).

Examples:
    python -m rgqa_tpu_torch.cli.distill --synthetic --data_root /tmp/gqa \
        --load /tmp/gqa_snap/BEST.pth --output /tmp/gqa_distill \
        --n_candidates 1000 --passes 3 --output_name distill_train
    python -m rgqa_tpu_torch.cli.distill --synthetic --data_root /tmp/gqa \
        --teacher_path /tmp/a/BEST.pth,/tmp/b/BEST.pth --output /tmp/gqa_distill \
        --output_name ensemble_train
"""

from __future__ import annotations

import argparse
import os
import sys

from rgqa_tpu_torch.config import parse_cli
from rgqa_tpu_torch.distill import build_distill_split, build_ensemble_distill_split, teacher_pth
from rgqa_tpu_torch.parallel import initialize_distributed, make_mesh
from rgqa_tpu_torch.runner import GQARunner


def main(argv=None) -> list:
    argv = list(sys.argv[1:] if argv is None else argv)
    # allow_abbrev=False: otherwise --output prefix-matches --output_name.
    extra = argparse.ArgumentParser(allow_abbrev=False)
    extra.add_argument("--n_candidates", type=int, default=1000)
    extra.add_argument("--passes", type=int, default=3)
    extra.add_argument("--output_name", default="distill_train")
    extra.add_argument("--tau_aq_c", type=float, default=0.5)
    extra.add_argument("--tau_aq_v", type=float, default=0.15)
    extra.add_argument("--tau_uq_c", type=float, default=0.1)
    extra.add_argument("--tau_uq_v", type=float, default=0.05)
    extra.add_argument("--balance", action="store_true")
    own, rest = extra.parse_known_args(argv)
    cfg, ns = parse_cli(rest)
    device = initialize_distributed(ns.device) or ns.device
    mesh = make_mesh(device)  # a rank launched without joining raises here

    ensemble = cfg.teacher_path.split(",") if cfg.teacher_path and "," in cfg.teacher_path else None
    if ensemble:
        ensemble = [teacher_pth(p) for p in ensemble]  # refuses orbax before anything is built
    runner = GQARunner(cfg, device=device)
    out_path = os.path.join(cfg.data.data_root, f"{own.output_name}.json")
    if ensemble:
        rows = build_ensemble_distill_split(runner, ensemble, splits=cfg.data.train_splits, out_path=out_path)
        what = "ensemble-distilled"
    else:
        rows = build_distill_split(
            runner, n_candidates=own.n_candidates, passes=own.passes, out_path=out_path, balance=own.balance,
            tau_aq_c=own.tau_aq_c, tau_aq_v=own.tau_aq_v, tau_uq_c=own.tau_uq_c, tau_uq_v=own.tau_uq_v,
        )
        what = "distilled"
    if mesh.is_main:
        print(f"wrote {len(rows)} {what} rows to {out_path}")
    return rows


if __name__ == "__main__":
    main()
