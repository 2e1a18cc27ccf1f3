"""LXMERT pretraining CLI (port of ``rgqa_tpu/cli/pretrain.py``; reference
``run/lxmert_pretrain.bash`` -> ``src/pretrain/lxmert_pretrain.py``).

Task toggles follow the reference flags: ``--taskMaskLM --taskMatched
--taskObjPredict`` (which adds ``--visualLosses``, default
``obj,attr,feat``) ``--taskQA``; with none given, all six tasks run.  It
writes ``<output>/BEST_EVAL_LOSS_LXRT.pth`` and ``<output>/EpochNN_LXRT.pth``
(reference ``model_LXRT.pth`` files) and prints ``{"eval_loss": [...]}``
last.  ``--wordMaskRate`` / ``--objMaskRate`` other than 0.15 are refused
(see :mod:`rgqa_tpu_torch.pretrain.trainer`).  It runs on the card
(``--device cuda``, the default; raises without one) unless given
``--device cpu``.

Example:
    python -m rgqa_tpu_torch.cli.pretrain --synthetic --data_root /tmp/gqa \
        --epochs 1 --batchSize 32 --lr 1e-4 --output /tmp/gqa_pretrain

Under N data-parallel ranks: ``python -m torch.distributed.run
--nproc_per_node N -m rgqa_tpu_torch.cli.pretrain ...`` (``--batchSize``
the global batch).
"""

from __future__ import annotations

import json

from rgqa_tpu_torch.config import parse_cli
from rgqa_tpu_torch.parallel import initialize_distributed
from rgqa_tpu_torch.pretrain.trainer import ALL_TASKS, PretrainRunner


def main(argv=None) -> dict:
    cfg, ns = parse_cli(argv)
    device = initialize_distributed(ns.device) or ns.device
    tasks = []
    if ns.task_mask_lm:
        tasks.append("mask_lm")
    if ns.task_matched:
        tasks.append("matched")
    if ns.task_obj_predict:
        tasks.extend(ns.visual_losses.split(","))
    if ns.task_qa:
        tasks.append("qa")
    runner = PretrainRunner(cfg, tasks=tuple(tasks) or ALL_TASKS, device=device,
                            word_mask_rate=ns.word_mask_rate, obj_mask_rate=ns.obj_mask_rate)
    history = runner.train()
    if runner.mesh.is_main:
        print(json.dumps({"eval_loss": history["eval"]}))
    return history


if __name__ == "__main__":
    main()
