"""VQA task CLI (port of ``rgqa_tpu/cli/vqa.py``; reference
``src/tasks/vqa.py`` __main__, :171-214).

With ``--test``: a split whose name holds ``test`` is predicted and
dumped as ``<output>/test_predict.json`` without scoring; any other is
evaluated and dumped as ``<output>/<split>_predict.json``.  Otherwise it
prints the valid split's oracle score, trains (``BEST.pth`` /
``LAST.pth`` under ``--output``) and prints ``{"final_loss", "train",
"valid"}``.  It runs on the card (``--device cuda``, the default; raises
without one) unless given ``--device cpu``.

Train:
    python -m rgqa_tpu_torch.cli.vqa --synthetic --data_root /tmp/vqa \
        --train train,nominival --valid minival --epochs 1 --batchSize 32 \
        --output /tmp/vqa_snap
Test (the VQA-challenge submission JSON):
    python -m rgqa_tpu_torch.cli.vqa --data_root /tmp/vqa --test minival \
        --load /tmp/vqa_snap/BEST.pth --output /tmp/vqa_snap
Under N data-parallel ranks: ``python -m torch.distributed.run
--nproc_per_node N -m rgqa_tpu_torch.cli.vqa ...`` (rank 0 prints and
writes).
"""

from __future__ import annotations

import json
import os

from rgqa_tpu_torch.config import parse_cli
from rgqa_tpu_torch.parallel import initialize_distributed
from rgqa_tpu_torch.vqa_task import VQARunner


def main(argv=None):
    cfg, ns = parse_cli(argv)
    device = initialize_distributed(ns.device) or ns.device
    test = cfg.data.test_splits
    runner = VQARunner(cfg, init_train=test is None, device=device)
    say = print if runner.mesh.is_main else (lambda *a, **k: None)

    if test is not None:
        # Reference dispatch (vqa.py:183-203): 'test' -> predict-only dump,
        # any other split -> evaluate and dump.
        if "test" in test:
            runner.predict(test, dump=os.path.join(cfg.output, "test_predict.json"))
            say(json.dumps({"split": test, "dumped": True}))
        else:
            result = runner.evaluate(test, dump=os.path.join(cfg.output, f"{test}_predict.json"))
            say(json.dumps({"split": test, "accuracy": result}))
        return None

    say("Splits in Train data:", runner.dataset.splits)
    if cfg.data.valid_splits:
        say("Valid Oracle: %0.2f" % (runner.oracle_score(cfg.data.valid_splits) * 100))
    history = runner.train()
    say(json.dumps({
        "final_loss": history["loss"][-1] if history["loss"] else None,
        "train": history["train"],
        "valid": history["valid"],
    }))
    return history


if __name__ == "__main__":
    main()
