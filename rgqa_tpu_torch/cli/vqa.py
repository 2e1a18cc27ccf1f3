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
"""

from __future__ import annotations

import json
import os

from rgqa_tpu_torch.config import parse_cli
from rgqa_tpu_torch.vqa_task import VQARunner


def main(argv=None):
    cfg, ns = parse_cli(argv)
    test = cfg.data.test_splits
    runner = VQARunner(cfg, init_train=test is None, device=ns.device)

    if test is not None:
        # Reference dispatch (vqa.py:183-203): 'test' -> predict-only dump,
        # any other split -> evaluate and dump.
        if "test" in test:
            runner.predict(test, dump=os.path.join(cfg.output, "test_predict.json"))
            print(json.dumps({"split": test, "dumped": True}))
        else:
            result = runner.evaluate(test, dump=os.path.join(cfg.output, f"{test}_predict.json"))
            print(json.dumps({"split": test, "accuracy": result}))
        return None

    print("Splits in Train data:", runner.dataset.splits)
    if cfg.data.valid_splits:
        print("Valid Oracle: %0.2f" % (runner.oracle_score(cfg.data.valid_splits) * 100))
    history = runner.train()
    print(json.dumps({
        "final_loss": history["loss"][-1] if history["loss"] else None,
        "train": history["train"],
        "valid": history["valid"],
    }))
    return history


if __name__ == "__main__":
    main()
