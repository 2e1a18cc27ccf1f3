"""Evaluation CLI (port of ``rgqa_tpu/cli/evaluate.py``).

Runs rejection-scored inference over one or more test splits and writes
``<output>/<split>_predict.json`` (the compute_accfpr-compatible
prediction contract) plus ``<output>/<split>_result.json`` with the
metric dict.  It takes the JAX CLI's flags (the port's copy of
``parse_cli``) and runs on the card (``--device cuda``, the default;
raises without one) unless given ``--device cpu``.

Scorers:
  msp | energy | odin | dropout | maha | branched  -- ``--scorer``
  ensemble  -- ``--load a.pth,b.pth,...`` (``--ensemble_method``)
  separate  -- a one-logit detector (``--load``) gating the answers of a
               GQA model (``--load_gqa``)
  ``--target_acc`` calibrates tau on the split and dumps ``{qid:
  [answer, confidence]}`` (full precision) with the tau in the result.

``--backbone`` lxmert (the default), uniter or vilt.  ``odin`` and
``maha`` perturb the RoI feats and boxes, which LXMERT and UNITER read
and ViLT has none of: on ViLT they exit with a message.  ``--branched``
is LXMERT's (UNITER and ViLT have no confidence head and raise).  Not ported, and refused by
name: ``--scorer frcnn``, ``clip``, ``match`` and ``caption``.

Example:
    python -m rgqa_tpu_torch.cli.evaluate --synthetic --data_root /tmp/gqa \
        --test testdev --scorer energy --output /tmp/gqa_out
    python -m rgqa_tpu_torch.cli.evaluate --backbone uniter --synthetic \
        --data_root /tmp/gqa --test testdev --scorer odin --output /tmp/gqa_uniter
"""

from __future__ import annotations

import dataclasses
import json
import os

from rgqa_tpu_torch.config import RunConfig, parse_cli
from rgqa_tpu_torch.data.dataset import GQADataset
from rgqa_tpu_torch.runner import GQARunner

NOT_PORTED = {
    "frcnn": "the FRCNN object-coverage scorer",
    "clip": "the CLIP scorer and backbone",
    "match": "the LXMERT pretraining heads",
    "caption": "the caps backbone",
}
ROI_SCORERS = ("odin", "maha")


def refuse_unported(cfg: RunConfig) -> None:
    """Exit on a ``--scorer`` that is not ported, or that needs RoI inputs
    on ViLT (the serve CLI refuses the same)."""
    scorer = cfg.ood.scorer
    if scorer in NOT_PORTED:
        raise SystemExit(f"--scorer {scorer} is not ported yet ({NOT_PORTED[scorer]})")
    if scorer in ROI_SCORERS and cfg.model.backbone == "vilt":
        raise SystemExit(
            f"--scorer {scorer} perturbs the RoI feats and boxes; --backbone vilt has none "
            "(the JAX package cannot run it there either)"
        )


def parse_args(argv=None) -> tuple[RunConfig, str, dict]:
    """The JAX CLI's flags -> (``RunConfig``, ``--device``, the run's
    plan: ``scorer``, ``ensemble`` paths, ``target_acc``); exits on what
    is not ported."""
    cfg, ns = parse_cli(argv)
    if not cfg.data.test_splits:
        raise SystemExit("--test <split[,split...]> is required")
    refuse_unported(cfg)
    scorer = cfg.ood.scorer
    ensemble = None
    if cfg.load and "," in cfg.load:
        scorer, ensemble = "ensemble", cfg.load.split(",")
        cfg = cfg.replace(load=ensemble[0])
    if scorer == "separate":
        if not cfg.load_gqa:
            raise SystemExit("--scorer separate needs --load_gqa <GQA model .pth>")
        if cfg.model.backbone != "lxmert" or (ns.ans_backbone or "lxmert") != "lxmert":
            raise SystemExit("--scorer separate is ported for --backbone lxmert (detector and answerer)")
        # The detector has a one-logit head; the runner reads its shape
        # off the strategy.
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, strategy="separate"))
    return cfg, ns.device, {"scorer": scorer, "ensemble": ensemble, "target_acc": ns.target_acc}


def make_runner(cfg: RunConfig, device: str, scorer: str) -> GQARunner:
    """The runner that scores: an evaluation runner, with bf16 serving
    weights under bf16, but for ``maha`` with f32 weights under bf16
    compute, as the JAX CLI's training runner keeps them
    (``init_train=scorer_name == "maha"``): they fit the estimator that
    ``sample_estimates.pkl`` keeps for every later run.  It stays an
    evaluation runner, so the evaluation flags (``--branched``,
    ``--strategy``, ...) pass as with the other scorers."""
    return GQARunner(cfg, init_train=False, f32_weights=scorer == "maha", device=device)


def main(argv=None) -> dict:
    cfg, device, plan = parse_args(argv)
    scorer = plan["scorer"]
    runner = make_runner(cfg, device, scorer)
    answerer = None
    if scorer == "separate":
        answerer = GQARunner(
            cfg.replace(
                load=cfg.load_gqa, train=dataclasses.replace(cfg.train, strategy="conf"),
                output=os.path.join(cfg.output, "answerer"),
            ),
            init_train=False, device=device,
        )
    all_results = {}
    for split in cfg.data.test_splits.split(","):
        encoded = runner._encode(GQADataset(cfg.data.data_root, split, add_uq=True))
        dump = os.path.join(cfg.output, f"{split}_predict.json")
        if plan["target_acc"] is not None:
            results = {"tau": runner.predict_with_thresh(encoded, dump=dump)["tau"]}
        elif scorer == "ensemble":
            results = runner.ensemble_ood_evaluate(encoded, plan["ensemble"], dump=dump)
        elif scorer == "separate":
            results = runner.gated_ood_evaluate(encoded, answerer, dump=dump)
        else:
            results = runner.ood_evaluate(encoded, dump=dump)
        all_results[split] = results
        with open(os.path.join(cfg.output, f"{split}_result.json"), "w") as f:
            json.dump(results, f, indent=2)
        print(split, json.dumps(results))
    return all_results


if __name__ == "__main__":
    main()
