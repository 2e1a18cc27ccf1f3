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
  caption   -- the Q-C matcher (``--backbone caps``; ``--load`` a trained
               GQABERT) gating the answers of a GQA model (``--load_gqa``)
  clip      -- the CLIP image-question cosine from a local HF CLIP
               checkpoint directory (``--clip_path``), answers from the
               ``--load`` model; pixels from ``<data_root>/pixels_clip_<size>/``
               (``prepare_data --pixel_transform clip``; a synthetic root
               writes its own) or the JPEGs under ``<data_root>/images``
               (PIL); f32, ``--batchSize`` questions a CLIP forward
  match     -- ``softmax(matched)[:, 1]`` of LXMERT's pretraining heads
               from a reference ``model_LXRT.pth`` (``--loadLXMERT``; an
               orbax directory through its ``<dir>_LXRT.pth`` export),
               f32, answers from the ``--load``
               model
  frcnn     -- object coverage: 1 iff every noun of the question names
               an object the detector found in its image (the pack's
               ``objects_id`` against ``<data_root>/objects_vocab.txt``),
               answers from the ``--load`` model
  ``--target_acc`` calibrates tau on the split and dumps ``{qid:
  [answer, confidence]}`` (full precision) with the tau in the result.

``--backbone`` lxmert (the default), uniter, vilt, butd or caps.  ``odin``
and ``maha`` perturb the RoI feats and boxes, which LXMERT, UNITER and
BUTD read and ViLT and the caption matcher have none of: there they exit
with a message.  ``--branched`` is LXMERT's and BUTD's (UNITER, ViLT and
the matcher have no confidence head and raise).  The gated scorers
(``separate``, ``caption``) take any detector and, with
``--ans_backbone``, any answerer (default: the detector's backbone, for
the caption matcher lxmert, as the JAX CLI).

Under N data-parallel ranks (``python -m torch.distributed.run
--nproc_per_node N -m rgqa_tpu_torch.cli.evaluate ...``) each rank scores
its rows of every batch; rank 0 writes the dumps and the results.

Example:
    python -m rgqa_tpu_torch.cli.evaluate --synthetic --data_root /tmp/gqa \
        --test testdev --scorer energy --output /tmp/gqa_out
    python -m rgqa_tpu_torch.cli.evaluate --backbone uniter --synthetic \
        --data_root /tmp/gqa --test testdev --scorer odin --output /tmp/gqa_uniter
    python -m rgqa_tpu_torch.cli.evaluate --backbone caps --scorer caption \
        --synthetic --data_root /tmp/gqa --test testdev --load_gqa BEST.pth \
        --ans_backbone butd --output /tmp/gqa_caps
"""

from __future__ import annotations

import dataclasses
import json
import os

from rgqa_tpu_torch.config import RunConfig, parse_cli
from rgqa_tpu_torch.data.dataset import GQADataset
from rgqa_tpu_torch.parallel import initialize_distributed, on_main
from rgqa_tpu_torch.runner import GQARunner

ROI_SCORERS = ("odin", "maha")
GATED_SCORERS = ("separate", "caption")
NO_ROI_BACKBONES = ("vilt", "caps")


def refuse_unported(cfg: RunConfig) -> None:
    """Exit on a ``--scorer`` that needs RoI inputs on ViLT or the caption
    matcher (the serve CLI refuses the same)."""
    scorer = cfg.ood.scorer
    if scorer in ROI_SCORERS and cfg.model.backbone in NO_ROI_BACKBONES:
        raise SystemExit(
            f"--scorer {scorer} perturbs the RoI feats and boxes; --backbone {cfg.model.backbone} "
            "has none (the JAX package cannot run it there either)"
        )


def parse_args(argv=None) -> tuple[RunConfig, str, dict]:
    """The JAX CLI's flags -> (``RunConfig``, ``--device``, the run's
    plan: ``scorer``, ``ensemble`` paths, ``target_acc``, and for the
    gated scorers the answerer's ``answerer_model`` config); exits on
    what is not ported."""
    cfg, ns = parse_cli(argv)
    if not cfg.data.test_splits:
        raise SystemExit("--test <split[,split...]> is required")
    refuse_unported(cfg)
    scorer = cfg.ood.scorer
    if scorer == "clip" and not cfg.ood.clip_path:
        raise SystemExit("--scorer clip needs --clip_path <local CLIP checkpoint dir> (nothing is downloaded)")
    if scorer == "match" and not cfg.load_lxmert:
        raise SystemExit("--scorer match needs --loadLXMERT <pretraining .pth>")
    ensemble = None
    if cfg.load and "," in cfg.load:
        scorer, ensemble = "ensemble", cfg.load.split(",")
        cfg = cfg.replace(load=ensemble[0])
    answerer_model = None
    if scorer in GATED_SCORERS:
        if not cfg.load_gqa:
            raise SystemExit(f"--scorer {scorer} needs --load_gqa <GQA model .pth>")
        # The answerer's backbone: --ans_backbone, else the detector's; a
        # caption matcher defaults to an lxmert answerer (JAX
        # cli/evaluate.py:102-111).
        answerer_model = cfg.model
        if ns.ans_backbone:
            answerer_model = dataclasses.replace(answerer_model, backbone=ns.ans_backbone)
        elif answerer_model.backbone == "caps":
            answerer_model = dataclasses.replace(answerer_model, backbone="lxmert")
        if answerer_model.backbone == "caps":
            raise SystemExit("--ans_backbone caps: the caption matcher gives no answers")
        # The detector has a one-logit head; the runner reads its shape
        # off the strategy.
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, strategy=scorer))
    return cfg, ns.device, {"scorer": scorer, "ensemble": ensemble, "target_acc": ns.target_acc,
                            "answerer_model": answerer_model}


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
    device = initialize_distributed(device) or device
    scorer = plan["scorer"]
    runner = make_runner(cfg, device, scorer)
    answerer = None
    if scorer in GATED_SCORERS:
        answerer = GQARunner(
            cfg.replace(
                load=cfg.load_gqa, model=plan["answerer_model"],
                train=dataclasses.replace(cfg.train, strategy="conf"),
                output=os.path.join(cfg.output, "answerer"),
            ),
            init_train=False, device=device,
        )
    clip = pretrain_forward = None
    if scorer == "clip":
        from rgqa_tpu_torch.scorers.clip import ClipScorer

        clip = ClipScorer(cfg.ood.clip_path, batch_size=cfg.train.batch_size, device=device)
    elif scorer == "match":
        from rgqa_tpu_torch.models.zoo import load_pretraining

        _, pretrain_forward = load_pretraining(cfg.load_lxmert, runner.model_cfg.encoder, device=device)
    all_results = {}
    for split in cfg.data.test_splits.split(","):
        encoded = runner._encode(GQADataset(cfg.data.data_root, split, add_uq=True))
        dump = os.path.join(cfg.output, f"{split}_predict.json")
        if plan["target_acc"] is not None:
            results = {"tau": runner.predict_with_thresh(encoded, dump=dump)["tau"]}
        elif scorer == "ensemble":
            results = runner.ensemble_ood_evaluate(encoded, plan["ensemble"], dump=dump)
        elif scorer in GATED_SCORERS:
            results = runner.gated_ood_evaluate(encoded, answerer, dump=dump)
        elif scorer == "clip":
            results = runner.clip_ood_evaluate(
                encoded, clip.scores, os.path.join(cfg.data.data_root, "images"), dump=dump,
                batch_size=cfg.train.batch_size,
            )
        elif scorer == "match":
            results = runner.match_ood_evaluate(encoded, pretrain_forward, dump=dump)
        elif scorer == "frcnn":
            results = runner.coverage_ood_evaluate(
                encoded, os.path.join(cfg.data.data_root, "objects_vocab.txt"), dump=dump)
        else:
            results = runner.ood_evaluate(encoded, dump=dump)
        all_results[split] = results
        on_main(runner.mesh, _write_results, cfg.output, split, results)
    return all_results


def _write_results(output: str, split: str, results: dict) -> None:
    with open(os.path.join(output, f"{split}_result.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(split, json.dumps(results))


if __name__ == "__main__":
    main()
