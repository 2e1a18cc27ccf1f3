"""Data-parallel check: named paths of the port run by one rank of W, for
``tests/test_torch_parallel.py`` (two gloo ranks on the CPU) and
``chip_smoke.py`` (two gloo ranks on one card, and one process).

    python -m rgqa_tpu_torch.tools.ddp_check --world 2 --rank R --port P \\
        --device cpu --root DIR --out DIR --paths rp,mixup_v1,eval_msp

Each rank joins the group through the ``TCPStore`` at ``localhost:P``
that :func:`launch` hosts (so the port is bound from the moment it is
picked), with the given backend (none at ``--world 1``); the join and
every collective fail after ``--timeout`` seconds.  Rank 0 writes the
synthetic roots under
``--root`` (the others wait), and the paths run in order, each through
the entry point a user calls (``GQARunner.train``, ``PretrainRunner``,
``VQARunner``, ``Nlvr2Runner``, ``cli.evaluate.main``) at the tiny widths
the CPU tests use, or with ``--full`` at LXMERT's (9 / 5 / 5 x 768, 36 x
2048 RoIs).  Each training step is recorded: its global loss (or the
pretraining parts), the attention kernels' launches, and on a card its
time between CUDA events; the streams' draws too (the RP shifts, the
attention seeds, the mixup draws, the batches' question ids).  The
evaluate paths report every question's answer and confidence at full
precision, and rank 0's prediction dump (``eval_maha`` also the path of
its fit's moments, ``maha_moments.pt``: the sums, counts and second
moment that the covariance's inverse is taken from).  Each rank prints
``DDP_CHECK_PATH <name>`` on stderr as a path starts, and one
``DDP_CHECK {json}`` line last; :func:`launch` spawns the ranks within a
deadline in proportion to the paths and collects those lines.  It
imports nothing of JAX.

Paths: ``rp``, ``mixup_v1``, ``treemix`` (``treemix_v2``), ``weighted_rp``
(``--strategy weight``, caption-overlap weights), ``minmax``
(``--strategy resampling``), ``villa`` (``--strategy adv``), ``distill``
(``--strategy distill_online``, the teacher ``rp``'s ``LAST.pth``),
``weight_model`` (``--strategy weight --update_weight_model`` with the
CLIP checkpoint ``--clip_path``),
``pretrain`` (all six tasks), ``vqa``, ``nlvr2``, ``eval_msp`` and
``eval_maha`` (both from ``rp``'s initial weights, ``INIT.pth``: the
same at any world size; maha's with the encoder's dense weights scaled,
:func:`_varied_pth`), ``rp_drop`` (``rp`` at dropout 0.1), ``cli`` (the
train CLI's ``main`` for an epoch of RP, then ``GQARunner.train(resume=
"LAST")`` for another), ``streams`` (the dropout streams' first
draws, no model), ``serve`` (the serve CLI's ``main`` on the testdev
split as JSONL with a malformed record and an unknown ``img_id``, from
``INIT.pth``, msp: the printed lines and the unrounded scores),
``distill_mc`` (the distill CLI, cartography over ``--passes 2`` from
``INIT.pth``), ``distill_ensemble`` (the distill CLI with the teachers
``rp``'s ``INIT.pth`` and ``LAST.pth``), ``verifier``
(``VerifierTrainer``: an epoch of ``train`` of a one-logit verifier over
the answerer ``INIT.pth``, then ``ood_evaluate``), and
``distill_mc_drop`` / ``verifier_drop`` (the two at dropout 0.1: the
passes and steps on #4 / #5, each rank on its own stream).  Without
``--device cpu`` it runs on the card, and raises without one.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

__all__ = ["PATHS", "Recorder", "recording", "nlvr2_rows", "serve_records", "serve_argv", "run", "launch", "main"]

PATHS = ("rp", "mixup_v1", "treemix", "weighted_rp", "minmax", "villa", "distill", "weight_model", "pretrain", "vqa",
         "nlvr2", "eval_msp", "eval_maha", "rp_drop", "cli", "streams", "serve", "distill_mc", "distill_ensemble",
         "verifier", "distill_mc_drop", "verifier_drop")
# The paths that end in _drop run at dropout 0.1 (attention dropout on #4 / #5).
DROP = ["--dropout", "0.1"]
# launch()'s deadline: the ranks' start and join, then this much a path.
START_SECONDS = 60.0
PATH_SECONDS = 60.0
KERNELS = ("fused_attention", "fused_attention_bwd", "fused_attention_dropout", "fused_attention_dropout_bwd",
           "fused_attention_long", "fused_attention_long_bwd", "fused_attention_dropout_long",
           "fused_attention_dropout_long_bwd")
TINY = ["--llayers", "1", "--xlayers", "1", "--rlayers", "1", "--hidden_size", "32", "--num_heads", "4"]
GQA_PATHS = {
    "rp": ["--sample_pair"],
    "rp_drop": ["--sample_pair", *DROP],
    "mixup_v1": ["--mixup_mode", "mixup_v1", "--mixup_beta", "5"],
    "treemix": ["--mixup_mode", "treemix_v2"],
    "weighted_rp": ["--strategy", "weight"],
    "minmax": ["--strategy", "resampling", "--train_pos", "GQAUQ_train_questions_unsup",
               "--train_neg", "GQAUQ_train_questions_unsup_hard"],
    "villa": ["--strategy", "adv", "--adv_steps", "2"],
    "distill": ["--strategy", "distill_online", "--mixup_mode", "mixup_v1"],
    "weight_model": ["--strategy", "weight", "--update_weight_model"],
}


def _counts() -> dict:
    from rgqa_tpu_torch.ops import attention

    return {k: getattr(attention, f"{k}_cuda").launches for k in KERNELS}


def _reset() -> None:
    from rgqa_tpu_torch.ops import attention

    for k in KERNELS:
        getattr(attention, f"{k}_cuda").launches = 0


class Recorder:
    """Each training step's global loss, launches and time, and the draws
    of the streams."""

    def __init__(self, device: torch.device, shifts: Optional[list] = None):
        self.cuda = device.type == "cuda"
        self.steps: list = []
        self.shifts: list = []
        self.seeds: list = []
        self.mixup: list = []
        self.qids: list = []
        self.given_shifts = list(shifts) if shifts else None

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def run_step(self, step, args, kw):
        if self.given_shifts is not None and kw.get("shift") is None and "draws" not in kw:
            kw = dict(kw, shift=self.given_shifts.pop(0))
        self._sync()
        _reset()
        t0 = time.perf_counter()
        if self.cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        out = step(*args, **kw)
        if self.cuda:
            end.record()
        self._sync()
        wall = (time.perf_counter() - t0) * 1e3
        aux = out[1] if isinstance(out, tuple) else out  # the min-max step: (weight gradients, aux)
        loss = float(aux["loss"]) if "loss" in aux else {k: float(v) for k, v in aux.items()}
        if "loss_w" in aux:  # the weight model's objective
            loss = {"loss": loss, "loss_w": float(aux["loss_w"])}
        self.steps.append({"loss": loss, "launches": _counts(), "wall_ms": wall,
                           "ms": start.elapsed_time(end) if self.cuda else None})
        return out

    def watch(self, rng) -> None:
        """Record the shifts and attention seeds ``rng`` gives."""
        if rng is None or getattr(rng, "_watched", False):
            return
        seed, shift = rng.seed, rng.shift

        def seeds():
            self.seeds.append(seed())
            return self.seeds[-1]

        def shifts(b):
            self.shifts.append(shift(b))
            return self.shifts[-1]

        rng.seed, rng.shift, rng._watched = seeds, shifts, True

    def factory(self, make, pair: bool = False):
        """``make`` (a step factory) whose steps are recorded."""

        def wrapped(*a, **kw):
            self.watch(kw.get("rng"))
            made = make(*a, **kw)
            step = made[0] if pair else made

            def run(*sa, **skw):
                return self.run_step(step, sa, skw)

            return (run, made[1]) if pair else run

        return wrapped


@contextlib.contextmanager
def _patched(pairs):
    """Set ``(module, name, value)`` attributes for the block."""
    old = [(m, n, getattr(m, n)) for m, n, _ in pairs]
    for m, n, v in pairs:
        setattr(m, n, v)
    try:
        yield
    finally:
        for m, n, v in old:
            setattr(m, n, v)


def recording(rec: Recorder):
    """Every step factory of the runners, recording; the mixup draws and
    the batches' question ids too."""
    from rgqa_tpu_torch import nlvr2_task, runner, vqa_task
    from rgqa_tpu_torch.pretrain import trainer
    from rgqa_tpu_torch.train import step as tstep

    draw, batches = tstep.draw_mixup, runner.batch_iterator

    def draw_mixup(*a, **kw):
        draws = draw(*a, **kw)
        rec.mixup.append({k: (float(v.double().sum()) if torch.is_tensor(v) else v) for k, v in draws.items()})
        return draws

    def batch_iterator(*a, **kw):
        for item in batches(*a, **kw):
            rec.qids.append(list(item[0]))
            yield item

    reduce = nlvr2_task.reduce_gradients

    def nlvr2_reduce(mesh, params, extras):
        out = reduce(mesh, params, extras)
        rec.steps.append({"loss": float(out[0]), "launches": _counts(), "wall_ms": None, "ms": None})
        _reset()
        return out

    return _patched([
        (runner, "make_train_step", rec.factory(runner.make_train_step)),
        (runner, "make_adv_train_step", rec.factory(runner.make_adv_train_step)),
        (runner, "make_minmax_step", rec.factory(runner.make_minmax_step)),
        (runner, "make_online_distill_step", rec.factory(runner.make_online_distill_step)),
        (runner, "make_weighted_clip_train_step", rec.factory(runner.make_weighted_clip_train_step)),
        (runner, "batch_iterator", batch_iterator),
        (vqa_task, "make_train_step", rec.factory(vqa_task.make_train_step)),
        (trainer, "make_pretrain_step", rec.factory(trainer.make_pretrain_step, pair=True)),
        (tstep, "draw_mixup", draw_mixup),
        (nlvr2_task, "reduce_gradients", nlvr2_reduce),
    ])


def nlvr2_rows(root: str, split: str, n: int, seed: int) -> list:
    """``n`` NLVR2 pairs over a synthetic GQA root's images, with the
    sentences of its ``split`` and labels from a seeded generator."""
    with open(os.path.join(root, f"{split}.json")) as f:
        questions = json.load(f)
    with open(os.path.join(root, "features", "img_ids.json")) as f:
        img_ids = json.load(f)
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        a, b = rng.choice(len(img_ids), 2, replace=False)
        rows.append({"uid": f"{split}-{i:04d}", "img0": img_ids[a], "img1": img_ids[b],
                     "sent": questions[i % len(questions)]["sent"], "label": int(rng.integers(2))})
    return rows


def _roots(args, mesh) -> tuple[str, str, str]:
    """(the GQA root, the VQA root, the Mahalanobis fit's GQA root),
    written by rank 0.  The fit's root has more train rows than the
    features are wide (256 at the tiny widths, 2048 at LXMERT's 768), as
    a real train split has."""
    from rgqa_tpu_torch.data.synthetic import SyntheticSpec, make_synthetic_gqa, make_synthetic_vqa
    from rgqa_tpu_torch.parallel import on_main

    n_images, n_train, n_valid, n_testdev = (int(x) for x in args.spec.split(","))
    spec = SyntheticSpec(n_images=n_images, n_train=n_train, n_valid=n_valid, n_testdev=n_testdev, seed=3)
    gqa, vqa, maha = (os.path.join(args.root, name) for name in ("gqa", "vqa", "gqa_maha"))
    maha_spec = SyntheticSpec(n_images=128 if args.full else 32, n_train=2048 if args.full else 256,
                              n_valid=n_valid, n_testdev=n_testdev, seed=3)

    def write():
        for root, make, sp in ((gqa, make_synthetic_gqa, spec), (vqa, make_synthetic_vqa, spec),
                               (maha, make_synthetic_gqa, maha_spec)):
            if not os.path.exists(os.path.join(root, "trainval_ans2label.json")):
                make(root, sp)

    on_main(mesh, write)
    return gqa, vqa, maha


def _streams(args, mesh, device) -> dict:
    """The dropout streams' first draws on this rank: attention seeds and
    hidden-dropout bytes (per rank), the RP shift, the shuffle and a
    mixup draw (shared)."""
    from rgqa_tpu_torch.data.batching import batch_indices
    from rgqa_tpu_torch.ops.dropout import DropoutRng
    from rgqa_tpu_torch.train.step import draw_mixup

    rng = DropoutRng.for_rank(args.seed, device, rank=mesh.rank, world=mesh.world)
    seeds = [rng.seed(), rng.shift(args.batch), rng.seed()]
    hidden = torch.randint(0, 256, (64,), generator=rng.device, device=device).tolist()
    order = np.concatenate(list(batch_indices(64, 8, shuffle=True, rng=np.random.default_rng(args.seed))))
    feats = torch.zeros(args.batch // mesh.world, 36, 4)
    draws = draw_mixup({"input_ids": torch.zeros(args.batch // mesh.world, 4, dtype=torch.long), "feats": feats,
                        "boxes": feats}, "mixup_v1", 1.0, 5.0, rng.host, rows=args.batch)
    return {"attention_seeds": [seeds[0], seeds[2]], "shift": seeds[1], "hidden": hidden, "shuffle": order.tolist(),
            "mixup": {k: (v.tolist() if torch.is_tensor(v) else v) for k, v in draws.items()}}


def _save_whole(runner, path: str) -> None:
    """``runner``'s weights as a reference ``.pth`` at ``path``, which
    appears only once it is whole."""
    from rgqa_tpu_torch.train.state import save_reference_pth

    save_reference_pth(runner.model, runner.model_cfg, path + ".part")
    os.replace(path + ".part", path)


def _varied_pth(src: str, dst: str, scale: float = 10.0) -> None:
    """``src`` (a GQA-LXMERT ``.pth``) with the encoder's dense weights
    scaled by ``scale``: near the random init the pooled features hardly
    depend on the input and their covariance is near singular, so the
    Mahalanobis fit's pseudo-inverse would be round-off
    (``tests/test_torch_scoring_slice.py`` varies its weights alike)."""
    sd = torch.load(src, map_location="cpu", weights_only=True)
    enc = "lxrt_encoder.model.bert."
    torch.save({k: v * scale if k.startswith(enc) and ".embeddings." not in k and v.dim() == 2 else v
                for k, v in sd.items()}, dst)


def serve_records(root: str) -> list:
    """The serve path's input lines: the ``testdev`` split of ``root`` as
    JSONL records, then a malformed record and one with an unknown
    ``img_id``."""
    with open(os.path.join(root, "testdev.json")) as f:
        rows = json.load(f)
    lines = [json.dumps({"question_id": r["question_id"], "sent": r["sent"], "img_id": r["img_id"]}) for r in rows]
    return lines + ["{not json", json.dumps({"question_id": "q_unknown", "sent": "what is it ?",
                                             "img_id": "no_such_image"})]


def _base(args) -> list:
    """The flags every path shares."""
    return ["--batchSize", str(args.batch), "--epochs", "1", "--dropout", str(args.dropout), "--seed",
            str(args.seed), "--lr", str(args.lr), "--fp32", *([] if args.full else TINY)]


def serve_argv(args, root: str, out: str) -> list:
    """The serve path's CLI arguments (less ``--device``) on ``root``,
    writing under ``out``: ``rp``'s ``INIT.pth``, msp, one wave at the
    end of the input."""
    return ["--data_root", root, "--synthetic", "--test", "testdev", "--load",
            os.path.join(args.out, "rp", "INIT.pth"), "--wave_timeout", "0", *_base(args), "--output", out]


def _read_dump(path: str) -> list:
    with open(path) as f:
        rows = json.load(f)
    return [[r["questionId"], r["prediction"], r["confidence"]] for r in rows]


def run(args) -> dict:
    """Run ``args.paths`` on this rank; returns ``{path: record}``."""
    import torch.distributed as dist

    from rgqa_tpu_torch.cli import distill as distill_cli
    from rgqa_tpu_torch.cli import evaluate, serve
    from rgqa_tpu_torch.cli import train as train_cli
    from rgqa_tpu_torch.config import parse_cli
    from rgqa_tpu_torch.data.dataset import GQADataset
    from rgqa_tpu_torch.device import resolve_device
    from rgqa_tpu_torch.eval import ScoringMixin
    from rgqa_tpu_torch.nlvr2_task import Nlvr2Runner
    from rgqa_tpu_torch.parallel import join_group, make_mesh, on_main
    from rgqa_tpu_torch.pretrain.trainer import ALL_TASKS, PretrainRunner
    from rgqa_tpu_torch.runner import GQARunner
    from rgqa_tpu_torch.scorers import maha as maha_scorer
    from rgqa_tpu_torch.verifier import VerifierTrainer
    from rgqa_tpu_torch.vqa_task import VQARunner

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if args.world > 1:  # a client of the store that launch() hosts
        store = dist.TCPStore("localhost", args.port, world_size=args.world, is_master=False,
                              timeout=datetime.timedelta(seconds=args.timeout))
        join_group(args.backend, args.rank, args.world, store=store, timeout=args.timeout)
    mesh = make_mesh(device)
    dev = "cpu" if device.type == "cpu" else "cuda"
    gqa, vqa, maha_root = _roots(args, mesh)
    base = _base(args)
    init = os.path.join(args.out, "rp", "INIT.pth")
    out = {}
    for name in args.paths.split(","):
        print(f"DDP_CHECK_PATH {name}", file=sys.stderr, flush=True)
        work = os.path.join(args.out, name)
        rec = Recorder(device, shifts=args.shifts if name == "rp" and args.shifts else None)
        t0 = time.perf_counter()
        with recording(rec):
            if name in GQA_PATHS:
                extra = list(GQA_PATHS[name])
                if name == "distill":
                    extra += ["--teacher_path", os.path.join(args.out, "rp", "LAST")]
                if name == "rp" and args.load:
                    extra += ["--load", args.load]
                if name == "weight_model":
                    if not args.clip_path:
                        raise ValueError("the weight_model path needs --clip_path (a CLIP checkpoint directory)")
                    extra += ["--clip_path", args.clip_path]
                cfg, _ = parse_cli(["--data_root", gqa, "--synthetic", *base, *extra, "--output", work])
                runner = GQARunner(cfg, device=device)
                if name == "rp":  # the evaluate paths' weights, the same at any world size (whole once it exists)
                    on_main(mesh, _save_whole, runner, os.path.join(work, "INIT.pth"))
                record = {"history": runner.train()}
            elif name == "cli":
                # lr 1e-2: the valid accuracy leaves 0 in the first epoch, so BEST.pth is written.
                argv = ["--data_root", gqa, "--synthetic", *base, "--sample_pair", "--lr", "1e-2", "--output", work]
                first = train_cli.main([*argv, "--device", "cpu" if device.type == "cpu" else "cuda"])
                cfg, _ = parse_cli(argv)
                record = {"history": first, "resumed": GQARunner(cfg, device=device).train(resume="LAST")}
            elif name == "pretrain":
                cfg, _ = parse_cli(["--data_root", gqa, "--synthetic", "--train", "train,valid", "--valid",
                                    "testdev", *base, "--batchSize", str(2 * args.batch), "--output", work])
                runner = PretrainRunner(cfg, ALL_TASKS, device=device)
                if args.pretrain_load:
                    runner.model.load_state_dict(torch.load(args.pretrain_load, map_location=device,
                                                            weights_only=True))
                if args.draws:
                    given = torch.load(args.draws, weights_only=False)
                    runner.train_draws = lambda batch, generator: given["train"].pop(0)
                    runner.eval_draws = lambda batch: given["eval"]
                record = {"history": runner.train()}
            elif name == "vqa":
                cfg, _ = parse_cli(["--data_root", vqa, "--synthetic", "--train", "train", "--valid", "minival",
                                    *base, "--output", work])
                history = VQARunner(cfg, device=device).train()
                record = {"history": history}
            elif name == "nlvr2":
                cfg, _ = parse_cli(["--data_root", gqa, *base, "--output", work])
                splits = {"train": nlvr2_rows(gqa, "train", 4 * args.batch, 0),
                          "valid": nlvr2_rows(gqa, "valid", 2 * args.batch + 3, 1)}
                record = {"history": Nlvr2Runner(cfg, splits, device=device).train()}
            elif name in ("eval_msp", "eval_maha"):
                scorer = name.split("_")[1]
                load = os.path.join(args.out, "rp", "INIT")
                if scorer == "maha":
                    load = os.path.join(args.out, "rp", "varied.pth")
                    on_main(mesh, _varied_pth, os.path.join(args.out, "rp", "INIT.pth"), load)
                _reset()
                scored, moments = {}, []
                rejection, accumulate = ScoringMixin._rejection_results, maha_scorer.accumulate_moments

                def keep(runner, encoded, quesid2ans, dump):
                    scored.update(quesid2ans)
                    return rejection(runner, encoded, quesid2ans, dump)

                def keep_moments(*a, **kw):
                    moments.append(accumulate(*a, **kw))
                    return moments[-1]

                with _patched([(ScoringMixin, "_rejection_results", keep),
                               (maha_scorer, "accumulate_moments", keep_moments)]):
                    evaluate.main(["--data_root", maha_root if scorer == "maha" else gqa, "--synthetic", "--test",
                                   "testdev", "--scorer", scorer, "--load", load, *base, "--device", dev,
                                   "--output", work])
                record = {"launches": _counts(), "scores": [[q, a, float(c)] for q, (a, c) in scored.items()]}
                if mesh.is_main:
                    record["dump"] = _read_dump(os.path.join(work, "testdev_predict.json"))
                    if moments:  # the fit's sums, counts and second moment, before any inverse
                        record["moments"] = os.path.join(work, "maha_moments.pt")
                        torch.save([m.cpu() for m in moments[0]], record["moments"])
            elif name == "serve":
                scored, score_rows = [], ScoringMixin.score_rows

                def keep_rows(runner, encoded, scorer=None):
                    rows = score_rows(runner, encoded, scorer)
                    scored.extend(rows)
                    return rows

                printed = io.StringIO()
                _reset()
                with _patched([(ScoringMixin, "score_rows", keep_rows)]):
                    served = serve.main([*serve_argv(args, gqa, work), "--device", dev],
                                        stdin=iter([line + "\n" for line in serve_records(gqa)]), stdout=printed)
                record = {"launches": _counts(), "served": served, "lines": printed.getvalue().splitlines(),
                          "scores": [[a, float(c)] for a, c in scored]}
            elif name in ("distill_mc", "distill_mc_drop", "distill_ensemble"):
                # --output_name a path: the rows go to this run's folder, not the shared root.
                argv = ["--data_root", gqa, "--synthetic", *base, "--device", dev, "--output", work,
                        "--output_name", os.path.join(work, "rows")]
                if name != "distill_ensemble":
                    argv += ["--load", init, "--n_candidates", str(4 * args.batch + 3), "--passes", "2"]
                    argv += DROP if name.endswith("_drop") else []
                else:
                    argv += ["--teacher_path", f"{init},{os.path.join(args.out, 'rp', 'LAST.pth')}"]
                _reset()
                rows = distill_cli.main(argv)
                record = {"launches": _counts(), "rows": rows}
                if mesh.is_main:
                    with open(os.path.join(work, "rows.json")) as f:
                        record["written"] = json.load(f) == rows
            elif name in ("verifier", "verifier_drop"):
                scored = {}
                rejection = ScoringMixin._rejection_results

                def keep(runner, encoded, quesid2ans, dump):
                    scored.update(quesid2ans)
                    return rejection(runner, encoded, quesid2ans, dump)

                acfg, _ = parse_cli(["--data_root", gqa, "--synthetic", *base, "--load", init, "--output",
                                     os.path.join(work, "answerer")])
                vcfg, _ = parse_cli(["--data_root", gqa, "--synthetic", *base, "--strategy", "separate",
                                     *(DROP if name.endswith("_drop") else []), "--output",
                                     os.path.join(work, "verifier")])
                answerer = GQARunner(acfg, init_train=False, device=device)
                ver = GQARunner(vcfg, device=device)
                trainer = VerifierTrainer(ver, answerer, topk=3, seed=5)
                _reset()
                losses = trainer.train(ver._encode(GQADataset(gqa, "train,train_uq", add_uq=True)), epochs=1,
                                       batch_size=args.batch)
                train_launches = _counts()
                _reset()
                with _patched([(ScoringMixin, "_rejection_results", keep)]):
                    results = trainer.ood_evaluate(ver._encode(GQADataset(gqa, "testdev", add_uq=True)),
                                                   dump=os.path.join(work, "testdev_predict.json"))
                record = {"losses": losses, "train_launches": train_launches, "launches": _counts(),
                          "results": {k: float(v) for k, v in results.items() if np.isscalar(v)},
                          "scores": [[q, a, float(c)] for q, (a, c) in scored.items()]}
                if mesh.is_main:
                    record["dump"] = _read_dump(os.path.join(work, "testdev_predict.json"))
            elif name == "streams":
                record = _streams(args, mesh, device)
            else:
                raise ValueError(f"unknown path {name!r}: one of {', '.join(PATHS)}")
        if device.type == "cuda":
            torch.cuda.synchronize()
        record.update(seconds=time.perf_counter() - t0, steps=rec.steps, shifts=rec.shifts, seeds=rec.seeds,
                      mixup=rec.mixup, qids=rec.qids)
        out[name] = record
    return out


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--world", type=int, default=1)
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--port", type=int, default=0, help="the port of the TCPStore that launch() hosts")
    p.add_argument("--timeout", type=float, default=600.0,
                   help="seconds that the join and each collective may take before the rank fails")
    p.add_argument("--backend", default="gloo")
    p.add_argument("--device", default="cuda", help="cuda (the default; raises without a card), cuda:N or cpu")
    p.add_argument("--root", required=True, help="where the synthetic roots are written (rank 0)")
    p.add_argument("--out", required=True, help="the runs' outputs, one folder a path")
    p.add_argument("--paths", default=",".join(PATHS))
    p.add_argument("--spec", default="16,32,16,24", help="n_images,n_train,n_valid,n_testdev of the roots")
    p.add_argument("--batch", type=int, default=8, help="the global batch (pretraining: twice it)")
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--full", action="store_true", help="LXMERT's widths (else the CPU tests' tiny ones)")
    p.add_argument("--load", default=None, help="rp's initial weights (a GQA .pth)")
    p.add_argument("--shifts", default=None, type=lambda s: [int(x) for x in s.split(",")],
                   help="rp's roll of each step, comma-separated (else drawn)")
    p.add_argument("--pretrain_load", default=None, help="pretraining's initial weights (a port state dict)")
    p.add_argument("--clip_path", default=None, help="weight_model's CLIP checkpoint directory")
    p.add_argument("--draws", default=None, help="pretraining's masks: a torch file {'train': [...], 'eval': {...}}")
    return p


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    out = run(args)
    print("DDP_CHECK " + json.dumps({"rank": args.rank, "world": args.world, "paths": out}), flush=True)
    return out


def _paths_of(argv: list) -> list:
    """The paths that ``argv`` asks for (the last ``--paths``, else all)."""
    given = [argv[i + 1] for i, a in enumerate(argv[:-1]) if a == "--paths"]
    return (given[-1] if given else ",".join(PATHS)).split(",")


def _last_path(stderr: str) -> Optional[str]:
    marks = [l.split(" ", 1)[1] for l in stderr.splitlines() if l.startswith("DDP_CHECK_PATH ")]
    return marks[-1] if marks else None


def launch(world: int, argv: list, *, env: Optional[dict] = None, path_seconds: float = PATH_SECONDS,
           cwd: Optional[str] = None, module: str = "rgqa_tpu_torch.tools.ddp_check", record: str = "DDP_CHECK ",
           budget: Optional[float] = None) -> list:
    """Spawn ``world`` ranks of this module (or of ``module``, which takes
    the same ``--world`` / ``--rank`` / ``--port`` / ``--timeout`` flags
    and prints a ``record`` line last) with ``argv`` and return each
    rank's record, in rank order.  This process hosts the
    group's ``TCPStore`` on a port the OS picks, bound from the start, and
    the ranks join it as clients.  The ranks have ``START_SECONDS`` plus
    ``path_seconds`` for each path of ``argv`` (or ``budget`` seconds;
    also each rank's ``--timeout``); a rank that fails or is still
    running then ends the others, and the error, with their output, names
    each rank's exit and the path it was in."""
    import torch.distributed as dist

    budget = budget or START_SECONDS + path_seconds * len(_paths_of(argv))
    store = port = None
    if world > 1:
        store = dist.TCPStore("localhost", 0, world_size=world, is_master=True, wait_for_workers=False,
                              timeout=datetime.timedelta(seconds=budget))
        port = store.port
    # Each rank writes to files, not pipes: a rank whose output outgrew a
    # pipe's buffer would block on it while nothing reads until the end.
    logs = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")) for _ in range(world)]
    procs = [subprocess.Popen([sys.executable, "-m", module, "--world", str(world),
                               "--rank", str(r), "--port", str(port or 0), "--timeout", str(budget), *argv],
                              stdout=logs[r][0], stderr=logs[r][1], text=True, env=env, cwd=cwd)
             for r in range(world)]
    deadline = time.monotonic() + budget
    late = False
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                late = True
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        del store
    records, errors = [], []
    for r, (p, (out, err)) in enumerate(zip(procs, logs)):
        with out, err:
            out.seek(0)
            err.seek(0)
            stdout, stderr = out.read(), err.read()
        line = next((l for l in reversed(stdout.splitlines()) if l.startswith(record)), None)
        if p.returncode != 0 or line is None:
            why = (f"still running at the deadline of {budget:.0f} s, killed" if late and p.returncode < 0
                   else f"exited {p.returncode}")
            errors.append(f"rank {r} of {world} {why} in path {_last_path(stderr)}:\n{stdout[-2000:]}\n"
                          f"{stderr[-4000:]}")
        else:
            records.append(json.loads(line[len(record):]))
    if errors:
        raise RuntimeError("\n".join(errors))
    return records


if __name__ == "__main__":
    main()
