"""Dry-run entry points of the port (the counterpart of the JAX package's
``__graft_entry__.py``): a compile-and-run check of the flagship model and
one data-parallel training step.

- :func:`entry`: LXMERT at full width (9 / 5 / 5 layers x 768, 36 RoIs x
  2048, 1842 answers), batch 8, bf16 unless asked otherwise: returns
  ``(fwd, (model, batch))``, ``fwd(model, batch) -> (label, score)``, the
  argmax answer and its MSP (max sigmoid) score.  ``cfg`` replaces the
  configuration (the tests run it narrow).
- :func:`dryrun_multichip`: the JAX dry run's tiny LXMERT (2 / 1 / 1
  layers x 64, 4 heads, 8 RoIs of 32, 16 answers, 8 tokens), one RP step
  (BCE, ``sample_pair``, BertAdam at 1e-5 with warmup 0.1 over 100 steps,
  the global clip at 5) and one MSP eval step on a global batch of 2n
  rows, over n ranks of ``torch.distributed`` through
  :mod:`rgqa_tpu_torch.parallel`: NCCL, a card a rank, when the host has
  n cards; else gloo ranks, all on the one card or on the CPU.  It
  asserts what the JAX dry run asserts (a finite loss, labels of shape
  (2n,), finite scores) and returns rank 0's record.  The step runs at
  dropout 0, so that n ranks compute the one-process step at the same
  global batch (at dropout > 0 each rank draws its own stream).
- :func:`dryrun_multichip_fullshape`: the same step at full width, one
  row a rank, data parallel only.  The JAX version also asserts that its
  tensor-parallel partition specs shard the weights; tensor parallelism
  (``--model_axis`` other than 1) is not ported, so those assertions have
  no counterpart here.

The ranks are processes of this module (``python -m
rgqa_tpu_torch.entry --rank R ...``), joined through a ``TCPStore`` that
the calling process hosts on a port the OS picks.  Every wait has a
limit that names the run: the join and each collective ``JOIN_SECONDS``,
the whole spawn ``START_SECONDS`` plus ``seconds``.  Without a card and
without ``device="cpu"`` every entry point raises.

    python -m rgqa_tpu_torch.entry --dryrun 2 --device cpu   # two gloo ranks
    python -m rgqa_tpu_torch.entry                           # entry() on the card
"""

from __future__ import annotations

import argparse
import datetime
import json
import math
import os
import sys
from typing import Optional

import torch

from rgqa_tpu_torch.config import EncoderConfig, ModelConfig
from rgqa_tpu_torch.data.batching import to_device
from rgqa_tpu_torch.device import resolve_device
from rgqa_tpu_torch.models.zoo import build_model, example_batch, module_mode

__all__ = ["entry", "tiny_config", "dryrun_step", "dryrun_multichip", "dryrun_multichip_fullshape"]

# The JAX dry run's tiny LXMERT (``__graft_entry__.dryrun_multichip``).
TINY_ENCODER = dict(hidden_size=64, num_heads=4, intermediate_size=128, vocab_size=512, l_layers=2,
                    x_layers=1, r_layers=1, num_objects=8, visual_feat_dim=32)
START_SECONDS = 120.0  # the ranks' start (imports) and join
JOIN_SECONDS = 600.0  # the join and every collective after it
STEP_SECONDS = 600.0  # the steps' limit past the start (a full-width f32 step on a card takes seconds)
RECORD = "DRYRUN "  # the prefix of rank 0's record line


def tiny_config() -> ModelConfig:
    """The JAX dry run's tiny LXMERT configuration, at dropout 0."""
    enc = EncoderConfig(**TINY_ENCODER, hidden_dropout=0.0, attention_dropout=0.0)
    return ModelConfig(backbone="lxmert", encoder=enc, num_answers=16, max_text_len=8)


def entry(cfg: Optional[ModelConfig] = None, *, device=None, use_bf16: bool = True):
    """``(fwd, (model, batch))`` for LXMERT (full width unless ``cfg``):
    ``fwd(model, batch, use_fused=None)`` runs the model in inference mode
    and returns (argmax answer, MSP score) of ``sigmoid(logits)`` in f32;
    ``use_fused=False`` runs the attention's plain version.  The weights
    come from build_model's seed, the batch from ``example_batch(seed=0)``.
    On the ``meta`` device the model has shapes and no storage (``fwd``
    cannot run)."""
    cfg = cfg or ModelConfig(backbone="lxmert")
    if cfg.backbone != "lxmert":
        raise ValueError(f"entry() builds LXMERT, as the JAX entry does; got backbone {cfg.backbone!r}")
    device = resolve_device(device)
    model, _ = build_model(cfg, use_bf16=use_bf16, device=device)
    batch = to_device(example_batch(cfg, 8, seed=0), device)

    def fwd(model, batch, use_fused: Optional[bool] = None):
        with torch.inference_mode(), module_mode(model, True):
            out = model(batch["input_ids"], batch["input_mask"], batch["segment_ids"], batch["feats"],
                        batch["boxes"], use_fused=use_fused)
        probs = torch.sigmoid(out["logits"].float())
        return torch.argmax(probs, dim=-1), torch.amax(probs, dim=-1)

    return fwd, (model, batch)


def dryrun_step(cfg: ModelConfig, rows: int, *, device, mesh=None) -> dict:
    """One RP training step and one MSP eval step of ``cfg`` in f32 on a
    global batch of ``rows`` rows (this rank's share of it under
    ``mesh``), from build_model's seeded init (rank 0's, on every rank);
    asserts the JAX dry run's conditions and returns ``{"loss", "label",
    "score", "step"}`` of the global batch."""
    from rgqa_tpu_torch.ops.dropout import DropoutRng
    from rgqa_tpu_torch.parallel import SINGLE, gather_rows, shard_batch, shard_params
    from rgqa_tpu_torch.scorers.core import make_msp_scorer
    from rgqa_tpu_torch.train.optimizer import BertAdam
    from rgqa_tpu_torch.train.step import make_train_step

    mesh = mesh or SINGLE
    model, forward = build_model(cfg, device=device, train=True)
    shard_params(mesh, model)
    batch = to_device(shard_batch(mesh, example_batch(cfg, rows, seed=0, with_target=True)), device)
    opt = BertAdam(model.parameters(), 1e-5, warmup=0.1, t_total=100)
    rng = DropoutRng.for_rank(1, device, rank=mesh.rank, world=mesh.world)
    step = make_train_step(forward, opt, loss="bce", sample_pair=True, grad_clip=5.0, rng=rng, mesh=mesh)
    loss = float(step(batch)["loss"])
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    out = make_msp_scorer(forward)(batch)
    label, score = gather_rows(mesh, out["label"]), gather_rows(mesh, out["score"])
    if tuple(label.shape) != (rows,):
        raise AssertionError(f"labels of shape {tuple(label.shape)}, want ({rows},)")
    if not bool(torch.isfinite(score).all()):
        raise AssertionError("non-finite MSP scores")
    return {"loss": loss, "label": label.tolist(), "score": score.tolist(), "step": opt.param_groups[0]["count"]}


def _plan(n: int, device) -> tuple[str, str]:
    """The backend and the device for ``n`` ranks: NCCL when the host has
    ``n`` cards (rank r on ``cuda:r``); else gloo, every rank on the one
    card (or on the CPU)."""
    device = resolve_device(device)
    if device.type == "cuda":
        if torch.cuda.device_count() >= n and n > 1:
            return "nccl", "cuda"
        return "gloo", str(torch.device("cuda", device.index or 0))
    return "gloo", str(device)


def _spawn(name: str, n: int, full: bool, device, seconds: float) -> dict:
    """Run ``n`` ranks of this module through ``tools.ddp_check.launch``,
    within ``START_SECONDS + seconds``; rank 0's record.  A rank that
    fails or overruns ends the others, and the error names ``name``, the
    rank and its output."""
    from rgqa_tpu_torch.tools import ddp_check

    backend, rank_device = _plan(n, device)
    # The ranks import this package from where this process found it.
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, (root, os.environ.get("PYTHONPATH")))))
    argv = ["--backend", backend, "--device", rank_device, "--name", name, *(["--full"] if full else [])]
    record = ddp_check.launch(n, argv, env=env, module="rgqa_tpu_torch.entry", record=RECORD,
                              budget=START_SECONDS + seconds)[0]
    record.update(world=n, backend=backend)
    print(f"{name}: world={n} backend={backend} loss={record['loss']:.4f} step={record['step']} "
          f"eval_scores=[{min(record['score']):.3f},{max(record['score']):.3f}]", flush=True)
    return record


def dryrun_multichip(n_devices: int, *, device=None, seconds: float = STEP_SECONDS) -> dict:
    """One tiny RP step and one eval step over ``n_devices`` ranks (global
    batch 2n); rank 0's record ``{"loss", "label", "score", "step",
    "device", "world", "backend"}``."""
    return _spawn("dryrun_multichip", n_devices, False, device, seconds)


def dryrun_multichip_fullshape(n_devices: int = 2, *, device=None, seconds: float = STEP_SECONDS) -> dict:
    """The step at full width (9 / 5 / 5 x 768, 1842 answers), one row a
    rank (global batch n), data parallel only: the JAX version's
    tensor-parallel assertions have no counterpart (``--model_axis`` other
    than 1 is not ported)."""
    return _spawn("dryrun_multichip_fullshape", n_devices, True, device, seconds)


def _rank_main(args) -> None:
    """One rank of a dry run: join, step, print the record."""
    import torch.distributed as dist

    from rgqa_tpu_torch.parallel import join_group, make_mesh

    print(f"DDP_CHECK_PATH {args.name}", file=sys.stderr, flush=True)  # names the run in a rank's error
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", args.rank) if args.backend == "nccl" else device
        torch.cuda.set_device(device)
    if args.world > 1:
        store = dist.TCPStore("localhost", args.port, world_size=args.world, is_master=False,
                              timeout=datetime.timedelta(seconds=args.timeout))
        join_group(args.backend, args.rank, args.world, store=store, timeout=min(JOIN_SECONDS, args.timeout))
    mesh = make_mesh(device)
    cfg = ModelConfig(backbone="lxmert") if args.full else tiny_config()
    rows = args.world if args.full else 2 * args.world
    record = dryrun_step(cfg, rows, device=device, mesh=mesh)
    if args.world > 1:
        dist.destroy_process_group()
    print(RECORD + json.dumps(dict(record, device=str(device))), flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="the card unless 'cpu'")
    p.add_argument("--dryrun", type=int, default=0, help="run dryrun_multichip over N ranks")
    p.add_argument("--fullshape", action="store_true", help="with --dryrun: dryrun_multichip_fullshape")
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--backend", default="gloo", help=argparse.SUPPRESS)
    p.add_argument("--timeout", type=float, default=JOIN_SECONDS, help=argparse.SUPPRESS)
    p.add_argument("--full", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--name", default="dryrun", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank is not None:
        return _rank_main(args)
    if args.dryrun:
        run = dryrun_multichip_fullshape if args.fullshape else dryrun_multichip
        return run(args.dryrun, device=args.device)
    fwd, fargs = entry(device=args.device)
    label, score = fwd(*fargs)
    print(f"entry ok: label {tuple(label.shape)}, score {tuple(score.shape)}")
    return label, score


if __name__ == "__main__":
    main()
