#!/usr/bin/env python3
"""Export the JAX package's orbax snapshots to the files the PyTorch port reads.

    python orbax_to_pth.py SNAPSHOT [SNAPSHOT ...] [--backbone NAME]

Run it where jax and orbax are installed: it reads each snapshot with
``rgqa_tpu.checkpoint.orbax_io.load_checkpoint``.  The port itself never
imports orbax (nor this script), and the machine with the card has no jax.
Each SNAPSHOT is a directory that a JAX runner wrote
(``orbax_io.save_checkpoint``); the files go beside it, in the names the
port's CLIs already read:

- a GQA snapshot (LXMERT, UNITER, ViLT, BUTD or the caption matcher:
  ``<output>/BEST``, ``LAST``, ``EPOCH_n``), a VQA or an NLVR2 one:
  ``<dir>.pth`` in the reference layout (``to_reference_state_dict``),
  which ``--load <dir>`` and ``--teacher_path <dir>`` take;
- a pretraining snapshot (``BEST_EVAL_LOSS``, ``EpochNN``):
  ``<dir>_LXRT.pth``, a reference ``model_LXRT.pth``, which
  ``--loadLXMERT <dir>`` and ``--loadLXMERTQA <dir>`` take;
- the trained CLIP of ``--update_weight_model`` (``<output>/clip_params``,
  or its ``jax_params/``): ``clip_params/pytorch_model.bin`` in HF's names
  beside ``jax_params/``, which ``--clip_path <output>/clip_params`` then
  loads where the JAX package loads ``jax_params/`` (the JAX export writes
  no ``.bin`` there, so one there is this script's); its train state
  ``<output>/<tag>_clip``: ``<tag>_clip.pth``, the port's
  ``save_clip_state`` layout (HF-named params, the CLIP optimizer's Adam
  moments, the step), which a resume of ``--update_weight_model`` reads;
- a GQA train state (a snapshot with the optimizer's state and step:
  ``LAST``, ``EPOCH_n``, ``BEST``) also ``<dir>.state.pt``, the layout of
  the port's ``train/state.py::save_train_state``: the step, the
  optimizer's state in the port optimizer of the run's ``--optim``
  (BertAdam's, Adam's and RMSprop's moments bit for bit; ``adamax`` is
  refused), and the dropout and shuffle generators of a port run at the
  run's seed, as it starts.  ``GQARunner(cfg).train(resume="LAST")`` with
  ``--output`` the JAX run's directory then continues the run from its
  weights, moments and step; the JAX resume restarts its key and shuffle
  from the seed, and so does the port's: the draws after a resume are the
  port's own.  One rank's (a resume under several ranks needs a port
  checkpoint of that world size).

The kind and the backbone come from the tree's own keys; ``--backbone``
overrides the backbone.  A train state needs the run's ``run_config.json``
beside the snapshot (every JAX runner writes one): the model's
configuration orders the optimizer's parameters, and it gives the run's
``--optim`` and ``--seed``.  A CLIP train state takes the CLIP
configuration from ``<output>/clip_params/config.json``, else from the
run's ``--clip_path``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from rgqa_tpu_torch.checkpoint.convert import (  # noqa: E402
    from_jax_params,
    jax_tree_backbone,
    to_reference_state_dict,
)

__all__ = ["export", "main"]

GQA_BACKBONES = ("lxmert", "uniter", "vilt", "butd", "caps")
_DEPTH = {
    "l_layers": re.compile(r"(?:^|\.)lang_layers\.(\d+)\."),
    "x_layers": re.compile(r"(?:^|\.)x_layers\.(\d+)\."),
    "r_layers": re.compile(r"(?:^|\.)visn_layers\.(\d+)\."),
    "num_layers": re.compile(r"(?:^|\.)(?:blocks|layers)\.(\d+)\."),
}


def _restore(path: str) -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")  # the export runs no device code
    from rgqa_tpu.checkpoint.orbax_io import load_checkpoint

    path = os.path.abspath(path)
    payload = load_checkpoint(os.path.dirname(path), os.path.basename(path))
    return jax.tree_util.tree_map(np.asarray, payload)


def _depths(sd) -> dict:
    """The stack depths of a port ``state_dict``, from its keys."""
    out = {}
    for name, pat in _DEPTH.items():
        idx = {int(m.group(1)) for k in sd if (m := pat.search(k))}
        if idx:
            out[name] = max(idx) + 1
    return out


def _run_config(snapshot: str) -> dict | None:
    path = os.path.join(os.path.dirname(os.path.abspath(snapshot)), "run_config.json")
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return json.load(f)


def _model_config(d: dict):
    """The port's ModelConfig of a JAX run_config.json's ``model``."""
    from rgqa_tpu_torch.config import EncoderConfig, ModelConfig

    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in d.items() if k in fields}
    kw["encoder"] = EncoderConfig(**d["encoder"])
    return ModelConfig(**kw)


def _adam_like(opt_state):
    """The optax state dict that holds the moments (``mu`` / ``nu``, or
    ``nu`` alone), searched through optax's chain; None for a stateless
    rule (sgd)."""
    if isinstance(opt_state, dict):
        if "nu" in opt_state:
            return opt_state
        items = opt_state.values()
    elif isinstance(opt_state, (list, tuple)):
        items = opt_state
    else:
        return None
    for x in items:
        found = _adam_like(x)
        if found is not None:
            return found
    return None


def _tree_tensors(tree, backbone: str) -> dict:
    """A moment tree (the params' structure) -> port names, in its dtype
    (f32, or bf16 under ``--bf16_moments``)."""
    bf16 = any(np.asarray(v).dtype.name == "bfloat16" for v in _flat(tree).values())
    return {k: v.to(torch.bfloat16) if bf16 else v for k, v in from_jax_params(tree, backbone).items()}


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def train_state(payload: dict, backbone: str, run: dict | None) -> dict:
    """``payload``'s step and optimizer state as the port's
    ``save_train_state`` file, with a fresh port run's generators at the
    run's seed."""
    from rgqa_tpu_torch.config import OptimConfig
    from rgqa_tpu_torch.models.zoo import build_model
    from rgqa_tpu_torch.ops.dropout import DropoutRng
    from rgqa_tpu_torch.train.optimizer import make_optimizer

    if run is None:
        raise FileNotFoundError(
            "a train state orders its moments by the port model's parameters, whose configuration is the "
            "run's run_config.json beside the snapshot; it is missing"
        )
    fields = {f.name for f in dataclasses.fields(OptimConfig)}
    ocfg = OptimConfig(**{k: v for k, v in run["train"]["optim"].items() if k in fields})
    name = ocfg.name.lower()
    if name == "adamax":
        raise NotImplementedError("--optim adamax: optax's adamax state has no port counterpart to export")
    seed = run["train"]["seed"]
    model, _ = build_model(_model_config(run["model"]), device="meta")
    names = [n for n, _ in model.named_parameters()]
    opt = make_optimizer(ocfg, [p for _, p in model.named_parameters()], t_total=1)
    sd = opt.state_dict()
    moments = _adam_like(payload["opt_state"])
    if moments is not None:  # sgd keeps none
        if name in ("adam", "adamw"):
            sd = _adam_state(opt, names, moments, backbone)
        elif "bert" in name or name == "rms":
            trees = {k: _tree_tensors(moments[k], backbone) for k in ("mu", "nu") if k in moments}
            sd["state"] = {i: {k: trees[k][n] for k in trees} for i, n in enumerate(names)}
        else:
            raise NotImplementedError(f"--optim {ocfg.name}: no port layout for its optax state")
    if "bert" in name:
        sd["param_groups"][0]["count"] = int(moments["count"])
    rng = DropoutRng.for_rank(seed, "cpu")
    return {
        "optimizer": sd,
        "step": int(payload["step"]),
        # The device generator as a run at this seed starts it (None: the
        # resuming run keeps its own fresh one), the host's state.
        "rng": {"device": None, "host": rng.host.get_state()},
        "shuffle": np.random.default_rng(seed).bit_generator.state,
    }


def _adam_state(opt, names: list, moments: dict, backbone: str) -> dict:
    """``opt``'s (an OptaxAdam over parameters ``names``) state_dict with
    optax Adam's ``moments``."""
    trees = {k: _tree_tensors(moments[k], backbone) for k in ("mu", "nu")}
    sd = opt.state_dict()
    sd["state"] = {i: {"mu": trees["mu"][n], "nu": trees["nu"][n], "count": int(moments["count"])}
                   for i, n in enumerate(names)}
    return sd


def clip_train_state(payload: dict, snapshot: str, run: dict | None) -> dict:
    """A CLIP adversary's snapshot (``<tag>_clip``) as the port's
    ``save_clip_state`` file."""
    from rgqa_tpu_torch.models.clip import ClipModel, clip_config_from_hf
    from rgqa_tpu_torch.train.optimizer import OptaxAdam

    candidates = [os.path.join(os.path.dirname(snapshot), "clip_params", "config.json")]
    if run is not None and run.get("ood", {}).get("clip_path"):
        candidates.append(os.path.join(run["ood"]["clip_path"], "config.json"))
    config = next((c for c in candidates if os.path.isfile(c)), None)
    if config is None:
        raise FileNotFoundError(f"{snapshot}: no CLIP config.json at {' or '.join(candidates)}")
    with open(config) as f:
        cfg = clip_config_from_hf(json.load(f))
    with torch.device("meta"):
        model = ClipModel(cfg, torch.float32)
    names = [n for n, _ in model.named_parameters()]
    moments = _adam_like(payload["opt_state"])
    opt = OptaxAdam([p for _, p in model.named_parameters()], lr=1e-5)
    return {"params": from_jax_params(payload["params"], "clip"),
            "optimizer": _adam_state(opt, names, moments, "clip"), "step": int(payload["step"])}


def export(snapshot: str, *, backbone: str | None = None) -> list[str]:
    """Export one snapshot directory; the paths written."""
    snapshot = os.path.abspath(snapshot.rstrip("/"))
    if os.path.isdir(os.path.join(snapshot, "jax_params")):
        snapshot = os.path.join(snapshot, "jax_params")  # <output>/clip_params
    payload = _restore(snapshot)
    params = payload["params"]
    kind = jax_tree_backbone(params) if backbone is None else backbone
    if kind == "clip":
        if "opt_state" in payload:  # <output>/<tag>_clip
            out = snapshot + ".pth"
            torch.save(clip_train_state(payload, snapshot, _run_config(snapshot)), out)
            return [out]
        out = os.path.join(os.path.dirname(snapshot), "pytorch_model.bin")  # beside jax_params/
        torch.save(from_jax_params(params, "clip"), out)
        return [out]
    sd = from_jax_params(params, kind)
    ref = to_reference_state_dict(sd, backbone=kind, **_depths(sd))
    if kind == "lxmert_pretrain":
        out = snapshot + "_LXRT.pth"
        torch.save(ref, out)
        return [out]
    out = snapshot + ".pth"
    torch.save(ref, out)
    written = [out]
    if "opt_state" in payload and kind in GQA_BACKBONES:
        run = _run_config(snapshot)
        if run is not None and run.get("model", {}).get("backbone") not in (None, kind):
            raise ValueError(f"{snapshot}: the tree is {kind}'s, its run_config.json says "
                             f"{run['model']['backbone']}")
        state_path = snapshot + ".state.pt"
        torch.save(train_state(payload, kind, run), state_path)
        written.append(state_path)
    return written


def main(argv=None) -> list[str]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("snapshots", nargs="+", help="orbax snapshot directories a JAX runner wrote")
    p.add_argument("--backbone", default=None,
                   help="the tree's model, where its keys do not say: lxmert, uniter, vilt, butd, caps, "
                        "nlvr2, lxmert_pretrain or clip")
    args = p.parse_args(argv)
    written = []
    for snap in args.snapshots:
        paths = export(snap, backbone=args.backbone)
        for path in paths:
            print(f"{snap} -> {path}")
        written += paths
    return written


if __name__ == "__main__":
    main()
