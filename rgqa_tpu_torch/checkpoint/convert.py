"""Weights into the port: from the JAX package's flax trees and from
reference GQA ``.pth`` checkpoints.

The port's parameter names follow the flax tree, so a flax path maps to
a port key by a plain rename (:func:`port_key`): path components joined
with dots, the stacked ``lang_i`` / ``visn_i`` / ``x_i`` layers as
``lang_layers.i`` / ``visn_layers.i`` / ``x_layers.i``, and the leaves
``kernel`` / ``scale`` / ``embedding`` as ``weight``.  Which paths exist
comes from :func:`rgqa_tpu_torch.checkpoint.torch_import.lxmert_key_map`
(a copy of the JAX package's importer key map), read in reverse; flax
kernels are (in, out) and transpose to ``nn.Linear``'s (out, in).
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

from rgqa_tpu_torch.checkpoint.torch_import import load_torch_state_dict, lxmert_key_map

__all__ = ["port_key", "from_jax_params", "load_reference_pth", "to_reference_state_dict"]

_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight", "bias": "bias"}
_STACKED = re.compile(r"^(lang|visn|x)_(\d+)$")
# Reference GQA checkpoints wrap the encoder (gqa_model.py:14-43); the
# answer head sits at the top level as logit_fc.*.
_REF_ENCODER_PREFIX = "lxrt_encoder.model."


def port_key(fpath: tuple) -> str:
    """Flax parameter path -> the port's ``state_dict`` key."""
    parts = []
    for p in fpath[:-1]:
        m = _STACKED.match(p)
        parts.append(f"{m.group(1)}_layers.{m.group(2)}" if m else p)
    parts.append(_LEAF[fpath[-1]])
    return ".".join(parts)


def _flatten(tree: Mapping, prefix: tuple = ()) -> dict[tuple, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _depths(flat: Mapping[tuple, Any]) -> tuple[int, int, int]:
    names = {p[1] for p in flat if len(p) > 1 and p[0] == "lxmert"}

    def count(stem):
        return sum(1 for n in names if re.fullmatch(rf"{stem}_\d+", n))

    return count("lang"), count("x"), count("visn")


def from_jax_params(params: Mapping) -> dict[str, torch.Tensor]:
    """A ``LxmertForGQA`` flax param tree (nested dicts of numpy or jax
    arrays) -> the port's f32 ``state_dict``.  Raises on a missing
    parameter and on parameters the port has no place for."""
    flat = _flatten(params)
    l_layers, x_layers, r_layers = _depths(flat)
    sd = {}
    for _, fpath, transpose in lxmert_key_map(l_layers, x_layers, r_layers):
        if fpath not in flat:
            raise KeyError(f"flax tree has no {'/'.join(fpath)}")
        val = np.asarray(flat.pop(fpath), dtype=np.float32)
        sd[port_key(fpath)] = torch.from_numpy(  # np.array copies: owned, writable
            np.array(val.T if transpose else val, order="C")
        )
    if flat:
        raise ValueError(
            "flax parameters the port has no place for: "
            f"{sorted('/'.join(p) for p in flat)[:5]}"
        )
    return sd


def _reference_pairs(l_layers: int, x_layers: int, r_layers: int):
    """(reference GQA .pth key, port key) for every parameter."""
    for tkey, fpath, _ in lxmert_key_map(l_layers, x_layers, r_layers):
        rkey = tkey if tkey.startswith("logit_fc") else _REF_ENCODER_PREFIX + tkey
        yield rkey, port_key(fpath)


def to_reference_state_dict(
    sd: Mapping[str, torch.Tensor], *, l_layers: int = 9, x_layers: int = 5,
    r_layers: int = 5,
) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` under the reference GQA model's key
    names: ``torch.save`` it to hand the weights to the reference code,
    to the JAX package's importer, or to ``--load``."""
    return {
        rkey: sd[pkey].detach().cpu()
        for rkey, pkey in _reference_pairs(l_layers, x_layers, r_layers)
    }


def load_reference_pth(
    path: str, *, l_layers: int = 9, x_layers: int = 5, r_layers: int = 5
) -> tuple[dict[str, torch.Tensor], list[str], list[str]]:
    """Load a reference GQA-LXMERT ``.pth`` (``lxrt_encoder.model.bert.*``
    + ``logit_fc.*``) through ``load_torch_state_dict`` (``module.``
    strip, gamma/beta renames).  Torch Linear weights are
    already (out, in), so nothing transposes.  Returns (state_dict,
    missing reference keys, unused reference keys)."""
    ref = load_torch_state_dict(path)
    sd, missing, used = {}, [], set()
    for rkey, pkey in _reference_pairs(l_layers, x_layers, r_layers):
        if rkey not in ref:
            missing.append(rkey)
            continue
        sd[pkey] = torch.from_numpy(np.ascontiguousarray(ref[rkey]))
        used.add(rkey)
    return sd, missing, [k for k in ref if k not in used]
