"""Weights into the port: from the JAX package's flax trees and from
reference GQA ``.pth`` checkpoints, for LXMERT, UNITER, ViLT, BUTD and the
caption matcher.

The port's parameter names follow the flax tree, so a flax path maps to
a port key by a plain rename (:func:`port_key`): path components joined
with dots, the stacked ``lang_i`` / ``visn_i`` / ``x_i`` / ``block_i`` /
``layer_i`` layers (and the branched heads' ``proj_i``) as
``lang_layers.i`` / ``visn_layers.i`` / ``x_layers.i`` / ``blocks.i`` /
``layers.i`` (``projectors.i``), and
the leaves ``kernel`` / ``scale`` / ``embedding`` as ``weight``.  Which
paths exist comes from the key maps of
:mod:`rgqa_tpu_torch.checkpoint.torch_import` (copies of the JAX
package's importer key maps), read in reverse.  Flax dense kernels are
(in, out) and transpose to ``nn.Linear``'s (out, in); ViLT's patch-conv
kernel (kh, kw, in, out) goes to the reference ``Conv2d`` layout
(out, in, kh, kw), which the port keeps.  Reference GQAViLT checkpoints
hold each block's Q/K/V as one fused ``attn.qkv`` (3E rows); the port
keeps ``query`` / ``key`` / ``value`` apart, split on load and fused on
export.  GQA-UNITER checkpoints wrap the encoder as
``encoder.model.uniter.*`` beside ``logit_fc.*``; pretrained UNITER
encoders come as ``uniter.*`` or ``bert.*``, without a head.
GQA-BUTD checkpoints (``w_emb.emb.*``, ``q_enc.rnn.*_l0``, ...) hold
each weight-normed layer as ``weight_g`` / ``weight_v`` / ``bias``
(the port's ``g`` / ``v`` / ``b``); PyTorch's ``weight_norm(dim=None)``
writes ``weight_g`` 0-d, older checkpoints with singleton dims: both
load, and the port writes it 0-d.  The JAX tree's ``gru_*`` leaves are
the port's ``torch.nn.GRU`` tensors ``gru.*_l0``.  The caption matcher
loads a plain HF ``BertModel`` (``embeddings.*`` ...), a ``bert.``-
prefixed task model or a trained GQABERT (``encoder.*`` + ``logit_fc.*``),
or a directory holding ``pytorch_model.bin``, and is written as a
trained GQABERT.

Two trees keep their reference names in the port, so their checkpoints
load with no rename at all: CLIP (``models/clip.py`` carries HF
``CLIPModel``'s names; :func:`load_clip_state_dict` reads an HF
checkpoint, less its ``position_ids`` buffers) and the pretraining heads
of ``LxmertPretraining`` (``cls.*``, ``obj_predict_head.*``,
``answer_head.logit_fc.*``, beside the port's ``lxmert.*`` encoder; a
reference ``model_LXRT.pth`` holds the encoder as ``bert.*`` and a tied
``cls.predictions.decoder.weight``, which is dropped on load and
written from the word table on export).  ``--loadLXMERT`` on LXMERT
and ``--loadLXMERTQA`` read such a file into ``LxmertForGQA``
(:func:`load_lxmert_pretrained`, :func:`load_lxmert_qa`) through the
same pretraining key map.

The NLVR2 model (``models/nlvr2.py``) keeps LXMERT's encoder names and
its head ``fc1`` / ``ln`` / ``fc2`` (the flax tree's); its ``.pth`` is the
port's own layout after the reference NLVR2 model's names
(:func:`nlvr2_key_map`: ``lxrt_encoder.model.bert.*`` and
``logit_fc.{0,2,3}``), which the JAX package never reads.

A CLIP tower trained by ``--update_weight_model`` is exported as an HF
checkpoint directory (:func:`save_clip_dir`): the source directory's
``config.json`` and tokenizer files beside ``pytorch_model.bin`` in HF's
names, which the port's ``ClipScorer`` and the JAX package's (through
its torch importer, when no ``jax_params/`` tree is there) both read.
The run's resume sibling ``<tag>_clip.pth`` (:func:`save_clip_state`)
holds the CLIP params, the CLIP optimizer's state and the step.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Mapping, Optional

import numpy as np
import torch

from rgqa_tpu_torch.checkpoint.torch_import import (
    bert_caps_key_map,
    butd_key_map,
    CLIP_WEIGHTS,
    caps_layout,
    clip_key_map,
    hf_checkpoint_file,
    load_torch_state_dict,
    lxmert_key_map,
    lxmert_pretrain_key_map,
    uniter_key_map,
    vilt_key_map,
)

__all__ = ["port_key", "from_jax_params", "jax_tree_backbone", "orbax_refusal", "is_orbax_dir", "lxrt_path", "nlvr2_key_map", "load_reference_pth", "to_reference_state_dict",
           "load_clip_state_dict", "save_clip_dir", "save_clip_state", "load_clip_state",
           "load_lxmert_pretrained", "load_lxmert_qa"]

_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight", "bias": "bias"}
_STACKED = re.compile(r"^(lang|visn|x|block|layer|proj)_(\d+)$")
_STACK_NAME = {"lang": "lang_layers", "visn": "visn_layers", "x": "x_layers", "block": "blocks",
               "layer": "layers", "proj": "projectors"}
# Reference GQA checkpoints wrap the encoder (gqa_model.py:14-43); the
# answer head and the branched confidence head sit at the top level as
# logit_fc.* and conf_fc.*.
_REF_ENCODER_PREFIX = "lxrt_encoder.model."
_REF_TOP_LEVEL = ("logit_fc", "conf_fc")
_REF_UNITER_PREFIX = "encoder.model.uniter."  # GQA-UNITER (uniter/entry.py + uniter.py)
_REF_CAPS_PREFIX = "encoder."  # the trained GQABERT matcher (caps.py:14-28)
# BUTD's GRU leaves in the flax tree -> the port's torch.nn.GRU tensors.
_RENAMED = {(f"gru_{w}_{g}",): f"gru.{'weight' if w[0] == 'w' else 'bias'}_{g}_l0"
            for w in ("w", "b") for g in ("ih", "hh")}
_CONV = "#conv"  # vilt_key_map's and clip_key_map's marker on the patch-conv weight
_TIED_DECODER = "cls.predictions.decoder.weight"  # model_LXRT.pth's copy of the word table
_QKV = re.compile(r"^(transformer\.blocks\.\d+\.attn\.)qkv\.(weight|bias)$")
# NLVR2's head (nlvr2_model.py:26-31): logit_fc.0 / .2 / .3 are the flax
# tree's fc1 / ln / fc2, where the GQA head's are answer_head.*.
_NLVR2_HEAD = {"dense": "fc1", "ln": "ln", "logits": "fc2"}


def nlvr2_key_map(l_layers: int = 9, x_layers: int = 5, r_layers: int = 5) -> list[tuple[str, tuple, bool]]:
    """The NLVR2 model's key map: LXMERT's encoder (``bert.*``, written
    under ``lxrt_encoder.model.``) and the head as the reference
    ``logit_fc.{0,2,3}``, in the flax tree ``fc1`` / ``ln`` / ``fc2``.  The
    ``.pth`` layout is the port's own after the reference NLVR2 model's
    names: the JAX package reads no NLVR2 ``.pth``."""
    return [(tkey, (_NLVR2_HEAD[fpath[1]], *fpath[2:]) if fpath[0] == "answer_head" else fpath, transpose)
            for tkey, fpath, transpose in lxmert_key_map(l_layers, x_layers, r_layers)]


def port_key(fpath: tuple) -> str:
    """Flax parameter path -> the port's ``state_dict`` key."""
    if tuple(fpath) in _RENAMED:
        return _RENAMED[tuple(fpath)]
    parts = []
    for p in fpath[:-1]:
        m = _STACKED.match(p)
        parts.append(f"{_STACK_NAME[m.group(1)]}.{m.group(2)}" if m else p)
    parts.append(_LEAF.get(fpath[-1], fpath[-1]))  # cls_token, pos_embed stay
    return ".".join(parts)


def _flatten(tree: Mapping, prefix: tuple = ()) -> dict[tuple, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _count(names, stem: str) -> int:
    return sum(1 for n in names if re.fullmatch(rf"{stem}_\d+", n))


def jax_tree_backbone(params: Mapping) -> str:
    """Which model a flax param tree is, read off its top-level keys:
    ``vilt``, ``uniter``, ``butd``, ``caps``, ``clip``,
    ``lxmert_pretrain`` (LXMERT with its pretraining heads), ``nlvr2`` or
    ``lxmert`` (GQA's, or VQA's: the same tree)."""
    top = set(params)
    return ("vilt" if "cls_token" in top else "uniter" if "uniter" in top
            else "butd" if "gru_w_ih" in top else "caps" if "match_head" in top
            else "clip" if "vision_model" in top else "lxmert_pretrain" if "mlm_head" in top
            else "nlvr2" if "fc1" in top else "lxmert")


def _key_map(flat: Mapping[tuple, Any], backbone: Optional[str]):
    """(backbone, key map) for a flattened flax tree; the backbone is read
    off the tree when not given."""
    if backbone is None:
        backbone = jax_tree_backbone(dict.fromkeys(p[0] for p in flat))
    if backbone == "clip":
        return backbone, clip_key_map(_count({p[1] for p in flat if p[0] == "vision_model"}, "layers"),
                                      _count({p[1] for p in flat if p[0] == "text_model"}, "layers"))
    if backbone == "lxmert_pretrain":
        names = {p[1] for p in flat if len(p) > 1 and p[0] == "lxmert"}
        return backbone, lxmert_pretrain_key_map(
            _count(names, "lang"), _count(names, "x"), _count(names, "visn"))
    if backbone == "nlvr2":
        names = {p[1] for p in flat if len(p) > 1 and p[0] == "lxmert"}
        return backbone, nlvr2_key_map(_count(names, "lang"), _count(names, "x"), _count(names, "visn"))
    if backbone == "butd":
        return backbone, butd_key_map(branched=("conf_fc1", "v") in flat)
    if backbone == "caps":
        return backbone, bert_caps_key_map(_count({p[0] for p in flat}, "layer"), match_head=True)
    if backbone == "vilt":
        return backbone, vilt_key_map(_count({p[0] for p in flat}, "block"))
    if backbone == "uniter":
        return backbone, uniter_key_map(_count({p[1] for p in flat if p[0] == "uniter"}, "layer"))
    if backbone == "lxmert":
        names = {p[1] for p in flat if len(p) > 1 and p[0] == "lxmert"}
        key_map = lxmert_key_map(
            _count(names, "lang"), _count(names, "x"), _count(names, "visn"),
            branched=("conf_head", "logits", "kernel") in flat,
        )
        # --branched_layer's heads have no reference keys (the JAX importer
        # has none either): flax paths only.
        for i in range(_count({p[0] for p in flat}, "proj")):
            key_map += [(f"proj_{i}", (f"proj_{i}", leaf), leaf == "kernel") for leaf in ("kernel", "bias")]
        if ("layer_conf", "kernel") in flat:
            key_map += [("layer_conf", ("layer_conf", leaf), leaf == "kernel") for leaf in ("kernel", "bias")]
        return backbone, key_map
    raise NotImplementedError(f"backbone {backbone!r} is not ported yet")


def _port_name(backbone: str, tkey: str, fpath: tuple) -> str:
    """The port's key of a key-map entry: CLIP's and the pretraining
    heads' are the reference names, every other the flax path renamed."""
    if backbone == "clip":
        return tkey.removesuffix(_CONV)
    if backbone == "lxmert_pretrain" and not tkey.startswith("bert."):
        return tkey
    return port_key(fpath)


# The offline export of the JAX package's orbax snapshots (the repository's
# orbax_to_pth.py, run where jax and orbax are; the port never imports it).
EXPORT_COMMAND = "python orbax_to_pth.py"


def orbax_refusal(flag: str, path: str, export: str) -> NotImplementedError:
    """The error for ``path`` given to ``flag`` where the JAX package
    reads an orbax snapshot directory (any path that is not a ``.pth``
    file) and no export ``export`` lies beside it: it names the command
    that writes the file."""
    return NotImplementedError(
        f"{flag} an orbax snapshot directory ({path!r} is not a .pth file, and no {export} is beside it): the "
        f"port reads no orbax.  Export it where jax and orbax are installed with `{EXPORT_COMMAND} {path}`, "
        f"which writes {export}, then give the same {flag}"
    )


def is_orbax_dir(path: str) -> bool:
    """Whether ``path`` is an orbax snapshot directory (its metadata
    file)."""
    return any(os.path.isfile(os.path.join(path, name)) for name in ("_METADATA", "_CHECKPOINT_METADATA"))


def lxrt_path(path: str) -> str:
    """A pretraining checkpoint's file: ``path`` when it is a file, else
    ``<path>_LXRT.pth`` when that is (the reference's ``"%s_LXRT.pth"``
    suffix, and the export of an orbax pretraining snapshot ``<path>``)."""
    if not os.path.isfile(path) and os.path.isfile(path + "_LXRT.pth"):
        return path + "_LXRT.pth"
    return path


def from_jax_params(params: Mapping, backbone: Optional[str] = None) -> dict[str, torch.Tensor]:
    """A ``LxmertForGQA``, ``UniterForGQA``, ``ViltForGQA``, ``ButdForGQA``,
    ``CaptionMatcher``, ``ClipModel``, ``LxmertPretraining`` or ``Nlvr2Model`` flax param
    tree (nested dicts of numpy or jax arrays; ``backbone`` None reads
    which off the tree; ``"clip"`` and ``"lxmert_pretrain"`` name the last
    two) -> the port's f32 ``state_dict``.  Raises on a missing parameter
    and on parameters the port has no place for."""
    flat = _flatten(params)
    backbone, key_map = _key_map(flat, backbone)
    sd = {}
    for tkey, fpath, transpose in key_map:
        if fpath not in flat:
            raise KeyError(f"flax tree has no {'/'.join(fpath)}")
        val = np.asarray(flat.pop(fpath), dtype=np.float32)
        if tkey.endswith(_CONV):
            val = val.transpose(3, 2, 0, 1)  # (kh, kw, in, out) -> (out, in, kh, kw)
        elif transpose:
            val = val.T
        sd[_port_name(backbone, tkey, fpath)] = torch.from_numpy(np.array(val, order="C"))  # owned, writable
    if flat:
        raise ValueError(
            "flax parameters the port has no place for: "
            f"{sorted('/'.join(p) for p in flat)[:5]}"
        )
    return sd


def _reference_pairs(backbone: str, l_layers: int, x_layers: int, r_layers: int, num_layers: int,
                     branched: bool = False):
    """(reference .pth key, port key) for every parameter; ViLT's keys
    with its Q/K/V apart (``attn.query`` ...); ``branched`` adds
    LXMERT's ``conf_fc.{0,2,3}``, BUTD's ``conf_classifier.{0,3}``; UNITER's
    are GQA-UNITER's, the caption matcher's a trained GQABERT's."""
    if backbone == "butd":
        for tkey, fpath, _ in butd_key_map(branched=branched):
            yield tkey, port_key(fpath)
        return
    if backbone == "caps":
        yield from _caps_pairs(num_layers, _REF_CAPS_PREFIX, match_head=True)
        return
    if backbone == "vilt":
        for tkey, fpath, _ in vilt_key_map(num_layers):
            yield tkey.removesuffix(_CONV), port_key(fpath)
        return
    if backbone == "uniter":
        yield from _uniter_pairs(num_layers, _REF_UNITER_PREFIX, answer_head=True)
        return
    if backbone == "lxmert_pretrain":
        for tkey, fpath, _ in lxmert_pretrain_key_map(l_layers, x_layers, r_layers):
            yield tkey, _port_name(backbone, tkey, fpath)
        return
    if backbone not in ("lxmert", "nlvr2"):
        raise NotImplementedError(f"backbone {backbone!r} is not ported yet")
    key_map = (nlvr2_key_map(l_layers, x_layers, r_layers) if backbone == "nlvr2"
               else lxmert_key_map(l_layers, x_layers, r_layers, branched=branched))
    for tkey, fpath, _ in key_map:
        rkey = tkey if tkey.startswith(_REF_TOP_LEVEL) else _REF_ENCODER_PREFIX + tkey
        yield rkey, port_key(fpath)


def _uniter_prefix(keys) -> str:
    """A UNITER checkpoint's encoder prefix, as ``import_uniter_gqa``
    reads it: GQA-UNITER's, else a pretrained encoder's ``uniter.`` or
    ``bert.``."""
    if any(k.startswith("encoder.model.") for k in keys):
        return _REF_UNITER_PREFIX
    return "uniter." if any(k.startswith("uniter.") for k in keys) else "bert."


def _uniter_pairs(num_layers: int, prefix: str, *, answer_head: bool):
    for tkey, fpath, _ in uniter_key_map(num_layers, encoder_prefix=prefix, answer_head=answer_head):
        yield tkey, port_key(fpath)


def _caps_pairs(num_layers: int, prefix: str, *, match_head: bool):
    for tkey, fpath, _ in bert_caps_key_map(num_layers, match_head=match_head):
        yield (tkey if tkey.startswith("logit_fc") else prefix + tkey), port_key(fpath)


def to_reference_state_dict(
    sd: Mapping[str, torch.Tensor], *, backbone: str = "lxmert", l_layers: int = 9,
    x_layers: int = 5, r_layers: int = 5, num_layers: int = 12,
) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` under the reference GQA model's key
    names (GQA-LXMERT, with ``conf_fc.*`` when ``sd`` holds the branched
    ``conf_head``; GQA-UNITER, ``encoder.model.uniter.*`` + ``logit_fc.*``;
    GQA-BUTD, with ``conf_classifier.*`` when ``sd`` holds the confidence
    head and each ``weight_g`` 0-d; the trained GQABERT matcher,
    ``encoder.*`` + ``logit_fc.*``; GQAViLT with each block's Q/K/V fused into
    ``attn.qkv``; for ``"lxmert_pretrain"``, a ``model_LXRT.pth`` with
    its tied decoder weight; for ``"nlvr2"``, :func:`nlvr2_key_map`'s
    names): ``torch.save`` it to hand the weights to the
    reference code, to the JAX package's importer, or to ``--load``
    (``--loadLXMERT``).
    ``--branched_layer``'s heads have no reference keys and are left out."""
    branched = "conf_head.logits.weight" in sd or "conf_fc1.v" in sd
    out = {
        rkey: sd[pkey].detach().cpu()
        for rkey, pkey in _reference_pairs(backbone, l_layers, x_layers, r_layers, num_layers, branched)
    }
    if backbone == "lxmert_pretrain":
        out[_TIED_DECODER] = out["bert.embeddings.word_embeddings.weight"].clone()
    if backbone == "vilt":
        for i in range(num_layers):
            base = f"transformer.blocks.{i}.attn."
            for leaf in ("weight", "bias"):
                out[f"{base}qkv.{leaf}"] = torch.cat(
                    [out.pop(f"{base}{name}.{leaf}") for name in ("query", "key", "value")]
                )
    return out


def _split_qkv(ref: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """GQAViLT's fused ``attn.qkv`` rows (3E) -> ``attn.{query,key,value}``;
    HF ``position_ids`` buffers dropped."""
    out = {}
    for key, val in ref.items():
        m = _QKV.match(key)
        if m:
            e = val.shape[0] // 3
            for j, name in enumerate(("query", "key", "value")):
                out[f"{m.group(1)}{name}.{m.group(2)}"] = val[j * e : (j + 1) * e]
        elif not key.endswith("position_ids"):
            out[key] = val
    return out


def load_reference_pth(
    path: str, *, backbone: str = "lxmert", l_layers: int = 9, x_layers: int = 5,
    r_layers: int = 5, num_layers: int = 12, branched: bool = False,
) -> tuple[dict[str, torch.Tensor], list[str], list[str]]:
    """Load a reference GQA-LXMERT (``lxrt_encoder.model.bert.*`` +
    ``logit_fc.*``), UNITER (GQA-UNITER's ``encoder.model.uniter.*`` +
    ``logit_fc.*``, or a pretrained encoder's ``uniter.*`` / ``bert.*``,
    the prefix read off the keys as the JAX package's
    ``import_uniter_gqa`` does; the answer head only where ``logit_fc`` is
    there) or GQAViLT (``transformer.*``, ``text_embeddings.*``,
    ``vqa_classifier.*``, ...) ``.pth`` through ``load_torch_state_dict``
    (``module.`` strip, gamma/beta renames).  Torch Linear and Conv2d
    weights are already in the port's layout, so nothing transposes;
    ViLT's fused ``attn.qkv`` is split; ``branched`` reads LXMERT's
    ``conf_fc.{0,2,3}`` too.  Returns (state_dict, missing reference
    keys, unused reference keys).

    BUTD reads GQA-BUTD's keys (``branched``: ``conf_classifier.*`` too),
    each ``weight_g`` 0-d or with singleton dims; the caption matcher
    reads the three layouts of the JAX package's ``import_bert_caps``
    (the prefix and the head read off the keys; ``position_ids``
    buffers dropped; ``path`` may be an HF checkpoint directory);
    ``"lxmert_pretrain"`` reads a reference ``model_LXRT.pth`` as
    ``import_lxmert_pretraining`` does, its tied decoder weight dropped."""
    if backbone == "caps":
        path = hf_checkpoint_file(path)
    ref = load_torch_state_dict(path)
    if backbone == "lxmert_pretrain":
        ref.pop(_TIED_DECODER, None)
    if backbone == "vilt":
        ref = _split_qkv(ref)
    if backbone == "butd":
        ref = {k: (v.reshape(()) if k.endswith("weight_g") else v) for k, v in ref.items()}
    if backbone == "caps":
        ref = {k: v for k, v in ref.items() if not k.endswith("position_ids")}
        prefix, head = caps_layout(ref)
        pairs = _caps_pairs(num_layers, prefix, match_head=head)
    elif backbone == "uniter":
        pairs = _uniter_pairs(num_layers, _uniter_prefix(ref),
                              answer_head=any(k.startswith("logit_fc") for k in ref))
    else:
        pairs = _reference_pairs(backbone, l_layers, x_layers, r_layers, num_layers, branched)
    return _select(ref, pairs)


def _select(ref: Mapping[str, np.ndarray], pairs) -> tuple[dict[str, torch.Tensor], list[str], list[str]]:
    """(port state_dict, missing reference keys, unused reference keys)
    of ``ref`` read through (reference key, port key) ``pairs``."""
    sd, missing, used = {}, [], set()
    for rkey, pkey in pairs:
        if rkey not in ref:
            missing.append(rkey)
            continue
        value = ref[rkey]  # ascontiguousarray lifts a 0-d weight_g to (1,): keep its shape
        sd[pkey] = torch.from_numpy(np.ascontiguousarray(value).reshape(np.shape(value)))
        used.add(rkey)
    return sd, missing, [k for k in ref if k not in used]


def _pretrained_pairs(l_layers: int, x_layers: int, r_layers: int, heads: tuple[str, ...]):
    """(``model_LXRT.pth`` key, ``LxmertForGQA`` key) of the encoder
    (``bert.*``) and of the QA head's entries under ``heads``: the
    pretraining key map read with the GQA model's names (its QA head
    ``answer_head.logit_fc.{0,2,3}`` is the GQA head's ``answer_head.
    {dense,ln,logits}`` in the flax tree of both)."""
    for tkey, fpath, _ in lxmert_pretrain_key_map(l_layers, x_layers, r_layers):
        if tkey.startswith(("bert.", *heads)):
            yield tkey, port_key(fpath)


def load_lxmert_pretrained(
    path: str, *, l_layers: int = 9, x_layers: int = 5, r_layers: int = 5,
) -> tuple[dict[str, torch.Tensor], list[str], list[str]]:
    """``--loadLXMERT`` on LXMERT: the encoder of a reference pretraining
    ``.pth`` (``model_LXRT.pth``, keys ``bert.*``) as ``LxmertForGQA``
    weights, as the JAX package's ``import_lxmert_gqa(from_pretrain=True)``
    reads it; the answer head stays at its init.  Returns (state_dict,
    missing encoder keys, unused keys of the file)."""
    return _select(load_torch_state_dict(path), _pretrained_pairs(l_layers, x_layers, r_layers, ()))


def load_lxmert_qa(
    path: str, label2ans, logits_weight: torch.Tensor, logits_bias: torch.Tensor, *,
    src_ans2id: Mapping[str, int], convert_ans=None, l_layers: int = 9, x_layers: int = 5,
    r_layers: int = 5,
) -> tuple[dict[str, torch.Tensor], int, int]:
    """``--loadLXMERTQA``: the answer-head transplant from a QA-pretrained
    LXMERT (reference ``load_lxmert_qa``, ``qa_answer_table.py:84-158``;
    the JAX package's ``load_lxmert_qa``).  The encoder (``bert.*``) and
    the pretraining answer head's dense + LayerNorm load as they are; the
    final layer's row of each GQA answer (``label2ans``, a list or a
    ``{label: answer}`` mapping; labels past the head's width skipped)
    whose ``convert_ans`` form is in ``src_ans2id`` is the pretraining
    row of that answer, every other row and its bias zero.  The head's
    current ``logits_weight`` (A, 2H) / ``logits_bias`` (A,) are the
    start.  Returns (state_dict, rows loaded, rows zeroed)."""
    ref = load_torch_state_dict(path)
    heads = ("answer_head.logit_fc.0", "answer_head.logit_fc.2")
    sd, _, _ = _select(ref, _pretrained_pairs(l_layers, x_layers, r_layers, heads))
    ans_w, ans_b = ref["answer_head.logit_fc.3.weight"], ref["answer_head.logit_fc.3.bias"]
    weight = logits_weight.detach().to("cpu", torch.float32).clone()
    bias = logits_bias.detach().to("cpu", torch.float32).clone()
    items = label2ans.items() if isinstance(label2ans, Mapping) else enumerate(label2ans)
    loaded = zeroed = 0
    for label, ans in items:
        if label >= weight.shape[0]:
            continue
        key = convert_ans(ans) if convert_ans else ans
        if key in src_ans2id:
            weight[label] = torch.from_numpy(np.asarray(ans_w[src_ans2id[key]], np.float32))
            bias[label] = float(ans_b[src_ans2id[key]])
            loaded += 1
        else:
            weight[label] = 0.0
            bias[label] = 0.0
            zeroed += 1
    sd["answer_head.logits.weight"], sd["answer_head.logits.bias"] = weight, bias
    return sd, loaded, zeroed


def load_clip_state_dict(path: str) -> dict[str, torch.Tensor]:
    """An HF ``CLIPModel`` checkpoint (a ``.bin`` / ``.pth`` file, or a
    checkpoint directory holding ``pytorch_model.bin``, ``model.bin`` or
    ``pytorch_model.pth``) -> the port's ``ClipModel`` state_dict: the
    same names, the ``position_ids`` buffers dropped, nothing
    transposed."""
    ref = load_torch_state_dict(hf_checkpoint_file(path, CLIP_WEIGHTS))
    return {k: torch.from_numpy(np.ascontiguousarray(v).reshape(np.shape(v)))
            for k, v in ref.items() if not k.endswith("position_ids")}


CLIP_DIR_FILES = ("config.json", "vocab.json", "merges.txt", "tokenizer.json")


def save_clip_dir(model, src_clip_path: str, out: str) -> str:
    """Write ``model`` (a port ``ClipModel``) as an HF CLIP checkpoint
    directory ``out`` (JAX ``_export_clip_params``): ``src_clip_path``'s
    ``config.json``, ``vocab.json``, ``merges.txt`` and ``tokenizer.json``
    where present, and ``pytorch_model.bin``, the f32 state_dict in HF's
    names.  ``src_clip_path`` may be ``out`` itself (a run continued from
    its own export): files already in place are left as they are."""
    os.makedirs(out, exist_ok=True)
    for name in CLIP_DIR_FILES:
        src, dst = os.path.join(src_clip_path, name), os.path.join(out, name)
        if os.path.exists(src) and not (os.path.exists(dst) and os.path.samefile(src, dst)):
            shutil.copy(src, dst)
    sd = {k: v.detach().to("cpu", torch.float32).contiguous() for k, v in model.state_dict().items()}
    torch.save(sd, os.path.join(out, "pytorch_model.bin"))
    return out


def save_clip_state(path: str, model, optimizer, step: int) -> str:
    """The CLIP side of a ``--update_weight_model`` checkpoint: its params
    (HF names), its optimizer's state and the step."""
    torch.save({"params": {k: v.detach().cpu() for k, v in model.state_dict().items()},
                "optimizer": optimizer.state_dict(), "step": int(step)}, path)
    return path


def load_clip_state(path: str, model, optimizer) -> int:
    """Restore :func:`save_clip_state`'s file into ``model`` and
    ``optimizer`` (strictly); returns its step."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(state["params"], strict=True)
    optimizer.load_state_dict(state["optimizer"])
    return state["step"]
