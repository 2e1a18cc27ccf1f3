"""Reference checkpoint key names: a copy of the four pieces of the JAX
package's ``rgqa_tpu/checkpoint/torch_import.py`` that the port uses.

- :func:`load_torch_state_dict` reads a reference ``.pth`` with the
  reference's own loading quirks: the ``module.`` DataParallel prefix
  strip (``src/tasks/gqa.py:259-265``) and the ``gamma``/``beta`` ->
  LayerNorm weight/bias renames (``src/lxrt/modeling.py:792-801``).
- :func:`lxmert_key_map` lists every GQA-LXMERT parameter as (reference
  torch key, flax path, transpose?).  Its layout follows
  ``src/lxrt/modeling.py`` (BertAttention 295-347, BertAttOutput 350-362,
  LXRTXLayer 439-488, VisualFeatEncoder 491-517) and
  ``src/tasks/gqa_model.py:20-27`` (``logit_fc.{0,2,3}``).
- :func:`uniter_key_map` lists every UNITER parameter likewise
  (``src/uniter/modeling.py:560-655``: BERT's embeddings and layers, the
  image embeddings' img / pos linears and their LayerNorms), under the
  encoder prefix a checkpoint uses, with the GQA head ``logit_fc.*``.
- :func:`vilt_key_map` lists every GQAViLT parameter likewise
  (``src/vilt/vilt.py:8-44`` over the vendored timm ViT-B/32), with the
  fused ``attn.qkv`` tensors split into ``attn.{query,key,value}`` and
  the patch conv's weight under a ``#conv`` marker (its layout differs
  from flax's; ``checkpoint/convert.py`` handles both).
- :func:`butd_key_map` lists every GQA-BUTD parameter likewise
  (``src/butd/butd.py:107-221``: ``weight_norm(..., dim=None)``'s
  ``weight_g`` / ``weight_v`` pairs, the GRU's ``*_l0`` tensors).
- :func:`bert_caps_key_map` lists every parameter of the Q-C matcher
  likewise (a plain HF ``BertModel``'s keys, with the trained GQABERT's
  ``logit_fc`` head when asked), and :func:`caps_layout` reads which of
  ``import_bert_caps``'s three layouts a state_dict is in.
- :func:`lxmert_pretrain_key_map` lists every parameter of a reference
  pretraining checkpoint (``model_LXRT.pth``: the encoder as ``bert.*``,
  the masked-LM, matched, visual and QA heads).
- :func:`clip_key_map` lists every parameter of an HF ``CLIPModel``
  checkpoint, the patch conv's weight under a ``#conv`` marker.
- :func:`hf_checkpoint_file` finds the weights file of an HF checkpoint
  directory as ``import_bert_caps`` and ``import_clip`` do.

``tests/test_torch_port_rules.py``, ``tests/test_torch_vilt.py``,
``tests/test_torch_uniter.py``, ``tests/test_torch_butd.py``,
``tests/test_torch_caps.py``, ``tests/test_torch_clip.py`` and
``tests/test_torch_match.py`` hold them to their originals.
"""

from __future__ import annotations

import numpy as np

import os

__all__ = ["load_torch_state_dict", "lxmert_key_map", "uniter_key_map", "vilt_key_map",
           "butd_key_map", "bert_caps_key_map", "hf_checkpoint_file", "caps_layout",
           "lxmert_pretrain_key_map", "clip_key_map", "CAPS_WEIGHTS", "CLIP_WEIGHTS"]


def load_torch_state_dict(path: str) -> dict[str, np.ndarray]:
    """Load a ``.pth`` state_dict to numpy, applying the reference's
    ``module.`` strip and gamma/beta renames."""
    import torch

    raw = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(raw, dict) and "state_dict" in raw and not any(
        hasattr(v, "numpy") for v in raw.values()
    ):
        raw = raw["state_dict"]
    out = {}
    for key, value in raw.items():
        if key.startswith("module."):
            key = key[len("module."):]
        key = key.replace(".gamma", ".weight").replace(".beta", ".bias")
        out[key] = value.detach().cpu().numpy()
    return out


# ---------------------------------------------------------------------------
# Key maps.  Each entry: torch key -> (flax path tuple, transpose?).
# ---------------------------------------------------------------------------


def _dense(tkey: str, fpath: tuple) -> list:
    return [
        (f"{tkey}.weight", fpath + ("kernel",), True),
        (f"{tkey}.bias", fpath + ("bias",), False),
    ]


def _ln(tkey: str, fpath: tuple) -> list:
    return [
        (f"{tkey}.weight", fpath + ("scale",), False),
        (f"{tkey}.bias", fpath + ("bias",), False),
    ]


def _bert_layer(tprefix: str, fprefix: tuple) -> list:
    """One BertLayer: attention.self/output + intermediate + output."""
    m = []
    for name in ("query", "key", "value"):
        m += _dense(f"{tprefix}.attention.self.{name}", fprefix + ("att", name))
    m += _dense(f"{tprefix}.attention.output.dense", fprefix + ("att", "out"))
    m += _ln(f"{tprefix}.attention.output.LayerNorm", fprefix + ("att", "out_ln"))
    m += _dense(f"{tprefix}.intermediate.dense", fprefix + ("mlp", "inter"))
    m += _dense(f"{tprefix}.output.dense", fprefix + ("mlp", "out"))
    m += _ln(f"{tprefix}.output.LayerNorm", fprefix + ("mlp", "out_ln"))
    return m


def _att_block(tprefix: str, fprefix: tuple, *, self_attr: str) -> list:
    """A BertCrossattLayer (att/output) or BertSelfattLayer (self/output)."""
    m = []
    for name in ("query", "key", "value"):
        m += _dense(f"{tprefix}.{self_attr}.{name}", fprefix + (name,))
    m += _dense(f"{tprefix}.output.dense", fprefix + ("out",))
    m += _ln(f"{tprefix}.output.LayerNorm", fprefix + ("out_ln",))
    return m


def _embeddings(tprefix: str, fprefix: tuple) -> list:
    m = []
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        m.append((f"{tprefix}.{name}.weight", fprefix + (name, "embedding"), False))
    m += _ln(f"{tprefix}.LayerNorm", fprefix + ("layer_norm",))
    return m


def lxmert_key_map(
    l_layers: int = 9,
    x_layers: int = 5,
    r_layers: int = 5,
    *,
    encoder_prefix: str = "bert.",
    flax_prefix: tuple = ("lxmert",),
    answer_head: bool = True,
    branched: bool = False,
) -> list[tuple[str, tuple, bool]]:
    """Key map for GQAModel-style checkpoints.

    Torch model layout: ``lxrt_encoder.model.bert.*`` + ``logit_fc.*``
    (``gqa_model.py:14-43``); pretraining checkpoints use bare ``bert.*``.
    """
    p = encoder_prefix
    f = flax_prefix
    m: list = []
    m += _embeddings(f"{p}embeddings", f + ("embeddings",))
    # VisualFeatEncoder (modeling.py:491-517).
    m += _dense(f"{p}encoder.visn_fc.visn_fc", f + ("visual", "feat_proj"))
    m += _ln(f"{p}encoder.visn_fc.visn_layer_norm", f + ("visual", "feat_ln"))
    m += _dense(f"{p}encoder.visn_fc.box_fc", f + ("visual", "box_proj"))
    m += _ln(f"{p}encoder.visn_fc.box_layer_norm", f + ("visual", "box_ln"))
    for i in range(l_layers):
        m += _bert_layer(f"{p}encoder.layer.{i}", f + (f"lang_{i}",))
    for i in range(r_layers):
        m += _bert_layer(f"{p}encoder.r_layers.{i}", f + (f"visn_{i}",))
    for i in range(x_layers):
        t = f"{p}encoder.x_layers.{i}"
        fx = f + (f"x_{i}",)
        m += _att_block(f"{t}.visual_attention", fx + ("cross_att",), self_attr="att")
        m += _att_block(f"{t}.lang_self_att", fx + ("lang_self",), self_attr="self")
        m += _att_block(f"{t}.visn_self_att", fx + ("visn_self",), self_attr="self")
        m += _dense(f"{t}.lang_inter.dense", fx + ("lang_mlp", "inter"))
        m += _dense(f"{t}.lang_output.dense", fx + ("lang_mlp", "out"))
        m += _ln(f"{t}.lang_output.LayerNorm", fx + ("lang_mlp", "out_ln"))
        m += _dense(f"{t}.visn_inter.dense", fx + ("visn_mlp", "inter"))
        m += _dense(f"{t}.visn_output.dense", fx + ("visn_mlp", "out"))
        m += _ln(f"{t}.visn_output.LayerNorm", fx + ("visn_mlp", "out_ln"))
    m += _dense(f"{p}pooler.dense", f + ("pooler", "dense"))
    if answer_head:
        # logit_fc = Sequential(Linear, GeLU, BertLayerNorm, Linear)
        # (gqa_model.py:20-27) -> indices 0, 2, 3.
        m += _dense("logit_fc.0", ("answer_head", "dense"))
        m += _ln("logit_fc.2", ("answer_head", "ln"))
        m += _dense("logit_fc.3", ("answer_head", "logits"))
    if branched:
        m += _dense("conf_fc.0", ("conf_head", "dense"))
        m += _ln("conf_fc.2", ("conf_head", "ln"))
        m += _dense("conf_fc.3", ("conf_head", "logits"))
    return m


def uniter_key_map(
    num_layers: int = 12,
    *,
    encoder_prefix: str = "uniter.",
    flax_prefix: tuple = ("uniter",),
    answer_head: bool = True,
) -> list[tuple[str, tuple, bool]]:
    """Key map for UNITER checkpoints (``src/uniter/modeling.py:560-655``).

    ``UniterEncoder.load`` renames ``bert.`` -> ``uniter.``
    (``entry.py:101-119``); embeddings/encoder follow BERT layout, image
    embeddings add img/pos linears + their LayerNorms.
    """
    p = encoder_prefix
    f = flax_prefix
    m: list = []
    m += _embeddings(f"{p}embeddings", f + ("embeddings",))
    m += _dense(f"{p}img_embeddings.img_linear", f + ("img_embeddings", "img_linear"))
    m += _ln(f"{p}img_embeddings.img_layer_norm", f + ("img_embeddings", "img_ln"))
    m += _dense(f"{p}img_embeddings.pos_linear", f + ("img_embeddings", "pos_linear"))
    m += _ln(f"{p}img_embeddings.pos_layer_norm", f + ("img_embeddings", "pos_ln"))
    m += _ln(f"{p}img_embeddings.LayerNorm", f + ("img_embeddings", "ln"))
    for i in range(num_layers):
        m += _bert_layer(f"{p}encoder.layer.{i}", f + (f"layer_{i}",))
    m += _dense(f"{p}pooler.dense", f + ("pooler", "dense"))
    if answer_head:
        m += _dense("logit_fc.0", ("answer_head", "dense"))
        m += _ln("logit_fc.2", ("answer_head", "ln"))
        m += _dense("logit_fc.3", ("answer_head", "logits"))
    return m


def vilt_key_map(num_layers: int = 12) -> list[tuple[str, tuple, bool]]:
    """Key map for reference GQAViLT checkpoints (``src/vilt/vilt.py:8-44``
    over the vendored timm ViT-B/32, ``src/vilt/modules/
    vision_transformer.py``).

    Expects the fused ``attn.qkv`` tensors to have been pre-split into
    ``attn.{query,key,value}``.
    """
    m: list[tuple[str, tuple, bool]] = []
    m += _embeddings("text_embeddings", ("text_embeddings",))
    # GQAViLT's own modality token-type table (vilt.py:28-29).
    m.append(
        ("token_type_embeddings.weight", ("modality_type", "embedding"), False)
    )
    m.append(("transformer.cls_token", ("cls_token",), False))
    m.append(("transformer.pos_embed", ("pos_embed",), False))
    # Conv2d weight (out, in, kh, kw) -> flax Conv kernel (kh, kw, in, out):
    # a custom transpose marker.
    m.append(
        ("transformer.patch_embed.proj.weight#conv",
         ("patch_embed", "proj", "kernel"), False)
    )
    m.append(
        ("transformer.patch_embed.proj.bias",
         ("patch_embed", "proj", "bias"), False)
    )
    for i in range(num_layers):
        t = f"transformer.blocks.{i}"
        f = (f"block_{i}",)
        m += _ln(f"{t}.norm1", f + ("norm1",))
        for name in ("query", "key", "value"):
            m += _dense(f"{t}.attn.{name}", f + (name,))
        m += _dense(f"{t}.attn.proj", f + ("att_out",))
        m += _ln(f"{t}.norm2", f + ("norm2",))
        m += _dense(f"{t}.mlp.fc1", f + ("mlp_in",))
        m += _dense(f"{t}.mlp.fc2", f + ("mlp_out",))
    m += _ln("transformer.norm", ("norm",))
    m += _dense("pooler.dense", ("pooler", "dense"))
    m += _dense("vqa_classifier.0", ("answer_head", "dense"))
    m += _ln("vqa_classifier.1", ("answer_head", "ln"))
    m += _dense("vqa_classifier.3", ("answer_head", "logits"))
    return m


def butd_key_map(*, branched: bool = False) -> list[tuple[str, tuple, bool]]:
    """Key map for BUTD checkpoints (``src/butd/butd.py:107-221``).

    torch ``weight_norm(..., dim=None)`` stores ``weight_g`` (scalar norm
    gain) + ``weight_v``; these map onto WeightNormDense's ``g``/``v``
    (same parameterization, ``w = g * v / ||v||_F``).  The GRU's
    ``weight_ih_l0``/``weight_hh_l0`` are already (3H, in) — no transpose.
    """

    def wn(tkey: str, fpath: tuple) -> list:
        return [
            (f"{tkey}.weight_g", fpath + ("g",), False),
            (f"{tkey}.weight_v", fpath + ("v",), False),
            (f"{tkey}.bias", fpath + ("b",), False),
        ]

    m: list = [
        ("w_emb.emb.weight", ("w_emb", "embedding"), False),
        ("q_enc.rnn.weight_ih_l0", ("gru_w_ih",), False),
        ("q_enc.rnn.weight_hh_l0", ("gru_w_hh",), False),
        ("q_enc.rnn.bias_ih_l0", ("gru_b_ih",), False),
        ("q_enc.rnn.bias_hh_l0", ("gru_b_hh",), False),
    ]
    m += wn("att.image_proj.mlp.0", ("att", "image_proj"))
    m += wn("att.question_proj.mlp.0", ("att", "question_proj"))
    m += wn("att.linear", ("att", "linear"))
    m += wn("q_project.mlp.0", ("q_project",))
    m += wn("img_project.mlp.0", ("img_project",))
    m += wn("ans_classifier.0", ("ans_fc1",))
    m += wn("ans_classifier.3", ("ans_fc2",))
    if branched:
        m += wn("conf_classifier.0", ("conf_fc1",))
        m += wn("conf_classifier.3", ("conf_fc2",))
    return m


def bert_caps_key_map(
    num_layers: int = 12, *, pooler: bool = True, match_head: bool = False
) -> list[tuple[str, tuple, bool]]:
    """Key map for a plain HF ``BertModel`` state_dict onto the caption
    matcher (the Q-C matcher's
    ``BertModel.from_pretrained("bert-base-uncased")`` init,
    ``src/caps/caps.py:17``).  ``match_head`` additionally maps a trained
    GQABERT checkpoint's ``logit_fc`` head (``caps.py:23-28``)."""
    m: list = []
    m += _embeddings("embeddings", ("embeddings",))
    for i in range(num_layers):
        m += _bert_layer(f"encoder.layer.{i}", (f"layer_{i}",))
    if pooler:
        m += _dense("pooler.dense", ("pooler", "dense"))
    if match_head:
        m += _dense("logit_fc.0", ("match_head", "dense"))
        m += _ln("logit_fc.2", ("match_head", "ln"))
        m += _dense("logit_fc.3", ("match_head", "logits"))
    return m


# The weights files an HF checkpoint directory may hold, as the JAX
# importers look for them: import_bert_caps and import_clip.
CAPS_WEIGHTS = ("pytorch_model.bin", "model.bin")
CLIP_WEIGHTS = ("pytorch_model.bin", "model.bin", "pytorch_model.pth")


def hf_checkpoint_file(path: str, names=CAPS_WEIGHTS) -> str:
    """``path``, or for an HF checkpoint directory the first of ``names``
    in it."""
    if os.path.isdir(path):
        for name in names:
            cand = os.path.join(path, name)
            if os.path.exists(cand):
                return cand
        raise FileNotFoundError(
            f"no {'/'.join(names)} under {path!r} "
            "(safetensors-only checkpoints are not supported here)"
        )
    return path


def caps_layout(keys) -> tuple[str, bool]:
    """(encoder prefix, whether the ``logit_fc`` head is there) of a
    caption-matcher state_dict, as ``import_bert_caps`` reads them: the
    trained GQABERT's ``encoder.``, a task model's ``bert.``, or a bare
    ``BertModel``'s none."""
    keys = list(keys)
    if any(k.startswith("encoder.embeddings.") for k in keys):
        prefix = "encoder."  # trained GQABERT (caps.py wraps BertModel)
    elif any(k.startswith("bert.") for k in keys):
        prefix = "bert."
    else:
        prefix = ""
    return prefix, any(k.startswith("logit_fc") for k in keys)


def lxmert_pretrain_key_map(
    l_layers: int = 9, x_layers: int = 5, r_layers: int = 5
) -> list[tuple[str, tuple, bool]]:
    """Key map for LXRTPretraining checkpoints (``model_LXRT.pth``;
    reference ``modeling.py:889-921``): the encoder plus MLM head
    (``cls.predictions``), matched head (``cls.seq_relationship``), visual
    heads (``obj_predict_head``), and the 9500-answer QA head."""
    m = lxmert_key_map(l_layers, x_layers, r_layers, answer_head=False)
    m += _dense("cls.predictions.transform.dense", ("mlm_head", "dense"))
    m += _ln("cls.predictions.transform.LayerNorm", ("mlm_head", "ln"))
    m.append(("cls.predictions.bias", ("mlm_head", "bias"), False))
    m += _dense("cls.seq_relationship", ("matched_head",))
    m += _dense("obj_predict_head.transform.dense", ("obj_head", "dense"))
    m += _ln("obj_predict_head.transform.LayerNorm", ("obj_head", "ln"))
    for key in ("obj", "attr", "feat"):
        m += _dense(
            f"obj_predict_head.decoder_dict.{key}",
            ("obj_head", f"decoder_{key}"),
        )
    m += _dense("answer_head.logit_fc.0", ("answer_head", "dense"))
    m += _ln("answer_head.logit_fc.2", ("answer_head", "ln"))
    m += _dense("answer_head.logit_fc.3", ("answer_head", "logits"))
    return m


def clip_key_map(
    vision_layers: int = 12, text_layers: int = 12
) -> list[tuple[str, tuple, bool]]:
    """Key map for HF ``CLIPModel`` checkpoints
    (``openai/clip-vit-base-patch32``; reference loads them in
    ``src/tasks/gqa_clip.py:76-79`` / ``gqa_weight.py:80``).

    The patch-embedding Conv2d weight (out, in, kh, kw) is pre-transposed
    by :func:`import_clip` (marker ``#conv``); projections are bias-free.
    """

    def clip_layer(tprefix: str, fprefix: tuple) -> list:
        m: list = []
        m += _ln(f"{tprefix}.layer_norm1", fprefix + ("layer_norm1",))
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            m += _dense(f"{tprefix}.self_attn.{name}", fprefix + (name,))
        m += _ln(f"{tprefix}.layer_norm2", fprefix + ("layer_norm2",))
        m += _dense(f"{tprefix}.mlp.fc1", fprefix + ("fc1",))
        m += _dense(f"{tprefix}.mlp.fc2", fprefix + ("fc2",))
        return m

    m: list = [("logit_scale", ("logit_scale",), False)]
    # Text tower.
    m.append(
        ("text_model.embeddings.token_embedding.weight",
         ("text_model", "token_embedding", "embedding"), False)
    )
    m.append(
        ("text_model.embeddings.position_embedding.weight",
         ("text_model", "position_embedding", "embedding"), False)
    )
    for i in range(text_layers):
        m += clip_layer(
            f"text_model.encoder.layers.{i}", ("text_model", f"layers_{i}")
        )
    m += _ln(
        "text_model.final_layer_norm", ("text_model", "final_layer_norm")
    )
    m.append(
        ("text_projection.weight", ("text_projection", "kernel"), True)
    )
    # Vision tower.
    m.append(
        ("vision_model.embeddings.class_embedding",
         ("vision_model", "class_embedding"), False)
    )
    m.append(
        ("vision_model.embeddings.patch_embedding.weight#conv",
         ("vision_model", "patch_embedding", "kernel"), False)
    )
    m.append(
        ("vision_model.embeddings.position_embedding.weight",
         ("vision_model", "position_embedding", "embedding"), False)
    )
    # HF spells it "pre_layrnorm" (sic).
    m += _ln("vision_model.pre_layrnorm", ("vision_model", "pre_layernorm"))
    for i in range(vision_layers):
        m += clip_layer(
            f"vision_model.encoder.layers.{i}",
            ("vision_model", f"layers_{i}"),
        )
    m += _ln(
        "vision_model.post_layernorm", ("vision_model", "post_layernorm")
    )
    m.append(
        ("visual_projection.weight", ("visual_projection", "kernel"), True)
    )
    return m

