"""Build a backbone + a uniform forward adapter (port of
``rgqa_tpu/models/zoo.py``: lxmert, uniter, vilt, butd and caps).

``forward(batch, **kw) -> dict`` takes a dict batch of tensors:

- lxmert: ``input_ids``, ``input_mask``, ``segment_ids`` (B, T),
  ``feats`` (B, K, 2048) and ``boxes`` (B, K, 4);
- uniter: the same keys, ``boxes`` (B, K, 7) UNITER's box transform;
- vilt: ``input_ids``, ``input_mask`` (B, T) and either ``pixels``
  (B, S, S, 3) f32 (the ``f32`` wire; pad patches masked from content)
  or ``pixels_u8`` (B, S, S, 3) uint8 + ``pixel_rect`` (B, 4), normalized
  on the device (the ``u8`` wire), with ``pixel_mask`` (B, patches) when
  the batch carries one;
- butd: ``token_ids`` (B, 40) front-padded word indices, ``feats`` and
  ``boxes`` (B, K, 4);
- caps: ``input_ids``, ``input_mask``, ``segment_ids`` (B, T) of the
  ``[CLS] caption [SEP] question [SEP]`` pair.

:func:`load_pretraining` builds LXMERT with its pretraining heads from a
reference ``model_LXRT.pth`` (the match scorer's ``--loadLXMERT``), with
an adapter over LXMERT's batch keys.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import nn

from rgqa_tpu_torch.checkpoint.convert import load_reference_pth, lxrt_path, orbax_refusal
from rgqa_tpu_torch.config import EncoderConfig, ModelConfig
from rgqa_tpu_torch.data.images import rect_patch_mask
from rgqa_tpu_torch.device import resolve_device
from rgqa_tpu_torch.models.butd import MAX_GQA_LENGTH, ButdForGQA, init_butd_weights
from rgqa_tpu_torch.models.caps import CaptionMatcher
from rgqa_tpu_torch.models.lxmert import LxmertForGQA, LxmertPretraining
from rgqa_tpu_torch.models.transformer import LayerNorm
from rgqa_tpu_torch.models.uniter import UNITER_POS_DIM, UniterForGQA
from rgqa_tpu_torch.models.vilt import ViltForGQA
from rgqa_tpu_torch.ops.pixels import pixelbert_normalize

__all__ = ["build_model", "default_config", "example_batch", "init_weights", "module_mode",
           "load_pretraining"]

DENSE_INIT_STD = 0.02  # BERT's normal init, flax ``dense_init`` in the JAX package


def default_config(backbone: str = "lxmert") -> ModelConfig:
    """A full-width GQA configuration.

    - ``"lxmert"``: 9 language / 5 vision / 5 cross layers x 768, 12
      heads, vocab 30522, 1842 answers, 36 RoI features of 2048, dropout
      0.1, 20 text tokens.
    - ``"uniter"``: UNITER-base, 12 layers x 768, 12 heads, MLP 3072,
      the same vocab, answers, RoI features, dropout and text length: a
      56-token stream.
    - ``"vilt"``: ViLT-B/32, 12 pre-norm layers x 768, 12 heads, MLP 3072,
      vocab 30522, 1842 answers, 384 px images in 32 px patches (144 +
      CLS), 40 text tokens: the reference's 185-token stream
      (``docs/vilt_images.md``).
    - ``"butd"``: GloVe-300 embeddings, a GRU-1024 over 40 front-padded
      tokens, 36 RoIs of 2048 + 4, the 2 x 1024 classifier over 1842
      answers, a 2941-word question vocabulary (the runner takes the
      size of its dictionary instead).
    - ``"caps"``: the caption matcher, BERT-base (12 x 768, 12 heads, MLP
      3072, vocab 30522, two token types) over 20 tokens of the
      caption-question pair, one match logit.
    """
    if backbone in ("lxmert", "uniter", "butd", "caps"):
        return ModelConfig(backbone=backbone)
    if backbone == "vilt":
        return ModelConfig(
            backbone="vilt", max_text_len=40, vilt_patch_size=32, vilt_image_size=384
        )
    raise NotImplementedError(f"backbone {backbone!r} is not ported yet")


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's init: normal(0, 0.02) for dense and embedding
    weights and ViLT's position table, zero biases and CLS token,
    LayerNorm ones/zeros.  The ViLT patch conv takes normal(0, 0.02) too
    (flax's Conv default is lecun-normal, std 1/sqrt(fan_in) = 0.018 at
    ViT-B/32).  Draws in module order from ``generator``, which must live
    on the model's device.  BUTD takes its own init
    (:func:`~rgqa_tpu_torch.models.butd.init_butd_weights`)."""
    if isinstance(model, ButdForGQA):
        init_butd_weights(model, generator)
        return

    def normal_(w):
        w.copy_(
            torch.randn(w.shape, generator=generator, device=w.device, dtype=torch.float32)
            * DENSE_INIT_STD
        )

    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Embedding, nn.Conv2d)):
            normal_(mod.weight)
            if not isinstance(mod, nn.Embedding):
                mod.bias.zero_()
        elif isinstance(mod, LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, ViltForGQA):
            normal_(mod.pos_embed)
            mod.cls_token.zero_()


def build_model(
    cfg: ModelConfig,
    *,
    use_bf16: bool = False,
    device: Optional[torch.device | str] = None,
    generator: Optional[torch.Generator] = None,
    train: bool = False,
) -> tuple[nn.Module, Callable[..., dict]]:
    """Instantiate (module, forward adapter) on ``device`` (default CUDA;
    raises without a card unless ``device`` is the CPU).  On the ``meta``
    device it returns ``(module, None)``: parameter shapes, no storage and
    no init.

    Weights come from ``generator`` (default: seed 0 on ``device``).
    ``use_bf16`` makes bf16 the compute dtype.  For inference (``train``
    False; the module is in eval mode) the weights are cast to bf16 too:
    the serving convention, no f32 master copy.  For training they stay
    f32 masters under bf16 compute, as the JAX trainer keeps them, and
    the module is in training mode.

    ``forward(batch, *, deterministic=None, use_fused=None, rng=None)``:
    ``rng`` is the :class:`~rgqa_tpu_torch.ops.dropout.DropoutRng` a
    stochastic forward draws its dropout from; ``deterministic`` True runs
    the call in eval mode, False in training mode (dropout on), None in
    the module's own mode, which is restored after the call either way.

    ``cfg.branched`` / ``cfg.branched_layers`` add LXMERT's confidence
    heads (the forward returns ``conf``); ``cfg.branched`` adds BUTD's.
    UNITER, ViLT and the caption matcher have none, in the JAX package
    too, and raise, as does ``branched_layers`` on BUTD (the JAX
    package's ``_build_butd`` ignores it).

    BUTD keeps f32 weights and f32 compute whatever ``use_bf16`` says,
    as the JAX package's BUTD does; its adapter carries ``precision``,
    the model's context for its products
    (:func:`~rgqa_tpu_torch.device.exact_f32`), which a training step
    holds over its backward too.  The caption matcher's
    logits are (B,)."""
    if cfg.backbone not in ("lxmert", "uniter", "vilt", "butd", "caps"):
        raise ValueError(
            f"unknown backbone {cfg.backbone!r}; have butd, caps, lxmert, uniter and vilt"
        )
    names = {"uniter": "UNITER", "vilt": "ViLT", "caps": "the caption matcher"}
    if cfg.backbone in names and (cfg.branched or cfg.branched_layers):
        name = names[cfg.backbone]
        raise NotImplementedError(
            f"--branched / --branched_layer: {name} has no branched confidence head "
            f"(nor has the JAX package's {name})"
        )
    if cfg.backbone == "butd" and cfg.branched_layers:
        raise NotImplementedError(
            "--branched_layer: BUTD has no layer taps (the JAX package's _build_butd ignores the "
            "flag); --branched adds its confidence head"
        )

    device = resolve_device(device)
    if cfg.backbone == "butd":
        use_bf16 = False  # f32 weights and products (the JAX _build_butd ignores the dtype)
    dtype = torch.bfloat16 if use_bf16 else torch.float32
    with device:
        if cfg.backbone == "butd":
            model = ButdForGQA(
                cfg.butd_vocab_size, cfg.num_answers, embed_dim=cfg.butd_embed_dim,
                hidden=cfg.butd_hidden_dim, visual_dim=cfg.encoder.visual_feat_dim,
                branched=cfg.branched,
            )
        elif cfg.backbone == "caps":
            model = CaptionMatcher(cfg.encoder, dtype=dtype)
        elif cfg.backbone == "vilt":
            model = ViltForGQA(
                cfg.encoder, cfg.num_answers, patch_size=cfg.vilt_patch_size,
                image_size=cfg.vilt_image_size, dtype=dtype,
            )
        elif cfg.backbone == "uniter":
            model = UniterForGQA(cfg.encoder, cfg.num_answers, dtype=dtype)
        else:
            model = LxmertForGQA(
                cfg.encoder, cfg.num_answers, dtype=dtype, branched=cfg.branched,
                branched_layers=cfg.branched_layers, project_size=cfg.project_size,
            )
    if device.type == "meta":  # shapes only (cli/compute_param.py): nothing to draw
        return model, None
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    init_weights(model, generator)
    if use_bf16 and not train:
        model.to(torch.bfloat16)
    model.train(train)

    if cfg.backbone == "vilt":
        return model, _vilt_forward(model)
    if cfg.backbone == "butd":
        return model, _butd_forward(model)
    if cfg.backbone == "caps":
        return model, _caps_forward(model)

    def forward(batch: dict, *, deterministic: Optional[bool] = None, **kw) -> dict:
        with module_mode(model, deterministic):
            return model(
                batch["input_ids"], batch["input_mask"], batch["segment_ids"],
                batch["feats"], batch["boxes"], **kw,
            )

    return model, forward


def load_pretraining(
    path: str, cfg: EncoderConfig, *, device: Optional[torch.device | str] = None,
) -> tuple[LxmertPretraining, Callable[..., dict]]:
    """LXMERT with its pretraining heads, f32 weights and compute, in eval
    mode on ``device`` (default CUDA), from a reference pretraining
    ``.pth`` (``model_LXRT.pth``, as ``import_lxmert_pretraining`` reads
    it: the tied decoder weight dropped), at ``cfg``'s depths; the QA
    head's width is the checkpoint's (9500 answers in the reference's).
    ``path`` may be an orbax pretraining snapshot directory (the JAX CLI's
    ``--loadLXMERT``) with its export ``<path>_LXRT.pth`` beside it.
    Raises on a key the checkpoint lacks, and on such a directory without
    its export (naming the command that writes it).  Returns the module
    and its forward adapter (LXMERT's batch keys, ``deterministic`` and
    ``use_fused`` as :func:`build_model`'s)."""
    path = lxrt_path(path)
    if os.path.isdir(path):
        raise orbax_refusal("--loadLXMERT", path, path + "_LXRT.pth")
    sd, missing, unused = load_reference_pth(
        path, backbone="lxmert_pretrain", l_layers=cfg.l_layers, x_layers=cfg.x_layers,
        r_layers=cfg.r_layers,
    )
    if missing:
        raise ValueError(f"pretraining checkpoint {path!r} is missing keys: {missing[:5]}")
    if unused:
        print(f"Ckpt weights unused: {unused[:5]}...")
    with resolve_device(device):
        model = LxmertPretraining(cfg, num_answers=sd["answer_head.logit_fc.3.weight"].shape[0])
    model.load_state_dict(sd)
    model.eval()

    def forward(batch: dict, *, deterministic: Optional[bool] = None, **kw) -> dict:
        with module_mode(model, deterministic):
            return model(batch["input_ids"], batch["input_mask"], batch["segment_ids"],
                         batch["feats"], batch["boxes"], **kw)

    return model, forward


@contextlib.contextmanager
def module_mode(model: nn.Module, deterministic: Optional[bool]):
    """The JAX adapters' ``deterministic`` as a module mode: True -> eval,
    False -> training, None -> as it is; the mode before is restored."""
    before = model.training
    if deterministic is not None:
        model.train(not deterministic)
    try:
        yield
    finally:
        model.train(before)


def _butd_forward(model) -> Callable[..., dict]:
    def forward(batch: dict, *, deterministic: Optional[bool] = None, use_fused=None, **kw) -> dict:
        # use_fused is the attention kernels' switch: BUTD has no attention.
        with module_mode(model, deterministic):
            return model(batch["token_ids"], batch["feats"], batch["boxes"], **kw)

    forward.precision = lambda: model.precision()
    return forward


def _caps_forward(model) -> Callable[..., dict]:
    def forward(batch: dict, *, deterministic: Optional[bool] = None, **kw) -> dict:
        with module_mode(model, deterministic):
            return model(batch["input_ids"], batch["input_mask"], batch["segment_ids"], **kw)

    return forward


def _vilt_forward(model) -> Callable[..., dict]:
    def forward(batch: dict, *, deterministic: Optional[bool] = None, **kw) -> dict:
        with module_mode(model, deterministic):
            return _vilt_call(model, batch, **kw)

    return forward


def _vilt_call(model, batch: dict, **kw) -> dict:
    pixels = batch.get("pixels")
    # An explicit pixel_mask wins over the batch's.
    pixel_mask = kw.pop("pixel_mask", batch.get("pixel_mask"))
    if pixels is None:
        # The u8 wire: normalize on the device; the pad-patch mask rides
        # the batch as rect geometry.
        pixels = pixelbert_normalize(batch["pixels_u8"], batch["pixel_rect"])
    return model(batch["input_ids"], batch["input_mask"], pixels, pixel_mask=pixel_mask, **kw)


def example_batch(
    cfg: ModelConfig, batch_size: int = 8, *, seed: int = 0, pixel_wire: str = "f32",
    with_target: bool = False,
) -> dict:
    """A synthetic fixed-shape numpy batch; the same draws as the JAX
    package's ``example_batch`` for lxmert, uniter (7-d ``boxes``), vilt
    (f32 ``pixels``, standard normal), butd (``token_ids`` (B, 40) in
    place of the text fields) and caps (the text fields alone), and with
    ``with_target`` its one-hot ``target`` rows, drawn after them.
    ``pixel_wire="u8"`` gives vilt the u8 wire
    instead: random ``pixels_u8``, and in three rows of four the
    ``pixel_rect`` of a 2:1, 3:2 or 4:3 image in pad mode, with its
    ``pixel_mask``."""
    rng = np.random.default_rng(seed)
    batch = _example_inputs(cfg, batch_size, rng, pixel_wire)
    if with_target:
        target = np.zeros((batch_size, cfg.num_answers), np.float32)
        target[np.arange(batch_size), rng.integers(0, cfg.num_answers, batch_size)] = 1.0
        batch["target"] = target
    return batch


def _example_inputs(cfg: ModelConfig, batch_size: int, rng: np.random.Generator, pixel_wire: str) -> dict:
    t = cfg.max_text_len
    k = cfg.encoder.num_objects
    batch: dict[str, Any] = {}
    if cfg.backbone == "butd":
        batch["token_ids"] = rng.integers(
            0, cfg.butd_vocab_size, (batch_size, MAX_GQA_LENGTH), dtype=np.int32
        )
    else:
        low = min(1000, cfg.encoder.vocab_size // 2)
        ids = rng.integers(low, cfg.encoder.vocab_size, (batch_size, t), dtype=np.int32)
        ids[:, 0] = min(101, cfg.encoder.vocab_size - 1)  # [CLS]
        batch["input_ids"] = ids
        batch["input_mask"] = np.ones((batch_size, t), np.int32)
        batch["segment_ids"] = np.zeros((batch_size, t), np.int32)
    if cfg.backbone == "caps":
        return batch
    if cfg.backbone == "vilt":
        s = cfg.vilt_image_size
        if pixel_wire == "f32":
            batch["pixels"] = rng.standard_normal((batch_size, s, s, 3), dtype=np.float32)
            return batch
        batch["pixels_u8"] = rng.integers(0, 256, (batch_size, s, s, 3), dtype=np.uint8)
        rects = np.tile(np.asarray([0, 0, s, s], np.int32), (batch_size, 1))
        rects[1::4] = (s // 4, 0, s // 2, s)
        rects[2::4] = (0, s // 6, s, 2 * s // 3)
        rects[3::4] = (s // 8, 0, 3 * s // 4, s)
        batch["pixel_rect"] = rects
        batch["pixel_mask"] = rect_patch_mask(rects, s, cfg.vilt_patch_size)
        return batch
    batch["feats"] = rng.standard_normal(
        (batch_size, k, cfg.encoder.visual_feat_dim), dtype=np.float32
    )
    pos_dim = UNITER_POS_DIM if cfg.backbone == "uniter" else 4
    batch["boxes"] = rng.random((batch_size, k, pos_dim), dtype=np.float32)
    return batch
