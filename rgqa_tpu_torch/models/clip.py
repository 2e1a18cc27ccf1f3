"""CLIP ViT-B/32 two-tower image-text model (port of ``rgqa_tpu/models/clip.py``).

The CLIP rejection scorer's model (the reference wraps HF ``CLIPModel``,
``src/tasks/gqa_clip.py:76-110``): a pre-norm ViT vision tower and a
causal-mask text transformer, each projected into a shared space where
the rejection score is the image-question cosine similarity.  Semantics
are HF ``CLIPModel``'s, as in the JAX package:

- quick-GELU ``x * sigmoid(1.702 x)``; pre-norm blocks ``x + attn(ln1(x))``,
  ``x + mlp(ln2(x))``, LayerNorm eps from the config (1e-5);
- vision: 32 x 32 patches (no bias), class embedding, learned positions,
  ``pre_layrnorm`` before the blocks, pooled = post-LN of token 0;
- text: token + position embeddings, a causal mask, final LN, pooled at
  the EOT position: argmax of the ids for the original ``eos_token_id ==
  2`` configs (EOT is the highest id), the first EOS otherwise;
- projections without bias, L2-normalized embeddings, learned
  ``logit_scale``.

The parameter names are HF's (``vision_model.encoder.layers.0.self_attn.
q_proj.weight``, ``vision_model.pre_layrnorm``, ``logit_scale``, ...), so
an HF checkpoint's state_dict loads as it is, less its ``position_ids``
buffers.  The patch-embedding weight keeps HF's ``Conv2d`` layout (out, 3,
32, 32), but the patches are embedded as one product over (kh, kw, in)
rows of the channels-last pixels, as XLA lowers the JAX package's conv:
no cuDNN convolution, whose f32 default on the card is TF32.

Vision attention (50 tokens at 224 px, no mask) goes through
:func:`rgqa_tpu_torch.ops.attention.fused_attention`, kernel #1 on the
card, 12 launches per image forward; ``use_fused=False`` runs its plain
version.  The text tower's causal 77 x 77 attention has no kernel in
either package (the JAX package runs it through XLA): it is plain
attention under a (B, 1, S, S) f32 mask built from ``finfo(float32).min``
as HF builds it, where causal and padding terms add to ``-inf``; every
row keeps its own position visible, so none turns to NaN.

``dtype`` is the compute dtype of every product (f32 by default, as the
JAX CLI builds the scorer); the weights stay f32.  In f32 the public
methods hold TF32 off (:func:`~rgqa_tpu_torch.device.exact_f32`).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rgqa_tpu_torch.device import exact_f32
from rgqa_tpu_torch.models.transformer import Dense, LayerNorm
from rgqa_tpu_torch.ops.attention import attention_probs, fused_attention

__all__ = [
    "ClipTowerConfig",
    "ClipConfig",
    "clip_config_from_hf",
    "quick_gelu",
    "ClipEncoderLayer",
    "ClipVisionTower",
    "ClipTextTower",
    "ClipModel",
    "init_clip_weights",
    "example_inputs",
]


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """HF ``quick_gelu``: ``x * sigmoid(1.702 x)``."""
    return x * torch.sigmoid(1.702 * x)


@dataclass(frozen=True)
class ClipTowerConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    layer_norm_eps: float = 1e-5


@dataclass(frozen=True)
class ClipConfig:
    """ViT-B/32 defaults (``openai/clip-vit-base-patch32``)."""

    vision: ClipTowerConfig = field(default_factory=ClipTowerConfig)
    text: ClipTowerConfig = field(
        default_factory=lambda: ClipTowerConfig(
            hidden_size=512, num_layers=12, num_heads=8, intermediate_size=2048,
        )
    )
    image_size: int = 224
    patch_size: int = 32
    vocab_size: int = 49408
    max_text_len: int = 77
    # The original openai configs ship eos_token_id == 2: EOT pooling is
    # then the argmax over ids; re-exported configs carry the real EOT id
    # and pool at its first occurrence.
    eos_token_id: int = 2
    projection_dim: int = 512
    logit_scale_init: float = 2.6592

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


def clip_config_from_hf(config: dict) -> ClipConfig:
    """A :class:`ClipConfig` from an HF ``config.json`` dict."""
    v = config.get("vision_config", {})
    t = config.get("text_config", {})
    return ClipConfig(
        vision=ClipTowerConfig(
            hidden_size=v.get("hidden_size", 768),
            num_layers=v.get("num_hidden_layers", 12),
            num_heads=v.get("num_attention_heads", 12),
            intermediate_size=v.get("intermediate_size", 3072),
            layer_norm_eps=v.get("layer_norm_eps", 1e-5),
        ),
        text=ClipTowerConfig(
            hidden_size=t.get("hidden_size", 512),
            num_layers=t.get("num_hidden_layers", 12),
            num_heads=t.get("num_attention_heads", 8),
            intermediate_size=t.get("intermediate_size", 2048),
            layer_norm_eps=t.get("layer_norm_eps", 1e-5),
        ),
        image_size=v.get("image_size", 224),
        patch_size=v.get("patch_size", 32),
        vocab_size=t.get("vocab_size", 49408),
        max_text_len=t.get("max_position_embeddings", 77),
        eos_token_id=t.get("eos_token_id", 2),
        projection_dim=config.get("projection_dim", 512),
        logit_scale_init=config.get("logit_scale_init_value", 2.6592),
    )


class ClipAttention(nn.Module):
    """HF ``CLIPAttention``'s projections; one fused (E, 3E) QKV product
    whose column views go to the attention."""

    def __init__(self, cfg: ClipTowerConfig, dtype: torch.dtype):
        super().__init__()
        e = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.compute_dtype = dtype
        self.q_proj = Dense(e, e, dtype)
        self.k_proj = Dense(e, e, dtype)
        self.v_proj = Dense(e, e, dtype)
        self.out_proj = Dense(e, e, dtype)

    def forward(self, x, bias4=None, *, use_fused: Optional[bool] = None) -> torch.Tensor:
        e, dt = x.shape[-1], self.compute_dtype
        w = torch.cat([self.q_proj.weight, self.k_proj.weight, self.v_proj.weight]).to(dt)
        b = torch.cat([self.q_proj.bias, self.k_proj.bias, self.v_proj.bias]).to(dt)
        q, k, v = F.linear(x.to(dt), w, b).split(e, dim=-1)
        if bias4 is None:
            ctx = fused_attention(q, k, v, None, num_heads=self.num_heads, force_xla=use_fused is False)
        else:  # the text tower's causal mask: plain attention
            bsz, s, h = x.shape[0], x.shape[1], self.num_heads
            probs = attention_probs(q, k, bias4, h).to(dt)
            ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v.reshape(bsz, s, h, e // h)).reshape(bsz, s, e)
        return self.out_proj(ctx)


class ClipMLP(nn.Module):
    def __init__(self, cfg: ClipTowerConfig, dtype: torch.dtype):
        super().__init__()
        self.fc1 = Dense(cfg.hidden_size, cfg.intermediate_size, dtype)
        self.fc2 = Dense(cfg.intermediate_size, cfg.hidden_size, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(quick_gelu(self.fc1(x)))


class ClipEncoderLayer(nn.Module):
    """Pre-norm block (HF ``CLIPEncoderLayer``); ``bias4`` is the text
    tower's additive (B, 1, S, S) mask, None in the vision tower."""

    def __init__(self, cfg: ClipTowerConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layer_norm1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.self_attn = ClipAttention(cfg, dtype)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.mlp = ClipMLP(cfg, dtype)

    def forward(self, x, bias4=None, *, use_fused: Optional[bool] = None) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), bias4, use_fused=use_fused)
        return x + self.mlp(self.layer_norm2(x))


class ClipEncoder(nn.Module):
    def __init__(self, cfg: ClipTowerConfig, dtype: torch.dtype):
        super().__init__()
        self.layers = nn.ModuleList(ClipEncoderLayer(cfg, dtype) for _ in range(cfg.num_layers))

    def forward(self, x, bias4=None, *, use_fused: Optional[bool] = None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, bias4, use_fused=use_fused)
        return x


class ClipVisionEmbeddings(nn.Module):
    def __init__(self, cfg: ClipConfig, dtype: torch.dtype):
        super().__init__()
        e = cfg.vision.hidden_size
        self.patch_size = cfg.patch_size
        self.compute_dtype = dtype
        self.class_embedding = nn.Parameter(torch.zeros(e))
        self.patch_embedding = nn.Conv2d(3, e, cfg.patch_size, cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding(cfg.num_patches + 1, e)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) channels-last pixels -> (B, 1 + N, E): the patches
        row-major, each flattened (kh, kw, in) against the weight
        permuted to match, one product."""
        b, hh, ww, c = pixels.shape
        p, dt = self.patch_size, self.compute_dtype
        patches = pixels.to(dt).reshape(b, hh // p, p, ww // p, p, c).transpose(2, 3)
        patches = patches.reshape(b, (hh // p) * (ww // p), p * p * c)
        weight = self.patch_embedding.weight.permute(0, 2, 3, 1).reshape(self.patch_embedding.out_channels, -1)
        x = F.linear(patches, weight.to(dt))
        cls = self.class_embedding.to(dt).expand(b, 1, x.shape[-1])
        x = torch.cat([cls, x], dim=1)
        return x + self.position_embedding.weight[: x.shape[1]].to(dt)


class ClipVisionTower(nn.Module):
    """HF ``CLIPVisionTransformer``: patches + CLS + positions -> pre-LN
    -> blocks -> post-LN of token 0."""

    def __init__(self, cfg: ClipConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        eps = cfg.vision.layer_norm_eps
        self.embeddings = ClipVisionEmbeddings(cfg, dtype)
        self.pre_layrnorm = LayerNorm(cfg.vision.hidden_size, eps)  # HF's spelling
        self.encoder = ClipEncoder(cfg.vision, dtype)
        self.post_layernorm = LayerNorm(cfg.vision.hidden_size, eps)

    def forward(self, pixels, *, use_fused: Optional[bool] = None) -> torch.Tensor:
        x = self.encoder(self.pre_layrnorm(self.embeddings(pixels)), use_fused=use_fused)
        return self.post_layernorm(x[:, 0])


class ClipTextEmbeddings(nn.Module):
    def __init__(self, cfg: ClipConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.text.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_text_len, cfg.text.hidden_size)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        s = input_ids.shape[1]
        return self.token_embedding(input_ids.long()) + self.position_embedding.weight[:s]


class ClipTextTower(nn.Module):
    """HF ``CLIPTextTransformer``: embeddings -> causal blocks -> final LN
    -> EOT pooling."""

    def __init__(self, cfg: ClipConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eos_token_id = cfg.eos_token_id
        self.compute_dtype = dtype
        self.embeddings = ClipTextEmbeddings(cfg)
        self.encoder = ClipEncoder(cfg.text, dtype)
        self.final_layer_norm = LayerNorm(cfg.text.hidden_size, cfg.text.layer_norm_eps)

    def forward(self, input_ids, attention_mask=None) -> torch.Tensor:
        b, s = input_ids.shape
        x = self.embeddings(input_ids).to(self.compute_dtype)
        # HF builds both masks with finfo(float32).min; where they overlap
        # they add to -inf, and each row keeps its own position visible.
        neg = torch.finfo(torch.float32).min
        bias4 = torch.triu(torch.full((s, s), neg, device=x.device), diagonal=1)[None, None]
        if attention_mask is not None:
            pad = (1.0 - attention_mask.to(torch.float32)) * neg
            bias4 = bias4 + pad[:, None, None, :]
        x = self.final_layer_norm(self.encoder(x, bias4))
        if self.eos_token_id == 2:  # original openai configs: EOT is the highest id
            eot = torch.argmax(input_ids, dim=-1)
        else:
            eot = torch.argmax((input_ids == self.eos_token_id).to(torch.int32), dim=-1)
        return x[torch.arange(b, device=x.device), eot]


class ClipModel(nn.Module):
    """Two towers + projections + logit scale (HF ``CLIPModel``)."""

    def __init__(self, cfg: ClipConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = dtype
        self.vision_model = ClipVisionTower(cfg, dtype)
        self.text_model = ClipTextTower(cfg, dtype)
        self.visual_projection = Dense(cfg.vision.hidden_size, cfg.projection_dim, dtype, bias=False)
        self.text_projection = Dense(cfg.text.hidden_size, cfg.projection_dim, dtype, bias=False)
        self.logit_scale = nn.Parameter(torch.tensor(cfg.logit_scale_init))

    def _precision(self):
        return exact_f32() if self.compute_dtype == torch.float32 else contextlib.nullcontext()

    def image_features(self, pixels, *, use_fused: Optional[bool] = None) -> torch.Tensor:
        """Projected, unnormalized image embeddings (HF
        ``get_image_features``) of f32 normalized (B, H, W, 3) pixels."""
        with self._precision():
            return self.visual_projection(self.vision_model(pixels, use_fused=use_fused))

    def text_features(self, input_ids, attention_mask=None) -> torch.Tensor:
        """Projected, unnormalized text embeddings (HF ``get_text_features``)."""
        with self._precision():
            return self.text_projection(self.text_model(input_ids, attention_mask))

    def _embeds(self, input_ids, attention_mask, pixels, use_fused):
        img = self.image_features(pixels, use_fused=use_fused).float()
        txt = self.text_features(input_ids, attention_mask).float()
        return img / img.norm(dim=-1, keepdim=True), txt / txt.norm(dim=-1, keepdim=True)

    def forward(self, input_ids, attention_mask, pixels, *, use_fused: Optional[bool] = None) -> dict:
        img, txt = self._embeds(input_ids, attention_mask, pixels, use_fused)
        logits_per_text = (txt @ img.T) * torch.exp(self.logit_scale.float())
        return {"image_embeds": img, "text_embeds": txt,
                "logits_per_image": logits_per_text.T, "logits_per_text": logits_per_text}

    def cosine(self, input_ids, attention_mask, pixels, *, use_fused: Optional[bool] = None) -> torch.Tensor:
        """Per-(image, question) cosine similarity, the rejection score
        (``gqa_clip.py:96-104``: the diagonal of ``logits_per_image /
        logit_scale.exp()``), pairwise."""
        img, txt = self._embeds(input_ids, attention_mask, pixels, use_fused)
        return (img * txt).sum(dim=-1)


@torch.no_grad()
def init_clip_weights(model: ClipModel, generator: torch.Generator) -> None:
    """The JAX package's init: normal(0, 0.02) for every product,
    embedding, patch and class embedding, zero biases, LayerNorm
    ones/zeros, ``logit_scale`` at its configured start.  Draws in
    module order from ``generator``, which lives on the model's device."""

    def normal_(w):
        w.copy_(torch.randn(w.shape, generator=generator, device=w.device) * 0.02)

    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Embedding, nn.Conv2d)):
            normal_(mod.weight)
            if getattr(mod, "bias", None) is not None:
                mod.bias.zero_()
        elif isinstance(mod, LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, ClipVisionEmbeddings):
            normal_(mod.class_embedding)
    model.logit_scale.fill_(model.cfg.logit_scale_init)


def example_inputs(cfg: ClipConfig, batch_size: int, *, seed: int = 0):
    """Seeded numpy inputs at ``cfg``'s shapes: ``(ids, mask)`` (B,
    max_text_len) int32 of texts of 4-20 tokens (at most max_text_len), BOT first and EOT (the
    vocabulary's highest id, as in CLIP's) last, padded with EOT as HF's
    tokenizer pads; uint8 pixels (B, image_size, image_size, 3)."""
    rng = np.random.default_rng(seed)
    eot = cfg.vocab_size - 1
    ids = np.full((batch_size, cfg.max_text_len), eot, np.int32)
    mask = np.zeros((batch_size, cfg.max_text_len), np.int32)
    for i, n in enumerate(rng.integers(4, min(21, cfg.max_text_len + 1), batch_size)):
        ids[i, 0] = eot - 1
        ids[i, 1 : n - 1] = rng.integers(1, eot - 1, n - 2)
        mask[i, :n] = 1
    pixels = rng.integers(0, 256, (batch_size, cfg.image_size, cfg.image_size, 3), dtype=np.uint8)
    return ids, mask, pixels
