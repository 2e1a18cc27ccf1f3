"""ViLT + GQA answer head (port of ``rgqa_tpu/models/vilt.py``).

A patch-based single-stream vision-language transformer (the reference
``GQAViLT`` over a ViT-B/32): BERT text embeddings and a conv patch
embedding with a CLS token and learned positions, a separate 2-way
modality-type table added to both streams, twelve **pre-norm** blocks
(``x + attn(ln(x))``, ``x + mlp(ln(x))``) over the concatenated stream
with the additive key mask, a final LayerNorm, the CLS pooler and the
Linear -> LayerNorm -> GELU -> Linear classifier.

At 384 px and 32 px patches the stream is the text (20 or 40 tokens)
plus 144 patches plus CLS, 165 or 185 tokens, so every attention call
goes through the long-stream kernels, 12 per forward
(``csrc/fused_attention_long.cu``) and, in training, 12 per backward
(``csrc/fused_attention_long_bwd.cu``).  Each block runs one fused (E, 3E) QKV product whose
column views go to the kernel, as ``transformer.AttentionBlock`` does.
The patch conv (stride = kernel) is a plain product over (kh, kw, in)
patches, as XLA lowers it in the JAX package; its weight keeps the
reference ``Conv2d`` layout (out, in, kh, kw).

Pad patches (the zero canvas around an image resized in ``pad`` mode)
are masked out of attention: by default from the pixel content (a patch
is valid iff any of its pixels is nonzero, the JAX package's rule), or
from an explicit ``pixel_mask`` (the u8 wire's rect geometry); CLS is
always valid.  LayerNorm eps: 1e-12 in the text embeddings, 1e-6 in the
blocks and the final norm, 1e-5 in the answer head.

In training mode the dropout sites are the JAX model's: hidden dropout
after ``att_out`` and after ``mlp_out`` in every block and at the end of
the text embeddings, each drawing from the forward's ``rng``.  There is
no attention dropout (``ViTBlock`` calls ``fused_attention``, never its
dropout variant), and none in the pooler or the answer head.  ``dtype`` is the
compute dtype of every product; the weights keep their own, and the
embeddings add in PyTorch's type promotion as flax's do in JAX's.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from rgqa_tpu_torch.config import EncoderConfig
from rgqa_tpu_torch.models.transformer import (
    Dense,
    LayerNorm,
    Pooler,
    TextEmbeddings,
    gelu,
    mask_to_bias,
)
from rgqa_tpu_torch.ops.attention import fused_attention
from rgqa_tpu_torch.ops.dropout import DropoutRng, HiddenDropout

__all__ = ["PatchEmbed", "ViTBlock", "ViltAnswerHead", "ViltForGQA"]


class PatchEmbed(nn.Module):
    """Conv patch embedding, stride = kernel = ``patch_size``:
    (B, H, W, 3) -> (B, (H/p) (W/p), hidden), patches in row-major order."""

    def __init__(self, hidden_size: int, patch_size: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.compute_dtype = dtype
        self.proj = nn.Conv2d(3, hidden_size, patch_size, patch_size)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = pixels.shape
        p, dt = self.patch_size, self.compute_dtype
        patches = pixels.to(dt).reshape(b, hh // p, p, ww // p, p, c).transpose(2, 3)
        patches = patches.reshape(b, (hh // p) * (ww // p), p * p * c)  # (kh, kw, in)
        weight = self.proj.weight.permute(0, 2, 3, 1).reshape(self.proj.out_channels, -1)
        return F.linear(patches, weight.to(dt), self.proj.bias.to(dt))


class ViTBlock(nn.Module):
    """Pre-norm transformer block (timm Block semantics)."""

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        e = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.compute_dtype = dtype
        self.norm1 = LayerNorm(e, 1e-6)
        self.query = Dense(e, e, dtype)
        self.key = Dense(e, e, dtype)
        self.value = Dense(e, e, dtype)
        self.att_out = Dense(e, e, dtype)
        self.norm2 = LayerNorm(e, 1e-6)
        self.mlp_in = Dense(e, cfg.intermediate_size, dtype)
        self.mlp_out = Dense(cfg.intermediate_size, e, dtype)
        self.dropout = HiddenDropout(cfg.hidden_dropout)

    def forward(
        self, x, bias=None, *, use_fused: Optional[bool] = None,
        rng: Optional[DropoutRng] = None,
    ) -> torch.Tensor:
        e, dt = x.shape[-1], self.compute_dtype
        h = self.norm1(x)
        w = torch.cat([self.query.weight, self.key.weight, self.value.weight]).to(dt)
        b = torch.cat([self.query.bias, self.key.bias, self.value.bias]).to(dt)
        q, k, v = F.linear(h.to(dt), w, b).split(e, dim=-1)
        ctx = fused_attention(q, k, v, bias, num_heads=self.num_heads, force_xla=use_fused is False)
        x = x + self.dropout(self.att_out(ctx), rng)
        h = self.mlp_out(gelu(self.mlp_in(self.norm2(x))))
        return x + self.dropout(h, rng)


class ViltAnswerHead(nn.Module):
    """Linear -> LayerNorm (eps 1e-5) -> GELU -> Linear (the LXMERT head
    puts GELU before its LayerNorm)."""

    def __init__(self, num_answers: int, hidden_size: int = 768, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dense = Dense(hidden_size, hidden_size * 2, dtype)
        self.ln = LayerNorm(hidden_size * 2, 1e-5)
        self.logits = Dense(hidden_size * 2, num_answers, dtype)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        return self.logits(gelu(self.ln(self.dense(pooled))))


class ViltForGQA(nn.Module):
    """ViLT + GQA answer head; returns ``{"logits", "pooled"}``."""

    def __init__(
        self, cfg: EncoderConfig, num_answers: int, *, patch_size: int = 32,
        image_size: int = 384, mask_pad_patches: bool = True,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        e = cfg.hidden_size
        self.patch_size = patch_size
        self.mask_pad_patches = mask_pad_patches
        self.compute_dtype = dtype
        self.text_embeddings = TextEmbeddings(cfg, dtype)
        self.modality_type = nn.Embedding(2, e)
        self.patch_embed = PatchEmbed(e, patch_size, dtype)
        n_patches = (image_size // patch_size) ** 2
        self.cls_token = nn.Parameter(torch.zeros(1, 1, e))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_patches + 1, e))
        self.blocks = nn.ModuleList(ViTBlock(cfg, dtype) for _ in range(cfg.num_layers))
        self.norm = LayerNorm(e, 1e-6)
        self.pooler = Pooler(cfg, dtype)
        self.answer_head = ViltAnswerHead(num_answers, e, dtype)

    def patch_valid_mask(self, pixels: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """(B, n_patches) validity from pixel content: a patch is valid iff
        any of its pixels is nonzero (pad pixels are exactly 0 after the
        normalize; the abs-sum cannot cancel a real one)."""
        b, hh, ww, _ = pixels.shape
        p = self.patch_size
        nz = pixels.to(torch.float32).abs().sum(-1) > 0  # (B, H, W)
        nz = nz.reshape(b, hh // p, p, ww // p, p)
        return nz.any(dim=4).any(dim=2).reshape(b, -1).to(dtype)

    def forward(
        self, input_ids, input_mask, pixels, *, pixel_mask=None,
        use_fused: Optional[bool] = None, rng: Optional[DropoutRng] = None,
    ) -> dict:
        b = input_ids.shape[0]
        text = self.text_embeddings(input_ids, rng=rng)
        text = text + self.modality_type(torch.zeros_like(input_mask).long())

        img = self.patch_embed(pixels)
        cls = self.cls_token.to(img.dtype).expand(b, 1, img.shape[-1])
        img = torch.cat([cls, img], dim=1) + self.pos_embed.to(img.dtype)
        if pixel_mask is None and self.mask_pad_patches:
            pixel_mask = self.patch_valid_mask(pixels, input_mask.dtype)
        if pixel_mask is None:
            img_mask = torch.ones((b, img.shape[1]), dtype=input_mask.dtype, device=img.device)
        else:
            cls_valid = torch.ones((b, 1), dtype=input_mask.dtype, device=img.device)
            img_mask = torch.cat([cls_valid, pixel_mask.to(input_mask.dtype)], dim=1)
        img = img + self.modality_type(torch.ones_like(img_mask).long())

        stream = torch.cat([text, img], dim=1)
        bias = mask_to_bias(torch.cat([input_mask, img_mask], dim=1), self.compute_dtype)
        for blk in self.blocks:
            stream = blk(stream, bias, use_fused=use_fused, rng=rng)
        pooled = self.pooler(self.norm(stream))
        return {"logits": self.answer_head(pooled), "pooled": pooled}
