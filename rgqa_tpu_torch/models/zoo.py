"""Build a backbone + a uniform forward adapter (port of
``rgqa_tpu/models/zoo.py``, lxmert only).

``forward(batch, **kw) -> dict`` takes a dict batch of tensors with the
keys ``input_ids``, ``input_mask``, ``segment_ids`` (B, T), ``feats``
(B, K, 2048) and ``boxes`` (B, K, 4).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import nn

from rgqa_tpu_torch.config import ModelConfig
from rgqa_tpu_torch.device import resolve_device
from rgqa_tpu_torch.models.transformer import LayerNorm

__all__ = ["build_model", "default_config", "example_batch", "init_weights"]

DENSE_INIT_STD = 0.02  # BERT's normal init, flax ``dense_init`` in the JAX package


def default_config() -> ModelConfig:
    """The full-width LXMERT GQA configuration: 9 language / 5 vision / 5
    cross layers x 768, 12 heads, vocab 30522, 1842 answers, 36 RoI
    features of 2048, dropout 0.1."""
    return ModelConfig()


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's init: normal(0, 0.02) for dense and embedding
    weights, zero biases, LayerNorm ones/zeros.  Draws in module order
    from ``generator``, which must live on the model's device."""
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Embedding)):
            w = mod.weight
            w.copy_(
                torch.randn(
                    w.shape, generator=generator, device=w.device,
                    dtype=torch.float32,
                ) * DENSE_INIT_STD
            )
            if isinstance(mod, nn.Linear):
                mod.bias.zero_()
        elif isinstance(mod, LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()


def build_model(
    cfg: ModelConfig,
    *,
    use_bf16: bool = False,
    device: Optional[torch.device | str] = None,
    generator: Optional[torch.Generator] = None,
    train: bool = False,
) -> tuple[nn.Module, Callable[..., dict]]:
    """Instantiate (module, forward adapter) on ``device`` (default CUDA;
    raises without a card unless ``device`` is the CPU).

    Weights come from ``generator`` (default: seed 0 on ``device``).
    ``use_bf16`` makes bf16 the compute dtype.  For inference (``train``
    False; the module is in eval mode) the weights are cast to bf16 too:
    the serving convention, no f32 master copy.  For training they stay
    f32 masters under bf16 compute, as the JAX trainer keeps them, and
    the module is in training mode.

    ``forward(batch, *, use_fused=None, rng=None)``: ``rng`` is the
    :class:`~rgqa_tpu_torch.ops.dropout.DropoutRng` a training forward
    draws its dropout from."""
    if cfg.backbone != "lxmert":
        raise NotImplementedError(
            f"backbone {cfg.backbone!r} is not ported yet; the port has lxmert"
        )
    if cfg.branched or cfg.branched_layers:
        raise NotImplementedError("the branched confidence heads are not ported yet")
    from rgqa_tpu_torch.models.lxmert import LxmertForGQA

    device = resolve_device(device)
    dtype = torch.bfloat16 if use_bf16 else torch.float32
    with device:
        model = LxmertForGQA(cfg.encoder, cfg.num_answers, dtype=dtype)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    init_weights(model, generator)
    if use_bf16 and not train:
        model.to(torch.bfloat16)
    model.train(train)

    def forward(batch: dict, **kw) -> dict:
        return model(
            batch["input_ids"], batch["input_mask"], batch["segment_ids"],
            batch["feats"], batch["boxes"], **kw,
        )

    return model, forward


def example_batch(cfg: ModelConfig, batch_size: int = 8, *, seed: int = 0) -> dict:
    """A synthetic fixed-shape numpy batch; the same draws as the JAX
    package's ``example_batch`` for lxmert."""
    rng = np.random.default_rng(seed)
    t = cfg.max_text_len
    k = cfg.encoder.num_objects
    low = min(1000, cfg.encoder.vocab_size // 2)
    ids = rng.integers(low, cfg.encoder.vocab_size, (batch_size, t), dtype=np.int32)
    ids[:, 0] = min(101, cfg.encoder.vocab_size - 1)  # [CLS]
    batch: dict[str, Any] = {
        "input_ids": ids,
        "input_mask": np.ones((batch_size, t), np.int32),
        "segment_ids": np.zeros((batch_size, t), np.int32),
    }
    batch["feats"] = rng.standard_normal(
        (batch_size, k, cfg.encoder.visual_feat_dim), dtype=np.float32
    )
    batch["boxes"] = rng.random((batch_size, k, 4), dtype=np.float32)
    return batch
