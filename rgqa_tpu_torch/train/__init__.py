"""Training (port of ``rgqa_tpu/train``): losses, BertAdam and the other
optimizers, the train step (RP pairing, mixup, the weighted RP loss),
VILLA (``adversarial``), the dual-loader min-max (``dual_loader``),
online distillation (``online_distill``) and checkpoint state."""

from rgqa_tpu_torch.train.losses import bce_answer_loss, optax_sigmoid_bce
from rgqa_tpu_torch.train.optimizer import BertAdam, make_optimizer, warmup_linear
from rgqa_tpu_torch.train.state import load_train_state, save_reference_pth, save_train_state
from rgqa_tpu_torch.train.step import global_norm_clip, make_train_step, rp_augment

__all__ = [
    "bce_answer_loss",
    "optax_sigmoid_bce",
    "BertAdam",
    "make_optimizer",
    "warmup_linear",
    "load_train_state",
    "save_reference_pth",
    "save_train_state",
    "global_norm_clip",
    "make_train_step",
    "rp_augment",
]
