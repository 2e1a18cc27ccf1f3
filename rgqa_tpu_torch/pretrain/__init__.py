"""LXMERT pretraining (port of ``rgqa_tpu/pretrain``): the host-drawn
masking, the multi-task losses and the answer table that
``--loadLXMERTQA`` matches answers through.  The trainer
(``PretrainRunner``, ``make_pretrain_step``) is
:mod:`rgqa_tpu_torch.pretrain.trainer`, imported on its own: it builds on
the GQA runner, which imports this package."""

from rgqa_tpu_torch.pretrain.answer_table import ANS_CONVERT, AnswerTable
from rgqa_tpu_torch.pretrain.losses import VISUAL_LOSS_CONFIG, pretrain_loss
from rgqa_tpu_torch.pretrain.masking import draw_pretrain_masks, mask_objects, mask_words, matched_swap

__all__ = ["ANS_CONVERT", "AnswerTable", "VISUAL_LOSS_CONFIG", "pretrain_loss", "draw_pretrain_masks",
           "mask_objects", "mask_words", "matched_swap"]
