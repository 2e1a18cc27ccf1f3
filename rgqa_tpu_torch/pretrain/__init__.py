"""Pretraining pieces the fine-tune needs (port of ``rgqa_tpu/pretrain``):
the answer table that ``--loadLXMERTQA`` matches answers through."""

from rgqa_tpu_torch.pretrain.answer_table import ANS_CONVERT, AnswerTable

__all__ = ["ANS_CONVERT", "AnswerTable"]
