"""BERT WordPiece tokenization: a numpy-only copy of ``rgqa_tpu/data/tokenizer.py``.

The module itself needs no jax, but importing it from the JAX package runs
``rgqa_tpu/data/__init__.py``, which imports the batching code and with it
``rgqa_tpu.parallel`` (jax) and ``data/dataset.py`` (flax, through
``models.uniter``).  The port runs where jax is absent, so it carries
this copy; ``tests/test_torch_data.py`` holds it to the original.
Left out: ``build_vocab`` (a vocab from a corpus) and id-to-token
lookup.  Sentence pairs (the caption matcher's ``[CLS] caption [SEP]
question [SEP]``) encode as in the original.

Basic tokenization + greedy longest-match-first WordPiece, matching the
reference's vendored tokenizer: lower-casing with accent stripping,
punctuation splitting, CJK isolation, ``##`` continuation pieces.
Questions are tokenized once at dataset-encode time into fixed-shape
arrays.
"""

from __future__ import annotations

import unicodedata
from typing import Iterable, Sequence

import numpy as np

__all__ = ["WordPieceTokenizer", "BasicTokenizer", "load_vocab"]

CLS, SEP, PAD, UNK, MASK = "[CLS]", "[SEP]", "[PAD]", "[UNK]", "[MASK]"


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in "\t\n\r":
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII ranges BERT treats as punctuation even when Unicode does not
    # (e.g. '$', '`', '~').
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


class BasicTokenizer:
    """Whitespace/punctuation/CJK splitting with optional lower-casing."""

    def __init__(self, do_lower_case: bool = True):
        self.do_lower_case = do_lower_case

    def tokenize(self, text: str) -> list[str]:
        text = self._clean(text)
        tokens: list[str] = []
        for word in text.split():
            if self.do_lower_case:
                word = self._strip_accents(word.lower())
            tokens.extend(self._split_punct(word))
        return tokens

    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            if _is_cjk(cp):
                out.append(f" {ch} ")
            elif _is_whitespace(ch):
                out.append(" ")
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(word: str) -> str:
        return "".join(
            ch
            for ch in unicodedata.normalize("NFD", word)
            if unicodedata.category(ch) != "Mn"
        )

    @staticmethod
    def _split_punct(word: str) -> list[str]:
        pieces: list[str] = []
        current: list[str] = []
        for ch in word:
            if _is_punctuation(ch):
                if current:
                    pieces.append("".join(current))
                    current = []
                pieces.append(ch)
            else:
                current.append(ch)
        if current:
            pieces.append("".join(current))
        return pieces


class WordPieceTokenizer:
    """Vocab-driven WordPiece with fixed-shape array encoding.

    ``encode_batch`` produces ``(input_ids, input_mask, segment_ids)`` int32
    arrays padded to ``max_len``, the fixed-shape input the model takes.
    """

    def __init__(
        self,
        vocab: dict[str, int] | str,
        do_lower_case: bool = True,
        max_chars_per_word: int = 100,
    ):
        if isinstance(vocab, str):
            vocab = load_vocab(vocab)
        self.vocab = dict(vocab)
        self.basic = BasicTokenizer(do_lower_case)
        self.max_chars_per_word = max_chars_per_word
        for tok in (CLS, SEP, PAD, UNK):
            if tok not in self.vocab:
                raise ValueError(f"vocab missing required token {tok!r}")
        self.pad_id = self.vocab[PAD]
        self.cls_id = self.vocab[CLS]
        self.sep_id = self.vocab[SEP]
        self.unk_id = self.vocab[UNK]

    # -- core ---------------------------------------------------------------

    def wordpiece(self, word: str) -> list[str]:
        """Greedy longest-match-first split of one basic token."""
        if len(word) > self.max_chars_per_word:
            return [UNK]
        pieces: list[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                candidate = word[start:end]
                if start > 0:
                    candidate = "##" + candidate
                if candidate in self.vocab:
                    piece = candidate
                    break
                end -= 1
            if piece is None:
                return [UNK]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> list[str]:
        out: list[str] = []
        for word in self.basic.tokenize(text):
            out.extend(self.wordpiece(word))
        return out

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> list[int]:
        return [self.vocab.get(t, self.unk_id) for t in tokens]

    # -- model-facing encoding ----------------------------------------------

    def encode(
        self, text: str, max_len: int, text_pair: str | None = None
    ) -> tuple[list[int], list[int], list[int]]:
        """``[CLS] a [SEP]`` (or ``[CLS] a [SEP] b [SEP]``) with padding.

        The first segment alone is truncated to ``max_len - 2`` pieces
        (the reference's convention, ``src/lxrt/entry.py:36-71``); a pair
        is truncated longest-first to ``max_len - 3`` pieces, popping from
        the end of the longer segment (of ``a`` on a tie), and its second
        segment with its closing ``[SEP]`` takes segment id 1.
        """
        a = self.tokenize(text)
        if text_pair is None:
            a = a[: max_len - 2]
            tokens = [CLS] + a + [SEP]
            segments = [0] * len(tokens)
        else:
            b = self.tokenize(text_pair)
            budget = max_len - 3
            # Longest-first truncation (BERT pair convention).
            while len(a) + len(b) > budget:
                (a if len(a) >= len(b) else b).pop()
            tokens = [CLS] + a + [SEP] + b + [SEP]
            segments = [0] * (len(a) + 2) + [1] * (len(b) + 1)
        ids = self.convert_tokens_to_ids(tokens)
        mask = [1] * len(ids)
        pad = max_len - len(ids)
        return ids + [self.pad_id] * pad, mask + [0] * pad, segments + [0] * pad

    def encode_batch(
        self,
        texts: Iterable[str],
        max_len: int,
        text_pairs: Iterable[str] | None = None,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        texts = list(texts)
        pairs = list(text_pairs) if text_pairs is not None else [None] * len(texts)
        n = len(texts)
        ids = np.zeros((n, max_len), dtype=np.int32)
        mask = np.zeros((n, max_len), dtype=np.int32)
        seg = np.zeros((n, max_len), dtype=np.int32)
        for i, (t, p) in enumerate(zip(texts, pairs)):
            ids[i], mask[i], seg[i] = self.encode(t, max_len, p)
        return ids, mask, seg


def load_vocab(path: str) -> dict[str, int]:
    """Load a one-token-per-line vocab file (BERT ``vocab.txt`` format)."""
    vocab: dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            tok = line.rstrip("\n")
            if tok:
                vocab[tok] = i
    return vocab

