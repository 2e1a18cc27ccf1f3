"""CLIP byte-level BPE tokenizer: a copy of ``rgqa_tpu/data/clip_tokenizer.py``.

The original needs only numpy, but importing it from the JAX package runs
``rgqa_tpu/data/__init__.py``, which imports jax and flax.  The port runs
where they are absent, so it carries this copy; ``tests/test_torch_clip.py``
holds it to the original.

The contract (the reference tokenizes through HF ``CLIPProcessor``,
``src/tasks/gqa_clip.py:76-110``), over a local checkpoint directory's
``vocab.json`` + ``merges.txt``:

- byte-to-unicode remapping (the public GPT-2/CLIP scheme) so BPE runs on
  printable symbols;
- word-level BPE with an ``</w>`` end-of-word marker and ranked merges;
- the CLIP pre-tokenization regex (contractions, letter runs, single
  digits, punctuation runs) over lowercased, whitespace-cleaned text;
- encodes to fixed-length ``(ids, attention_mask)`` arrays:
  ``<|startoftext|> tokens <|endoftext|>`` padded with the EOT id (HF's
  pad hack), truncated to ``max_len``.
"""

from __future__ import annotations

import functools
import json
import os
import unicodedata
from typing import Optional, Sequence

import numpy as np

__all__ = ["ClipBPETokenizer", "bytes_to_unicode"]


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """Reversible byte -> printable-unicode table (GPT-2/CLIP scheme):
    printable latin bytes map to themselves, the rest to 256+n."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _get_pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return set(zip(word[:-1], word[1:]))


# CLIP's pre-tokenization pattern.  The ``regex`` module (a transformers
# dependency) supports the \p{L}/\p{N} classes; where it is absent, plain
# ``re`` falls back to ASCII-equivalent classes (GQA is English).
try:
    import regex as _re

    _PAT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>"""
        r"""|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _re.IGNORECASE,
    )
except ImportError:  # pragma: no cover - regex ships with transformers
    import re as _re

    # NOTE '_' is \w in plain re but belongs to the punctuation class
    # [^\s\p{L}\p{N}] in the real pattern — keep it there explicitly,
    # or 'img_1'-style strings drop the underscore.
    _PAT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>"""
        r"""|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|(?:[^\s\w]|_)+""",
        _re.IGNORECASE | _re.UNICODE,
    )

BOT = "<|startoftext|>"
EOT = "<|endoftext|>"


def _clean(text: str) -> str:
    """Lowercase + whitespace-collapse + control-char strip (the HF
    tokenizer's BasicTokenizer/ftfy cleanup reduced to what matters for
    GQA questions; NFC for combining sequences)."""
    text = unicodedata.normalize("NFC", text)
    text = "".join(
        ch
        for ch in text
        if ch in ("\t", "\n", "\r")
        or (ord(ch) != 0 and ord(ch) != 0xFFFD and not unicodedata.category(ch).startswith("C"))
    )
    return " ".join(text.split()).lower()


class ClipBPETokenizer:
    """Encode-to-arrays CLIP tokenizer over a local vocab.json/merges.txt."""

    def __init__(self, vocab: dict[str, int], merges: Sequence[tuple[str, str]]):
        self.encoder = dict(vocab)
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.bot_id = self.encoder[BOT]
        self.eot_id = self.encoder[EOT]
        self.unk_id = self.eot_id  # HF CLIPTokenizer's unk == eos
        self._cache: dict[str, str] = {BOT: BOT, EOT: EOT}

    @classmethod
    def from_dir(cls, path: str) -> "ClipBPETokenizer":
        """Load from an HF checkpoint dir (vocab.json + merges.txt;
        merges.txt's first line is a version header)."""
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            lines = f.read().strip().split("\n")
        merges = [
            tuple(line.split()) for line in lines[1:] if len(line.split()) == 2
        ]
        return cls(vocab, merges)

    def bpe(self, token: str) -> str:
        """Ranked-merge BPE of one pre-token (already byte-remapped)."""
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word: tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)
        if len(word) == 1:
            self._cache[token] = word[0]
            return word[0]
        pairs = _get_pairs(word)
        while True:
            bigram = min(
                pairs, key=lambda p: self.bpe_ranks.get(p, float("inf"))
            )
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (
                    word[i] == first
                    and i < len(word) - 1
                    and word[i + 1] == second
                ):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def tokenize(self, text: str) -> list[str]:
        out: list[str] = []
        for tok in _PAT.findall(_clean(text)):
            mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            out.extend(self.bpe(mapped).split(" "))
        return out

    def token_ids(self, text: str) -> list[int]:
        return [
            self.encoder.get(t, self.unk_id) for t in self.tokenize(text)
        ]

    def encode(
        self, text: str, max_len: int = 77
    ) -> tuple[np.ndarray, np.ndarray]:
        """One text -> (ids, mask) int32 arrays of length ``max_len``:
        BOT + tokens + EOT, truncated like HF (tokens cut to fit both
        specials), padded with the EOT id, mask 1 on real positions."""
        ids = self.token_ids(text)[: max_len - 2]
        ids = [self.bot_id, *ids, self.eot_id]
        mask = np.zeros(max_len, np.int32)
        mask[: len(ids)] = 1
        ids = ids + [self.eot_id] * (max_len - len(ids))
        return np.asarray(ids, np.int32), mask

    def encode_batch(
        self, texts: Sequence[str], max_len: Optional[int] = 77
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batch encode to (B, max_len) arrays."""
        pairs = [self.encode(t, max_len) for t in texts]
        return (
            np.stack([p[0] for p in pairs]),
            np.stack([p[1] for p in pairs]),
        )
