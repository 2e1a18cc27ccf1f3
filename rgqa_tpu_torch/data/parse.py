"""Constituency-parse utilities for TreeMix: a copy of
``rgqa_tpu/data/parse.py`` (numpy only; ``rgqa_tpu.data``'s ``__init__``
imports jax, so the port keeps its own).

The reference ships PTB-style parse strings with the data and rebuilds
``nltk.Tree`` objects per batch on the host (``src/tasks/gqa_mixup_both.py:
47-77``, the ``parse`` passthrough in ``src/tasks/gqa_data.py:203-228``).
Here the trees are parsed once at encode time into fixed-shape candidate
spans in wordpiece coordinates, so the splice runs on the device inside
the train step (``rgqa_tpu_torch.train.step.treemix_apply``).  No nltk:
PTB parse strings are plain s-expressions.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = [
    "parse_tree",
    "tree_leaves",
    "subtree_spans",
    "encode_parse_spans",
    "MAX_PARSE_SPANS",
]

MAX_PARSE_SPANS = 12


def parse_tree(s: str):
    """Parse a PTB-style constituency string into nested
    ``(label, children)`` tuples; leaves are plain strings.

    Equivalent to ``nltk.Tree.fromstring`` for the well-formed parses the
    reference data carries (``gqa_mixup_both.py:53``).
    """
    tokens = s.replace("(", " ( ").replace(")", " ) ").split()
    pos = 0

    def read():
        nonlocal pos
        if tokens[pos] != "(":
            word = tokens[pos]
            pos += 1
            return word
        pos += 1  # '('
        label = tokens[pos]
        pos += 1
        children = []
        while tokens[pos] != ")":
            children.append(read())
        pos += 1  # ')'
        return (label, children)

    tree = read()
    if pos != len(tokens):
        raise ValueError(f"trailing tokens in parse: {s!r}")
    return tree


def tree_leaves(tree) -> list[str]:
    if isinstance(tree, str):
        return [tree]
    out: list[str] = []
    for child in tree[1]:
        out.extend(tree_leaves(child))
    return out


def subtree_spans(tree) -> list[tuple[int, int]]:
    """(word_start, word_end) for every internal subtree, in the same
    iteration order as ``nltk.Tree.subtrees`` (pre-order)."""
    spans: list[tuple[int, int]] = []

    def walk(node, start: int) -> int:
        if isinstance(node, str):
            return start + 1
        end = start
        for child in node[1]:
            end = walk(child, end)
        spans.append((start, end))
        return end

    walk(tree, 0)
    # Pre-order like nltk (parents before children): walk() appends
    # post-order, so flip.
    return spans[::-1]


def encode_parse_spans(
    parses: Sequence[Optional[str]],
    sents: Sequence[str],
    tokenizer,
    max_text_len: int,
    *,
    max_spans: int = MAX_PARSE_SPANS,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Precompute TreeMix candidate spans in wordpiece coordinates.

    Returns ``(spans, span_words, n_words)``:

    - ``spans`` (N, K, 2) int32: [start, end) positions **in the encoded
      sequence** (i.e. offset +1 for [CLS]); -1 padding;
    - ``span_words`` (N, K) int32: subtree width in words (the reference's
      ratio filter operates on word counts, ``gqa_mixup_both.py:58-61``);
    - ``n_words`` (N,) int32: sentence length in words; 0 marks rows with
      no usable parse (the train step falls back to random windows).

    A parse is usable only when the concatenation of its leaves'
    wordpieces equals the sentence's own tokenization (so span
    coordinates are exact) and every span fits inside ``max_text_len``
    after the [CLS]/[SEP] budget.
    """
    n = len(parses)
    spans = np.full((n, max_spans, 2), -1, np.int32)
    span_words = np.zeros((n, max_spans), np.int32)
    n_words = np.zeros((n,), np.int32)
    budget = max_text_len - 2

    for i, (parse, sent) in enumerate(zip(parses, sents)):
        if not parse:
            continue
        try:
            tree = parse_tree(parse)
        except (ValueError, IndexError):
            continue
        words = tree_leaves(tree)
        # Per-word wordpiece offsets.  The basic tokenizer may split a
        # leaf further (punctuation); count pieces per leaf.
        piece_counts = []
        pieces_flat: list[str] = []
        for w in words:
            p = tokenizer.tokenize(w)
            piece_counts.append(len(p))
            pieces_flat.extend(p)
        if pieces_flat != tokenizer.tokenize(sent)[:budget]:
            continue  # coordinates would be inexact -> fallback row
        offsets = np.zeros(len(words) + 1, np.int64)
        np.cumsum(piece_counts, out=offsets[1:])
        k = 0
        for ws, we in subtree_spans(tree):
            if k >= max_spans:
                break
            s, e = int(offsets[ws]), int(offsets[we])
            if e <= s or e > budget:
                continue
            spans[i, k] = (1 + s, 1 + e)  # +1 for [CLS]
            span_words[i, k] = we - ws
            k += 1
        if k:
            n_words[i] = len(words)
    return spans, span_words, n_words
