"""The Faster-RCNN object-coverage rejection scorer (port of
``rgqa_tpu/scorers/coverage.py``; host-side, no device code).

Reference ``src/tasks/gqa_fasterrcnn.py:97-126``: a question's confidence
is 1 iff every noun of it (less a stop list) stem-matches the name of an
object the detector found in its image; the answer still comes from a
VQA model.  The reference tags nouns with spacy and stems with NLTK's
``PorterStemmer``; the JAX package tags with NLTK's perceptron tagger
when its data is installed, else with a lexicon-free rule (alphabetic
tokens longer than two letters that are not function words or GQA's
closed adjective classes).  The port keeps that rule alone, and stems
with :mod:`rgqa_tpu_torch.scorers.porter`, a copy of NLTK's stemmer
behaviour: the tagger's data would need a download, and neither this
package's machines nor the card's have it.  Wherever NLTK's tagger data
is absent, the port's scores equal the JAX package's bit for bit
(``tests/test_torch_coverage.py``).
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

from rgqa_tpu_torch.scorers.porter import stem

__all__ = ["load_object_vocab", "noun_tokens", "coverage_scores", "NOUN_STOPLIST"]

NOUN_STOPLIST = {
    "left", "right", "thing", "top", "bottom", "photo", "image", "kind", "color",
}

# Function words that are never the content nouns of a GQA question.
_NON_NOUNS = {
    "a", "an", "the", "is", "are", "was", "were", "there", "this", "that",
    "these", "those", "what", "which", "who", "whom", "whose", "where",
    "when", "why", "how", "do", "does", "did", "can", "could", "on", "in",
    "at", "of", "to", "by", "with", "near", "next", "behind", "front",
    "above", "below", "under", "over", "and", "or", "not", "no", "yes",
    "any", "some", "you", "it", "its", "his", "her", "their", "same",
    "different", "both", "either", "made", "see", "seen", "have", "has",
    "think", "look", "looks", "looking", "called", "wearing", "holding",
    "sitting", "standing", "side", "part", "beside", "inside", "around",
    "out", "toward", "towards",
}

# GQA's closed adjective classes (colors / sizes / materials / common
# states).  A spacy NOUN tag would exclude these; the lexicon-free
# heuristic must too, or "blue chair" demands a detected object "blue"
# and coverage falsely rejects (measured on the golden example's real
# questions in tests/test_fidelity.py).
_COMMON_ADJECTIVES = {
    # colors
    "red", "blue", "green", "yellow", "orange", "purple", "pink", "brown",
    "black", "white", "gray", "grey", "silver", "gold", "golden", "dark",
    "light", "blond", "blonde", "beige", "tan", "cream", "maroon", "teal",
    # sizes / shapes
    "big", "small", "large", "little", "tall", "short", "long", "huge",
    "tiny", "wide", "narrow", "thick", "thin", "round", "square",
    "rectangular", "giant",
    # materials
    "wooden", "metal", "metallic", "plastic", "glass", "leather", "stone",
    "concrete", "brick", "wood", "steel", "cloth", "ceramic", "chrome",
    "cobblestone", "wicker", "porcelain", "rubber", "denim", "wool",
    # common states
    "old", "new", "young", "clean", "dirty", "empty", "full", "open",
    "closed", "wet", "dry", "bright", "shiny", "dull", "colorful", "comfy",
    "comfortable", "happy", "sad", "male", "female", "striped", "spotted",
    "parked", "modern", "electric", "electrical", "soft", "hard", "heavy",
    "fresh", "healthy", "cooked", "raw", "sliced",
}


def load_object_vocab(path: str) -> list[str]:
    """The detector's class names, stemmed (``objects_vocab.txt`` rows are
    ``name[,alias...]``; the reference keeps the first name)."""
    out = []
    with open(path) as f:
        for line in f:
            name = line.strip().split(",")[0]
            if name:
                out.append(stem(name))
    return out


def noun_tokens(sent: str) -> list[str]:
    """A question's content-noun candidates (the lexicon-free rule), stop
    list applied."""
    toks = sent.lower().replace("?", " ").replace(",", " ").split()
    nouns = [
        t for t in toks
        if t.isalpha() and t not in _NON_NOUNS and t not in _COMMON_ADJECTIVES and len(t) > 2
    ]
    return [n for n in nouns if n.lower() not in NOUN_STOPLIST]


def coverage_scores(
    sents: Sequence[str],
    objects_per_row: Sequence[Iterable[int]],
    object_vocab: Sequence[str],
) -> np.ndarray:
    """``score[i]`` = 1.0 iff every noun stem of ``sents[i]`` is among the
    stems of row i's detected objects (``gqa_fasterrcnn.py:118-126``);
    ids outside the vocabulary are ignored."""
    out = np.zeros((len(sents),), np.float32)
    for i, (sent, obj_ids) in enumerate(zip(sents, objects_per_row)):
        detected = {object_vocab[int(o)] for o in obj_ids if 0 <= int(o) < len(object_vocab)}
        out[i] = 1.0 if all(stem(tok) in detected for tok in noun_tokens(sent)) else 0.0
    return out
