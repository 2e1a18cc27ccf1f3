"""The Porter stemmer as NLTK's ``PorterStemmer()`` runs it, in its default
``NLTK_EXTENSIONS`` mode, with the standard library alone (the machine
with the card has no nltk).

Martin Porter's algorithm (1980): steps 1a-5 strip suffixes whose stem's
*measure* m (the number of vowel-consonant runs, ``[C](VC)^m[V]``)
passes each rule's condition; in every step the first listed suffix
that the word ends with decides, and a failed condition ends the step.
NLTK's mode adds, as its behaviour shows:

- the word is lower-cased; a small pool of irregular forms (``skies`` ->
  ``sky``, ``dying`` -> ``die``, ...) is looked up first; words of one
  or two letters are returned as they are;
- step 1a: a four-letter ``-ies`` word keeps ``ie`` (``dies`` -> ``die``);
- step 1b: ``-ied`` becomes ``ie`` in a four-letter word, else ``i``,
  before any other rule;
- step 1c: ``y`` -> ``i`` only after a consonant that is not the word's
  first letter (``happy`` -> ``happi``, ``enjoy`` and ``by`` stay);
- step 2: ``-alli`` -> ``al`` first, then step 2 again; ``-bli`` ->
  ``ble`` (not the paper's ``-abli``); ``-fulli`` -> ``ful``; ``-logi``
  -> ``log`` when the stem with its ``l`` has m > 0;
- the *o condition (consonant-vowel-consonant, the last not w, x or y)
  also holds for a two-letter stem of a vowel then a consonant.

Every character but a, e, i, o, u and y is a consonant, spaces and
hyphens included, so a multi-word name such as ``"tennis racket"`` is
stemmed as one string, as NLTK does.  ``tests/test_torch_coverage.py``
holds :func:`stem` to ``nltk.stem.PorterStemmer().stem`` on a word list
and on random strings.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

__all__ = ["stem"]

_VOWELS = frozenset("aeiou")

# The irregular forms, each with the stem it maps to.
_IRREGULAR = {
    "sky": "sky", "skies": "sky", "dying": "die", "lying": "lie", "tying": "tie", "news": "news",
    "innings": "inning", "inning": "inning", "outings": "outing", "outing": "outing",
    "cannings": "canning", "canning": "canning", "howe": "howe", "proceed": "proceed",
    "exceed": "exceed", "succeed": "succeed",
}


def _kinds(word: str) -> str:
    """'c' or 'v' for each letter: y is a vowel after a consonant."""
    out = []
    for i, ch in enumerate(word):
        if ch in _VOWELS:
            out.append("v")
        elif ch == "y":
            out.append("v" if i > 0 and out[i - 1] == "c" else "c")
        else:
            out.append("c")
    return "".join(out)


def _measure(word: str) -> int:
    return _kinds(word).count("vc")


def _has_vowel(word: str) -> bool:
    return "v" in _kinds(word)


def _double_consonant(word: str) -> bool:
    return len(word) >= 2 and word[-1] == word[-2] and _kinds(word)[-1] == "c"


def _star_o(word: str) -> bool:
    """*o: ends consonant-vowel-consonant, the last not w, x or y; or is
    a vowel then a consonant."""
    kinds = _kinds(word)
    if len(word) >= 3 and kinds[-3:] == "cvc" and word[-1] not in "wxy":
        return True
    return len(word) == 2 and kinds == "vc"


Rule = tuple[str, str, Optional[Callable[[str], bool]]]


def _first_rule(word: str, rules: Sequence[Rule]) -> str:
    """The first rule whose suffix ends ``word`` decides: its replacement
    when its condition holds on the stem, else ``word`` unchanged.  The
    suffix ``"*d"`` matches a double consonant and strips both letters."""
    for suffix, replacement, condition in rules:
        if suffix == "*d":
            if not _double_consonant(word):
                continue
            stem_ = word[:-2]
        elif word.endswith(suffix):
            stem_ = word[: len(word) - len(suffix)]
        else:
            continue
        return stem_ + replacement if condition is None or condition(stem_) else word
    return word


def _m_positive(stem_: str) -> bool:
    return _measure(stem_) > 0


def _m_above_1(stem_: str) -> bool:
    return _measure(stem_) > 1


def _step1a(word: str) -> str:
    if len(word) == 4 and word.endswith("ies"):
        return word[:-1]
    return _first_rule(word, [("sses", "ss", None), ("ies", "i", None), ("ss", "ss", None), ("s", "", None)])


def _step1b(word: str) -> str:
    if word.endswith("ied"):
        return word[:-3] + ("ie" if len(word) == 4 else "i")
    if word.endswith("eed"):
        return word[:-1] if _m_positive(word[:-3]) else word
    for suffix in ("ed", "ing"):
        if word.endswith(suffix) and _has_vowel(word[: -len(suffix)]):
            base = word[: -len(suffix)]
            break
    else:
        return word
    return _first_rule(base, [
        ("at", "ate", None), ("bl", "ble", None), ("iz", "ize", None),
        ("*d", base[-1], lambda _: base[-1] not in "lsz"),
        ("", "e", lambda s: _measure(s) == 1 and _star_o(s)),
    ])


def _step1c(word: str) -> str:
    return _first_rule(word, [("y", "i", lambda s: len(s) > 1 and _kinds(s)[-1] == "c")])


_STEP2 = [
    ("ational", "ate"), ("tional", "tion"), ("enci", "ence"), ("anci", "ance"), ("izer", "ize"),
    ("bli", "ble"), ("alli", "al"), ("entli", "ent"), ("eli", "e"), ("ousli", "ous"),
    ("ization", "ize"), ("ation", "ate"), ("ator", "ate"), ("alism", "al"), ("iveness", "ive"),
    ("fulness", "ful"), ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"), ("biliti", "ble"),
    ("fulli", "ful"),
]


def _step2(word: str) -> str:
    if word.endswith("alli") and _m_positive(word[:-4]):
        return _step2(word[:-2])
    rules: list[Rule] = [(suffix, rep, _m_positive) for suffix, rep in _STEP2]
    rules.append(("logi", "log", lambda _: _m_positive(word[:-3])))
    return _first_rule(word, rules)


def _step3(word: str) -> str:
    return _first_rule(word, [(suffix, rep, _m_positive) for suffix, rep in (
        ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"), ("ical", "ic"),
        ("ful", ""), ("ness", ""))])


_STEP4 = ("al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement", "ment", "ent", "ion",
          "ou", "ism", "ate", "iti", "ous", "ive", "ize")


def _step4(word: str) -> str:
    return _first_rule(word, [
        (suffix, "", (lambda s: _m_above_1(s) and s[-1:] in ("s", "t")) if suffix == "ion" else _m_above_1)
        for suffix in _STEP4
    ])


def _step5(word: str) -> str:
    if word.endswith("e"):
        base = word[:-1]
        m = _measure(base)
        if m > 1 or (m == 1 and not _star_o(base)):
            word = base
    if word.endswith("ll") and _measure(word[:-1]) > 1:
        word = word[:-1]
    return word


def stem(word: str) -> str:
    """``word``'s Porter stem, as ``nltk.stem.PorterStemmer().stem(word)``."""
    lower = word.lower()
    if lower in _IRREGULAR:
        return _IRREGULAR[lower]
    if len(word) <= 2:
        return lower
    for step in (_step1a, _step1b, _step1c, _step2, _step3, _step4, _step5):
        lower = step(lower)
    return lower

