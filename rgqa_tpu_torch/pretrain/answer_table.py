"""Answer vocabulary table with string normalization (a copy of the JAX
package's ``rgqa_tpu/pretrain/answer_table.py``, held to it by
``tests/test_torch_port_rules.py``).

Behavioral rebuild of the reference ``AnswerTable``
(``src/pretrain/qa_answer_table.py:8-80``): normalizes answer strings
(lowercase, strip trailing '.', strip leading articles, number-word and
spelling conversions) and maps them into the pretraining answer id space.
``--loadLXMERTQA`` matches the GQA answers to the 9500 pretraining
answers through :meth:`AnswerTable.convert_ans`.

The reference loads ``data/lxmert/all_ans.json`` (rows
``{"ans": str, "dsets": [..]}``); here the answer list is injectable so
synthetic settings work without the download.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Optional

__all__ = ["AnswerTable", "ANS_CONVERT"]

ANS_CONVERT = {
    "a man": "man",
    "the man": "man",
    "a woman": "woman",
    "the woman": "woman",
    "one": "1",
    "two": "2",
    "three": "3",
    "four": "4",
    "five": "5",
    "six": "6",
    "seven": "7",
    "eight": "8",
    "nine": "9",
    "ten": "10",
    "grey": "gray",
}


class AnswerTable:
    def __init__(
        self,
        dsets: Optional[Iterable[str]] = None,
        *,
        path: str = "data/lxmert/all_ans.json",
        answers: Optional[list[str]] = None,
    ):
        if answers is not None:
            self.anss = list(answers)
        else:
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"{path} not found; pass answers=[...] explicitly"
                )
            with open(path) as f:
                all_ans = json.load(f)
            if dsets is not None:
                dsets = set(dsets)
                self.anss = [
                    a["ans"] for a in all_ans if set(a["dsets"]) & dsets
                ]
            else:
                self.anss = [a["ans"] for a in all_ans]
        self.ans_set = set(self.anss)
        self._ans2id = {ans: i for i, ans in enumerate(self.anss)}

    @staticmethod
    def convert_ans(ans: str) -> str:
        if not ans:
            return ""
        ans = ans.lower()
        if ans.endswith("."):
            ans = ans[:-1].strip()
        for article in ("a ", "an ", "the "):
            if ans.startswith(article):
                ans = ans[len(article):].strip()
                break
        return ANS_CONVERT.get(ans, ans)

    def ans2id(self, ans: str) -> int:
        return self._ans2id[ans]

    def id2ans(self, ans_id: int) -> str:
        return self.anss[ans_id]

    def ans2id_map(self) -> dict[str, int]:
        return dict(self._ans2id)

    def used(self, ans: str) -> bool:
        return ans in self.ans_set

    def all_answers(self) -> list[str]:
        return list(self.anss)

    @property
    def num_answers(self) -> int:
        return len(self.anss)
