"""Tokenization and vocabulary construction.

The port's own copy of `reviews4rec_tpu/data/tokenizer.py`, with the
same semantics: lowercase, letter runs only (digits and punctuation
split words and vanish), ids assigned in first-appearance order
starting at 1, and a frequency cap where only words at least as
frequent as the (cap+1)-th most frequent word survive; everything else
maps to UNK (id 0).
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Tuple

_TOKEN = re.compile(r"[a-z]+")


def tokenize(text: str) -> List[str]:
    """"I LOVED it! Don't you?" -> [i, loved, it, don, t, you].
    Letters only: "win 100 now" -> [win, now]."""
    return _TOKEN.findall(text.lower())


def build_vocab(token_lists: Iterable[List[str]],
                cap: int = 50000) -> Tuple[Dict[str, int], int]:
    """Return (word -> id map incl. UNK=0 entries, number of kept words).

    Ids are assigned in first-appearance order starting at 1. The
    survival threshold is the count at descending-sorted index
    `min(total - 1, cap)`, the (cap+1)-th most frequent word; when the
    vocabulary fits the cap, the threshold is the minimum count and
    every word survives.
    """
    token_lists = list(token_lists)
    freq: Dict[str, int] = {}
    for lst in token_lists:
        for w in lst:
            freq[w] = freq.get(w, 0) + 1

    if freq:
        thresh = sorted(freq.values(), reverse=True)[min(len(freq) - 1, cap)]
    else:
        thresh = 0

    word_map: Dict[str, int] = {}
    next_id = 1
    for lst in token_lists:
        for w in lst:
            if w in word_map:
                continue
            if freq[w] >= thresh:
                word_map[w] = next_id
                next_id += 1
            else:
                word_map[w] = 0
    return word_map, next_id - 1
