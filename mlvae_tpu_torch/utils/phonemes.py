"""Phoneme inventories and the TIMIT 60->48->39 folding (the port's own
copy of ``mlvae_tpu/utils/phonemes.py``).

The 60/48/39 table is the standard Lee & Hon (1989) folding used by every
TIMIT recipe; each row is (timit_60, folded_48, folded_39). Plain Python.
"""
from __future__ import annotations

from pathlib import Path
from typing import List

_TIMIT_FOLDING = [
    ("aa", "aa", "aa"), ("ae", "ae", "ae"), ("ah", "ah", "ah"),
    ("ao", "ao", "aa"), ("aw", "aw", "aw"), ("ax", "ax", "ah"),
    ("ax-h", "ax", "ah"), ("axr", "er", "er"), ("ay", "ay", "ay"),
    ("b", "b", "b"), ("bcl", "vcl", "sil"), ("ch", "ch", "ch"),
    ("d", "d", "d"), ("dcl", "vcl", "sil"), ("dh", "dh", "dh"),
    ("dx", "dx", "dx"), ("eh", "eh", "eh"), ("el", "el", "l"),
    ("em", "m", "m"), ("en", "en", "n"), ("eng", "ng", "ng"),
    ("epi", "epi", "sil"), ("er", "er", "er"), ("ey", "ey", "ey"),
    ("f", "f", "f"), ("g", "g", "g"), ("gcl", "vcl", "sil"),
    ("h#", "sil", "sil"), ("hh", "hh", "hh"), ("hv", "hh", "hh"),
    ("ih", "ih", "ih"), ("ix", "ix", "ih"), ("iy", "iy", "iy"),
    ("jh", "jh", "jh"), ("k", "k", "k"), ("kcl", "cl", "sil"),
    ("l", "l", "l"), ("m", "m", "m"), ("n", "n", "n"),
    ("ng", "ng", "ng"), ("nx", "n", "n"), ("ow", "ow", "ow"),
    ("oy", "oy", "oy"), ("p", "p", "p"), ("pau", "sil", "sil"),
    ("pcl", "cl", "sil"), ("q", "err", "err"), ("r", "r", "r"),
    ("s", "s", "s"), ("sh", "sh", "sh"), ("t", "t", "t"),
    ("tcl", "cl", "sil"), ("th", "th", "th"), ("uh", "uh", "uh"),
    ("uw", "uw", "uw"), ("ux", "uw", "uw"), ("v", "v", "v"),
    ("w", "w", "w"), ("y", "y", "y"), ("z", "z", "z"),
    ("zh", "zh", "sh"), ("spn", "err", "err"), ("nsn", "err", "err"),
    ("sp", "sil", "sil"), ("sil", "sil", "sil"),
]

MAP_TO_48 = {}
MAP_TO_39 = {}
for _p60, _p48, _p39 in _TIMIT_FOLDING:
    MAP_TO_48[_p60] = _p48
    MAP_TO_39[_p60] = _p39
    MAP_TO_39[_p48] = _p39

DIGITS = ["zero", "one", "two", "three", "four", "five", "six", "seven",
          "eight", "nine", "sil", "err"]


def get_phoneme_set(language: str = "english", n_phonemes: int = 39,
                    **kwargs) -> List[str]:
    language = language.lower()
    if language == "english":
        assert n_phonemes in (60, 48, 39)
        col = {60: 0, 48: 1, 39: 2}[n_phonemes]
        seen = []
        for row in _TIMIT_FOLDING:
            p = row[col]
            if p not in seen:
                seen.append(p)
        return seen
    if language == "digits":
        assert n_phonemes == len(DIGITS)
        return list(DIGITS)
    if language == "pinyin":
        path = Path(__file__).parent / "pinyin_dict.txt"
        with open(path) as f:
            pset = [l.rstrip() for l in f if l.strip()]
        assert n_phonemes == len(pset)
        return pset
    raise ValueError(f"unknown language: {language}")


class PhonemeSetHandler:
    """YAML-visible (``!new:utils.phonemes.PhonemeSetHandler``)."""

    def __init__(self, language: str = "english", n_phonemes: int = 39,
                 **kwargs):
        if language == "english":
            assert n_phonemes in (60, 48, 39)
        elif language == "digits":
            # the digit set is fixed at 12 (10 digits + sil + err), like
            # the reference (utils/phonemes.py:93-95)
            assert n_phonemes == len(DIGITS)
        self.language = language
        self.n_phonemes = n_phonemes
        self.phoneme_set = get_phoneme_set(language, n_phonemes, **kwargs)

    def get_phoneme_set(self):
        return self.phoneme_set

    def map_phoneme(self, p: str) -> str:
        if self.n_phonemes == 60 or p not in MAP_TO_48:
            return p
        if self.n_phonemes == 48:
            return MAP_TO_48[p]
        return MAP_TO_39[p]
