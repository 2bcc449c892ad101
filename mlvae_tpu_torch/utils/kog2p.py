"""Korean grapheme-to-phoneme conversion (the port's own copy of
``mlvae_tpu/utils/kog2p.py``, pure Python, with its own rulebook
``kog2p_rules.py``; the reference's dormant ``utils/KoG2P`` utility,
imported nowhere in the reference either; reference
``src/utils/KoG2P/g2p.py``).

Full-fidelity pipeline matching the reference implementation step for step
(parity-locked against its outputs in ``tests/test_kog2p_parity.py``):

1. Romanization (``_romanize``): Hangul syllables -> ``-``-prefixed phone
   runs via Unicode jamo arithmetic (U+AC00 block), ``#`` for spaces,
   everything else dropped; silent onset ``oh`` deleted and coda ``oh``
   realized as the velar nasal ``ng`` (reference ``g2p.py:128-191`` —
   including its quirk that a ``#``/space immediately after an ``oh`` coda
   is consumed by the ``oh([# ]|$) -> ng`` substitution).
2. Phone-boundary marking (``_add_boundaries``): a comma after every
   two-letter phone, ``-``/``#`` delimiters preserved (``g2p.py:203-220``).
3. The rule engine (``g2p_prono``): one pass over the rule list, then
   repeat — with the reference's exact comma<->space round-trip per
   iteration — until the hyphen-stripped string reaches a fixpoint; the
   final output drops the syllable hyphens (``g2p.py:194-200,236-276``).

The rule set (:data:`DEFAULT_RULES`) is the complete 184-rule KoG2P
rulebook, transcribed rule for rule into ``kog2p_rules.py`` (reference
``utils/KoG2P/rulebook.txt``): exception lexicon, cluster aspiration,
cluster rules, tensification, cluster simplification, nasalization,
l-resyllabification, liquidization, palatalization, simple aspiration,
liaison, and coda neutralization, in the rulebook's documented order.
:func:`read_rules` still loads any external KoG2P-format rulebook file.

Phone inventory (Korean Spontaneous Speech corpus romanization): onsets
``k0 kk nn t0 tt rr mm p0 pp s0 ss oh c0 cc ch kh th ph h0``; nuclei
``aa qq ya yq vv ee yv ye oo wa wq wo yo uu wv we wi yu xx xi ii``; codas
``kf kk ks nf nc nh tf ll lk lm lb ls lt lp lh mf pf ps s0 ss oh c0 ch
kh th ph h0`` (``oh`` -> ``ng``).
"""
from __future__ import annotations

import re
from typing import List, Sequence, Tuple

from mlvae_tpu_torch.utils.kog2p_rules import RULES as _RULEBOOK

_ONSETS = ["k0", "kk", "nn", "t0", "tt", "rr", "mm", "p0", "pp",
           "s0", "ss", "oh", "c0", "cc", "ch", "kh", "th", "ph", "h0"]
_NUCLEI = ["aa", "qq", "ya", "yq", "vv", "ee", "yv", "ye", "oo", "wa",
           "wq", "wo", "yo", "uu", "wv", "we", "wi", "yu", "xx", "xi", "ii"]
_CODAS = ["", "kf", "kk", "ks", "nf", "nc", "nh", "tf",
          "ll", "lk", "lm", "lb", "ls", "lt", "lp", "lh",
          "mf", "pf", "ps", "s0", "ss", "oh", "c0", "ch",
          "kh", "th", "ph", "h0"]

#: The complete KoG2P rulebook (see module docstring).
DEFAULT_RULES: List[Tuple[str, str]] = list(_RULEBOOK)


def decompose(text: str) -> List[List[str]]:
    """Hangul string -> per-syllable [onset, nucleus, coda] phone lists
    (coda '' when absent).  Non-Hangul characters are skipped."""
    out = []
    for ch in text:
        code = ord(ch)
        if not 0xAC00 <= code <= 0xD7A3:
            continue
        idx = code - 0xAC00
        out.append([_ONSETS[idx // 588], _NUCLEI[(idx % 588) // 28],
                    _CODAS[idx % 28]])
    return out


def _romanize(text: str) -> str:
    """Hangul -> '-'-prefixed phone runs, '#' word delimiters (reference
    ``graph2phone``, ``g2p.py:128-191``)."""
    phones = ""
    for ch in text:
        code = ord(ch)
        if 0xAC00 <= code <= 0xD7A3:
            idx = code - 0xAC00
            coda = _CODAS[idx % 28]
            phones += ("-" + _ONSETS[idx // 588]
                       + _NUCLEI[(idx % 588) // 28] + coda)
        elif ch == " ":
            phones += "#"
        # silent onset deleted as we go (reference does this in-loop too)
        phones = re.sub("-(oh)", "-", phones)
    # coda 'oh' -> velar nasal; NB the reference substitution consumes a
    # following '#'/space (no capture re-insertion), so a word boundary
    # right after an 'ng' coda disappears — kept for parity
    phones = re.sub("oh-", "ng-", phones)
    phones = re.sub("oh([# ]|$)", "ng", phones)
    # collapse delimiter runs, strip leading/trailing delimiters
    phones = re.sub(r"(\W+)-", r"\1", phones)
    phones = re.sub(r"\W+$", "", phones)
    phones = re.sub(r"^-", "", phones)
    return phones


def _add_boundaries(phones: str) -> str:
    """Comma after every two-letter phone; '-'/'#' kept (reference
    ``addPhoneBoundary``, ``g2p.py:203-220``)."""
    out = []
    i = 0
    while i + 2 <= len(phones):
        if phones[i] == "-":
            out.append("-")
            i += 1
        elif phones[i] == " ":
            i += 1
        elif phones[i] == "#":
            out.append("#")
            i += 1
        out.append(phones[i:i + 2] + ",")
        i += 2
    return "".join(out)


def graph2phone(text: str) -> str:
    """Romanize Hangul text: comma-delimited phones, '-' between
    syllables, '#' between words; silent onset dropped, coda 'oh'->'ng'."""
    return _add_boundaries(_romanize(text))


def read_rules(path: str) -> List[Tuple[str, str]]:
    """Parse a KoG2P-format rulebook: tab-separated ``pattern<TAB>
    replacement`` per line, '#'-prefixed comment lines skipped.  The
    reference's 212-line ``rulebook.txt`` loads unmodified (and equals
    :data:`DEFAULT_RULES`)."""
    rules = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            fields = line.split("\t")
            if not fields[0]:
                continue
            rules.append((fields[0], fields[1] if len(fields) > 1 else ""))
    return rules


def _apply_once(phones: str, rules: Sequence[Tuple[str, str]]) -> str:
    """One pass over the rule list (reference ``phone2prono``)."""
    for pattern, replacement in rules:
        phones = re.sub(pattern, replacement, phones)
    return phones


def apply_rules(phones: str, rules: Sequence[Tuple[str, str]],
                max_iters: int = 10) -> str:
    """Apply the rule list repeatedly until the comma-delimited string
    stops changing."""
    for _ in range(max_iters):
        prev = phones
        phones = _apply_once(phones, rules)
        if phones == prev:
            break
    return phones


def g2p_prono(text: str,
              rules: Sequence[Tuple[str, str]] | None = None) -> str:
    """Korean text -> space-separated pronunciation string, bit-identical
    to the reference ``graph2prono`` (``g2p.py:236-276``): first pass on
    the boundary-marked romanization, then iterate — re-commaifying with a
    trailing comma each round — until the hyphen-stripped string is stable;
    hyphens are dropped from the final output."""
    rules = DEFAULT_RULES if rules is None else rules
    prono = _apply_once(_add_boundaries(_romanize(text)), rules)
    prono = re.sub(",", " ", prono)
    prono = re.sub(" $", "", prono)
    prono = re.sub("#", "-", prono)
    prono = re.sub("-+", "-", prono)

    while True:
        new = _apply_once(re.sub(" ", ",", prono + ","), rules)
        new = re.sub(",", " ", new)
        new = re.sub(" $", "", new)
        if re.sub("-", "", prono) == re.sub("-", "", new):
            return re.sub("-", "", new)
        prono = new


def g2p(text: str, rulebook: str | None = None) -> List[str]:
    """Korean text -> phone list.  With ``rulebook`` (a KoG2P-format rule
    file) those rules are applied instead of the built-in full set."""
    rules = read_rules(rulebook) if rulebook else None
    return g2p_prono(text, rules).split()
