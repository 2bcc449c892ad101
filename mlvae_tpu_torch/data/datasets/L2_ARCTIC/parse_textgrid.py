"""L2-ARCTIC TextGrid annotation parsing (the port's own copy of
``mlvae_tpu/data/datasets/L2_ARCTIC/parse_textgrid.py``).

The ``phones`` tier encodes "canonical,pronounced[,...]" per interval; a
single token means correct pronunciation; alphabetic symbols are extracted
from each token. Built on the port's TextGrid reader (``data/textgrid.py``).
"""
from __future__ import annotations

import re
from pathlib import Path

import logging

from mlvae_tpu_torch.data.textgrid import read_textgrid

_ALPHA = re.compile(r"[a-zA-Z]+")

logger = logging.getLogger(__name__)


def parse_textgrid(path, level: str):
    # tgt (the reference's reader) drops empty intervals by default
    tg = read_textgrid(path, include_empty_intervals=False)
    annotation = {
        "all": {
            "start_time": tg.start_time,
            "end_time": tg.end_time,
            "word": [],
            "phoneme": [],
            "canonical_phoneme": [],
        },
        "word": [],
        "phoneme": [],
        "canonical_phoneme": [],
    }

    for interval in tg.get_tier_by_name("words"):
        annotation["word"].append(interval.text)
        annotation["all"]["word"].append(
            (interval.start_time, interval.end_time, interval.text)
        )

    for interval in tg.get_tier_by_name("phones"):
        parts = interval.text.lower().split(",")
        pronounced = parts[0] if len(parts) == 1 else parts[1]
        canonical = parts[0]
        p_hit = _ALPHA.findall(pronounced)
        c_hit = _ALPHA.findall(canonical)
        if not p_hit or not c_hit:
            # deletion/addition tokens ('CPL,,d' / ',PPL,a') have an empty
            # comma slot; the reference's [0]-index crashes on them — skip
            # the interval with a warning instead of fabricating a label
            logger.warning(
                "%s: skipping phones interval with empty slot: %r",
                path, interval.text)
            continue
        pronounced = p_hit[0]
        canonical = c_hit[0]
        annotation["phoneme"].append(pronounced)
        annotation["all"]["phoneme"].append(
            (interval.start_time, interval.end_time, pronounced)
        )
        annotation["canonical_phoneme"].append(canonical)
        annotation["all"]["canonical_phoneme"].append(
            (interval.start_time, interval.end_time, canonical)
        )

    return annotation[level]
