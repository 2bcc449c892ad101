"""Minimal Praat TextGrid reader and writer, long text format (the port's
own copy of ``mlvae_tpu/data/textgrid.py``).

Takes the place of the ``tgt`` package that the reference's L2-ARCTIC and
ChineseDPA preparations read TextGrids with. Supports IntervalTier items
with quoted attributes, which covers both corpora's annotation files.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple


@dataclass
class Interval:
    start_time: float
    end_time: float
    text: str


@dataclass
class Tier:
    name: str
    intervals: List[Interval] = field(default_factory=list)

    def __iter__(self):
        return iter(self.intervals)


@dataclass
class TextGrid:
    start_time: float
    end_time: float
    tiers: List[Tier] = field(default_factory=list)

    def get_tier_by_name(self, name: str) -> Tier:
        for tier in self.tiers:
            if tier.name == name:
                return tier
        raise KeyError(f"no tier named {name!r}")


_NUM_RE = re.compile(r"(xmin|xmax)\s*=\s*([-\d.eE+]+)")
_NAME_RE = re.compile(r'name\s*=\s*"((?:[^"]|"")*)"')
_TEXT_RE = re.compile(r'text\s*=\s*"((?:[^"]|"")*)"', re.S)
_ITEM_RE = re.compile(r"item\s*\[\d+\]\s*:")
_INTERVAL_RE = re.compile(r"intervals\s*\[\d+\]\s*:")


def read_textgrid(path, include_empty_intervals: bool = True) -> TextGrid:
    text = Path(path).read_text(encoding="utf-8", errors="replace")

    header_nums = _NUM_RE.findall(text[: text.find("item")])
    header = {k: float(v) for k, v in header_nums[:2]}
    tg = TextGrid(header.get("xmin", 0.0), header.get("xmax", 0.0))

    item_spans = [m.start() for m in _ITEM_RE.finditer(text)] + [len(text)]
    for i in range(len(item_spans) - 1):
        block = text[item_spans[i]: item_spans[i + 1]]
        if '"IntervalTier"' not in block:
            continue
        name_m = _NAME_RE.search(block)
        tier = Tier(name=name_m.group(1).replace('""', '"') if name_m else "")
        ivl_spans = [m.start() for m in _INTERVAL_RE.finditer(block)] + \
            [len(block)]
        for j in range(len(ivl_spans) - 1):
            chunk = block[ivl_spans[j]: ivl_spans[j + 1]]
            nums = dict(_NUM_RE.findall(chunk))
            text_m = _TEXT_RE.search(chunk)
            label = text_m.group(1).replace('""', '"') if text_m else ""
            if not include_empty_intervals and not label.strip():
                continue
            tier.intervals.append(Interval(
                float(nums.get("xmin", 0)), float(nums.get("xmax", 0)), label
            ))
        tg.tiers.append(tier)
    return tg


def write_textgrid(path, tiers: Dict[str, List[Tuple[float, float, str]]],
                   xmax: Optional[float] = None):
    """Write a long-format TextGrid (used by tests/fixtures)."""
    if xmax is None:
        xmax = max((iv[1] for t in tiers.values() for iv in t), default=0.0)
    lines = [
        'File type = "ooTextFile"',
        'Object class = "TextGrid"',
        "xmin = 0",
        f"xmax = {xmax}",
        "tiers? <exists>",
        f"size = {len(tiers)}",
        "item []:",
    ]
    for i, (name, intervals) in enumerate(tiers.items(), 1):
        lines += [
            f"    item [{i}]:",
            '        class = "IntervalTier"',
            f'        name = "{name}"',
            "        xmin = 0",
            f"        xmax = {xmax}",
            f"        intervals: size = {len(intervals)}",
        ]
        for j, (a, b, label) in enumerate(intervals, 1):
            lines += [
                f"        intervals [{j}]:",
                f"            xmin = {a}",
                f"            xmax = {b}",
                f'            text = "{label}"',
            ]
    Path(path).write_text("\n".join(lines) + "\n", encoding="utf-8")
