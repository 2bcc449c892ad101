"""Parsers for external scoring artifacts (the port's own copy of
``mlvae_tpu/data/parsers.py``).

``parse_filt_prf``: NIST sclite ``.filt.prf`` alignment files -> DNN-HMM
result JSON (reference ``utils/parsers/parse_filt_prf.py``: keep
File/REF/HYP/H_T1/H_T2 rows, drop insertions, deletions inherit the
previous segment's span).  Two deliberate fixes over the reference:

* an inserted HYP token HAS an H_T1/H_T2 slot (it is a hypothesis word);
  the reference skips insertions without consuming the slot, shifting
  every later segment's timestamps onto the previous token's span;
* sclite wraps long alignments into continuation REF/HYP/H_T1/H_T2 groups
  without a File row; the reference's fixed 5-row blocking either trips
  its assert or silently mis-assigns utterance ids.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

VALID_PREFIXES = ["File", "REF:", "HYP:", "H_T1", "H_T2"]


def parse_filt_prf(file_path, output_path=None,
                   header_lines: int = 25) -> Dict[str, List]:
    file_path = Path(file_path)
    if not file_path.exists():
        raise FileNotFoundError(f"file not found: {file_path.absolute()}")

    with open(file_path) as f:
        lines = f.readlines()[header_lines:]
    # sequential walk: a File row starts a new utterance; REF/HYP/H_T1/H_T2
    # rows (including sclite's width-wrap continuation groups) accumulate
    # onto the current utterance
    utts: List[Dict[str, List[str]]] = []
    for line in lines:
        prefix = line[:4]
        if prefix not in VALID_PREFIXES:
            continue
        cells = line.split()[1:]
        if prefix == "File":
            utts.append({"id": cells[0], "REF:": [], "HYP:": [],
                         "H_T1": [], "H_T2": []})
        elif utts:
            utts[-1][prefix].extend(cells)

    parsed: Dict[str, List] = {}
    for utt in utts:
        if len(utt["REF:"]) != len(utt["HYP:"]):
            raise ValueError(
                f"{file_path}: REF/HYP length mismatch for {utt['id']}")
        result = []
        j = 0
        for gt_phn, pred_phn in zip(utt["REF:"], utt["HYP:"]):
            if "*" in gt_phn:  # insertion: ignore, but CONSUME its slot
                j += 1
                continue
            if "*" in pred_phn:  # deletion: inherit the previous span
                if result:
                    start, end, _ = result[-1]
                else:
                    start = end = 0.0
            else:
                start, end = float(utt["H_T1"][j]), float(utt["H_T2"][j])
                j += 1
            result.append([float(start), float(end), pred_phn.lower()])
        parsed[utt["id"]] = result

    if output_path is not None:
        output_path = Path(output_path)
        output_path.parent.mkdir(parents=True, exist_ok=True)
        with open(output_path, "w") as f:
            json.dump(parsed, f, indent=4)
    return parsed
