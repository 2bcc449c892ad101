"""Frame-level mispronunciation-detection scoring (the part of
``mlvae_tpu/metrics/md.py`` that LSTM_FC's metric keys ``flvl_md.ACC``,
``PRE``, ``REC`` and ``F1`` need: ``binary_seq_md_scoring`` and
``MDMetricStats`` over predicted and reference label sequences).

It keeps the reference's INVERTED counting convention: TP counts matching
zeros (correct pronunciations), while PRE, REC and F1 are computed over the
ones (mispronunciations, counted as TN, FN and FP in that scheme). F1 is
recomputed from the MEAN precision and recall at summarize time. The
boundary, soft and PER scores, the saved sequences and the results-table
writer stay with the JAX package until a recipe of the port needs them.
Host-side numpy.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from mlvae_tpu_torch.metrics.base import BaseMetricStats

EPS = 1e-6


def _to_binary_array(x, name="input"):
    x = np.atleast_1d(np.asarray(x).astype(np.int64).squeeze())
    if x.ndim > 1:
        raise ValueError(f"{name}: only one-dimension input is allowed")
    if not np.all((x == 0) | (x == 1)):
        raise ValueError(f"{name}: only binary input values are supported")
    return x


def binary_seq_md_scoring(prediction, target) -> Dict[str, float]:
    prediction = _to_binary_array(prediction, "prediction")
    target = _to_binary_array(target, "target")
    if len(prediction) != len(target):
        raise ValueError(
            f"Inconsistent lengths: {len(prediction)} != {len(target)}")
    # the reference's inverted convention: TP = matching zeros, TN =
    # matching ones
    TP = float(np.sum((1 - prediction) * (1 - target)))
    TN = float(np.sum(prediction * target))
    FP = float(np.sum((1 - prediction) * target))
    FN = float(np.sum(prediction * (1 - target)))
    ACC = (TP + TN) / (TP + TN + FP + FN + EPS) * 100
    PRE = TN / (TN + FN + EPS) * 100
    REC = TN / (TN + FP + EPS) * 100
    F1 = 2 * PRE * REC / (PRE + REC + EPS)
    return {"ACC": ACC, "PRE": PRE, "REC": REC, "F1": F1}


def batch_seq_md_scoring(pred_md_lbl_seqs, gt_md_lbl_seqs):
    """Per-utterance scores of a batch (the JAX ``batch_seq_md_scoring``
    given both label sequences)."""
    if len(pred_md_lbl_seqs) != len(gt_md_lbl_seqs):
        raise ValueError("Inconsistent batch size")
    return [binary_seq_md_scoring(p, g)
            for p, g in zip(pred_md_lbl_seqs, gt_md_lbl_seqs)]


class MDMetricStats(BaseMetricStats):
    def __init__(self):
        super().__init__(metric_fn=batch_seq_md_scoring)

    def summarize(self, field: Optional[str] = None):
        means = super().summarize()
        # F1 from the mean PRE and REC, as the reference summarizes
        means["F1"] = (2 * means["PRE"] * means["REC"]) / (
            means["PRE"] + means["REC"] + EPS)
        means = {k: round(v, 2) for k, v in means.items()}
        return means if field is None else means[field]
