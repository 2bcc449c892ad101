"""Boundary detection scoring: interval-matched precision/recall/F1 and
R-value (the port's own copy of ``mlvae_tpu/metrics/boundary.py``).
Host-side numpy."""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from mlvae_tpu_torch.metrics.base import BaseMetricStats

EPS = 1e-6


def boundary_scoring(prediction, target) -> Dict[str, float]:
    prediction = np.asarray(prediction)
    target = np.asarray(target)
    if prediction.ndim != 1 or target.ndim != 1:
        raise ValueError("only one-dimensional inputs are supported")
    if len(prediction) != len(target):
        raise ValueError("inconsistent input lengths")

    pred_idx = np.where(prediction == 1)[0]
    tgt_idx = np.where(target == 1)[0].tolist() + [len(target)]
    intervals = [(tgt_idx[i - 1], tgt_idx[i]) for i in range(1, len(tgt_idx))]

    # two-pointer interval matching: each target interval can absorb one
    # predicted boundary falling inside it
    pi = ti = correct = 0
    while ti < len(intervals) and pi < len(pred_idx):
        left, right = intervals[ti]
        b = pred_idx[pi]
        if b < left:
            pi += 1
        elif left <= b <= right:
            ti += 1
            pi += 1
            correct += 1
        else:
            ti += 1

    pre = correct / (float(prediction.sum()) + EPS) * 100
    rec = correct / (float(target.sum()) + EPS) * 100
    f1 = 2 * pre * rec / (pre + rec + EPS)
    os_ = pre / (rec + EPS) - 1
    r1 = np.sqrt((100 - rec) ** 2 + os_ ** 2)
    r2 = np.abs(rec - os_ - 100) / np.sqrt(2)
    r_value = (1 - (r1 + r2) / 200) * 100
    return {"pre": pre, "rec": rec, "f1": f1, "r_value": float(r_value)}


def batch_boundary_scoring(predictions: List, targets: List):
    if not isinstance(predictions, list) or not isinstance(targets, list):
        raise TypeError("inputs must be lists")
    if len(predictions) != len(targets):
        raise ValueError("Inconsistent batch size")
    return [boundary_scoring(p, t) for p, t in zip(predictions, targets)]


class BoundaryMetricStats(BaseMetricStats):
    def __init__(self):
        super().__init__(metric_fn=batch_boundary_scoring)

    def summarize(self, field: Optional[str] = None):
        means = {k: round(v, 2) for k, v in super().summarize().items()}
        return means if field is None else means[field]
