"""Phoneme classification accuracy, frame- and phoneme-level (counterpart
of ``mlvae_tpu/metrics/phn_acc.py``). Host-side numpy."""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from mlvae_tpu_torch.metrics.base import BaseMetricStats


def flvl_phn_acc_scoring(prediction, target) -> float:
    """Share (in %) of frames whose argmax over (T, N) logits is the
    (T,) target."""
    prediction = np.asarray(prediction)
    target = np.asarray(target)
    if prediction.ndim != 2 or target.ndim != 1:
        raise ValueError("prediction must be (T, N), target (T,)")
    if prediction.shape[0] != target.shape[0]:
        raise ValueError("inconsistent input lengths")
    return float((prediction.argmax(-1) == target).mean()) * 100


def plvl_phn_acc_scoring(prediction, target, boundary_seq) -> float:
    """The same per phoneme: the logits summed within each segment of
    ``boundary_seq`` (one start frame per phoneme of ``target``)."""
    boundary_seq = np.asarray(boundary_seq)
    target = np.asarray(target)
    assert boundary_seq.sum() == len(target)
    idx = np.where(boundary_seq == 1)[0].tolist() + [len(boundary_seq)]
    assert np.diff(idx).sum() == prediction.shape[0]
    plvl = np.stack([np.asarray(prediction)[idx[i]:idx[i + 1]].sum(0)
                     for i in range(len(target))])
    return flvl_phn_acc_scoring(plvl, target)


def batch_phn_acc_scoring(predictions: List, flvl_targets: List,
                          plvl_targets=None, boundary_seqs=None):
    for x in [predictions, flvl_targets, plvl_targets, boundary_seqs]:
        if x is not None and not isinstance(x, list):
            raise TypeError("inputs must be lists")
    if plvl_targets is not None and boundary_seqs is None:
        raise ValueError("boundary_seqs required with plvl_targets")
    out = []
    for i in range(len(predictions)):
        flvl = flvl_phn_acc_scoring(predictions[i], flvl_targets[i])
        plvl = 0.0
        if plvl_targets is not None:
            plvl = plvl_phn_acc_scoring(predictions[i], plvl_targets[i],
                                        boundary_seqs[i])
        out.append({"flvl_acc": flvl, "plvl_acc": plvl})
    return out


class PhnAccMetricStats(BaseMetricStats):
    def __init__(self):
        super().__init__(metric_fn=batch_phn_acc_scoring)

    def summarize(self, field: Optional[str] = None):
        means = {k: round(v, 2) for k, v in super().summarize().items()}
        return means if field is None else means[field]
