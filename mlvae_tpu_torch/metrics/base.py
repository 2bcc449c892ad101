"""Metric accumulation (counterpart of ``mlvae_tpu/metrics/base.py``):
append per-utterance score dicts, summarize to means. Host-side numpy."""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np


class BaseMetricStats:
    def __init__(self, metric_fn: Optional[Callable] = None):
        self.metric_fn = metric_fn
        self.clear()

    def clear(self):
        self.metric_keys: List[str] = []
        self.ids: List[str] = []
        self.scores_list: List[Dict[str, float]] = []

    def append(self, ids, **kwargs):
        if self.metric_fn is None:
            raise ValueError("No metric_fn has been provided")
        self.ids.extend(ids)
        self.scores_list.extend(self.metric_fn(**kwargs))
        # an all-filtered batch can yield no score dicts: take the keys
        # from the first batch that has some
        if not self.metric_keys and self.scores_list:
            self.metric_keys = list(self.scores_list[0].keys())

    def summarize(self, field: Optional[str] = None):
        if not self.metric_keys:
            raise ValueError("No metrics saved yet")
        means = {k: float(np.mean([float(s[k]) for s in self.scores_list]))
                 for k in self.metric_keys}
        return means if field is None else means[field]

    def write_stats(self, f):
        scores = self.summarize()
        f.write("\t".join(str(v) for v in scores.values()) + "\n")
