"""Generic MetricStats, a metric function over per-batch positional
arguments (the port's own copy of ``mlvae_tpu/metrics/metric_stats.py``).
Host-side numpy."""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np


class MetricStats:
    def __init__(self, metric: Callable):
        self.metric = metric
        self.clear()

    def clear(self):
        self.ids: List[str] = []
        self.scores: List[float] = []

    def append(self, ids, *args, **kwargs):
        self.ids.extend(ids)
        self.scores.extend(float(s) for s in self.metric(*args, **kwargs))

    def summarize(self, field: Optional[str] = None):
        if not self.scores:
            # same contract as the other stats classes: an empty logger
            # raises so metric collection skips it, instead of logging a
            # misleading constant 0.0 for stages where nothing appended
            raise ValueError("no scores appended")
        stats = {
            "average": float(np.mean(self.scores)),
            "min_score": float(np.min(self.scores)),
            "max_score": float(np.max(self.scores)),
        }
        return stats if field is None else stats[field]

    def write_stats(self, f):
        f.write(str(self.summarize()) + "\n")
