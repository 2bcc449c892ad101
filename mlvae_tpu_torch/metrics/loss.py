"""Scalar loss accumulation (the port's own copy of
``mlvae_tpu/metrics/loss.py``): losses are kept as the step returns them,
on the device, and fetched once at ``summarize``."""
from __future__ import annotations

from typing import Optional

import numpy as np


class LossMetricStats:
    def __init__(self, name: str):
        self.name = name
        self.clear()

    def clear(self):
        self.loss_list = []

    def append(self, loss):
        # device scalars stay as they are: a fetch here would wait for the
        # card every batch; summarize() fetches once per stage
        self.loss_list.append(loss)

    def summarize(self, field: Optional[str] = None):
        if not self.loss_list:
            raise ValueError(f"no values appended for {self.name}")
        stats = {"loss": float(np.mean([float(l)
                                        for l in self.loss_list]))}
        # dotted metric keys ('recon_loss.loss') address a field like every
        # other stats class — raising here made md_model's no-data handler
        # silently drop the metric
        return stats if field is None else stats[field]

    def write_stats(self, f):
        f.write(f"{self.name}: {self.summarize()}\n")
