"""Epoch counter (counterpart of ``mlvae_tpu/training/epoch_loop.py``; YAML
alias of ``speechbrain.utils.epoch_loop.EpochCounter``, which every recipe
builds, e.g. ``models/MD_VAE/model.yaml``). A checkpoint recoverable: its
state is the current epoch."""
from __future__ import annotations


class EpochCounter:
    def __init__(self, limit: int):
        self.limit = int(limit)
        self.current = 0

    def __iter__(self):
        while self.current < self.limit:
            self.current += 1
            yield self.current

    # -- checkpoint protocol -------------------------------------------------
    def state_dict(self):
        return {"current": self.current}

    def load_state_dict(self, state):
        self.current = int(state["current"])
