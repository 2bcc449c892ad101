"""Tracing and per-step timing (counterpart of
``mlvae_tpu/utils/profiling.py``), for ``--profile``:

* :class:`StepTimer`: the wall time of each train step (its dispatch; the
  epoch's losses are fetched once at its end) with mean, p50 and p90
  summaries, the first step apart (``compile_s``: on the card the first
  step of a shape builds, warms or captures), and utterance-seconds a
  second; ``write`` appends one JSON line a call;
* :func:`trace`: a ``torch.profiler`` window (host and, on the card, the
  CUDA kernels through CUPTI) written as a Chrome trace
  (``trace.json``), where the JAX package writes a ``jax.profiler``
  trace.
"""
from __future__ import annotations

import contextlib
import json
import logging
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

TRACE_FILE = "trace.json"


class StepTimer:
    def __init__(self, hop_seconds: float = 0.02):
        self.hop_seconds = hop_seconds
        self.reset()

    def reset(self):
        self.durations: List[float] = []
        self.utt_seconds: List[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, batch_frames: Optional[int] = None):
        if self._t0 is None:
            return
        self.durations.append(time.perf_counter() - self._t0)
        if batch_frames is not None:
            self.utt_seconds.append(batch_frames * self.hop_seconds)
        self._t0 = None

    def summarize(self) -> Dict[str, float]:
        if not self.durations:
            return {}
        # the first step apart
        durs = np.asarray(self.durations[1:] or self.durations)
        out = {
            "steps": len(self.durations),
            "mean_s": float(durs.mean()),
            "p50_s": float(np.percentile(durs, 50)),
            "p90_s": float(np.percentile(durs, 90)),
            "compile_s": float(self.durations[0]),
        }
        if self.utt_seconds:
            total_audio = float(np.sum(self.utt_seconds[1:] or
                                       self.utt_seconds))
            out["utt_sec_per_sec"] = total_audio / max(float(durs.sum()),
                                                       1e-9)
        return out

    def write(self, path):
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(self.summarize()) + "\n")


@contextlib.contextmanager
def trace(log_dir, enabled: bool = True):
    """A ``torch.profiler`` window written to ``<log_dir>/trace.json``
    (CUDA activity too where the card is there); nothing when disabled.
    Yields the profiler (None when disabled)."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    logger.info("profiler trace -> %s", log_dir / TRACE_FILE)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / TRACE_FILE))
