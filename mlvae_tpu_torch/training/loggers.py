"""Training logs (counterpart of ``mlvae_tpu/training/loggers.py``): the
SpeechBrain-style ``FileTrainLogger`` lines of ``train_log.txt``, in the
JAX package's format, and a scalar sink that appends one JSON line per
metric to ``scalars.jsonl`` (the JAX package's fallback format; the port
writes no TensorBoard events)."""
from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Dict, Optional

logger = logging.getLogger(__name__)


class FileTrainLogger:
    def __init__(self, save_file):
        self.save_file = Path(save_file)
        self.save_file.parent.mkdir(parents=True, exist_ok=True)

    def _stats_str(self, stats: Dict) -> str:
        return ", ".join(f"{k}: {v}" for k, v in stats.items())

    def log_stats(self, stats_meta: Dict, train_stats: Optional[Dict] = None,
                  valid_stats: Optional[Dict] = None,
                  test_stats: Optional[Dict] = None, **named_stats):
        parts = [self._stats_str(stats_meta)]
        for name, stats in [("train", train_stats), ("valid", valid_stats),
                            ("test", test_stats)] + [
            (k.replace("_stats", ""), v) for k, v in named_stats.items()
        ]:
            if stats:
                parts.append(f"{name}: " + self._stats_str(stats))
        line = " - ".join(parts)
        with open(self.save_file, "a") as f:
            f.write(line + "\n")
        logger.info(line)


class ScalarWriter:
    """Per-metric time series, one JSON object a line in
    ``<log_dir>/scalars.jsonl``."""

    def __init__(self, log_dir):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.path = self.log_dir / "scalars.jsonl"

    def add_scalar(self, tag: str, value, global_step: int = 0):
        with open(self.path, "a") as f:
            f.write(json.dumps({"tag": tag, "value": float(value),
                                "step": int(global_step),
                                "time": time.time()}) + "\n")
