"""Padded batching (the port's own copy of ``mlvae_tpu/data/batch.py``).

Batches pad the time axis up to the JAX package's bucket multiples (time
32, sequences 8, waves 8000 samples), so the same samples give the same
padded arrays and relative lengths in both packages, and therefore the
same masks and LSTM inputs. The SpeechBrain convention holds downstream:

* ``batch[key]`` -> ``(padded_array, relative_lens)`` for array keys
* ``batch['id']`` -> list of utterance ids
* relative lens are true_len / padded_len, so ``round(rel * padded)``
  recovers exact counts.

Host-side numpy; ``Brain.to_device_batch`` moves a batch onto the run's
device.
"""
from __future__ import annotations

import math
import queue
import threading
from typing import Any, Dict, Iterator, List, Sequence

import numpy as np


def _round_up(n: int, m: int) -> int:
    return max(m, ((n + m - 1) // m) * m)


class PaddedBatch:
    def __init__(self, samples: List[Dict[str, Any]],
                 time_bucket: int = 32, seq_bucket: int = 8):
        self.ids = [s["id"] for s in samples]
        self._data: Dict[str, Any] = {}
        keys = [k for k in samples[0] if k != "id"]
        for key in keys:
            vals = [np.asarray(s[key]) for s in samples]
            if vals[0].ndim == 0:
                self._data[key] = (np.stack(vals), np.ones(len(vals), np.float32))
                continue
            lens = np.asarray([v.shape[0] for v in vals], np.int64)
            if key == "prior":  # class-dim vector; never pad
                bucket = 1
            elif key.endswith("wav"):
                # sample-rate axis: coarse 0.5 s buckets
                bucket = 8000
            elif key.endswith("feat") or "flvl" in key or "boundary" in key:
                bucket = time_bucket
            else:
                bucket = seq_bucket
            Tpad = _round_up(int(lens.max()), bucket)
            rest = vals[0].shape[1:]
            out = np.zeros((len(vals), Tpad) + rest, vals[0].dtype)
            for i, v in enumerate(vals):
                out[i, : v.shape[0]] = v
            rel = (lens / Tpad).astype(np.float32)
            self._data[key] = (out, rel)

    def __getitem__(self, key):
        if key == "id":
            return self.ids
        return self._data[key]

    def __setitem__(self, key, value):
        """A key a recipe's ``prepare_batch`` adds: (array, relative
        lengths)."""
        self._data[key] = value

    def __contains__(self, key):
        return key == "id" or key in self._data

    def keys(self):
        return ["id"] + list(self._data.keys())

    @property
    def batchsize(self):
        return len(self.ids)


class DataLoader:
    """Duration-ordered batching over a DynamicItemDataset-like sequence.

    The reference sorts by duration and disables shuffling
    (``data_io.py:155-158``); we keep that behavior (order == dataset order)
    and optionally shuffle batches (not samples) when requested.
    """

    def __init__(self, dataset, batch_size: int = 8, shuffle: bool = False,
                 time_bucket: int = 32, seq_bucket: int = 8, seed: int = 0,
                 drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.time_bucket = time_bucket
        self.seq_bucket = seq_bucket
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return math.ceil(n / self.batch_size)

    def __iter__(self) -> Iterator[PaddedBatch]:
        n = len(self.dataset)
        starts = list(range(0, n, self.batch_size))
        if self.drop_last:
            starts = [s for s in starts if s + self.batch_size <= n]
        if self.shuffle:
            rs = np.random.RandomState(self.seed + self._epoch)
            rs.shuffle(starts)
        self._epoch += 1
        for s in starts:
            samples = [self.dataset[i]
                       for i in range(s, min(s + self.batch_size, n))]
            yield PaddedBatch(samples, self.time_bucket, self.seq_bucket)


def prefetch(iterable, depth: int = 2) -> Iterator:
    """Iterate ``iterable`` with a background producer thread (bounded
    queue), overlapping host batch assembly (wav padding, numpy stacking)
    with device execution. Order is preserved; producer exceptions
    re-raise at the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()
    _END, _ERR = object(), object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for item in iterable:
                if not put(item):
                    return
            put(_END)
        except BaseException as e:  # noqa: BLE001 - re-raised at consumer
            put((_ERR, e))

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, tuple) and len(item) == 2 and item[0] is _ERR:
                raise item[1]
            yield item
    finally:
        stop.set()
