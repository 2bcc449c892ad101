"""Metric-keyed checkpointing (counterpart of
``mlvae_tpu/training/checkpointer.py``; YAML alias of
``speechbrain.utils.checkpoints.Checkpointer``).

The layout is the JAX package's: one directory per checkpoint,
``CKPT-<date>_<time>-<micros>``, holding one ``<recoverable>.npz`` per
state tree and a ``meta.json`` written last by an atomic rename (the
completeness marker). A state tree is a flat dict keyed by the JAX
package's ``jax.tree_util.keystr`` paths (``['rnn']['weight_ih_l0']``,
``['rnn'].inner_state[0].mu['rnn']['weight_ih_l0']``), so either package
reads the other's checkpoints (``training/brain.py`` maps the port's
modules and optimizer states onto those paths). ``convert.write_npz_flat``
and ``convert.read_npz_flat`` are the one writer and reader of a blob.

``find_checkpoint`` picks by ``max_key`` / ``min_key`` with ties going to
the newest; ``save_and_keep_only`` keeps the best under each key and the
newest. A state to save is the trees themselves, or a
:class:`DeviceSnapshot` (the Brain's: the tensors on their way to the host
and how to make the trees of them), whose trees are those of the same
state saved at once, byte for byte.

``async_save`` (``--async_ckpt``) is the JAX checkpointer's worker-thread
saver: ``save_and_keep_only`` starts the snapshot's device-to-host copy
(a side stream into pinned host buffers) and returns; the worker waits for
the copy, writes and prunes. A queued save that newer requests supersede
is dropped unless it may still be the best under one of its keys
(``_possibly_kept``); a dropped save is held on the host until the saves
that justified the drop have persisted, and queued again if one fails.
Enqueueing blocks at two queued saves (one above
``MLVAE_ASYNC_CKPT_TIGHT_BYTES``, default 1 GiB). ``flush`` waits for every
pending save, ``close`` also stops the worker, an atexit hook flushes, and
a worker's error is raised by the next ``save_and_keep_only``, ``flush``,
``find_checkpoint`` or ``wait_device_release``. The train step updates the
parameters and moments in place, so ``wait_device_release`` makes the
current stream wait for every pending copy before the next step writes
them (the JAX package donates its buffers and blocks until the worker
has fetched them instead). The orbax backend is not ported.
"""
from __future__ import annotations

import atexit
import functools
import json
import logging
import os
import shutil
import threading
import time
import warnings
import weakref
from collections import deque
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from mlvae_tpu_torch.convert import read_npz_flat, write_npz_flat

logger = logging.getLogger(__name__)


class CheckpointKeyMismatch(ValueError):
    """The saved tree's key paths do not cover the template's: the state
    LAYOUT changed since the checkpoint was written (a shape mismatch, by
    contrast, means the architecture changed)."""

    def __init__(self, missing, rec_name: str = "?"):
        self.missing = list(missing)
        self.rec_name = rec_name
        super().__init__(
            f"checkpoint layout mismatch for recoverable {rec_name!r}: "
            f"{len(self.missing)} template key(s) absent from the saved "
            f"file, e.g. {self.missing[:3]}")


def _restore_like(template: Dict[str, Any], flat: Dict[str, np.ndarray],
                  rec_name: str) -> Dict[str, np.ndarray]:
    missing = [k for k in template if k not in flat]
    if missing:
        raise CheckpointKeyMismatch(missing, rec_name)
    out = {}
    for key, cur in template.items():
        arr, cur = flat[key], np.asarray(cur)
        if arr.shape != cur.shape:
            raise ValueError(
                f"checkpoint/model shape mismatch at {key}: saved "
                f"{arr.shape}, current model expects {cur.shape}: the "
                "model architecture changed since this checkpoint was "
                "written; delete the stale checkpoints or match the "
                "original configuration")
        out[key] = arr.astype(cur.dtype)
    return out


def _jsonable(obj):
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


class DeviceSnapshot:
    """A checkpoint's tensors on their way to the host, and ``build``,
    which makes the state trees (recoverable name -> flat tree) of their
    host copies. CPU tensors are copied at once; CUDA tensors with
    ``asynchronous`` are copied on a side stream into pinned host buffers
    after the current stream's work, an event marking the copy's end
    (without it, at once)."""

    def __init__(self, tensors: Dict[str, torch.Tensor],
                 build: Callable[[Dict[str, torch.Tensor]], Dict],
                 asynchronous: bool = False):
        self.build = build
        self.event = None
        self.device = None
        self.nbytes = sum(t.numel() * t.element_size()
                          for t in tensors.values())
        self._host: Dict[str, torch.Tensor] = {}
        cuda = [t for t in tensors.values() if t.is_cuda]
        if cuda and asynchronous:
            dev = cuda[0].device
            stream = torch.cuda.Stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                for key, t in tensors.items():
                    if t.is_cuda:
                        host = torch.empty(t.shape, dtype=t.dtype,
                                           pin_memory=True)
                        host.copy_(t.detach(), non_blocking=True)
                        t.record_stream(stream)
                        self._host[key] = host
            self.event = torch.cuda.Event()
            self.event.record(stream)
            self.device = dev
        for key, t in tensors.items():
            if key not in self._host:
                self._host[key] = t.detach().to("cpu", copy=True)

    @property
    def pins_device(self) -> bool:
        """Whether a copy from the device may still be running."""
        return self.event is not None

    def fence(self) -> None:
        """The current stream waits for the copy (no host wait): the next
        in-place update of the snapshot's tensors comes after it."""
        if self.event is not None:
            torch.cuda.current_stream(self.device).wait_event(self.event)

    def fetch(self) -> Dict[str, Dict[str, np.ndarray]]:
        """The state trees, once the copy has ended."""
        if self.event is not None:
            self.event.synchronize()
        return self.build(self._host)


def _host_state(state):
    """A state to save as its trees (a snapshot's copy awaited)."""
    return state.fetch() if isinstance(state, DeviceSnapshot) else state


def _pins_device(state) -> bool:
    return isinstance(state, DeviceSnapshot) and state.pins_device


def _state_bytes(state) -> int:
    if isinstance(state, DeviceSnapshot):
        return state.nbytes
    return sum(int(np.asarray(v).nbytes) for tree in state.values()
               for v in tree.values())


class Checkpoint:
    def __init__(self, path: Path, meta: Dict[str, Any]):
        self.path = Path(path)
        self.meta = meta


class Checkpointer:
    def __init__(self, checkpoints_dir, recoverables: Optional[Dict] = None,
                 async_save: bool = False):
        self.checkpoints_dir = Path(checkpoints_dir)
        # the YAML's recoverables (modules, the epoch counter) are kept for
        # introspection; the Brain hands the live state trees to save
        self.recoverables = dict(recoverables or {})
        self.last_selection_fell_back = False
        # the worker-thread saver (--async_ckpt)
        self.async_save = bool(async_save)
        self._queue: deque = deque()
        self._cv = threading.Condition()
        self._worker: Optional[threading.Thread] = None
        self._worker_error: Optional[BaseException] = None
        self._inflight_meta: Optional[Dict[str, Any]] = None
        # saves dropped by a newer request, on the host, until the saves
        # that justified the drop have persisted (queued again otherwise)
        self._dropped: List[tuple] = []
        # queued or in-flight snapshots whose copy from the device may
        # still run (released by the worker's fetch or by a fence)
        self._pinned: List[DeviceSnapshot] = []
        self._closed = False
        self._atexit_cb = None

    @property
    def _device_pinned(self) -> int:
        return len(self._pinned)

    # -- enumeration ---------------------------------------------------------
    def list_checkpoints(self) -> List[Checkpoint]:
        out = []
        if not self.checkpoints_dir.exists():
            return out
        for d in sorted(self.checkpoints_dir.iterdir()):
            meta_path = d / "meta.json"
            try:
                if d.is_dir() and meta_path.exists():
                    with open(meta_path) as f:
                        out.append(Checkpoint(d, json.load(f)))
            except (FileNotFoundError, NotADirectoryError,
                    json.JSONDecodeError):
                continue   # pruned by the worker meanwhile, or torn
        return out

    def find_checkpoint(self, max_key: Optional[str] = None,
                        min_key: Optional[str] = None
                        ) -> Optional[Checkpoint]:
        """The best checkpoint by ``max_key`` (largest) or ``min_key``
        (smallest), ties to the newest; the newest without a key. A key
        that no checkpoint records falls back to the newest with a warning
        and sets ``last_selection_fell_back``. Pending saves persist
        first."""
        self.flush()
        self.last_selection_fell_back = False
        ckpts = self.list_checkpoints()
        if not ckpts:
            return None
        newest = max(ckpts, key=lambda c: c.meta.get("unixtime", 0))
        if max_key:
            keyed = [c for c in ckpts if max_key in c.meta]
            if keyed:
                return max(keyed, key=lambda c: (c.meta[max_key],
                                                 c.meta.get("unixtime", 0)))
        elif min_key:
            keyed = [c for c in ckpts if min_key in c.meta]
            if keyed:
                return min(keyed, key=lambda c: (c.meta[min_key],
                                                 -c.meta.get("unixtime", 0)))
        else:
            return newest
        warnings.warn(
            f"no checkpoint meta contains the selection key "
            f"{max_key or min_key!r}; falling back to the newest checkpoint "
            f"({newest.path.name})")
        self.last_selection_fell_back = True
        return newest

    # -- save ----------------------------------------------------------------
    def save_checkpoint(self, state, meta: Optional[Dict[str, Any]] = None
                        ) -> Checkpoint:
        """``state``: recoverable name -> flat tree (keystr path -> array),
        or a :class:`DeviceSnapshot` of them."""
        state = _host_state(state)
        meta = dict(meta or {})
        meta.setdefault("unixtime", time.time())
        name = (f"CKPT-{time.strftime('%Y-%m-%d_%H-%M-%S')}-"
                f"{int(time.time() * 1e6) % 1000000:06d}")
        path = self.checkpoints_dir / name
        path.mkdir(parents=True, exist_ok=True)
        for rec_name, flat in state.items():
            write_npz_flat(path / f"{rec_name}.npz", flat)
        tmp = path / "meta.json.tmp"
        with open(tmp, "w") as f:
            json.dump(_jsonable(meta), f, indent=2)
        os.replace(tmp, path / "meta.json")
        return Checkpoint(path, meta)

    def save_and_keep_only(self, state, meta: Optional[Dict] = None,
                           max_keys: Optional[List[str]] = None,
                           min_keys: Optional[List[str]] = None,
                           num_to_keep: int = 1, keep_recent: bool = True):
        """Save, then delete every checkpoint that is neither among the
        best ``num_to_keep`` under one of the keys (ties to the newest, as
        ``find_checkpoint`` breaks them) nor, with ``keep_recent``, the
        newest, which a resumed fit restarts from. With ``async_save`` the
        worker saves and prunes (see the module docstring)."""
        meta = dict(meta or {})
        meta.setdefault("unixtime", time.time())
        if not self.async_save:
            self._save_and_prune(state, meta, max_keys, min_keys,
                                 num_to_keep, keep_recent)
            return
        self._raise_worker_error()
        with self._cv:
            if self._queue:
                # supersede: set aside the queued saves that can no longer
                # be kept once the newer requests persist
                known = [m for (_, m, *_rest) in self._queue] + [meta]
                inflight_t = None
                if self._inflight_meta is not None:
                    known.append(self._inflight_meta)
                    inflight_t = self._inflight_meta.get("unixtime")
                known += [c.meta for c in self.list_checkpoints()
                          if inflight_t is None
                          or c.meta.get("unixtime") != inflight_t]
                new_queue: deque = deque()
                for item in self._queue:
                    if self._possibly_kept(item[1], item[2], item[3],
                                           item[4], known):
                        new_queue.append(item)
                    else:
                        # a held drop may linger: its trees on the host
                        self._release(item[0])
                        self._dropped.append((_host_state(item[0]),)
                                             + item[1:])
                self._queue = new_queue
            # backpressure: each queued snapshot holds host buffers (and
            # its device tensors until its copy ends)
            tight_at = int(os.environ.get("MLVAE_ASYNC_CKPT_TIGHT_BYTES",
                                          1 << 30))
            depth = 1 if _state_bytes(state) > tight_at else 2
            while len(self._queue) >= depth and self._worker_error is None:
                self._cv.wait()
            self._queue.append(
                (state, meta, max_keys, min_keys, num_to_keep, keep_recent))
            if _pins_device(state):
                self._pinned.append(state)
            self._ensure_worker()
            self._cv.notify_all()

    def _release(self, state) -> None:
        """``state`` no longer pins the device (call under ``_cv``)."""
        if any(s is state for s in self._pinned):
            self._pinned = [s for s in self._pinned if s is not state]
            self._cv.notify_all()

    def wait_device_release(self) -> None:
        """Before a step updates the parameters and moments in place: the
        current stream waits for every queued or in-flight snapshot's copy
        (a stream wait, not a host wait)."""
        if self._worker is None:
            return
        with self._cv:
            for snap in self._pinned:
                snap.fence()
            self._pinned = []
            self._cv.notify_all()
        self._raise_worker_error()

    @staticmethod
    def _possibly_kept(meta, max_keys, min_keys, num_to_keep, known) -> bool:
        """Could a save with this meta still be kept once the newer
        requests in ``known`` have persisted? True unless ``num_to_keep``
        strictly better metas exist under every key."""
        for key, better in ([(k, lambda a, b: a > b) for k in max_keys or []]
                            + [(k, lambda a, b: a < b)
                               for k in min_keys or []]):
            if key not in meta:
                continue
            n_better = sum(1 for m in known
                           if m is not meta and key in m
                           and better(m[key], meta[key]))
            if n_better < num_to_keep:
                return True
        return False

    def _save_and_prune(self, state, meta, max_keys, min_keys, num_to_keep,
                        keep_recent):
        self.save_checkpoint(state, meta)
        keep = set()
        ckpts = self.list_checkpoints()
        for key in max_keys or []:
            ranked = sorted([c for c in ckpts if key in c.meta],
                            key=lambda c: (c.meta[key],
                                           c.meta.get("unixtime", 0)),
                            reverse=True)
            keep.update(str(c.path) for c in ranked[:num_to_keep])
        for key in min_keys or []:
            ranked = sorted([c for c in ckpts if key in c.meta],
                            key=lambda c: (c.meta[key],
                                           -c.meta.get("unixtime", 0)))
            keep.update(str(c.path) for c in ranked[:num_to_keep])
        if keep_recent or not keep:
            newest = max(ckpts, key=lambda c: c.meta.get("unixtime", 0))
            keep.add(str(newest.path))
        for c in ckpts:
            if str(c.path) not in keep:
                shutil.rmtree(c.path, ignore_errors=True)

    # -- the worker ----------------------------------------------------------
    def _ensure_worker(self):
        if self._worker is None or not self._worker.is_alive():
            # the thread and the atexit hook hold a weakref only
            ref = weakref.ref(self)
            self._worker = threading.Thread(
                target=_worker_main, args=(ref,), daemon=True,
                name="mlvae-ckpt")
            self._worker.start()
            if self._atexit_cb is None:
                self._atexit_cb = functools.partial(_flush_at_exit, ref)
                atexit.register(self._atexit_cb)

    def flush(self):
        """Wait until every queued save has persisted; raise a worker's
        error. Nothing to do without the worker."""
        if self._worker is not None:
            with self._cv:
                while True:
                    while self._queue or self._inflight_meta is not None:
                        self._cv.wait()
                    if self._dropped and self._worker_error is None:
                        # a held drop that no persisted save justified
                        self._queue.extend(self._dropped)
                        self._dropped = []
                        self._cv.notify_all()
                        continue
                    break
        self._raise_worker_error()

    def close(self):
        """Flush, stop the worker and drop the atexit hook; a later async
        save starts a worker again."""
        try:
            self.flush()
        finally:
            with self._cv:
                self._closed = True
                self._cv.notify_all()
            if self._atexit_cb is not None:
                atexit.unregister(self._atexit_cb)
                self._atexit_cb = None
            if self._worker is not None:
                self._worker.join(timeout=5)
                self._worker = None
            self._closed = False

    def _flush_best_effort(self):
        try:
            self.flush()
        except BaseException as e:
            logger.error("checkpoint flush at exit failed: %s", e)

    def _raise_worker_error(self):
        with self._cv:
            err, self._worker_error = self._worker_error, None
        if err is not None:
            raise RuntimeError("async checkpoint save failed") from err

    # -- load ----------------------------------------------------------------
    def load_checkpoint(self, ckpt: Checkpoint,
                        templates: Dict[str, Dict[str, Any]]
                        ) -> Dict[str, Dict[str, np.ndarray]]:
        """The saved trees named by ``templates`` (name -> flat tree whose
        keys, shapes and dtypes the saved one must give), where saved."""
        out = {}
        for rec_name, template in templates.items():
            npz_path = ckpt.path / f"{rec_name}.npz"
            if not npz_path.exists():
                continue
            out[rec_name] = _restore_like(template, read_npz_flat(npz_path),
                                          rec_name)
        return out

    def recover_if_possible(self, templates, max_key: Optional[str] = None,
                            min_key: Optional[str] = None):
        ckpt = self.find_checkpoint(max_key=max_key, min_key=min_key)
        if ckpt is None:
            return None, None
        return self.load_checkpoint(ckpt, templates), ckpt


def _worker_main(ref: "weakref.ref[Checkpointer]"):
    """The saver: holds a weakref to its Checkpointer, polls, and ends when
    the owner is gone or closed with nothing queued."""
    while True:
        self = ref()
        if self is None:
            return
        cv = self._cv
        with cv:
            if not self._queue:
                if self._closed:
                    return
                del self
                cv.wait(timeout=0.5)
                continue
            item = self._queue.popleft()
            self._inflight_meta = item[1]
            cv.notify_all()   # wake a blocked enqueuer
        try:
            # the copy first, then the device is free of the snapshot
            snap = item[0]
            if isinstance(snap, DeviceSnapshot):
                try:
                    item = (snap.fetch(),) + item[1:]
                finally:
                    with cv:
                        self._release(snap)
            self._save_and_prune(*item)
            if self._dropped:
                # a held drop is final once the persisted saves justify it
                disk = [c.meta for c in self.list_checkpoints()]
                with cv:
                    self._dropped = [
                        d for d in self._dropped
                        if self._possibly_kept(d[1], d[2], d[3], d[4], disk)]
        except BaseException as e:   # raised by the next call
            logger.error("async checkpoint save failed: %s", e)
            with cv:
                self._worker_error = e
                if self._dropped:
                    # the failed save may have justified these drops
                    self._queue.extendleft(reversed(self._dropped))
                    self._dropped = []
        finally:
            with cv:
                self._inflight_meta = None
                cv.notify_all()


def _flush_at_exit(ref: "weakref.ref[Checkpointer]"):
    self = ref()
    if self is not None:
        self._flush_best_effort()


def checkpoint_has(ckpt: Checkpoint, rec_name: str) -> bool:
    return (ckpt.path / f"{rec_name}.npz").exists()
