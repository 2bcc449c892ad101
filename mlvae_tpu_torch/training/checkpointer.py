"""Metric-keyed checkpointing (counterpart of
``mlvae_tpu/training/checkpointer.py``, synchronous only; YAML alias of
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
newest. Saves are synchronous: the JAX ``--async_ckpt`` is refused by
``check_run_opts``, and the orbax backend is not ported.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import time
import warnings
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

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


class Checkpoint:
    def __init__(self, path: Path, meta: Dict[str, Any]):
        self.path = Path(path)
        self.meta = meta


class Checkpointer:
    def __init__(self, checkpoints_dir, recoverables: Optional[Dict] = None):
        self.checkpoints_dir = Path(checkpoints_dir)
        # the YAML's recoverables (modules, the epoch counter) are kept for
        # introspection; the Brain hands the live state trees to save
        self.recoverables = dict(recoverables or {})
        self.last_selection_fell_back = False

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
                continue   # a torn entry left by a killed process
        return out

    def find_checkpoint(self, max_key: Optional[str] = None,
                        min_key: Optional[str] = None
                        ) -> Optional[Checkpoint]:
        """The best checkpoint by ``max_key`` (largest) or ``min_key``
        (smallest), ties to the newest; the newest without a key. A key
        that no checkpoint records falls back to the newest with a warning
        and sets ``last_selection_fell_back``."""
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
    def save_checkpoint(self, state: Dict[str, Dict[str, np.ndarray]],
                        meta: Optional[Dict[str, Any]] = None) -> Checkpoint:
        """``state``: recoverable name -> flat tree (keystr path -> array)."""
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
        newest, which a resumed fit restarts from."""
        meta = dict(meta or {})
        meta.setdefault("unixtime", time.time())
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


def checkpoint_has(ckpt: Checkpoint, rec_name: str) -> bool:
    return (ckpt.path / f"{rec_name}.npz").exists()
