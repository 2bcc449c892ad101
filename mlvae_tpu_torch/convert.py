"""Carry weights between the JAX package and the port.

The JAX package keeps parameters as nested dicts whose leaves already use
torch names and layouts (``Module.init``: ``Linear`` weights (out, in),
LSTM weights ``weight_ih_l{k}[_reverse]`` ...), and the running normalizer
statistics apart from them in ``states["normalizer"]``. The port's
``state_dict`` keys are the same paths joined by dots, so the bridge is a
flatten and an unflatten. Only numpy is used: no JAX is imported.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

_KEYSTR = re.compile(r"\['([^']*)'\]")


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = np.asarray(v)
    return out


def _insert(tree: Dict, path, value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def from_jax(params: Dict, states: Dict = None) -> Dict[str, torch.Tensor]:
    """JAX ``params`` (and ``states``) -> the port's ``state_dict``, the
    normalizer buffers under ``normalizer.*``."""
    flat = _flatten(params)
    for name, state in (states or {}).items():
        flat.update(_flatten(state, name + "."))
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in
            flat.items()}


STATE_MODULES = ("normalizer",)  # running state, kept apart from params


def to_jax(state_dict: Dict[str, torch.Tensor]) -> Tuple[Dict, Dict]:
    """The inverse of ``from_jax``: (params, states) nested dicts of numpy
    arrays."""
    params, states = {}, {}
    for key, value in state_dict.items():
        path = key.split(".")
        target = states if path[0] in STATE_MODULES else params
        _insert(target, path, value.detach().cpu().numpy())
    return params, states


def write_npz_flat(path, flat: Dict[str, np.ndarray]) -> None:
    """One checkpoint blob: ``np.savez`` of a flat tree keyed by
    ``jax.tree_util.keystr`` paths, the layout of the ``mlvae_tpu``
    checkpointer."""
    np.savez(path, **{k: np.asarray(v) for k, v in flat.items()})


def read_npz_flat(path) -> Dict[str, np.ndarray]:
    """One checkpoint blob -> {keystr path: numpy array}; the one reader
    of the layout (``read_npz_tree`` and the checkpointer build on it)."""
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


def read_npz_tree(path) -> Dict:
    """One blob of plain nested dicts (keys such as
    ``['decoder']['rnn']['...']``, as ``params.npz`` and ``states.npz``
    hold them) -> nested dict of numpy arrays."""
    tree: Dict = {}
    for key, value in read_npz_flat(path).items():
        parts = _KEYSTR.findall(key)
        if "".join(f"['{p}']" for p in parts) != key:
            raise ValueError(f"{path}: unrecognised key path {key!r}")
        _insert(tree, parts, value)
    return tree


def load_jax_checkpoint(path) -> Dict[str, torch.Tensor]:
    """An ``mlvae_tpu`` npz checkpoint directory (``params.npz`` and, where
    saved, ``states.npz``) -> the port's ``state_dict``."""
    path = Path(path)
    params = read_npz_tree(path / "params.npz")
    states_path = path / "states.npz"
    states = read_npz_tree(states_path) if states_path.exists() else {}
    return from_jax(params, states)
