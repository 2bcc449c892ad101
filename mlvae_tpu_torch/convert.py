"""Carry weights between the JAX package and the port.

The JAX package keeps parameters as nested dicts whose leaves already use
torch names and layouts (``Module.init``: ``Linear`` weights (out, in),
LSTM weights ``weight_ih_l{k}[_reverse]`` ...), and the running normalizer
statistics apart from them in ``states["normalizer"]``. The port's
``state_dict`` keys are the same paths joined by dots, so the bridge is a
flatten and an unflatten. One layout differs: the JAX wav2vec2 encoder
stacks its L transformer layers on a leading axis
(``['layers']['q_w']`` (L, H, H)), where the port keeps a module a layer
(``layers.<i>.q_w``); ``unstack_layers`` and ``stack_layers`` carry one
to the other wherever a ``pos_conv.weight`` beside ``layers`` marks the
encoder, and ``from_jax`` / ``to_jax`` and the checkpoints go through
them. ``hf_state_dict_to_port`` maps an HF ``Wav2Vec2Model`` state dict
onto the encoder (the JAX module's ``params_from_hf_model``). Only numpy
and torch are used: no JAX is imported, nor ``transformers``.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

_KEYSTR = re.compile(r"\['([^']*)'\]")
# a transformer layer's parameters, as the JAX module stacks them
LAYER_KEYS = ("q_w", "q_b", "k_w", "k_b", "v_w", "v_b", "o_w", "o_b",
              "ff_in_w", "ff_in_b", "ff_out_w", "ff_out_b",
              "ln1_s", "ln1_b", "ln2_s", "ln2_b")
_LAYER = re.compile(r"^(.*?)layers\.(\d+)\.(%s)$" % "|".join(LAYER_KEYS))
_MARK = "pos_conv.weight"


def _encoder_prefixes(keys):
    """The dotted prefixes of wav2vec2 encoders among ``keys``."""
    return {k[:-len(_MARK)] for k in keys if k.endswith(_MARK)}


def stack_layers(flat: Dict) -> Dict:
    """Dotted keys of the port (``<enc>.layers.<i>.q_w``) -> the JAX
    encoder's stacked leaves (``<enc>.layers.q_w``, layer i at row i);
    every other key as it is."""
    prefixes = _encoder_prefixes(flat)
    out, groups = {}, {}
    for key, value in flat.items():
        m = _LAYER.match(key)
        if m and m.group(1) in prefixes:
            groups.setdefault(f"{m.group(1)}layers.{m.group(3)}", {})[
                int(m.group(2))] = np.asarray(value)
        else:
            out[key] = value
    for key, rows in groups.items():
        out[key] = np.stack([rows[i] for i in range(len(rows))])
    return out


def unstack_layers(flat: Dict) -> Dict:
    """The inverse of ``stack_layers``."""
    prefixes = _encoder_prefixes(flat)
    out = {}
    for key, value in flat.items():
        head, _, leaf = key.rpartition(".")
        if (leaf in LAYER_KEYS and (head == "layers"
                                    or head.endswith(".layers"))
                and head[:-len("layers")] in prefixes):
            for i, row in enumerate(value):
                out[f"{head}.{i}.{leaf}"] = row
        else:
            out[key] = value
    return out


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
    flat = unstack_layers(_flatten(params))
    for name, state in (states or {}).items():
        flat.update(_flatten(state, name + "."))
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in
            flat.items()}


STATE_MODULES = ("normalizer",)  # running state, kept apart from params


def to_jax(state_dict: Dict[str, torch.Tensor]) -> Tuple[Dict, Dict]:
    """The inverse of ``from_jax``: (params, states) nested dicts of numpy
    arrays."""
    params, states = {}, {}
    flat = stack_layers({k: v.detach().cpu().numpy()
                         for k, v in state_dict.items()})
    for key, value in flat.items():
        path = key.split(".")
        target = states if path[0] in STATE_MODULES else params
        _insert(target, path, value)
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


def _weight_norm(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """torch's ``weight_norm(dim=2)`` kernel: ``g v / ||v||`` with the norm
    over every axis but 2."""
    return v * (g / v.norm(dim=(0, 1), keepdim=True))


def hf_state_dict_to_port(sd: Dict[str, torch.Tensor]
                          ) -> Dict[str, torch.Tensor]:
    """HF ``Wav2Vec2Model`` state-dict names -> the port encoder's
    (the counterpart of the JAX module's ``params_from_hf_model``): conv
    kernels (out, in, K) -> (K, in, out), linear weights transposed to
    (in, out), the positional conv's weight norm resolved, a
    ``wav2vec2.`` prefix (a task head's snapshot) dropped; names of no
    use to the encoder (``masked_spec_embed``, heads) are left out."""
    sd = {(k[len("wav2vec2."):] if k.startswith("wav2vec2.") else k): v
          for k, v in sd.items()}
    out = {}
    i = 0
    while f"feature_extractor.conv_layers.{i}.conv.weight" in sd:
        pre = f"feature_extractor.conv_layers.{i}."
        out[f"extractor.conv{i}.weight"] = \
            sd[pre + "conv.weight"].permute(2, 1, 0)
        if pre + "conv.bias" in sd:
            out[f"extractor.conv{i}.bias"] = sd[pre + "conv.bias"]
        if pre + "layer_norm.weight" in sd:
            out[f"extractor.conv{i}.norm_scale"] = sd[pre + "layer_norm.weight"]
            out[f"extractor.conv{i}.norm_bias"] = sd[pre + "layer_norm.bias"]
        i += 1
    fp = "feature_projection."
    out["proj.norm_scale"] = sd[fp + "layer_norm.weight"]
    out["proj.norm_bias"] = sd[fp + "layer_norm.bias"]
    out["proj.w"] = sd[fp + "projection.weight"].t()
    out["proj.b"] = sd[fp + "projection.bias"]
    pc = "encoder.pos_conv_embed.conv."
    if pc + "weight" in sd:
        w = sd[pc + "weight"]
    elif pc + "parametrizations.weight.original0" in sd:
        w = _weight_norm(sd[pc + "parametrizations.weight.original0"],
                         sd[pc + "parametrizations.weight.original1"])
    else:
        w = _weight_norm(sd[pc + "weight_g"], sd[pc + "weight_v"])
    out["pos_conv.weight"] = w.permute(2, 1, 0)
    out["pos_conv.bias"] = sd[pc + "bias"]
    out["enc_norm.scale"] = sd["encoder.layer_norm.weight"]
    out["enc_norm.bias"] = sd["encoder.layer_norm.bias"]
    i = 0
    while f"encoder.layers.{i}.attention.q_proj.weight" in sd:
        pre = f"encoder.layers.{i}."
        for ours, theirs in (("q", "q_proj"), ("k", "k_proj"),
                             ("v", "v_proj"), ("o", "out_proj")):
            out[f"layers.{i}.{ours}_w"] = \
                sd[f"{pre}attention.{theirs}.weight"].t()
            out[f"layers.{i}.{ours}_b"] = sd[f"{pre}attention.{theirs}.bias"]
        for ours, theirs in (("ff_in", "intermediate_dense"),
                             ("ff_out", "output_dense")):
            out[f"layers.{i}.{ours}_w"] = \
                sd[f"{pre}feed_forward.{theirs}.weight"].t()
            out[f"layers.{i}.{ours}_b"] = \
                sd[f"{pre}feed_forward.{theirs}.bias"]
        for ours, theirs in (("ln1", "layer_norm"),
                             ("ln2", "final_layer_norm")):
            out[f"layers.{i}.{ours}_s"] = sd[f"{pre}{theirs}.weight"]
            out[f"layers.{i}.{ours}_b"] = sd[f"{pre}{theirs}.bias"]
        i += 1
    return {k: v.float().contiguous() for k, v in out.items()}
