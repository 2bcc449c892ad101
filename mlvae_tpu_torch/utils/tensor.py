"""Tensor utilities (counterpart of ``mlvae_tpu/utils/tensor.py``).

Two length conventions live side by side and must not be mixed up:

* ``abs_lengths`` rounds (``torch.round`` is half-to-even like
  ``jnp.round``); the decode and ``undo_padding`` use it;
* ``apply_lens_to_loss`` masks frame t iff ``t < rel_len * T`` with the
  UNROUNDED threshold, as speechbrain's ``length_to_mask`` does. Rounding
  there shifts every masked loss by about 2e-3.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch


def abs_lengths(rel_lens: torch.Tensor, max_len: int) -> torch.Tensor:
    """Relative (0..1] lengths -> absolute int32 counts, rounded."""
    return torch.round(rel_lens * max_len).to(torch.int32)


def length_mask(rel_lens: torch.Tensor, max_len: int,
                dtype=torch.float32) -> torch.Tensor:
    """(B,) relative lengths -> (B, max_len) 0/1 mask over the rounded
    lengths."""
    lens = abs_lengths(rel_lens, max_len)
    idx = torch.arange(max_len, device=lens.device)[None, :]
    return (idx < lens[:, None]).to(dtype)


def apply_weight(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Contract the component axis: x (B, T, N, C) or (B, T, N*C), weight
    (B, T, N) -> (B, T, C), in the promoted dtype of the two (an f32 loss
    weighted by bf16 weights stays f32, as in the JAX package)."""
    B, T, N = weight.shape
    if x.dim() == 3:
        x = x.reshape(B, T, N, x.shape[-1] // N)
    dt = torch.promote_types(x.dtype, weight.dtype)
    return torch.einsum("btnc,btn->btc", x.to(dt), weight.to(dt))


def apply_lens_to_loss(loss: torch.Tensor, rel_lens: torch.Tensor,
                       reduction: str = "mean") -> torch.Tensor:
    """Masked reduction; loss (B, T, ...), rel_lens (B,). The mask
    threshold is the unrounded ``rel_len * T`` (see the module header).
    ``reduction``: ``mean`` over the valid elements, ``batchmean`` (their
    sum over B) or ``batch`` (each utterance's mean)."""
    T = loss.shape[1]
    idx = torch.arange(T, device=loss.device)[None, :]
    thresh = rel_lens.float()[:, None] * T
    mask = (idx < thresh).to(loss.dtype)
    while mask.dim() < loss.dim():
        mask = mask[..., None]
    mask = mask.expand(loss.shape)
    masked = loss * mask
    B = loss.shape[0]
    if reduction == "mean":
        return masked.sum() / mask.sum()
    if reduction == "batchmean":
        return masked.sum() / B
    if reduction == "batch":
        return masked.reshape(B, -1).sum(-1) / mask.reshape(B, -1).sum(-1)
    raise ValueError(f"unknown reduction: {reduction}")


def to_host(x) -> np.ndarray:
    """A tensor (bf16 as f32) or an array -> a host numpy array."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.detach().cpu().numpy()
    return np.asarray(x)


def undo_padding(batch, rel_lens) -> List[np.ndarray]:
    """Host side: padded (B, T, ...) -> list of trimmed numpy arrays."""
    batch = np.asarray(batch)
    rel_lens = np.asarray(rel_lens, np.float32)
    T = batch.shape[1]
    return [seq[:int(np.round(float(l) * T))]
            for seq, l in zip(batch, rel_lens)]


def boundary_to_phoneme_index(boundary_seqs: torch.Tensor) -> torch.Tensor:
    """(B, T) start-frame indicators -> (B, T) index of the phoneme active
    at each frame: ``cumsum(boundary) - 1``, floored at 0."""
    idx = torch.cumsum(boundary_seqs.to(torch.int32), dim=1) - 1
    return torch.clamp(idx, min=0)


def resample_by_factor_np(source: np.ndarray, target_len: int,
                          axis: int = 1, tol: int = 3) -> np.ndarray:
    """Host side: repeat each frame of ``source`` along ``axis`` by the
    integer factor ``target_len // len``, then cut or zero-pad to
    ``target_len``. A length difference beyond ``tol`` raises: zero
    log-probabilities are probability 1 for every class and would corrupt
    the posteriors an alignment reads."""
    src_len = source.shape[axis]
    factor = target_len // src_len
    if factor <= 0:
        raise ValueError(
            f"non-positive factor for input lengths: {src_len} and "
            f"{target_len}")
    out = np.repeat(source, factor, axis=axis)
    diff = out.shape[axis] - target_len
    if not -tol <= diff <= tol:
        raise ValueError(
            "length difference between resampled and target too large: "
            f"{diff} (source {src_len} x{factor} vs target {target_len})")
    if diff > 0:
        out = np.take(out, np.arange(target_len), axis=axis)
    elif diff < 0:
        pad_widths = [(0, 0)] * out.ndim
        pad_widths[axis] = (0, -diff)
        out = np.pad(out, pad_widths)
    return out
