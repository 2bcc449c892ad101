"""Input normalization with running global statistics (counterpart of
``mlvae_tpu/nn/norm.py``, ``norm_type="global"``; YAML alias of
``speechbrain.processing.features.InputNormalization``).

``count``, ``glob_mean`` and ``glob_std`` are f32 buffers and the output
comes back in the input's dtype. ``update=True`` folds the batch's masked
per-utterance statistics into the running averages while
``epoch < update_until_epoch``; the eval step never updates. Under data
parallelism the batch means and the count are the global batch's (sums
over the data group), as the JAX step takes them over its mesh.

A recipe's YAML gives no feature width (``norm_type: global`` only), as
the JAX module takes it from the first batch (``Brain.ensure_states``):
built with ``feat_dim=None``, the buffers appear at ``ensure_size``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mlvae_tpu_torch.parallel.mesh import data_all_reduce, data_size
from mlvae_tpu_torch.utils.tensor import length_mask

EPS = 1e-10


class InputNormalization(nn.Module):
    def __init__(self, feat_dim: Optional[int] = None,
                 update_until_epoch: int = 3, norm_type: str = "global",
                 device=None):
        super().__init__()
        if norm_type != "global":
            raise NotImplementedError(
                f"norm_type {norm_type!r}: the port has the global "
                "statistics only, which every ported recipe uses")
        self.update_until_epoch = update_until_epoch
        self._device = device
        self.feat_dim = None
        if feat_dim is not None:
            self.ensure_size(feat_dim)

    def ensure_size(self, feat_dim: int) -> None:
        """Create the buffers for ``feat_dim`` features (count 0, mean 0,
        std 1) unless they exist; a different width raises."""
        if self.feat_dim is not None:
            if self.feat_dim != int(feat_dim):
                raise ValueError(f"normalizer holds {self.feat_dim} features, "
                                 f"got {feat_dim}")
            return
        self.feat_dim = int(feat_dim)
        dev = self._device
        self.register_buffer("count", torch.zeros((), device=dev))
        self.register_buffer("glob_mean", torch.zeros(feat_dim, device=dev))
        self.register_buffer("glob_std", torch.ones(feat_dim, device=dev))

    @torch.no_grad()
    def _update(self, feats: torch.Tensor, rel_lens: torch.Tensor):
        B, T, _ = feats.shape
        mask = length_mask(rel_lens, T, dtype=feats.dtype)[..., None]
        denom = torch.clamp(mask.sum(dim=1), min=1.0)              # (B, 1)
        cur_mean = (feats * mask).sum(dim=1) / denom               # (B, C)
        var = ((feats - cur_mean[:, None, :]) ** 2 * mask).sum(dim=1) / denom
        cur_std = torch.sqrt(torch.clamp(var, min=EPS))
        # the global batch's means: this rank holds B of its rows
        B = B * data_size()
        sums = data_all_reduce(torch.stack([cur_mean.sum(dim=0),
                                            cur_std.sum(dim=0)]))
        batch_mean, batch_std = sums[0] / B, sums[1] / B
        new_count = self.count + B
        w_old = self.count / new_count
        w_new = 1.0 - w_old
        self.glob_mean.copy_(w_old * self.glob_mean + w_new * batch_mean)
        self.glob_std.copy_(w_old * self.glob_std + w_new * batch_std)
        self.count.copy_(new_count)

    def forward(self, feats: torch.Tensor, rel_lens: torch.Tensor,
                epoch: int = 1, update: bool = False) -> torch.Tensor:
        in_dtype = feats.dtype
        self.ensure_size(feats.shape[-1])
        feats = feats.float()
        if update and epoch < self.update_until_epoch:
            self._update(feats, rel_lens)
        out = (feats - self.glob_mean) / torch.clamp(self.glob_std, min=EPS)
        return out.to(in_dtype)
