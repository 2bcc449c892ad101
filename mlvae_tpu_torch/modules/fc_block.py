"""MLP block of Linear + LeakyReLU pairs (counterpart of
``mlvae_tpu/modules/fc_block.py``): hidden layers get LeakyReLU, the last
Linear gets one only when ``end_activation``. Layers are named
``lin0``, ``lin1``, ... as in the JAX package's parameter tree. ``dropout``
is taken and never used, as by the JAX module (the recipes' YAML passes
it)."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from mlvae_tpu_torch.nn.layers import Linear, leaky_relu


class FCBlock(nn.Module):
    def __init__(self, fc_sizes: Sequence[int], end_activation: bool = False,
                 dropout: float = 0.15,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        sizes = [int(s) for s in fc_sizes]
        if len(sizes) < 2:
            raise ValueError(f"fc_sizes needs at least [in, out], got {sizes}")
        self.end_activation = bool(end_activation)
        self.dropout = dropout   # taken, never used
        self.n_layers = len(sizes) - 1
        for i in range(self.n_layers):
            self.add_module(f"lin{i}", Linear(sizes[i], sizes[i + 1],
                                              generator=generator,
                                              device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"lin{i}")(x)
            if i < self.n_layers - 1 or self.end_activation:
                x = leaky_relu(x)
        return x
