"""Dense layers and simple activations (counterpart of
``mlvae_tpu/nn/layers.py``).

``Linear`` stores its weight as (out, in), torch's layout and the JAX
package's, so weights carry across one to one. Initialisation is torch's
U(+-1/sqrt(fan_in)) from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01):
    return F.leaky_relu(x, negative_slope)


def softplus(x: torch.Tensor):
    return F.softplus(x)


def uniform_(t: torch.Tensor, bound: float,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


class Linear(nn.Module):
    """y = x @ W^T + b."""

    def __init__(self, in_size: int, out_size: int, bias: bool = True,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        bound = 1.0 / math.sqrt(in_size)
        self.weight = nn.Parameter(uniform_(
            torch.empty(out_size, in_size, device=device), bound, generator))
        self.bias = nn.Parameter(uniform_(
            torch.empty(out_size, device=device), bound, generator)) \
            if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator] = None,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverted dropout (scale by 1/(1-p) while training). ``mask`` is the
    keep-mask of ``x``'s shape (as ``jax.random.bernoulli(key, 1-p, shape)``
    gives it); without one it is drawn from ``generator``."""
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    if mask is None:
        mask = torch.rand(x.shape, device=x.device, generator=generator) < keep
    elif tuple(mask.shape) != tuple(x.shape):
        raise ValueError(f"dropout mask shape {tuple(mask.shape)} != "
                         f"{tuple(x.shape)}")
    return torch.where(mask.to(device=x.device, dtype=torch.bool), x / keep,
                       torch.zeros((), dtype=x.dtype, device=x.device))
