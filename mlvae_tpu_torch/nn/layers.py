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
    """The slope is taken in x's dtype (bf16(0.01) under AMP), as the JAX
    package's weakly typed ``negative_slope * x`` takes it."""
    slope = float(torch.tensor(negative_slope, dtype=x.dtype))
    return F.leaky_relu(x, slope)


def softplus(x: torch.Tensor):
    return F.softplus(x)


def uniform_(t: torch.Tensor, bound: float,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


class Linear(nn.Module):
    """y = x @ W^T + b. In bf16 the product is rounded to x's dtype before
    the bias is added, as the JAX package's einsum-then-add rounds; f32
    takes one fused ``F.linear``."""

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
        if x.dtype == torch.float32:
            return F.linear(x, self.weight, self.bias)
        y = torch.matmul(x, self.weight.t())
        return y if self.bias is None else y + self.bias


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator] = None,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverted dropout (scale by 1/(1-p) while training). ``mask`` is the
    keep-mask of ``x``'s shape (as ``jax.random.bernoulli(key, 1-p, shape)``
    gives it); without one it is drawn from ``generator``. The keep
    probability is taken in x's dtype, as the JAX package's ``x / keep``
    takes it (bf16(0.85) = 0.8515625 under AMP)."""
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    if mask is None:
        mask = torch.rand(x.shape, device=x.device, generator=generator) < keep
    elif tuple(mask.shape) != tuple(x.shape):
        raise ValueError(f"dropout mask shape {tuple(mask.shape)} != "
                         f"{tuple(x.shape)}")
    keep_x = float(torch.tensor(keep, dtype=x.dtype))
    return torch.where(mask.to(device=x.device, dtype=torch.bool),
                       x / keep_x,
                       torch.zeros((), dtype=x.dtype, device=x.device))


class LeakyReLU(nn.Module):
    """Stateless activation (YAML alias of ``torch.nn.LeakyReLU``), with
    ``leaky_relu``'s slope in x's dtype."""

    def __init__(self, negative_slope: float = 0.01):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(x, self.negative_slope)


class Softplus(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return softplus(x)


class Identity(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


class Sequential(nn.Sequential):
    """Ordered composition; children are named ``0``, ``1``, ... as the
    JAX ``Sequential``'s parameter subtrees are."""
