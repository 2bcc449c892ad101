"""2-D convolution, max pooling and layer norm, channels last (counterpart of
``mlvae_tpu/nn/conv.py``).

The public layout is the JAX package's: NHWC activations and an HWIO
``weight`` parameter, so that ``convert.from_jax`` carries the weights
across as a flatten. ``Conv2d`` permutes to PyTorch's NCHW / OIHW inside
``forward`` and pads as XLA's SAME padding does, ``total = max((ceil(H/s)
- 1)·s + k - H, 0)`` with ``total // 2`` before and the rest after (under
stride 2 that is not ``F.conv2d``'s symmetric ``padding``). The
convolution is ``F.conv2d``, as the JAX package leaves it to XLA; cuDNN
runs it in full f32 because ``device.resolve_device`` turns TF32 off.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mlvae_tpu_torch.nn.layers import uniform_


def _pair(v) -> tuple:
    return (int(v), int(v)) if isinstance(v, int) else tuple(int(x) for x in v)


def same_padding(size: int, k: int, s: int) -> tuple:
    """(before, after) of XLA's SAME padding for one spatial dimension."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv2d(nn.Module):
    """NHWC convolution with SAME padding and an HWIO weight; torch's
    U(+-1/sqrt(fan_in)) init from an explicit ``torch.Generator``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=(1, 1), bias: bool = True,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride)
        kh, kw = self.kernel_size
        bound = 1.0 / math.sqrt(in_channels * kh * kw)
        self.weight = nn.Parameter(uniform_(torch.empty(
            (kh, kw, in_channels, out_channels), device=device), bound,
            generator))
        self.bias = nn.Parameter(uniform_(torch.empty(
            out_channels, device=device), bound, generator)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        ph = same_padding(x.shape[1], kh, sh)
        pw = same_padding(x.shape[2], kw, sw)
        y = F.conv2d(F.pad(x.permute(0, 3, 1, 2), pw + ph),
                     self.weight.permute(3, 2, 0, 1), stride=self.stride)
        y = y.permute(0, 2, 3, 1)
        # the bias after the convolution, in x's dtype, as XLA adds it
        return y if self.bias is None else y + self.bias


def max_pool(x: torch.Tensor, window: Sequence[int],
             strides: Sequence[int]) -> torch.Tensor:
    """Max pooling over the spatial dims of NHWC, VALID padding."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), tuple(window), tuple(strides))
    return y.permute(0, 2, 3, 1)


def layer_norm(x: torch.Tensor, gamma, beta, eps: float = 1e-5):
    """Over the last dim with f32 statistics; the output in x's dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps) * torch.as_tensor(
        gamma, dtype=torch.float32, device=x.device) + torch.as_tensor(
        beta, dtype=torch.float32, device=x.device)
    return out.to(x.dtype)
