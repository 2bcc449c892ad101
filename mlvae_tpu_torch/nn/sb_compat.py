"""The small SpeechBrain-surface modules of the CTC recipes (counterpart of
``mlvae_tpu/nn/sb_compat.py``): ``!new:speechbrain.nnet.linear.Linear``
and ``!new:speechbrain.nnet.activations.Softmax``."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mlvae_tpu_torch.nn.layers import Linear


class SBLinear(nn.Module):
    """``Linear`` with SpeechBrain's constructor (``input_size``,
    ``n_neurons``); its weights under ``lin``, as the JAX module's."""

    def __init__(self, input_size: int, n_neurons: int, bias: bool = True,
                 generator: Optional[torch.Generator] = None, device=None,
                 **kwargs):
        super().__init__()
        self.lin = Linear(input_size, n_neurons, bias, generator=generator,
                          device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin(x)


class Softmax(nn.Module):
    """Stateless (log-)softmax over ``dim``, in x's dtype."""

    def __init__(self, apply_log: bool = False, dim: int = -1):
        super().__init__()
        self.apply_log = bool(apply_log)
        self.dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.apply_log:
            return F.log_softmax(x, dim=self.dim)
        return F.softmax(x, dim=self.dim)
