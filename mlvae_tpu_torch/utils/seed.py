"""Seeding (counterpart of ``mlvae_tpu/utils/seed.py``).

The recipes seed at YAML load time (``__set_seed: !apply:torch.manual_seed
[!ref <seed>]``, ``config/run.yaml``). The port draws every random number
from an explicit ``torch.Generator``: the loader hands the run's
generator to ``manual_seed`` as it hands it to every module it builds
(``hyperyaml.load_hyperyaml(..., generator=...)``), so the seed reaches
the weights through that generator and not through torch's global state.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def manual_seed(seed: int, generator: Optional[torch.Generator] = None
                ) -> int:
    """YAML alias of ``torch.manual_seed``: seeds ``generator`` (the run's,
    which the loader passes) and numpy's global state; returns the seed."""
    seed = int(seed)
    if generator is not None:
        generator.manual_seed(seed)
    np.random.seed(seed % 2 ** 32)
    return seed


def use_deterministic_algorithms(mode: bool = True, **kwargs) -> None:
    """YAML alias of ``torch.use_deterministic_algorithms``: forwards to
    it. The port's hand-written kernels are deterministic either way (a
    repeated launch is bit-equal to the first)."""
    torch.use_deterministic_algorithms(bool(mode), **kwargs)
