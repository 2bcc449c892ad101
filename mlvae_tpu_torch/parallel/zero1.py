"""ZeRO-1: the optimizer state split over the data group (counterpart of
``mlvae_tpu/parallel/zero1.py``).

The port's optimizer state is one flat vector a moment per module
(``training/optim.py``). Under ``--zero1`` each data rank keeps one
contiguous piece of each moment: the module's flat gradient, padded with
zeros to a multiple of the data axis, is reduce-scattered (the rank gets
the sum of its piece), the optimizer's elementwise update runs on the
piece against the piece's moments, and one all-gather of the update
brings every rank's parameters to the same values. The global gradient
norm is computed from the pieces, by replicated data parallelism as well
(``training/brain.py``), so that both take the same clip and give the
same parameters bit for bit. Tensor-split modules keep their own shards'
moments and are left out, as the JAX package leaves them.

``split_flat`` / ``gather_flat`` cut a full flat vector into this rank's
piece and put the pieces back together (for checkpoints, which keep the
full JAX layout); ``moment_shard_fraction`` is the share of the moments'
bytes a rank holds (1/N when every module is split).
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch
import torch.nn.functional as F

from mlvae_tpu_torch.parallel import mesh as M


def piece_len(n: int, n_data: int) -> int:
    return -(-n // n_data)


def pad_flat(flat: torch.Tensor, n_data: int) -> torch.Tensor:
    """``flat`` with zeros up to a multiple of ``n_data`` (``flat`` itself
    where it is one)."""
    if flat.numel() % n_data == 0:
        return flat
    return F.pad(flat, (0, piece_len(flat.numel(), n_data) * n_data
                        - flat.numel()))


def split_flat(flat: torch.Tensor, mesh: "M.Mesh") -> torch.Tensor:
    """This data rank's piece of the full flat vector."""
    k = piece_len(flat.numel(), mesh.n_data)
    return pad_flat(flat, mesh.n_data)[mesh.data_rank * k:
                                       (mesh.data_rank + 1) * k].clone()


def gather_flat(piece: torch.Tensor, n: int, mesh: "M.Mesh"
                ) -> torch.Tensor:
    """The full flat vector of length ``n`` from every data rank's piece
    (a collective)."""
    return M.all_gather_cat(piece, mesh.data_group)[:n]


def reduce_scatter_grad(flat: torch.Tensor, mesh: "M.Mesh") -> torch.Tensor:
    """This rank's piece of the data group's summed flat gradient."""
    return M.reduce_scatter_flat(pad_flat(flat, mesh.n_data),
                                 mesh.data_group)


def shard_state(state: Dict, moments: Iterable[str], mesh: "M.Mesh"
                ) -> None:
    """Replace the full ``moments`` of one module's state by this rank's
    pieces, in place."""
    for key in moments:
        state[key] = split_flat(state[key], mesh)


def moment_shard_fraction(pairs: Iterable[Tuple[Dict, Iterable[str], int]]
                          ) -> float:
    """Bytes of moments this rank holds over the bytes of the full
    moments: ``pairs`` gives, per module state, the state, its moment keys
    and the full length of a moment."""
    held = full = 0
    for state, moments, n in pairs:
        for key in moments:
            t = state[key]
            held += t.numel() * t.element_size()
            full += n * t.element_size()
    return held / full if full else 1.0
