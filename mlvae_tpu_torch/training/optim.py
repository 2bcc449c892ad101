"""Optimizers as plain tensor code (counterpart of
``mlvae_tpu/training/optim.py``).

``Adam`` follows ``optax.adam`` as the JAX package builds it
(``inject_hyperparams``, so the hyperparameters are f32 scalars) in optax's
order of operations: ``mu = (1-b1)*g + b1*mu``, ``nu = (1-b2)*g^2 + b2*nu``,
bias corrections by the incremented ``count``, and
``update = mu_hat / (sqrt(nu_hat) + eps) * (-lr)``. It is not
``torch.optim.Adam``, whose association differs and which cannot skip a
module's state advance and update on a device-side condition, as the train
step's inactive-module rule needs. One state covers one module's parameters
as a flat vector.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

INT32_MAX = 2 ** 31 - 1


class Adam:
    def __init__(self, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        self.lr = float(lr)
        self.betas = (float(betas[0]), float(betas[1]))
        self.eps = float(eps)

    def init(self, params: Sequence[torch.Tensor]) -> Dict:
        n = sum(p.numel() for p in params)
        dev = params[0].device
        return {"count": torch.zeros((), dtype=torch.int32, device=dev),
                "mu": torch.zeros(n, dtype=torch.float32, device=dev),
                "nu": torch.zeros(n, dtype=torch.float32, device=dev)}

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], grad: torch.Tensor,
             state: Dict, active: Optional[torch.Tensor] = None) -> None:
        """Advance ``state`` and update ``params`` in place from ``grad``,
        the parameters' gradients flattened and concatenated in order.
        Where the 0-d bool ``active`` is False, neither happens."""
        dev = grad.device

        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=dev)

        b1, b2, eps, neg_lr = (f32(self.betas[0]), f32(self.betas[1]),
                               f32(self.eps), f32(-self.lr))
        count = state["count"]
        mu = (1 - b1) * grad + b1 * state["mu"]
        nu = (1 - b2) * (grad * grad) + b2 * state["nu"]
        count_inc = torch.where(count < INT32_MAX, count + 1, count)
        c = count_inc.float()
        mu_hat = mu / (1 - torch.pow(b1, c))
        nu_hat = nu / (1 - torch.pow(b2, c))
        update = mu_hat / (torch.sqrt(nu_hat) + eps) * neg_lr
        if active is not None:
            update = torch.where(active, update, torch.zeros_like(update))
            mu = torch.where(active, mu, state["mu"])
            nu = torch.where(active, nu, state["nu"])
            count_inc = torch.where(active, count_inc, count)
        state["mu"].copy_(mu)
        state["nu"].copy_(nu)
        state["count"].copy_(count_inc)
        offset = 0
        for p in params:
            n = p.numel()
            p.add_(update[offset:offset + n].view_as(p))
            offset += n
