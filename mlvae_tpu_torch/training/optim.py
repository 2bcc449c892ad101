"""Optimizers as plain tensor code (counterpart of
``mlvae_tpu/training/optim.py``): ``Adam``, ``Adadelta`` and ``SGD``.

``Adam`` follows ``optax.adam`` as the JAX package builds it
(``inject_hyperparams``, so the hyperparameters are f32 scalars) in optax's
order of operations: ``mu = (1-b1)*g + b1*mu``, ``nu = (1-b2)*g^2 + b2*nu``,
bias corrections by the incremented ``count``, and
``update = mu_hat / (sqrt(nu_hat) + eps) * (-lr)``. It is not
``torch.optim.Adam``, whose association differs and which cannot skip a
module's state advance and update on a device-side condition, as the train
step's inactive-module rule needs. One state covers one module's parameters
as a flat vector.

``Adadelta`` follows ``optax.adadelta`` (``scale_by_adadelta`` then the
learning rate): ``e_g = (1-rho)*g^2 + rho*e_g``, ``u = sqrt(e_x + eps) /
sqrt(e_g + eps) * g``, ``e_x = (1-rho)*u^2 + rho*e_x``, ``update = u *
(-lr)``. ``SGD`` follows ``optax.sgd``: without momentum ``g * (-lr)``,
with it the trace ``t = g + momentum*t`` and ``t * (-lr)``. Their
hyperparameters are f32 scalars, as ``inject_hyperparams`` makes them.

``Adam(moment_dtype=...)``, or the environment's ``MLVAE_OPT_MOMENT_DTYPE``
where the argument is not given, keeps both moments in that dtype, as the
JAX ``OptimizerFactory.make`` builds ``_scale_by_adam_moment_dtype``
(``mlvae_tpu/training/optim.py:20-62,80-86``): the stored moments are
upcast to the grads' f32, ``mu = b1*m + (1-b1)*g`` and ``nu = b2*v +
(1-b2)*g^2`` in f32, the update ``(mu / c1) / (sqrt(nu / c2) + eps) *
(-lr)`` from those f32 moments, and only then are they rounded into the
state. Its injected hyperparameters lack ``eps_root``; its moments are
written to a checkpoint in their dtype (bf16 as the JAX checkpointer's
``|V2`` raw 16-bit words). f32, or nothing, keeps ``optax.adam``.

Each optimizer names its checkpoint layout, the JAX package's
``inject_hyperparams`` state of one module: ``hyperparams()`` (the
injected hyperparameters by name), ``SCALARS`` (state keys written under
an inner path as well as the outer ``count``) and ``MOMENTS`` (state key
-> inner path of a flat moment, written per parameter).
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import torch

INT32_MAX = 2 ** 31 - 1


def _f32(v, dev) -> torch.Tensor:
    """A 0-d f32 constant filled on ``dev`` (no host copy: a step graph
    can capture it)."""
    return torch.full((), v, dtype=torch.float32, device=dev)


def scatter_flat(params: Sequence[torch.Tensor], update: torch.Tensor) -> None:
    """Add the flat ``update`` to ``params`` in order."""
    offset = 0
    for p in params:
        n = p.numel()
        p.add_(update[offset:offset + n].view_as(p))
        offset += n


def _advance(count: torch.Tensor) -> torch.Tensor:
    return torch.where(count < INT32_MAX, count + 1, count)


class _Optimizer:
    """The flat per-module state: ``count`` and the ``MOMENTS``, vectors of
    the module's parameters' total size in ``moment_dtype``."""
    SCALARS: Dict[str, str] = {}
    MOMENTS: Dict[str, str] = {}
    moment_dtype = torch.float32

    def init(self, params: Sequence[torch.Tensor]) -> Dict:
        n = sum(p.numel() for p in params)
        dev = params[0].device
        state = {"count": torch.zeros((), dtype=torch.int32, device=dev)}
        for key in self.MOMENTS:
            state[key] = torch.zeros(n, dtype=self.moment_dtype, device=dev)
        return state

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], grad: torch.Tensor,
             state: Dict, active: Optional[torch.Tensor] = None) -> None:
        """Advance ``state`` and update ``params`` in place from ``grad``,
        the parameters' gradients flattened and concatenated in order.
        Where the 0-d bool ``active`` is False, neither happens."""
        scatter_flat(params, self.delta(grad, state, active))

    @torch.no_grad()
    def delta(self, grad: torch.Tensor, state: Dict,
              active: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Advance ``state`` from the flat ``grad`` and return the flat
        update, elementwise; ZeRO-1 runs it on a rank's piece of a
        module's gradient and moments (``parallel/zero1.py``)."""
        count = _advance(state["count"])
        update, new = self._update(grad, state, count)
        new["count"] = count
        if active is not None:
            update = torch.where(active, update, torch.zeros_like(update))
            new = {k: torch.where(active, v, state[k])
                   for k, v in new.items()}
        for k, v in new.items():
            state[k].copy_(v)
        return update

    def _update(self, grad: torch.Tensor, state: Dict, count: torch.Tensor):
        """(the flat update, the new moments) at the advanced ``count``."""
        raise NotImplementedError


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _moment_dtype(name) -> torch.dtype:
    """A dtype name as ``jnp.dtype`` takes it ("bfloat16", ...)."""
    if str(name).strip() not in _DTYPES:
        raise ValueError(f"moment_dtype {name!r}: one of {sorted(_DTYPES)}")
    return _DTYPES[str(name).strip()]


class Adam(_Optimizer):
    SCALARS = {"count": "inner_state[0].count"}
    MOMENTS = {"mu": "inner_state[0].mu", "nu": "inner_state[0].nu"}

    def __init__(self, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, moment_dtype=None):
        self.lr = float(lr)
        self.betas = (float(betas[0]), float(betas[1]))
        self.eps = float(eps)
        if moment_dtype is None:
            moment_dtype = os.environ.get("MLVAE_OPT_MOMENT_DTYPE",
                                          "").strip() or None
        self.moment_dtype = (torch.float32 if not moment_dtype
                             else _moment_dtype(moment_dtype))

    def hyperparams(self) -> Dict[str, float]:
        out = {"b1": self.betas[0], "b2": self.betas[1], "eps": self.eps,
               "eps_root": 0.0, "learning_rate": self.lr}
        if self.moment_dtype != torch.float32:
            del out["eps_root"]   # _adam_moment_dtype injects no eps_root
        return out

    def _update(self, grad, state, count):
        dev = grad.device
        b1, b2, eps, neg_lr = (_f32(self.betas[0], dev),
                               _f32(self.betas[1], dev), _f32(self.eps, dev),
                               _f32(-self.lr, dev))
        c = count.float()
        if self.moment_dtype != torch.float32:
            mu = b1 * state["mu"].to(grad.dtype) + (1 - b1) * grad
            nu = b2 * state["nu"].to(grad.dtype) + (1 - b2) * (grad * grad)
            out = (mu / (1 - torch.pow(b1, c))) / (
                torch.sqrt(nu / (1 - torch.pow(b2, c))) + eps)
            return out * neg_lr, {"mu": mu.to(self.moment_dtype),
                                  "nu": nu.to(self.moment_dtype)}
        mu = (1 - b1) * grad + b1 * state["mu"]
        nu = (1 - b2) * (grad * grad) + b2 * state["nu"]
        mu_hat = mu / (1 - torch.pow(b1, c))
        nu_hat = nu / (1 - torch.pow(b2, c))
        return mu_hat / (torch.sqrt(nu_hat) + eps) * neg_lr, \
            {"mu": mu, "nu": nu}


class Adadelta(_Optimizer):
    """``optax.adadelta`` (weight decay 0) at the JAX factory's defaults."""
    MOMENTS = {"e_g": "inner_state[1].e_g", "e_x": "inner_state[1].e_x"}

    def __init__(self, lr: float = 1.0, rho: float = 0.9, eps: float = 1e-6,
                 **kwargs):
        self.lr, self.rho, self.eps = float(lr), float(rho), float(eps)

    def hyperparams(self) -> Dict[str, float]:
        return {"eps": self.eps, "learning_rate": self.lr, "rho": self.rho,
                "weight_decay": 0.0}

    def _update(self, grad, state, count):
        dev = grad.device
        rho, eps, neg_lr = (_f32(self.rho, dev), _f32(self.eps, dev),
                            _f32(-self.lr, dev))
        e_g = (1 - rho) * (grad * grad) + rho * state["e_g"]
        u = torch.sqrt(state["e_x"] + eps) / torch.sqrt(e_g + eps) * grad
        e_x = (1 - rho) * (u * u) + rho * state["e_x"]
        return u * neg_lr, {"e_g": e_g, "e_x": e_x}


class SGD(_Optimizer):
    """``optax.sgd``: a trace of ``momentum`` where it is nonzero (the JAX
    factory passes ``momentum or None``), plain steps otherwise."""

    def __init__(self, lr: float = 1e-2, momentum: float = 0.0, **kwargs):
        self.lr, self.momentum = float(lr), float(momentum or 0.0)
        self.MOMENTS = ({"trace": "inner_state[0].trace"} if self.momentum
                        else {})

    def hyperparams(self) -> Dict[str, float]:
        out = {"learning_rate": self.lr}
        if self.momentum:
            out["momentum"] = self.momentum
        return out

    def _update(self, grad, state, count):
        neg_lr = _f32(-self.lr, grad.device)
        if not self.momentum:
            return grad * neg_lr, {}
        trace = grad + _f32(self.momentum, grad.device) * state["trace"]
        return trace * neg_lr, {"trace": trace}
