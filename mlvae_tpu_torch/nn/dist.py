"""Distribution math for the VAE family (counterpart of
``mlvae_tpu/nn/dist.py``).

The math runs in f32 whatever the activations' dtype, except the
categorical sample, which ``jax.random.categorical`` takes in the logits'
dtype (bf16 under AMP). Every sampler takes
its noise explicitly (``u``, ``g`` or ``eps``: the raw draw, as
``jax.random.uniform`` / ``gumbel`` / ``normal`` would give it) or draws it
from an optional ``torch.Generator``, so a test can replay the JAX draws.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

LOG_2PI = math.log(2.0 * math.pi)


def _noise(noise, shape, device, sampler, generator):
    if noise is not None:
        if tuple(noise.shape) != tuple(shape):
            raise ValueError(f"noise shape {tuple(noise.shape)} != "
                             f"{tuple(shape)}")
        return noise.to(device=device, dtype=torch.float32)
    return sampler(shape, device=device, generator=generator)


def gumbel_noise(shape, device=None, generator=None,
                 dtype=torch.float32):
    """Standard Gumbel noise, -log(-log(u)) computed in ``dtype``, with u
    drawn as ``jax.random.gumbel`` draws it: on the dtype's grid of eps
    (2^-7 for bf16) in [tiny, 1). An f32 uniform rounded to bf16 would
    reach 1.0 and give +inf; floored to the grid it never does."""
    fi = torch.finfo(dtype)
    u = torch.floor(torch.rand(shape, device=device, generator=generator)
                    / fi.eps) * fi.eps
    return -torch.log(-torch.log(torch.clamp(u.to(dtype), min=fi.tiny)))


# -- Gaussian ---------------------------------------------------------------

def reparameterize(mean, log_var, eps: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None):
    std = torch.exp(0.5 * log_var.float())
    eps = _noise(eps, mean.shape, mean.device, torch.randn, generator)
    return (eps * std + mean.float()).to(mean.dtype)


def kld_std_normal(mean, log_var):
    """Per-element KL(N(mean, var) || N(0, 1)); f32."""
    mean, log_var = mean.float(), log_var.float()
    return -0.5 * (1.0 + log_var - mean.square() - torch.exp(log_var))


def kld_gaussian_prior(prior_mean, prior_log_var, mean, log_var, eps=1e-5):
    """Per-element KL between diagonal Gaussians with a learned prior, in
    the reference's eps-regularised form; f32."""
    prior_mean, prior_log_var = prior_mean.float(), prior_log_var.float()
    mean, log_var = mean.float(), log_var.float()
    return -0.5 * (1.0 + log_var - prior_log_var
                   - (torch.exp(log_var) + (mean - prior_mean).square())
                   / (torch.exp(prior_log_var) + eps))


def gaussian_nll(mean, log_var, target, eps=1e-5):
    """Per-element negative Gaussian log-likelihood; f32."""
    mean, log_var, target = mean.float(), log_var.float(), target.float()
    ll = -0.5 * (LOG_2PI + log_var
                 + (target - mean).square() / (torch.exp(log_var) + eps))
    return -ll


# -- Gumbel softmax ----------------------------------------------------------

def gumbel_softmax(logits, tau: float = 1.0,
                   g: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None):
    """Hard (one-hot) Gumbel-softmax sample with the straight-through
    gradient of the soft sample."""
    in_dtype = logits.dtype
    logits = logits.float()
    g = _noise(g, logits.shape, logits.device, gumbel_noise, generator)
    y_soft = torch.softmax((logits + g) / tau, dim=-1)
    idx = torch.argmax(y_soft, dim=-1)
    y_hard = F.one_hot(idx, logits.shape[-1]).float()
    # straight-through estimator
    return (y_hard + y_soft - y_soft.detach()).to(in_dtype)


# -- Kumaraswamy / Beta -------------------------------------------------------

def kumaraswamy_sample(alpha, beta, u: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None,
                       u_lo=0.01, u_span=0.98, eps=1e-5):
    """Inverse-CDF draw v = (1 - u^(1/beta))^(1/alpha) with the raw uniform
    u squashed into [0.01, 0.99], and v into [eps, 1 - eps]."""
    alpha, beta = alpha.float(), beta.float()
    u = _noise(u, alpha.shape, alpha.device, torch.rand, generator)
    u = u * u_span + u_lo
    v = torch.pow(1.0 - torch.pow(u, 1.0 / beta), 1.0 / alpha)
    return v * (1.0 - 2.0 * eps) + eps


def kld_beta(alpha, beta, prior_alpha: float, prior_beta: float):
    """Closed-form KL(Beta(alpha, beta) || Beta(a0, b0)) in the
    digamma/lgamma form."""
    alpha, beta = alpha.float(), beta.float()
    # filled on the device: no host copy inside a step graph
    a0 = torch.full((), prior_alpha, dtype=torch.float32,
                    device=alpha.device)
    b0 = torch.full((), prior_beta, dtype=torch.float32, device=alpha.device)
    lg, dg = torch.special.gammaln, torch.special.digamma

    def log_beta_fn(a, b):
        return lg(a) + lg(b) - lg(a + b)

    return (log_beta_fn(a0, b0) - log_beta_fn(alpha, beta)
            + (alpha - a0) * dg(alpha)
            + (beta - b0) * dg(beta)
            + (a0 - alpha + b0 - beta) * dg(alpha + beta))


# -- Bernoulli / BCE ----------------------------------------------------------

def bce(probs, targets, eps=1e-7):
    """Elementwise binary cross entropy on probabilities clamped to
    [eps, 1 - eps]; eps below ~1e-7 would round 1 - eps to 1 in f32."""
    probs, targets = probs.float(), targets.float()
    p = torch.clamp(probs, eps, 1.0 - eps)
    return -(targets * torch.log(p) + (1.0 - targets) * torch.log1p(-p))


def bce_with_logits(logits, targets):
    """Elementwise, numerically stable BCE-with-logits; f32."""
    logits, targets = logits.float(), targets.float()
    return (torch.clamp(logits, min=0.0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


# -- Categorical --------------------------------------------------------------

def categorical_sample(logits, g: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None):
    """One draw per row of Categorical(logits) by the Gumbel-max trick:
    ``argmax(g + logits)`` over the last axis, ``g`` the raw Gumbel noise
    of ``logits``' shape. As ``jax.random.categorical``, the noise and the
    sum are in the logits' dtype: bf16 logits take bf16 noise."""
    if g is None:
        g = gumbel_noise(logits.shape, device=logits.device,
                         generator=generator, dtype=logits.dtype)
    elif tuple(g.shape) != tuple(logits.shape):
        raise ValueError(f"noise shape {tuple(g.shape)} != "
                         f"{tuple(logits.shape)}")
    return torch.argmax(g.to(device=logits.device, dtype=logits.dtype)
                        + logits, dim=-1)


def categorical_log_prob(logits, value):
    """log p(value) for integer ``value`` under Categorical(logits); f32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(logp, -1, value.long()[..., None])[..., 0]


def categorical_entropy(logits):
    """Entropy of Categorical(logits) over the last axis; f32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(torch.exp(logp) * logp).sum(dim=-1)


def categorical_ll_onehot(logits, one_hot):
    """<log_softmax(logits), one_hot> over the last axis: the reference's
    bmm of ``Categorical.logits``, which torch normalizes to
    log-probabilities at construction, against a one-hot target; so its
    logit gradient is one_hot - softmax. f32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return (logp * one_hot.float()).sum(dim=-1)
