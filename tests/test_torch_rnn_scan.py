"""The plain recurrences that the port runs where the JAX package runs its
``lax.scan`` (``mlvae_tpu/nn/rnn.py:225-239`` for the LSTM, ``:386`` for
the GRU), on the CPU against the JAX modules' own dispatch (off the TPU
that dispatch is the scan at every H; on the TPU too at these H):

* a bf16 GRU layer and a bf16 LSTM layer at H=32, B=16, T=160 (the GRU is
  the repair of ``nn.rnn.GRU``, which ran K5 with an f32 carry there):
  hs bit-equal, both sides rounding every op to bf16 and expanding the
  sigmoid as XLA does (``nn.rnn.logistic``);
* their gradients (dx and every parameter's) against ``jax.grad`` of the
  same sum, rel 5e-2 in norm, the AMP tests' bound (both backwards sum
  each parameter's grad over the 160 steps in bf16, in other orders: the
  biases' differ most, 2.9e-2);
* f32 layers at H=20 (no K1 or K5 build: not a multiple of 16), two
  layers, bidirectional, with dropout masks replayed: outputs atol 1e-5,
  gradients rel 1e-4 in norm;
* the routes, which shape and dtype decide before any launch."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mlvae_tpu.nn.rnn import GRU as JaxGRU
from mlvae_tpu.nn.rnn import LSTM as JaxLSTM

from mlvae_tpu_torch.convert import from_jax
from mlvae_tpu_torch.nn import rnn as prnn

torch.set_num_threads(2)

BF16_GRAD_RTOL = 5e-2
F32_ATOL, F32_RTOL = 1e-5, 1e-4
MODULES = {"gru": (JaxGRU, prnn.GRU), "lstm": (JaxLSTM, prnn.LSTM)}


def _pair(kind, In, H, **kw):
    jcls, pcls = MODULES[kind]
    jm = jcls(In, H, **kw)
    params = jax.device_get(jm.init(jax.random.PRNGKey(7)))
    pm = pcls(In, H, **kw)
    pm.load_state_dict(from_jax(params), strict=True)
    return jm, params, pm


def _norm_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _port_bf16(pm, x):
    """The module on bf16 copies of its parameters and input (the AMP
    step's cast), differentiable back to the f32 masters."""
    params = {n: p.to(torch.bfloat16) for n, p in pm.named_parameters()}
    return torch.func.functional_call(pm, params, (x.to(torch.bfloat16),))


@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_bf16_layer_at_h32_is_the_jax_scan(kind):
    B, T, H, In = 16, 160, 32, 24
    jm, params, pm = _pair(kind, In, H)
    x = np.random.RandomState(0).randn(B, T, In).astype(np.float32)
    pb = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                params)
    want = np.asarray(jm.apply(pb, jnp.asarray(x, jnp.bfloat16))[0]
                      .astype(jnp.float32))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = _port_bf16(pm, xt)[0]
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().detach().numpy(), want)

    # gradients of sum(out * w) for a fixed w, through the bf16 casts
    w = np.random.RandomState(1).randn(B, T, H).astype(np.float32)

    def jloss(p, xx):
        pbf = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), p)
        o = jm.apply(pbf, xx.astype(jnp.bfloat16))[0]
        return jnp.sum(o.astype(jnp.float32) * w)
    jg, jdx = jax.grad(jloss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    (out.float() * torch.from_numpy(w)).sum().backward()
    assert _norm_err(xt.grad.numpy(), jdx) <= BF16_GRAD_RTOL
    for name, p in pm.named_parameters():
        assert _norm_err(p.grad.numpy(), jg[name]) <= BF16_GRAD_RTOL, name


@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_f32_layers_at_h20_take_the_scan(kind):
    B, T, H, In = 5, 9, 20, 12
    jm, params, pm = _pair(kind, In, H, num_layers=2, bidirectional=True,
                           dropout=0.3)
    x = np.random.RandomState(2).randn(B, T, In).astype(np.float32)
    rng = jax.random.PRNGKey(3)
    masks = [torch.from_numpy(np.array(jax.random.bernoulli(
        jax.random.fold_in(rng, 0), 0.7, (T, B, 2 * H))))]

    def jloss(p, xx):
        return jnp.sum(jm.apply(p, xx, rng=rng, train=True)[0] ** 2)
    want = np.asarray(jm.apply(params, jnp.asarray(x), rng=rng,
                               train=True)[0])
    jg, jdx = jax.grad(jloss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = pm(xt, train=True, masks=masks)[0]
    np.testing.assert_allclose(out.detach().numpy(), want, atol=F32_ATOL)
    (out ** 2).sum().backward()
    assert _norm_err(xt.grad.numpy(), jdx) <= F32_RTOL
    for name, p in pm.named_parameters():
        assert _norm_err(p.grad.numpy(), jg[name]) <= F32_RTOL, name


@pytest.mark.parametrize("H, dtype, lstm, gru", [
    (32, torch.bfloat16, "scan", "scan"),
    (528, torch.bfloat16, "scan", "scan"),
    (20, torch.float32, "scan", "scan"),
    (20, torch.bfloat16, "scan", "scan"),
    (32, torch.float32, "k1", "k5"),
    (512, torch.bfloat16, "k1", "k5"),
    (1024, torch.bfloat16, "k1", "k5"),
])
def test_routes_by_shape_and_dtype(H, dtype, lstm, gru):
    # an input width that no fused tier takes (not a multiple of 128 when
    # padded... 7,680 is, but too wide for the budget)
    assert prnn.lstm_route(7680, H, dtype) == lstm
    assert prnn.gru_route(H, dtype) == gru


def test_scan_launches_no_kernel(monkeypatch):
    """A layer on the scan never reaches a kernel wrapper."""
    from mlvae_tpu_torch.ops import gru as G
    from mlvae_tpu_torch.ops import lstm as L

    def boom(*a, **k):
        raise AssertionError("a kernel wrapper was called")
    for mod, names in ((L, ("lstm_layer_fwd", "lstm_layer_bwd")),
                       (G, ("gru_layer_fwd", "gru_layer_bwd"))):
        for n in names:
            monkeypatch.setattr(mod, n, boom)
    for cls in (prnn.LSTM, prnn.GRU):
        m = cls(8, 32)
        x = torch.randn(2, 5, 8, requires_grad=True)
        _port_bf16(m, x)[0].float().sum().backward()
        m = cls(8, 20)
        m(x)[0].sum().backward()
