"""The port's LSTM against the JAX package: the plain recurrence and its
plain backward against the Pallas kernels (interpret mode), the autograd
seam against autograd through the plain recurrence, and the ``nn.LSTM``
module's outputs and gradients against the JAX ``LSTM`` module with the
same weights (and the same dropout mask). f32 tolerance rtol 1e-5,
atol 1e-6: the sums run in another order."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mlvae_tpu.nn.rnn import LSTM as JaxLSTM
from mlvae_tpu.ops.lstm_pallas import lstm_layer

from mlvae_tpu_torch.convert import from_jax, to_jax
from mlvae_tpu_torch.nn.rnn import LSTM
from mlvae_tpu_torch.ops.lstm import (LSTMRecurrence, lstm_layer_bwd,
                                      lstm_layer_bwd_ref, lstm_layer_fwd,
                                      lstm_layer_ref)

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_layer_ref_matches_pallas_kernel(reverse):
    rs = np.random.RandomState(3)
    gx = (rs.randn(24, 8, 64) * 0.5).astype(np.float32)
    w = (rs.randn(64, 16) * 0.1).astype(np.float32)
    hs_j, c_last_j = lstm_layer(jnp.asarray(gx), jnp.asarray(w), reverse,
                                True)
    hs, cs = lstm_layer_ref(torch.from_numpy(gx), torch.from_numpy(w),
                            reverse)
    np.testing.assert_allclose(hs.numpy(), np.asarray(hs_j), RTOL, ATOL)
    c_last = cs[0] if reverse else cs[-1]
    np.testing.assert_allclose(c_last.numpy(), np.asarray(c_last_j), RTOL,
                               ATOL)
    # on CPU tensors the wrapper is the plain version, bit for bit
    hs_w, cs_w = lstm_layer_fwd(torch.from_numpy(gx), torch.from_numpy(w),
                                reverse)
    assert torch.equal(hs_w, hs) and torch.equal(cs_w, cs)


@pytest.mark.parametrize("in_size,bidirectional", [(12, False), (32, True)])
def test_lstm_module_matches_jax_module(in_size, bidirectional):
    H, B, T = 16, 4, 10
    jmod = JaxLSTM(in_size, H, num_layers=2, bidirectional=bidirectional)
    params = jmod.init(jax.random.PRNGKey(1))
    x = np.random.RandomState(4).randn(B, T, in_size).astype(np.float32)
    out_j, (h_j, c_j) = jmod.apply(params, jnp.asarray(x))

    mod = LSTM(in_size, H, num_layers=2, bidirectional=bidirectional)
    mod.load_state_dict(from_jax(params))
    with torch.no_grad():
        out, (h, c) = mod(torch.from_numpy(x))
    for got, want in ((out, out_j), (h, h_j), (c, c_j)):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), RTOL, ATOL)
    # and the weights carry back unchanged
    back, _ = to_jax(mod.state_dict())
    for k, v in params.items():
        np.testing.assert_array_equal(back[k], np.asarray(v))


def _bwd_problem(seed, T=16, B=8, H=16):
    rs = np.random.RandomState(seed)
    return ((rs.randn(T, B, 4 * H) * 0.5).astype(np.float32),
            (rs.randn(4 * H, H) * 0.1).astype(np.float32),
            rs.randn(T, B, H).astype(np.float32),
            rs.randn(B, H).astype(np.float32))


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_layer_bwd_ref_matches_pallas_kernel(reverse):
    """The plain BPTT against ``jax.vjp`` of the Pallas ``lstm_layer``,
    whose backward is the Pallas backward kernel in interpret mode, with
    random cotangents for every h and for the final cell state."""
    gx, w, dhs, dc_last = _bwd_problem(5)
    _, vjp = jax.vjp(lambda g, ww: lstm_layer(g, ww, reverse, True),
                     jnp.asarray(gx), jnp.asarray(w))
    dgx_j, dw_j = vjp((jnp.asarray(dhs), jnp.asarray(dc_last)))
    t = torch.from_numpy
    hs, cs = lstm_layer_ref(t(gx), t(w), reverse)
    dgx, dw = lstm_layer_bwd_ref(t(gx), t(w), hs, cs, t(dhs), t(dc_last),
                                 reverse)
    np.testing.assert_allclose(dgx.numpy(), np.asarray(dgx_j), RTOL, ATOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_j), RTOL, ATOL)
    # on CPU tensors the wrapper is the plain version, bit for bit
    dgx_w, dw_w = lstm_layer_bwd(t(gx), t(w), hs, cs, t(dhs), t(dc_last),
                                 reverse)
    assert torch.equal(dgx_w, dgx) and torch.equal(dw_w, dw)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_recurrence_matches_autograd_of_plain_version(reverse):
    """``LSTMRecurrence`` (plain forward, plain BPTT on the CPU) against
    autograd through the plain recurrence; an unused final cell state
    gives its backward a None cotangent, taken as zeros."""
    gx, w, dhs, dc_last = _bwd_problem(6)
    grads = []
    for use_seam in (True, False):
        g = torch.from_numpy(gx).requires_grad_()
        ww = torch.from_numpy(w).requires_grad_()
        if use_seam:
            hs, c_last = LSTMRecurrence.apply(g, ww, reverse)
        else:
            hs, cs = lstm_layer_ref(g, ww, reverse)
            c_last = cs[0] if reverse else cs[-1]
        loss = (hs * torch.from_numpy(dhs)).sum() \
            + (c_last * torch.from_numpy(dc_last)).sum()
        grads.append(torch.autograd.grad(loss, (g, ww)))
        if use_seam:
            hs2, _ = LSTMRecurrence.apply(g, ww, reverse)
            dg_h, dw_h = torch.autograd.grad(
                (hs2 * torch.from_numpy(dhs)).sum(), (g, ww))
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), RTOL, ATOL)
    t = torch.from_numpy
    hs, cs = lstm_layer_ref(t(gx), t(w), reverse)
    dgx0, dw0 = lstm_layer_bwd_ref(t(gx), t(w), hs, cs, t(dhs),
                                   torch.zeros_like(cs[0]), reverse)
    assert torch.equal(dg_h, dgx0) and torch.equal(dw_h, dw0)


@pytest.mark.parametrize("in_size,bidirectional,dropout", [
    (12, False, 0.0), (32, True, 0.15)])
def test_lstm_module_gradients_match_jax(in_size, bidirectional, dropout):
    """dX and every weight's and bias's gradient of a 2-layer stack against
    ``jax.grad`` of the JAX module, through the outputs and both final
    states; the bidirectional stack (with a 2H input, as the decoder's
    second layer sees) trains with dropout, its keep-mask replayed."""
    H, B, T = 16, 4, 10
    jmod = JaxLSTM(in_size, H, num_layers=2, bidirectional=bidirectional,
                   dropout=dropout)
    params = jmod.init(jax.random.PRNGKey(2))
    rs = np.random.RandomState(7)
    D = 2 if bidirectional else 1
    x = rs.randn(B, T, in_size).astype(np.float32)
    w_out = rs.randn(B, T, D * H).astype(np.float32)
    w_h = rs.randn(2 * D, B, H).astype(np.float32)
    w_c = rs.randn(2 * D, B, H).astype(np.float32)
    rng = jax.random.PRNGKey(3)
    train = dropout > 0

    def jloss(p, xx):
        out, (h, c) = jmod.apply(p, xx, rng=rng, train=train)
        return (jnp.sum(out * w_out) + jnp.sum(h * w_h)
                + jnp.sum(c * w_c))

    gp_j, gx_j = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))

    mod = LSTM(in_size, H, num_layers=2, bidirectional=bidirectional,
               dropout=dropout)
    mod.load_state_dict(from_jax(params))
    masks = [torch.from_numpy(np.array(jax.random.bernoulli(
        jax.random.fold_in(rng, 0), 1.0 - dropout, s)))
        for s in mod.dropout_shapes(B, T)]
    xt = torch.from_numpy(x).requires_grad_()
    out, (h, c) = mod(xt, train=train, masks=masks)
    t = torch.from_numpy
    ((out * t(w_out)).sum() + (h * t(w_h)).sum()
     + (c * t(w_c)).sum()).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), RTOL, ATOL)
    for name, p in mod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp_j[name]),
                                   RTOL, ATOL, err_msg=name)


def test_lstm_layer_bwd_takes_the_plain_version_only_on_the_cpu():
    """A tensor that lies neither on the CPU nor on a CUDA device is
    refused, never run by the plain version."""
    T, B, H = 4, 2, 16
    meta = dict(device="meta")
    with pytest.raises(ValueError):
        lstm_layer_bwd(torch.empty((T, B, 4 * H), **meta),
                       torch.empty((4 * H, H), **meta),
                       torch.empty((T, B, H), **meta),
                       torch.empty((T, B, H), **meta),
                       torch.empty((T, B, H), **meta),
                       torch.empty((B, H), **meta))
