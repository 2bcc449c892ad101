"""The port's ``nn.rnn.LSTM`` constructor against the JAX ``LSTM``'s:
``batch_first`` and ``bias`` in the JAX module's keyword order, no bias
parameters with ``bias=False`` (so that ``from_jax`` of a bias-less JAX
LSTM loads strictly), and ``batch_first=False`` refused in ``forward``.

Tolerances, with their reasons: f32 rtol 1e-5 / atol 1e-6 (sums in another
order). bf16, through the fused tier with the JAX module's Pallas dispatch
forced on (kernels in interpret mode): 4e-3 absolute, one bf16 ulp at
|h| <= 1, since an f32 sum taken in another order can land on the other
side of a bf16 rounding boundary and a flipped h_t feeds every later step.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mlvae_tpu.nn.rnn as jrnn
import mlvae_tpu.ops.lstm_pallas as lp
from mlvae_tpu.nn.rnn import LSTM as JaxLSTM

from mlvae_tpu_torch.convert import from_jax
from mlvae_tpu_torch.nn.rnn import LSTM

torch.set_num_threads(2)

F32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_ATOL = 4e-3


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().float().numpy()
    return np.array(jnp.asarray(v, jnp.float32))


def _pair(in_size, H, bias, seed=0):
    """A 2-layer bidirectional JAX LSTM and the port's, the JAX weights
    carried across with a strict ``load_state_dict``."""
    jmod = JaxLSTM(in_size, H, num_layers=2, batch_first=True,
                   bidirectional=True, bias=bias)
    params = jmod.init(jax.random.PRNGKey(seed))
    mod = LSTM(in_size, H, num_layers=2, batch_first=True,
               bidirectional=True, bias=bias)
    mod.load_state_dict(from_jax(params), strict=True)
    return jmod, params, mod


@pytest.mark.parametrize("bias", [True, False])
def test_lstm_args_f32_match_jax(bias):
    jmod, params, mod = _pair(12, 16, bias)
    assert any("bias" in k for k in mod.state_dict()) == bias
    x = np.random.RandomState(1).randn(3, 9, 12).astype(np.float32)
    out_j, (h_j, c_j) = jmod.apply(params, jnp.asarray(x))
    with torch.no_grad():
        out, (h_n, c_n) = mod(torch.from_numpy(x))
    for name, got, want in (("out", out, out_j), ("h_n", h_n, h_j),
                            ("c_n", c_n, c_j)):
        assert tuple(got.shape) == tuple(want.shape), name
        np.testing.assert_allclose(_np(got), _np(want), err_msg=name,
                                   **F32_TOL)


def test_lstm_without_bias_matches_jax_through_the_fused_tier(monkeypatch):
    """bf16, H=128: both packages take the fused tier (K3) for both layers,
    the JAX one with its Pallas dispatch forced on and its kernel in
    interpret mode, each with a zero f32 bias."""
    real = lp.lstm_layer_fused
    calls = []

    def spy(x, w_ih, bias, w_hh, reverse=False, interpret=False):
        calls.append((tuple(x.shape), reverse))
        return real(x, w_ih, bias, w_hh, reverse, True)

    monkeypatch.setattr(jrnn, "_pallas_eligible", lambda x, H: True)
    monkeypatch.setattr(jrnn, "PALLAS_LSTM_MESH", None)
    monkeypatch.setattr(lp, "lstm_layer_fused", spy)

    H, B, T, In = 128, 4, 10, 32
    jmod, params, mod = _pair(In, H, bias=False, seed=2)
    params = jax.tree_util.tree_map(lambda v: v.astype(jnp.bfloat16), params)
    mod.load_state_dict(from_jax(jax.tree_util.tree_map(
        lambda v: v.astype(jnp.float32), params)), strict=True)
    mod = mod.to(torch.bfloat16)
    x = jnp.asarray(np.random.RandomState(3).randn(B, T, In) * 0.5,
                    jnp.bfloat16)
    out_j, (h_j, c_j) = jmod.apply(params, x)
    assert len(calls) == 4
    with torch.no_grad():
        out, (h_n, c_n) = mod(torch.from_numpy(_np(x)).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    for name, got, want in (("out", out, out_j), ("h_n", h_n, h_j),
                            ("c_n", c_n, c_j)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                   atol=BF16_ATOL, err_msg=name)


def test_lstm_refuses_batch_first_false_in_forward():
    mod = LSTM(6, 8, batch_first=False, bias=False)
    assert not any("bias" in k for k in mod.state_dict())
    with pytest.raises(ValueError, match="batch_first"):
        mod(torch.randn(2, 3, 6))


def test_lstm_keyword_order_is_the_jax_modules():
    """Positional arguments land where the JAX module puts them."""
    mod = LSTM(6, 8, 2, True, 0.25, True, False)
    jmod = JaxLSTM(6, 8, 2, True, 0.25, True, False)
    for attr in ("num_layers", "batch_first", "dropout", "bidirectional",
                 "bias"):
        assert getattr(mod, attr) == getattr(jmod, attr), attr
