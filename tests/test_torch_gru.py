"""The port's GRU (K5) against the JAX package: the plain forward and
backward against the Pallas kernels (``gru_pallas._run_fwd`` / ``_run_bwd``
in interpret mode), f32 and bf16, both directions; ``GRURecurrence``
against ``jax.grad`` of ``gru_layer``; ``nn.rnn.GRU`` against the JAX
module with its Pallas dispatch forced on (kernels in interpret mode) and
the port's route pinned to K5 alike (a bf16 layer at this H=32 takes
both packages' scans otherwise: ``tests/test_torch_rnn_scan.py``),
values and gradients; weights carried by ``convert.from_jax``; and the
wrappers' refusal of a tensor that is on neither the CPU nor a card.

Tolerances, with their reasons: f32 rtol 1e-5 / atol 1e-6, and gradients
within 1e-5 of their largest entry, as ``tests/test_gru_pallas.py`` holds
the Pallas kernel against the scan (sums in another order). bf16: the
plain versions round where the Pallas kernels round, but an f32 sum taken
in another order can land on the other side of a bf16 rounding boundary,
and a flipped h_t feeds every later step: hs and hs32 within 4e-3
absolute (one bf16 ulp, 2^-8, at |h| <= 1), gradients within 1e-2 of
their largest entry (a dgh one bf16 ulp off in a sum of B*T terms).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mlvae_tpu.nn.rnn as jrnn
import mlvae_tpu.ops.gru_pallas as gp
from mlvae_tpu.nn.rnn import GRU as JaxGRU

import mlvae_tpu_torch.nn.rnn as prnn
import mlvae_tpu_torch.ops.gru as pg
from mlvae_tpu_torch.convert import from_jax
from mlvae_tpu_torch.nn.rnn import GRU

torch.set_num_threads(2)

F32_TOL = dict(rtol=1e-5, atol=1e-6)
F32_GRAD_RTOL = 1e-5
BF16_ATOL = 4e-3
BF16_GRAD_RTOL = 1e-2
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(_np(a).copy()).to(dtype)


def _rel(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else _np(got)
    want = _np(want)
    scale = float(np.abs(want).max())
    return float(np.abs(got - want).max()) / (scale or 1.0)


def _problem(seed, dtype, T=14, B=8, H=32):
    """gx (T, B, 3H) and w_hh (3H, H) in the stream dtype, b_hh f32, on
    both sides with the same values."""
    jd, td = DTYPES[dtype]
    rs = np.random.RandomState(seed)
    gx = jnp.asarray(rs.randn(T, B, 3 * H) * 0.5, jd)
    w = jnp.asarray(rs.randn(3 * H, H) * 0.1, jd)
    b = jnp.asarray(rs.randn(3 * H) * 0.1, jnp.float32)
    return (gx, w, b), (_t(gx, td), _t(w, td), _t(b))


def _close_hs(got, want, dtype):
    if dtype == "f32":
        np.testing.assert_allclose(got.float().numpy(), _np(want),
                                   **F32_TOL)
    else:
        assert np.abs(got.float().numpy() - _np(want)).max() <= BF16_ATOL


@pytest.mark.parametrize("H", [16, 128])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_forward_matches_pallas(dtype, reverse, H):
    (gx, w, b), (tgx, tw, tb) = _problem(0, dtype, H=H)
    hs_j, hs32_j = gp._run_fwd(gx, w, b, reverse, True)
    hs, hs32 = pg.gru_layer_ref(tgx, tw, tb, reverse)
    assert hs.dtype == DTYPES[dtype][1]
    _close_hs(hs, hs_j, dtype)
    if dtype == "f32":
        assert hs32 is None and hs32_j is None
    else:
        assert hs32.dtype == torch.float32
        _close_hs(hs32, hs32_j, dtype)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_backward_matches_pallas(dtype, reverse):
    """The backward alone: both sides take the Pallas forward's hs (and
    hs32) and the same cotangents."""
    (gx, w, b), (tgx, tw, tb) = _problem(1, dtype, T=12, B=8, H=48)
    jd, td = DTYPES[dtype]
    hs, hs32 = gp._run_fwd(gx, w, b, reverse, True)
    dhs = jnp.asarray(np.random.RandomState(2).randn(*hs.shape) * 0.1, jd)
    dgx_j, dw_j, db_j = gp._run_bwd(gx, hs, hs32, dhs, w, b, reverse, True)
    dgx, dw, db = pg.gru_layer_bwd_ref(
        tgx, tw, tb, _t(hs, td), None if hs32 is None else _t(hs32),
        _t(dhs, td), reverse)
    assert dgx.dtype == td and dw.dtype == db.dtype == torch.float32
    tol = F32_GRAD_RTOL if dtype == "f32" else BF16_GRAD_RTOL
    for got, want in ((dgx, dgx_j), (dw, dw_j.T), (db, db_j.reshape(-1))):
        assert tuple(got.shape) == tuple(want.shape)
        assert _rel(got, want) <= tol


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_recurrence_grads_match_jax_grad(dtype, reverse):
    """``GRURecurrence`` (the plain versions on the CPU) against
    ``jax.grad`` through ``gru_layer`` in interpret mode: the grads leave in
    their inputs' dtypes and W_hh's in torch's (3H, H) layout."""
    (gx, w, b), (tgx, tw, tb) = _problem(3, dtype, T=10, B=8, H=32)
    w_out = np.random.RandomState(4).randn(10, 8, 32).astype(np.float32)

    def f(g, ww, bb):
        hs = gp.gru_layer(g, ww, bb, reverse, True)
        return jnp.sum(hs.astype(jnp.float32) * w_out)

    hs_j = gp.gru_layer(gx, w, b, reverse, True)
    grads_j = jax.grad(f, argnums=(0, 1, 2))(gx, w, b)
    args = [v.clone().requires_grad_() for v in (tgx, tw, tb)]
    hs = pg.GRURecurrence.apply(*args, reverse)
    _close_hs(hs.detach(), hs_j, dtype)
    (hs.float() * torch.from_numpy(w_out)).sum().backward()
    tol = F32_GRAD_RTOL if dtype == "f32" else BF16_GRAD_RTOL
    for a, want in zip(args, grads_j):
        assert a.grad.dtype == a.dtype and a.grad.shape == a.shape
        assert _rel(a.grad, want) <= tol


def _spy_jax_interpret(monkeypatch, calls):
    """Force the JAX module's Pallas dispatch on the CPU and run its GRU
    kernel in interpret mode, recording (gx shape, reverse)."""
    real = gp.gru_layer

    def spy(gx, w_hh, b_hh, reverse=False, interpret=False):
        calls.append((tuple(gx.shape), reverse))
        return real(gx, w_hh, b_hh, reverse, True)

    monkeypatch.setattr(jrnn, "_pallas_eligible", lambda x, H: True)
    monkeypatch.setattr(jrnn, "PALLAS_LSTM_MESH", None)
    monkeypatch.setattr(gp, "gru_layer", spy)


def _spy_port(monkeypatch, calls):
    real = pg.GRURecurrence.apply

    def apply(gx, w_hh, b_hh, reverse):
        calls.append((tuple(gx.shape), reverse))
        return real(gx, w_hh, b_hh, reverse)

    monkeypatch.setattr(pg.GRURecurrence, "apply", apply)


CASES = {  # (layers, bidirectional, dropout, bias)
    "bi_dropout": (2, True, 0.3, True),
    "no_bias": (2, False, 0.0, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gru_module_matches_jax(dtype, case, monkeypatch):
    """``nn.rnn.GRU`` against the JAX module (Pallas dispatch forced on,
    interpret mode): the same recurrence calls, outputs, h_n, dX and every
    weight's gradient, with the JAX dropout mask replayed while
    training."""
    layers, bi, rate, bias = CASES[case]
    jd, td = DTYPES[dtype]
    B, T, In, H = 4, 9, 24, 32
    jmod = JaxGRU(In, H, num_layers=layers, bidirectional=bi, dropout=rate,
                  bias=bias)
    params = jax.tree_util.tree_map(lambda v: v.astype(jd),
                                    jmod.init(jax.random.PRNGKey(1)))
    rs = np.random.RandomState(6)
    x = jnp.asarray(rs.randn(B, T, In) * 0.5, jd)
    D = 2 if bi else 1
    w_out = rs.randn(B, T, D * H).astype(np.float32)
    key = jax.random.PRNGKey(7)
    train = rate > 0

    jcalls, pcalls = [], []
    _spy_jax_interpret(monkeypatch, jcalls)
    _spy_port(monkeypatch, pcalls)
    # both packages on the kernel path: a bf16 layer at H=32 routes to
    # the bf16-carry scan in both (tests/test_torch_rnn_scan.py holds
    # that route); this test holds the module's K5 plumbing
    monkeypatch.setattr(prnn, "gru_route", lambda H, dtype: "k5")

    def f(p, xx):
        out, h_n = jmod.apply(p, xx, rng=key, train=train)
        return jnp.sum(out.astype(jnp.float32) * w_out), (out, h_n)

    (_, (out_j, hn_j)), (gp_j, gx_j) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, x)

    mod = GRU(In, H, num_layers=layers, bidirectional=bi, dropout=rate,
              bias=bias)
    mod.load_state_dict(from_jax(params))
    mod = mod.to(td)
    masks = None
    if train:
        k = jax.random.fold_in(key, 0)   # the JAX module's first stream draw
        masks = [torch.from_numpy(np.array(jax.random.bernoulli(
            k, 1.0 - rate, shape)))
            for shape in mod.dropout_shapes(B, T)]
    xt = _t(x, td).requires_grad_()
    out, h_n = mod(xt, train=train, masks=masks)
    (out.float() * torch.from_numpy(w_out)).sum().backward()

    assert pcalls == jcalls and len(pcalls) == layers * D
    assert out.dtype == h_n.dtype == td
    assert tuple(h_n.shape) == (layers * D, B, H)
    _close_hs(out.detach(), out_j, dtype)
    _close_hs(h_n.detach(), hn_j, dtype)
    tol = F32_GRAD_RTOL if dtype == "f32" else BF16_GRAD_RTOL
    assert _rel(xt.grad, gx_j) <= tol
    names = [n for n, _ in mod.named_parameters()]
    assert sorted(names) == sorted(params)
    for name, p in mod.named_parameters():
        assert _rel(p.grad, gp_j[name]) <= tol, name


@pytest.mark.parametrize("bias", [True, False])
def test_from_jax_carries_gru_weights(bias):
    jmod = JaxGRU(12, 16, num_layers=2, bidirectional=True, bias=bias)
    params = jmod.init(jax.random.PRNGKey(3))
    mod = GRU(12, 16, num_layers=2, bidirectional=True, bias=bias)
    sd = from_jax(params)
    assert set(sd) == set(mod.state_dict())
    assert any("bias" in k for k in sd) == bias
    mod.load_state_dict(sd)
    for name, p in mod.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      np.asarray(params[name]))


def test_gru_wrappers_take_the_plain_version_only_on_the_cpu():
    """A tensor on neither the CPU nor a CUDA device is refused, never run
    by the plain version; on the CPU the wrappers are the plain versions."""
    H = 16
    meta = dict(device="meta")
    gx = torch.empty((4, 2, 3 * H), **meta)
    w = torch.empty((3 * H, H), **meta)
    b = torch.empty((3 * H,), **meta)
    hs = torch.empty((4, 2, H), **meta)
    with pytest.raises(ValueError):
        pg.gru_layer_fwd(gx, w, b)
    with pytest.raises(ValueError):
        pg.gru_layer_bwd(gx, w, b, hs, None, hs)
    (_, _, _), (tgx, tw, tb) = _problem(5, "f32", T=3, B=2, H=H)
    hs, hs32 = pg.gru_layer_fwd(tgx, tw, tb, True)
    assert torch.equal(hs, pg.gru_layer_ref(tgx, tw, tb, True)[0])
    assert hs32 is None
