"""The port's fused-projection LSTM (K3/K4) against the JAX package: the
plain forward and both plain backwards against the Pallas kernels
(``lstm_layer_fused`` / ``lstm_layer_semifused`` in interpret mode), in f32
and bf16, both directions; ``LSTMFused`` / ``LSTMSemiFused`` against
``jax.grad``; the port's tier predicates against the JAX ones; and
``nn.LSTM``'s bf16 dispatch (In padding included) against the JAX module
with its Pallas dispatch forced on.

Tolerances, with their reasons: f32 rtol 1e-5 / atol 1e-6 (sums in another
order). bf16: the plain versions round where the Pallas kernels round, but
a sum taken in another order can land on the other side of a bf16 rounding
boundary: values within 4e-3 absolute (one bf16 ulp, 2^-8, at |h| <= 1)
and grads within 4e-3 of their largest entry; the losses of the module
tests within 1e-2 relative, where a flipped h_t feeds every later step and
layer.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mlvae_tpu.nn.rnn as jrnn
import mlvae_tpu.ops.lstm_pallas as lp
from mlvae_tpu.nn.rnn import LSTM as JaxLSTM

import mlvae_tpu_torch.nn.rnn as prnn
import mlvae_tpu_torch.ops.lstm as pl
from mlvae_tpu_torch.convert import from_jax
from mlvae_tpu_torch.nn.rnn import LSTM

torch.set_num_threads(2)

F32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_ATOL = 4e-3       # absolute, values of order 1 (see the module header)
BF16_GRAD_RTOL = 4e-3  # of the largest entry
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, T=14, B=8, In=64, H=32):
    rs = np.random.RandomState(seed)
    return ((rs.randn(T, B, In) * 0.5).astype(np.float32),
            (rs.randn(4 * H, In) * 0.1).astype(np.float32),
            (rs.randn(4 * H) * 0.1).astype(np.float32),
            (rs.randn(4 * H, H) * 0.1).astype(np.float32))


def _both(arrs, dtype):
    """(JAX arrays, torch tensors) of x, w_ih, bias, w_hh: x and the
    weights in ``dtype``, the bias f32, the same values on both sides."""
    jd, td = DTYPES[dtype]
    x, wi, b, wh = arrs
    j = (jnp.asarray(x, jd), jnp.asarray(wi, jd), jnp.asarray(b),
         jnp.asarray(wh, jd))
    t = tuple(torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        td if i != 2 else torch.float32) for i, v in enumerate(j))
    return j, t


def _np(v):
    return np.array(jnp.asarray(v, jnp.float32)) if not isinstance(
        v, torch.Tensor) else v.float().numpy()


def _close(got, want, dtype, err_msg=""):
    if dtype == "f32":
        np.testing.assert_allclose(_np(got), _np(want), err_msg=err_msg,
                                   **F32_TOL)
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                   atol=BF16_ATOL, err_msg=err_msg)


def _grad_close(got, want, dtype, err_msg=""):
    g, w = _np(got), _np(want)
    if dtype == "f32":
        np.testing.assert_allclose(g, w, err_msg=err_msg, **F32_TOL)
    else:
        scale = max(np.abs(w).max(), 1e-8)
        assert np.abs(g - w).max() / scale < BF16_GRAD_RTOL, \
            (err_msg, np.abs(g - w).max() / scale)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("reverse", [False, True])
def test_fused_fwd_ref_matches_pallas_kernel(dtype, reverse):
    (jx, jwi, jb, jwh), (x, wi, b, wh) = _both(_inputs(1), dtype)
    hs_j, c_j = lp.lstm_layer_fused(jx, jwi, jb, jwh, reverse, True)
    hs, cs = pl.lstm_fused_fwd_ref(x, wi, b, wh, reverse)
    assert hs.dtype == x.dtype and cs.dtype == torch.float32
    _close(hs, hs_j, dtype, "hs")
    _close(cs[0] if reverse else cs[-1], c_j, dtype, "c_last")
    # on CPU tensors the wrapper is the plain version, bit for bit
    hs_w, cs_w = pl.lstm_fused_fwd(x, wi, b, wh, reverse)
    assert torch.equal(hs_w, hs) and torch.equal(cs_w, cs)


def _cotangents(seed, T, B, H, dtype):
    rs = np.random.RandomState(seed)
    jd, td = DTYPES[dtype]
    dhs = jnp.asarray(rs.randn(T, B, H) * 0.5, jd)
    dc = jnp.asarray(rs.randn(B, H) * 0.5, jnp.float32)
    return (dhs, dc), (torch.from_numpy(_np(dhs)).to(td),
                       torch.from_numpy(_np(dc)))


@pytest.mark.parametrize("T", [1, 2, 14])
@pytest.mark.parametrize("semi", [False, True], ids=["K3", "K4"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("reverse", [False, True])
def test_fused_bwd_refs_match_pallas_kernels(semi, dtype, reverse, T):
    """The plain K3-bwd (dX, dW_ih, db, dW_hh) and the plain K4-bwd with
    ``semi_input_grads`` against ``jax.vjp`` of the Pallas layer, whose
    backward is the Pallas backward kernel in interpret mode, with random
    cotangents for every h and for the final cell state. T=1 and T=2 are
    where the CUDA kernels' prologue and last step meet."""
    (jx, jwi, jb, jwh), (x, wi, b, wh) = _both(_inputs(2, T=T), dtype)
    T, B, _ = x.shape
    H = wh.shape[1]
    kernel = lp.lstm_layer_semifused if semi else lp.lstm_layer_fused
    _, vjp = jax.vjp(lambda *a: kernel(*a, reverse, True), jx, jwi, jb, jwh)
    (jdhs, jdc), (dhs, dc) = _cotangents(3, T, B, H, dtype)
    want = vjp((jdhs, jdc))
    hs, cs = pl.lstm_fused_fwd_ref(x, wi, b, wh, reverse)
    args = (x, wi, b, wh, hs, cs, dhs, dc, reverse)
    if semi:
        dgx, dwhh = pl.lstm_semi_bwd_ref(*args)
        assert dgx.shape == (T, B, 4 * H) and dgx.dtype == x.dtype
        got = (*pl.semi_input_grads(x, wi, dgx), dwhh)
        assert torch.equal(pl.lstm_semi_bwd(*args)[0], dgx)
    else:
        got = pl.lstm_fused_bwd_ref(*args)
        assert all(torch.equal(a, c) for a, c in
                   zip(pl.lstm_fused_bwd(*args), got))
    assert got[0].dtype == x.dtype
    # K3-bwd's dW_ih leaves f32; semi_input_grads' leaves its one GEMM in
    # the stream dtype, as the JAX package's einsum rounds it
    assert got[1].dtype == (x.dtype if semi else torch.float32)
    assert got[2].dtype == got[3].dtype == torch.float32
    # the weights' grads leave in the weights' dtype, as the Pallas ones do
    got = (got[0], got[1].to(wi.dtype), got[2], got[3].to(wh.dtype))
    for name, g, w in zip(("dx", "dw_ih", "db", "dw_hh"), got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        _grad_close(g, w, dtype, name)


@pytest.mark.parametrize("fn", ["LSTMFused", "LSTMSemiFused"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_autograd_functions_match_jax_grad(fn, dtype):
    """Values and all four cotangents through the port's autograd
    functions against ``jax.grad`` through the Pallas layers, a loss that
    reads every h and the final cell state, both directions."""
    kernel = {"LSTMFused": lp.lstm_layer_fused,
              "LSTMSemiFused": lp.lstm_layer_semifused}[fn]
    rs = np.random.RandomState(5)
    T, B, H = 14, 8, 32
    w_h = rs.randn(T, B, H).astype(np.float32)
    w_c = rs.randn(B, H).astype(np.float32)
    for reverse in (False, True):
        (jx, jwi, jb, jwh), ts = _both(_inputs(4), dtype)

        def jloss(*a):
            hs, c = kernel(*a, reverse, True)
            return (jnp.sum(hs.astype(jnp.float32) * w_h)
                    + jnp.sum(c * w_c))

        v_j, g_j = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3))(
            jx, jwi, jb, jwh)
        leaves = [t.clone().requires_grad_() for t in ts]
        hs, c = getattr(pl, fn).apply(*leaves, reverse)
        loss = (hs.float() * torch.from_numpy(w_h)).sum() \
            + (c * torch.from_numpy(w_c)).sum()
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(v_j),
                                   rtol=1e-5 if dtype == "f32" else 1e-2)
        for name, leaf, want in zip(("dx", "dw_ih", "db", "dw_hh"), leaves,
                                    g_j):
            assert leaf.grad.dtype == leaf.dtype, name
            _grad_close(leaf.grad, want, dtype, f"{name} reverse={reverse}")


@pytest.mark.parametrize("In", [120, 32, 128, 512, 1024])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_tier_predicates_match_jax(In, dtype):
    """At the MD_VAE widths (H=512; the fbank's 120 and the latent's 32
    padded to 128) the port picks the JAX package's tier for each layer."""
    jd, td = DTYPES[dtype]
    In_pad = -(-In // 128) * 128
    H = 512
    assert pl.fused_eligible(In_pad, H, td) == lp.fused_eligible(
        In_pad, H, jd)
    assert pl.semifused_eligible(In_pad, H, td) == lp.semifused_eligible(
        In_pad, H, jd)
    assert pl.fused_eligible(In, H, td) == lp.fused_eligible(In, H, jd)
    if dtype == "bf16":
        want = (pl.LSTMSemiFused if In == 1024 else pl.LSTMFused)
        assert prnn.fused_tier(In, H, td) is want
    else:
        assert prnn.fused_tier(In, H, td) is None


def _spy_jax_interpret(monkeypatch, calls):
    """Force the JAX module's Pallas dispatch on the CPU and run its fused
    kernels in interpret mode, recording (tier, x shape, reverse)."""
    real = {"fused": lp.lstm_layer_fused, "semi": lp.lstm_layer_semifused}

    def spy(name):
        def f(x, w_ih, bias, w_hh, reverse=False, interpret=False):
            calls.append((name, tuple(x.shape), reverse))
            return real[name](x, w_ih, bias, w_hh, reverse, True)
        return f

    monkeypatch.setattr(jrnn, "_pallas_eligible", lambda x, H: True)
    monkeypatch.setattr(jrnn, "PALLAS_LSTM_MESH", None)
    monkeypatch.setattr(lp, "lstm_layer_fused", spy("fused"))
    monkeypatch.setattr(lp, "lstm_layer_semifused", spy("semi"))


def _spy_port(monkeypatch, calls):
    """Record (function, first input's shape, reverse) of every
    ``apply`` of the port's LSTM autograd functions."""
    for name in ("LSTMRecurrence", "LSTMFused", "LSTMSemiFused"):
        cls = getattr(prnn, name)

        def apply(*a, _orig=cls.apply, _name=name):
            calls.append((_name, tuple(a[0].shape), a[-1]))
            return _orig(*a)

        monkeypatch.setattr(cls, "apply", apply)


@pytest.mark.parametrize("case", ["pad120", "bi_semi"])
def test_lstm_module_bf16_dispatch_matches_jax(case, monkeypatch):
    """``nn.LSTM`` on a bf16 stream against the JAX module with its Pallas
    dispatch forced on (kernels in interpret mode): the same tier for each
    layer direction, outputs, dX and every weight's gradient, W_ih's of
    its unpadded shape. ``pad120``: one layer of In=120, padded to 128.
    ``bi_semi``: the decoder's shape at H=128, a 2-layer bidirectional
    stack over a 32-wide latent, with both packages' budgets lowered alike
    so that the second layer's In=2H takes the semi-fused tier, as the
    decoder's In=1024 layer does at H=512."""
    H, B, T = 128, 4, 10
    if case == "pad120":
        in_size, layers, bi = 120, 1, False
    else:
        in_size, layers, bi = 32, 2, True
        budget = 1_000_000  # (256+128)*4H*6 B over it, *2 + 4H*H*4 under
        monkeypatch.setattr(lp, "FUSED_RESIDENT_BUDGET", budget)
        monkeypatch.setattr(pl, "FUSED_RESIDENT_BUDGET", budget)
    jmod = JaxLSTM(in_size, H, num_layers=layers, bidirectional=bi)
    params = jax.tree_util.tree_map(lambda v: v.astype(jnp.bfloat16),
                                    jmod.init(jax.random.PRNGKey(1)))
    rs = np.random.RandomState(6)
    x = jnp.asarray(rs.randn(B, T, in_size) * 0.5, jnp.bfloat16)
    D = 2 if bi else 1
    w_out = rs.randn(B, T, D * H).astype(np.float32)

    jcalls, pcalls = [], []
    _spy_jax_interpret(monkeypatch, jcalls)

    def jloss(p, xx):
        out, _ = jmod.apply(p, xx)
        return jnp.sum(out.astype(jnp.float32) * w_out)

    v_j, (gp_j, gx_j) = jax.value_and_grad(jloss, argnums=(0, 1))(params, x)

    _spy_port(monkeypatch, pcalls)
    mod = LSTM(in_size, H, num_layers=layers, bidirectional=bi)
    mod.load_state_dict(from_jax(jax.tree_util.tree_map(
        lambda v: v.astype(jnp.float32), params)))
    mod = mod.to(torch.bfloat16)
    xt = torch.from_numpy(_np(x)).to(torch.bfloat16).requires_grad_()
    out, _ = mod(xt)
    assert out.dtype == torch.bfloat16
    loss = (out.float() * torch.from_numpy(w_out)).sum()
    loss.backward()

    tiers = {"fused": "LSTMFused", "semi": "LSTMSemiFused"}
    assert [(tiers[n], s, r) for n, s, r in jcalls] == pcalls
    if case == "pad120":
        assert pcalls == [("LSTMFused", (T, B, 128), False)]
    else:
        assert [n for n, _, _ in pcalls] == ["LSTMFused"] * 2 \
            + ["LSTMSemiFused"] * 2
    np.testing.assert_allclose(float(loss.detach()), float(v_j), rtol=1e-2)
    _grad_close(xt.grad, gx_j, "bf16", "dx")
    for name, p in mod.named_parameters():
        assert tuple(p.grad.shape) == tuple(gp_j[name].shape), name
        _grad_close(p.grad, gp_j[name], "bf16", name)


def test_lstm_module_f32_keeps_k1(monkeypatch):
    """An f32 stream never takes a fused tier, whatever its widths."""
    calls = []
    _spy_port(monkeypatch, calls)
    mod = LSTM(128, 128, num_layers=2, bidirectional=True)
    with torch.no_grad():
        mod(torch.randn(2, 5, 128))
    assert [n for n, _, _ in calls] == ["LSTMRecurrence"] * 4


def test_bf16_layer_outside_both_tiers_is_refused(monkeypatch):
    """Such a layer (H=16, no fused tier, no bf16 K1 build) is no longer
    refused: it runs ``lstm_scan``, the JAX package's bf16-carry scan,
    and no kernel wrapper."""
    import mlvae_tpu_torch.nn.rnn as prnn
    calls = []
    real = prnn.lstm_scan
    monkeypatch.setattr(prnn, "lstm_scan",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    monkeypatch.setattr(pl, "lstm_layer_fwd", lambda *a: pytest.fail(
        "a bf16 layer at H=16 reached K1"))
    mod = LSTM(12, 16).to(torch.bfloat16)
    out, (h_n, c_n) = mod(torch.randn(2, 5, 12, dtype=torch.bfloat16))
    assert out.dtype == h_n.dtype == c_n.dtype == torch.bfloat16
    assert out.shape == (2, 5, 16) and calls == [(5, 2, 64)]


def test_fused_wrappers_take_the_plain_version_only_on_the_cpu():
    """A tensor that lies neither on the CPU nor on a CUDA device is
    refused, never run by the plain version."""
    T, B, In, H = 4, 2, 16, 16
    m = dict(device="meta", dtype=torch.bfloat16)
    x, wi, wh = (torch.empty((T, B, In), **m), torch.empty((4 * H, In), **m),
                 torch.empty((4 * H, H), **m))
    b = torch.empty((4 * H,), device="meta")
    with pytest.raises(ValueError):
        pl.lstm_fused_fwd(x, wi, b, wh)
    cs = torch.empty((T, B, H), device="meta")
    for fn in (pl.lstm_fused_bwd, pl.lstm_semi_bwd):
        with pytest.raises(ValueError):
            fn(x, wi, b, wh, torch.empty((T, B, H), **m), cs,
               torch.empty((T, B, H), **m), torch.empty((B, H),
                                                        device="meta"))


@pytest.mark.parametrize("name", ["lstm_fused_fwd", "lstm_fused_bwd",
                                  "lstm_semi_bwd"])
def test_fused_wrappers_refuse_h_above_528_before_the_device(name):
    """A bf16 layer at H=640 fits the fused tiers' budget (``fused_tier``
    sends In=128 to ``LSTMFused`` and In=640 to ``LSTMSemiFused``), but the
    fused kernels keep H/4 blocks resident, 132 at most on an H100: the
    wrappers refuse it naming ROADMAP queue 2 before they look at the
    device, and H=528, the widest grid that fits, reaches the device
    check."""
    from mlvae_tpu_torch.nn.rnn import fused_tier
    assert fused_tier(128, 640, torch.bfloat16) is pl.LSTMFused
    assert fused_tier(640, 640, torch.bfloat16) is pl.LSTMSemiFused
    fn = getattr(pl, name)

    def call(H):
        T, B, In = 3, 2, 128
        m = dict(device="meta", dtype=torch.bfloat16)
        args = (torch.empty((T, B, In), **m), torch.empty((4 * H, In), **m),
                torch.empty((4 * H,), device="meta"),
                torch.empty((4 * H, H), **m))
        if name != "lstm_fused_fwd":
            args += (torch.empty((T, B, H), **m),
                     torch.empty((T, B, H), device="meta"),
                     torch.empty((T, B, H), **m),
                     torch.empty((B, H), device="meta"))
        return fn(*args)

    for H in (544, 640, 1024):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP.md queue 2, 'Still to port'"):
            call(H)
    with pytest.raises(ValueError, match="CUDA device"):
        call(528)
