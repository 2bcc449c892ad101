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
layer. A bf16 layer on K1 (``MLVAE_PALLAS_FUSED=0``) takes its bias grads
from a bf16 gx, which XLA sums over B*T in bf16 with more than one
rounding: within 2e-2 of their largest entry, as in
``tests/test_torch_lstm_bf16.py``.
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
K1_BIAS_RTOL = 2e-2    # a bf16 K1 layer's bias grads (see the module header)
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


SWITCHES = ["auto", True, False]   # MLVAE_PALLAS_FUSED unset, =1, =0


def _set_switch(monkeypatch, switch):
    """``MLVAE_PALLAS_FUSED`` as both packages read it at import, set alike
    in the JAX module and the port."""
    monkeypatch.setattr(jrnn, "PALLAS_LSTM_FUSED", switch)
    monkeypatch.setattr(prnn, "PALLAS_LSTM_FUSED", switch)


@pytest.mark.parametrize("switch", SWITCHES, ids=["auto", "on", "off"])
@pytest.mark.parametrize("In", [120, 32, 128, 512, 1024])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_tier_predicates_match_jax(In, dtype, switch, monkeypatch):
    """At the MD_VAE widths (H=512; the fbank's 120 and the latent's 32
    padded to 128) the port picks the JAX package's tier for each layer,
    under each value of the switch: by default bf16 only (In=1024 K4, the
    rest K3), with ``1`` also f32 (In 32-128 K3, 512 K4, 1024 neither: the
    f32 budgets), with ``0`` neither dtype."""
    _set_switch(monkeypatch, switch)
    jd, td = DTYPES[dtype]
    In_pad = -(-In // 128) * 128
    H = 512
    assert pl.fused_eligible(In_pad, H, td) == lp.fused_eligible(
        In_pad, H, jd)
    assert pl.semifused_eligible(In_pad, H, td) == lp.semifused_eligible(
        In_pad, H, jd)
    assert pl.fused_eligible(In, H, td) == lp.fused_eligible(In, H, jd)
    want = None
    if jrnn._fused_requested(jd):
        if lp.fused_eligible(In_pad, H, jd):
            want = pl.LSTMFused
        elif lp.semifused_eligible(In_pad, H, jd):
            want = pl.LSTMSemiFused
    assert prnn._fused_requested(td) == jrnn._fused_requested(jd)
    assert prnn.fused_tier(In, H, td) is want
    table = {("bf16", "auto"): {1024: pl.LSTMSemiFused},
             ("bf16", True): {1024: pl.LSTMSemiFused},
             ("f32", True): {512: pl.LSTMSemiFused, 1024: None}}
    expect = table.get((dtype, switch))
    assert want is (None if expect is None else expect.get(In, pl.LSTMFused))


def _spy_jax_interpret(monkeypatch, calls):
    """Force the JAX module's Pallas dispatch on the CPU and run its
    kernels in interpret mode, the fused ones and K1 (``lstm_layer``),
    recording (tier, input shape, reverse)."""
    real = {"fused": lp.lstm_layer_fused, "semi": lp.lstm_layer_semifused}
    real_k1 = lp.lstm_layer

    def spy(name):
        def f(x, w_ih, bias, w_hh, reverse=False, interpret=False):
            calls.append((name, tuple(x.shape), reverse))
            return real[name](x, w_ih, bias, w_hh, reverse, True)
        return f

    def k1(gates_x, w_hh, reverse=False, interpret=False):
        calls.append(("k1", tuple(gates_x.shape), reverse))
        return real_k1(gates_x, w_hh, reverse, True)

    monkeypatch.setattr(jrnn, "_pallas_eligible", lambda x, H: True)
    monkeypatch.setattr(jrnn, "PALLAS_LSTM_MESH", None)
    monkeypatch.setattr(lp, "lstm_layer_fused", spy("fused"))
    monkeypatch.setattr(lp, "lstm_layer_semifused", spy("semi"))
    monkeypatch.setattr(lp, "lstm_layer", k1)


def _spy_port(monkeypatch, calls):
    """Record (function, first input's shape, reverse) of every
    ``apply`` of the port's LSTM autograd functions."""
    for name in ("LSTMRecurrence", "LSTMFused", "LSTMSemiFused"):
        cls = getattr(prnn, name)

        def apply(*a, _orig=cls.apply, _name=name):
            calls.append((_name, tuple(a[0].shape), a[-1]))
            return _orig(*a)

        monkeypatch.setattr(cls, "apply", apply)


def _module_case(case, dtype):
    """(in_size, layers, bidirectional, the fused budget or None)."""
    if case == "pad120":
        return 120, 1, False, None
    # bf16: (256+128)*4H*6 B over 1e6, *2 + 4H*H*4 under; f32 the same at
    # *8 and *4 + 4H*H*4 against 1.3e6
    return 32, 2, True, 1_000_000 if dtype == "bf16" else 1_300_000


_JAX_MODULE_RUNS = {}


def _jax_module_run(case, dtype, fused, monkeypatch):
    """The JAX module's loss, parameter and input grads and its kernel
    calls (dispatch forced, kernels in interpret mode) for ``case`` on a
    ``dtype`` stream, the fused tiers requested or not: computed once per
    (case, dtype, fused) in a process, since the switch reaches the JAX
    module only through ``_fused_requested``."""
    key = (case, dtype, fused)
    if key not in _JAX_MODULE_RUNS:
        jd, _ = DTYPES[dtype]
        in_size, layers, bi, _ = _module_case(case, dtype)
        jmod = JaxLSTM(in_size, 128, num_layers=layers, bidirectional=bi)
        params = jax.tree_util.tree_map(lambda v: v.astype(jd),
                                        jmod.init(jax.random.PRNGKey(1)))
        rs = np.random.RandomState(6)
        x = jnp.asarray(rs.randn(4, 10, in_size) * 0.5, jd)
        w_out = rs.randn(4, 10, (2 if bi else 1) * 128).astype(np.float32)
        jcalls = []
        with monkeypatch.context() as mp:
            _spy_jax_interpret(mp, jcalls)

            def jloss(p, xx):
                out, _ = jmod.apply(p, xx)
                return jnp.sum(out.astype(jnp.float32) * w_out)

            v_j, (gp_j, gx_j) = jax.value_and_grad(
                jloss, argnums=(0, 1))(params, x)
        _JAX_MODULE_RUNS[key] = (params, x, w_out, v_j, gp_j, gx_j, jcalls)
    return _JAX_MODULE_RUNS[key]


@pytest.mark.parametrize("switch", SWITCHES, ids=["auto", "on", "off"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["pad120", "bi_semi"])
def test_lstm_module_bf16_dispatch_matches_jax(case, dtype, switch,
                                               monkeypatch):
    """``nn.LSTM`` on a ``dtype`` stream against the JAX module with its
    Pallas dispatch forced on (kernels in interpret mode, K1 too), under
    each value of ``MLVAE_PALLAS_FUSED`` set alike in both: the same
    kernel for each layer direction, outputs, dX and every weight's
    gradient, W_ih's of its unpadded shape. ``pad120``: one layer of
    In=120, padded to 128 where it takes a fused tier. ``bi_semi``: the
    decoder's shape at H=128, a 2-layer bidirectional stack over a 32-wide
    latent, with both packages' budgets lowered alike so that the second
    layer's In=2H takes the semi-fused tier where the switch sends its
    dtype there, as the decoder's In=1024 layer does at H=512 in bf16 (in
    f32 the budget is set so that the first layer takes K3 and the second
    K4)."""
    _set_switch(monkeypatch, switch)
    jd, td = DTYPES[dtype]
    H, B, T = 128, 4, 10
    in_size, layers, bi, budget = _module_case(case, dtype)
    if budget:
        monkeypatch.setattr(lp, "FUSED_RESIDENT_BUDGET", budget)
        monkeypatch.setattr(pl, "FUSED_RESIDENT_BUDGET", budget)
    fused = switch is True or (switch == "auto" and dtype == "bf16")
    assert jrnn._fused_requested(jd) == fused
    params, x, w_out, v_j, gp_j, gx_j, jcalls = _jax_module_run(
        case, dtype, fused, monkeypatch)

    pcalls = []
    _spy_port(monkeypatch, pcalls)
    mod = LSTM(in_size, H, num_layers=layers, bidirectional=bi)
    mod.load_state_dict(from_jax(jax.tree_util.tree_map(
        lambda v: v.astype(jnp.float32), params)))
    mod = mod.to(td)
    xt = torch.from_numpy(_np(x)).to(td).requires_grad_()
    out, _ = mod(xt)
    assert out.dtype == td
    loss = (out.float() * torch.from_numpy(w_out)).sum()
    loss.backward()

    tiers = {"fused": "LSTMFused", "semi": "LSTMSemiFused",
             "k1": "LSTMRecurrence"}
    assert [(tiers[n], s, r) for n, s, r in jcalls] == pcalls
    if case == "pad120":
        assert pcalls == ([("LSTMFused", (T, B, 128), False)] if fused
                          else [("LSTMRecurrence", (T, B, 4 * H), False)])
    else:
        assert [n for n, _, _ in pcalls] == (
            ["LSTMFused"] * 2 + ["LSTMSemiFused"] * 2 if fused
            else ["LSTMRecurrence"] * 4)
    np.testing.assert_allclose(float(loss.detach()), float(v_j),
                               rtol=1e-5 if dtype == "f32" else 1e-2)
    _grad_close(xt.grad, gx_j, dtype, "dx")
    for name, p in mod.named_parameters():
        assert tuple(p.grad.shape) == tuple(gp_j[name].shape), name
        if dtype == "bf16" and not fused and name.startswith("bias"):
            # K1's bf16 gx: XLA sums a bias's grad over B*T in bf16 with
            # more than one rounding (tests/test_torch_lstm_bf16.py)
            g, w = _np(p.grad), _np(gp_j[name])
            assert np.abs(g - w).max() / np.abs(w).max() < K1_BIAS_RTOL, name
            continue
        _grad_close(p.grad, gp_j[name], dtype, name)


def test_lstm_module_f32_keeps_k1(monkeypatch):
    """By default (``MLVAE_PALLAS_FUSED`` unset) an f32 stream never takes a
    fused tier, whatever its widths."""
    _set_switch(monkeypatch, "auto")
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


def _meta_bwd_args(T, B, In, H, dtype=torch.float32):
    m = dict(device="meta", dtype=dtype)
    return (torch.empty((T, B, In), **m), torch.empty((4 * H, In), **m),
            torch.empty((4 * H,), device="meta"),
            torch.empty((4 * H, H), **m), torch.empty((T, B, H), **m),
            torch.empty((T, B, H), device="meta"),
            torch.empty((T, B, H), **m), torch.empty((B, H), device="meta"))


@pytest.mark.parametrize("H", [128, 256, 384, 512])
def test_f32_tiers_fit_the_f32_builds(H):
    """Every layer the f32 budgets admit (In a multiple of 128, the width
    ``fused_tier`` pads to) fits the f32 builds' shared memory, and K3's
    dX columns (In at most 4H) unless the wrapper refuses the layer before
    the device, naming ROADMAP queue 2 (K3 at H=128 and In 640-3200, at
    H=256 and In 1152-1408, which the bf16 build refuses alike); the
    recipes' f32 layers (H=512, In 128 to 640 padded) all fit. The forward
    (``fused_f32_fwd_plan``) fits at B 1, 64 and 256 with the producer a
    step ahead."""
    refused = []
    for In in range(128, 8193, 128):
        if pl.fused_eligible(In, H, torch.float32):
            kinds = ("fwd", "bwd")
        elif pl.semifused_eligible(In, H, torch.float32):
            kinds = ("fwd", "semi")
        else:
            continue
        if "bwd" in kinds and In > 4 * H:
            refused.append(In)
            with pytest.raises(NotImplementedError,
                               match="ROADMAP.md queue 2, item 1"):
                pl.lstm_fused_bwd(*_meta_bwd_args(3, 2, In, H))
            continue
        for kind in kinds[1:]:
            assert pl.fused_f32_smem(kind, In, H) <= pl.SMEM_LIMIT, \
                (kind, In, H)
        for B in (1, 64, 256):
            plan = pl.fused_f32_fwd_plan(In, H, B)
            assert plan.smem <= pl.SMEM_LIMIT, (In, H, B)
            assert plan.schedule == pl.F32_FWD_AHEAD, (In, H, B)
    assert refused == {128: list(range(640, 3201, 128)),
                       256: [1152, 1280, 1408]}.get(H, [])
    # the split-K layout: 16 h boxes of 64 x 32, x slots of a box and W_ih's
    # 16 rows of its 32 columns (K3 In=128 four, K4 its ring of four),
    # W_hh's 16 rows, the split-K sums (4 x 64 x 16) and the dgates (64 x
    # 16), f32, and an mbarrier a box and slot
    for kind, In in (("bwd", 128), ("semi", 512), ("semi", 640)):
        assert pl.fused_f32_smem(kind, In, 512) == 4 * (
            16 * 64 * 32 + 4 * (64 * 32 + 16 * 32) + 16 * 512 + 4096
            + 1024) + 8 * (16 + 4) == 225440
    # K3 at In=256, H=512: its eight x boxes do not fit beside the h tile,
    # so it keeps the exchange schedule's layout (the forward's with dW
    # and a tile's dgates); and K3 past 768 columns of [x | h]
    assert pl.fused_f32_smem("bwd", 256, 512) == 4 * (
        16 * 516 + 4096 + 2 * (64 * 132 + 2560) + 16 * 768 + 1024)
    assert pl.fused_f32_smem("bwd", 640, 256) == 4 * (
        16 * 260 + 4096 + 2 * (64 * 132 + 2560) + 16 * 896 + 1024)


@pytest.mark.parametrize("K", [1, 2, 4, 8])
def test_f32_fwd_plan_at_the_recipes_shapes(K):
    """The f32 K3/K4-fwd (K 1) and K7b layouts (``fused_f32_fwd_plan``, the
    mirror of ``plan_of`` in ``csrc/lstm_fused_fwd_f32.cu``; ``chip_smoke.py``
    holds it against the C plan) at H=512, the recipes' In and batches:
    within 227 KB, 544 threads, four x slots, the h ping-pong as scratch,
    the item slots of two steps (K7b: of K steps, or as many as fit once
    the h ring is down to two copies a slice) and the ring as deep as the
    rest leaves. Shapes that no layout holds are refused, named."""
    for In in (128, 256, 512, 640):
        for B in (1, 64, 70, 128, 256):
            ntiles = -(-B // 64)
            plan = pl.fused_f32_fwd_plan(In, 512, B, K)
            assert plan.smem <= pl.SMEM_LIMIT
            assert (plan.threads, plan.xslots) == (544, 4)
            assert plan.scratch == 2 * 512 * pl.hbuf_pitch(B)
            assert plan.schedule == pl.F32_FWD_AHEAD
            assert 2 * ntiles <= plan.slots <= max(K, 2) * ntiles
            assert 2 <= plan.ring <= 4 * ntiles
            if plan.ring < 4 * ntiles:   # one copy more would not fit
                assert pl._f32_fwd_smem(512, plan.ring + 1, plan.slots) \
                    > pl.SMEM_LIMIT
            if plan.slots < max(K, 2) * ntiles:   # the ring gave way first
                assert plan.ring == 2
                assert pl._f32_fwd_smem(512, 2, plan.slots + 1) \
                    > pl.SMEM_LIMIT
            # the layout does not depend on In
            assert plan == pl.fused_f32_fwd_plan(128, 512, B, K)
    # MD_VAE's layers (B=64): every h copy of a step in flight, two slots
    assert pl.fused_f32_fwd_plan(128, 512, 64) == (
        pl.F32_FWD_AHEAD, 2, 4, 4, 544,
        4 * (4 * 2560 + 4 * 4 * 32 * 64 + 16 * 512 + 4096 + 2 * 1024)
        + 8 * (16 + 8 + 4), 2 * 512 * 64)
    for In, H, B, Kk in ((130, 512, 64, K), (128, 520, 64, K),
                         (128, 544, 64, K), (128, 512, 0, K),
                         (128, 512, 64, 0)):
        with pytest.raises(ValueError, match=rf"fused_f32_fwd_plan\(In={In}, "
                           rf"H={H}, B={B}, K={Kk}\)"):
            pl.fused_f32_fwd_plan(In, H, B, Kk)


@pytest.mark.parametrize("B", [1, 64, 70, 256])
def test_f32_bwd_plan_takes_split_k_where_it_fits(B):
    """The f32 backwards' schedule (``fused_f32_bwd_plan``, the mirror of
    ``schedule_of`` and ``work_floats`` in ``csrc/lstm_fused_bwd_f32.cu``;
    ``chip_smoke.py`` holds it against the C plan): split-K where its
    layout fits, whatever B, its partials (2, H/4, min(B, 64), In + H) (K4:
    H columns); else the exchange schedule and its (2, B, 4H) exchange
    buffer (K3) and (B, 4H) pre-activations. MD_VAE's f32 layers under
    MLVAE_PALLAS_FUSED=1 (H=512: K3 at In=128, K4 at In=512 and 640) take
    split-K."""
    split = pl.F32_SPLIT
    for kind, In, H, slots in (("bwd", 128, 512, 4), ("semi", 512, 512, 4),
                               ("semi", 640, 512, 4), ("semi", 8, 512, 1),
                               ("bwd", 512, 128, 16), ("bwd", 8, 16, 1),
                               ("semi", 6400, 128, 4), ("semi", 8, 528, 1),
                               ("semi", 512, 528, 3), ("bwd", 96, 528, 3),
                               ("bwd", 384, 256, 12)):
        plan = pl.fused_f32_bwd_plan(kind, In, H, B)
        cols = H if kind == "semi" else In + H
        assert plan == (split, slots, pl.fused_f32_smem(kind, In, H),
                        2 * (H // 4) * min(B, 64) * cols), (kind, In, H)
        assert plan.smem <= pl.SMEM_LIMIT
    # K3 where x's boxes do not all fit (In=256 at H=512, 128 at H=528,
    # 512 at H=256) or In + H passes 768 columns (In=640 at H=256)
    for In, H in ((256, 512), (128, 528), (512, 256), (640, 256),
                  (1024, 256)):
        plan = pl.fused_f32_bwd_plan("bwd", In, H, B)
        assert plan == (pl.F32_EXCHANGE, 0, pl.fused_f32_smem("bwd", In, H),
                        3 * B * 4 * H), (In, H)


def test_f32_bwd_split_layout_covers_every_h():
    """K4 takes split-K at every H the fused kernels take (one x slot at
    least beside the h tile); K3 at every H for In up to 64."""
    for H in range(16, 529, 16):
        for In in (8, 64):
            for kind in ("bwd", "semi"):
                plan = pl.fused_f32_bwd_plan(kind, In, H, 64)
                assert plan.schedule == pl.F32_SPLIT, (kind, In, H)
                assert plan.smem <= pl.SMEM_LIMIT


def test_k3_width_is_refused_in_bf16_too():
    """The bf16 K3-bwd refuses In above 4H as the f32 build does, before
    the device; 4H itself reaches the device check."""
    with pytest.raises(NotImplementedError, match="In=640 above 4H=512"):
        pl.lstm_fused_bwd(*_meta_bwd_args(3, 2, 640, 128, torch.bfloat16))
    with pytest.raises(ValueError, match="CUDA device"):
        pl.lstm_fused_bwd(*_meta_bwd_args(3, 2, 512, 128, torch.bfloat16))
