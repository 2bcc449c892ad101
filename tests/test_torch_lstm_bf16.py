"""K1 on bf16 streams (the JAX package's ``lstm_layer`` under AMP): the
plain recurrence and the plain BPTT in bf16 against the Pallas kernels in
interpret mode, ``nn.LSTM``'s dispatch of bf16 layers that miss both fused
tiers, LSTM_FC's AMP train step against the JAX AMP step, and the refusals
and bindings of the wide bf16 builds.

On the CPU the JAX LSTM would take its bf16-carry ``lax.scan``, which is
not what the TPU runs, so its Pallas dispatch is forced on
(``_pallas_eligible``) and ``lstm_layer`` runs in interpret mode, which
needs H % 128 == 0. At H=128 every layer fits a fused tier under the
13 MB budget, so both packages' ``FUSED_RESIDENT_BUDGET`` are lowered
alike until no layer does, as none does at LSTM_FC's H=1024.

Tolerances, with their reasons. Both sides round to bf16 at the same
points (gx, h_{t-1} before the recurrent product, hs, the dgates before
both backward products, dgx, dW_hh once at the end) and sum in f32, but
in another order, so a value can land one bf16 ulp (2^-8 relative) apart
and a flipped h_t feeds every later step: hs within 4e-3 absolute (one ulp
at |h| <= 1), c_last within 4e-3 absolute, dgx and dW_hh within 1e-2 of
their largest entry. Those maxima barely see a wrong rounding point,
since both sides round to bf16 anyway; the share of bf16 elements that
are not bit-equal does: at most ``HS_SHARE`` of hs, ``DGX_SHARE`` of dgx
and ``DW_SHARE`` of dW_hh. The plain BPTT that formed its backward
products from f32 dgates differed in 13.6-19.8 % of dgx and 40.2-41.6 %
of dW_hh in these four cases, the repaired one in 0.04-0.7 % and
0.02-4.3 % (``CHANGES.md``).
The module and train-step tests keep the tolerances of
``tests/test_torch_lstm_fused.py`` and ``tests/test_torch_amp_step.py``.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mlvae_tpu.nn.rnn as jrnn
import mlvae_tpu.ops.lstm_pallas as lp
from mlvae_tpu.ops.lstm_pallas import lstm_layer

from mlvae_tpu_torch import _build
from mlvae_tpu_torch.ops import lstm as L

torch.set_num_threads(2)

HS_ATOL = 4e-3       # one bf16 ulp at |h| <= 1
BWD_RTOL = 1e-2      # dgx, dW_hh: of the largest entry
HS_SHARE = 0.02      # bf16 elements not bit-equal to the Pallas kernel's
DGX_SHARE = 0.05
DW_SHARE = 0.15
CSRC = Path(L.__file__).resolve().parent.parent / "csrc"


def _problem(seed, T, B, H):
    """gx, W_hh and dhs in bf16 (as numpy f32 holding bf16 values), dc_last
    f32, at the scale of a trained layer's."""
    rs = np.random.RandomState(seed)

    def bf16(a):
        return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))

    return (bf16(rs.randn(T, B, 4 * H) * 0.5),
            bf16((rs.rand(4 * H, H) * 2 - 1) * 2 / np.sqrt(H)),
            bf16(rs.randn(T, B, H) * 0.1),
            (rs.randn(B, H) * 0.1).astype(np.float32))


def _bf16(a):
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)


def _share(got, want) -> float:
    """The share of elements of ``got`` (rounded to bf16) that are not
    bit-equal to ``want`` (bf16)."""
    g = got.to(torch.bfloat16).float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    return float((g != w).mean())


def _rel(got, want) -> float:
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    return float(np.abs(g - w).max() / np.abs(w).max())


@pytest.mark.parametrize("H, T, B", [(128, 12, 16), (1024, 3, 8)])
@pytest.mark.parametrize("reverse", [False, True])
def test_plain_k1_matches_pallas_in_bf16(H, T, B, reverse):
    """The plain recurrence and the plain BPTT, bf16 streams, against
    ``lstm_layer`` and its VJP in interpret mode: hs, c_last, dgx, dW_hh,
    by their largest error and by the share of bf16 elements that are not
    bit-equal."""
    gx, w, dhs, dc_last = _problem(21, T, B, H)
    jgx, jw = jnp.asarray(gx, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    (hs_j, c_j), vjp = jax.vjp(
        lambda g, ww: lstm_layer(g, ww, reverse, True), jgx, jw)
    dgx_j, dw_j = vjp((jnp.asarray(dhs, jnp.bfloat16),
                       jnp.asarray(dc_last)))
    assert dgx_j.dtype == dw_j.dtype == jnp.bfloat16

    tgx, tw = _bf16(gx), _bf16(w)
    hs, cs = L.lstm_layer_ref(tgx, tw, reverse)
    assert hs.dtype == torch.bfloat16 and cs.dtype == torch.float32
    dgx, dw = L.lstm_layer_bwd_ref(tgx, tw, hs, cs, _bf16(dhs),
                                   torch.from_numpy(dc_last), reverse)
    assert dgx.dtype == torch.bfloat16 and dw.dtype == torch.float32

    c_last = cs[0] if reverse else cs[-1]
    assert np.abs(hs.float().numpy() - np.asarray(
        hs_j.astype(jnp.float32))).max() <= HS_ATOL
    np.testing.assert_allclose(c_last.numpy(), np.asarray(c_j), atol=HS_ATOL)
    shares = {"hs": _share(hs, hs_j), "dgx": _share(dgx, dgx_j),
              "dW_hh": _share(dw, dw_j)}
    errs = {"dgx": _rel(dgx, dgx_j), "dW_hh": _rel(dw, dw_j)}
    assert errs["dgx"] <= BWD_RTOL and errs["dW_hh"] <= BWD_RTOL, errs
    assert shares["hs"] <= HS_SHARE, shares
    assert shares["dgx"] <= DGX_SHARE, shares
    assert shares["dW_hh"] <= DW_SHARE, shares
    # on CPU tensors the wrappers are the plain versions, bit for bit
    hs_w, cs_w = L.lstm_layer_fwd(tgx, tw, reverse)
    assert torch.equal(hs_w, hs) and torch.equal(cs_w, cs)
    dgx_w, dw_w = L.lstm_layer_bwd(tgx, tw, hs, cs, _bf16(dhs),
                                   torch.from_numpy(dc_last), reverse)
    assert torch.equal(dgx_w, dgx) and torch.equal(dw_w, dw)


# ---------------------------------------------------------------------------
# nn.LSTM's dispatch of bf16 layers outside both fused tiers
# ---------------------------------------------------------------------------

# (128 + 128) * 4H * 2 + 4H * H * 4 bytes (the semi-fused tier's residents
# at H=128, In padded to 128) are over it: every layer takes K1
K1_BUDGET = 100_000


@pytest.fixture
def k1_tiers(monkeypatch):
    """Force the JAX module's Pallas dispatch, run its ``lstm_layer`` in
    interpret mode recording (gx shape, reverse) of each call, lower both
    packages' budgets alike, and record the port's LSTM autograd calls.
    Returns (JAX calls, port calls)."""
    import mlvae_tpu_torch.nn.rnn as prnn
    jcalls, pcalls = [], []
    real = lp.lstm_layer

    def spy(gx, w_hh, reverse=False, interpret=False):
        jcalls.append(("lstm_layer", tuple(gx.shape), reverse))
        return real(gx, w_hh, reverse, True)

    monkeypatch.setattr(jrnn, "_pallas_eligible", lambda x, H: True)
    monkeypatch.setattr(jrnn, "PALLAS_LSTM_MESH", None)
    monkeypatch.setattr(lp, "lstm_layer", spy)
    monkeypatch.setattr(lp, "FUSED_RESIDENT_BUDGET", K1_BUDGET)
    monkeypatch.setattr(L, "FUSED_RESIDENT_BUDGET", K1_BUDGET)
    for name in ("LSTMRecurrence", "LSTMFused", "LSTMSemiFused"):
        cls = getattr(prnn, name)

        def apply(*a, _orig=cls.apply, _name=name):
            pcalls.append((_name, tuple(a[0].shape), a[-1]))
            return _orig(*a)

        monkeypatch.setattr(cls, "apply", apply)
    return jcalls, pcalls


MOD_LOSS_RTOL = 1e-2   # tests/test_torch_lstm_fused.py's module losses
MOD_GRAD_RTOL = 4e-3   # its grads, of their largest entry
# On K1's path XLA forms the biases' grads by summing the bf16 dgx over
# B*T in bf16 with more than one rounding (tests/test_torch_amp_step.py
# measured 6.4e-3 of the largest entry for 96 terms; 1.4e-2 at most here,
# 40 terms), PyTorch sums in f32 and rounds once; the fused kernels form db
# in f32 inside the kernel, so the fused test does not meet this.
BIAS_RTOL = 2e-2


@pytest.mark.parametrize("in_size, layers, bi", [(120, 2, False),
                                                 (32, 2, True)])
def test_lstm_module_bf16_k1_dispatch_matches_jax(k1_tiers, in_size,
                                                  layers, bi):
    """``nn.LSTM`` on a bf16 stream whose layers miss both fused tiers
    against the JAX module with its Pallas ``lstm_layer`` in interpret
    mode: every layer direction takes K1 on both sides (the port's
    ``LSTMRecurrence`` on bf16 gx and W_hh), the outputs, the final states,
    dX and every weight's gradient agree. LSTM_FC's stack (In=120, two
    layers) and a bidirectional one (the reverse direction, the folded
    biases)."""
    from mlvae_tpu.nn.rnn import LSTM as JaxLSTM
    from mlvae_tpu_torch.convert import from_jax
    from mlvae_tpu_torch.nn.rnn import LSTM
    jcalls, pcalls = k1_tiers
    H, B, T = 128, 4, 10
    D = 2 if bi else 1
    jmod = JaxLSTM(in_size, H, num_layers=layers, bidirectional=bi)
    params = jax.tree_util.tree_map(lambda v: v.astype(jnp.bfloat16),
                                    jmod.init(jax.random.PRNGKey(3)))
    rs = np.random.RandomState(7)
    x = jnp.asarray(rs.randn(B, T, in_size) * 0.5, jnp.bfloat16)
    w_out = rs.randn(B, T, D * H).astype(np.float32)
    w_c = rs.randn(layers * D, B, H).astype(np.float32)

    def jloss(p, xx):
        out, (_, c) = jmod.apply(p, xx)
        return (jnp.sum(out.astype(jnp.float32) * w_out)
                + jnp.sum(c.astype(jnp.float32) * w_c))

    v_j, (gp_j, gx_j) = jax.value_and_grad(jloss, argnums=(0, 1))(params, x)

    mod = LSTM(in_size, H, num_layers=layers, bidirectional=bi)
    mod.load_state_dict(from_jax(jax.tree_util.tree_map(
        lambda v: v.astype(jnp.float32), params)))
    mod = mod.to(torch.bfloat16)
    xt = _bf16(np.asarray(x.astype(jnp.float32))).requires_grad_()
    out, (h_n, c_n) = mod(xt)
    assert out.dtype == h_n.dtype == c_n.dtype == torch.bfloat16
    loss = ((out.float() * torch.from_numpy(w_out)).sum()
            + (c_n.float() * torch.from_numpy(w_c)).sum())
    loss.backward()

    want = [("lstm_layer", (T, B, 4 * H), bool(d))
            for _ in range(layers) for d in range(D)]
    assert jcalls == want
    assert pcalls == [("LSTMRecurrence", s, r) for _, s, r in want]
    np.testing.assert_allclose(float(loss.detach()), float(v_j),
                               rtol=MOD_LOSS_RTOL)
    for got, j, name in [(xt.grad, gx_j, "dx")] + [
            (p.grad, gp_j[n], n) for n, p in mod.named_parameters()]:
        assert got.dtype == torch.bfloat16, name
        tol = BIAS_RTOL if name.startswith("bias") else MOD_GRAD_RTOL
        assert _rel(got, j) < tol, (name, _rel(got, j))


def test_lstm_fc_layers_miss_both_fused_tiers_at_full_width():
    """At the recipe's H=1024 every LSTM_FC layer (In 120 padded to 128, and
    1024) misses both tiers in both packages under the default budget, so
    a bf16 stream takes K1."""
    from mlvae_tpu_torch.nn.rnn import fused_tier
    for In in (128, 1024):
        assert not lp.fused_eligible(In, 1024, jnp.bfloat16)
        assert not lp.semifused_eligible(In, 1024, jnp.bfloat16)
    for In in (120, 1024):
        assert fused_tier(In, 1024, torch.bfloat16) is None
    # a bf16 layer in a fused tier keeps it
    assert fused_tier(120, 512, torch.bfloat16) is L.LSTMFused


def test_bf16_layer_off_the_lane_names_the_scan():
    """A bf16 layer outside both tiers whose H is not a multiple of 128
    takes the JAX package's bf16-carry scan, ``lstm_scan``; an H that is
    not a multiple of 16 takes it in either dtype; every other layer keeps
    its kernel."""
    from mlvae_tpu_torch.nn.rnn import fused_tier, lstm_route
    assert fused_tier(12, 16, torch.bfloat16) is None
    assert lstm_route(12, 16, torch.bfloat16) == "scan"
    assert lstm_route(7680, 32, torch.bfloat16) == "scan"
    assert lstm_route(12, 20, torch.float32) == "scan"
    assert lstm_route(12, 32, torch.float32) == "k1"
    assert lstm_route(7680, 512, torch.bfloat16) == "k1"
    assert lstm_route(120, 512, torch.bfloat16) is L.LSTMFused


# ---------------------------------------------------------------------------
# LSTM_FC's AMP train step against the JAX AMP step
# ---------------------------------------------------------------------------

FC_B, FC_T = 4, 12
FC_NARROW = {"lstm_hidden_size": 128, "lstm_num_layers": 2, "fc_size": 16}
FC_PORT = {"lstm_hidden_size": 128, "lstm_num_layers": 2,
           "fc_sizes": [128, 16, 16, 2]}
STEPS = 3
LOSS_RTOL = 1e-2     # tests/test_torch_amp_step.py: step 1's loss
LATER_RTOL = 3e-2    # steps 2-3
GRAD_RTOL = 5e-2     # each module's grads and Adam first moments in norm:
                     # XLA's bf16 bias sums (above) lead, the final FC's
                     # bias 2.9e-2 here


def _jax_lstm_fc():
    from mlvae_tpu.hyperyaml import load_hyperyaml
    from mlvae_tpu.models.LSTM_FC.model import SBModel
    from mlvae_tpu_torch.bench_utils import INPUT_SIZE
    repo = Path(__file__).resolve().parent.parent
    injected = {"n_epochs": 1, "dataset_name": "SynAudioMNIST",
                "model_name": "bench", "output_dir": "/tmp/mlvae_bench",
                "input_size": INPUT_SIZE, "n_phonemes": 12,
                "batch_size": FC_B, **FC_NARROW}
    with open(repo / "mlvae_tpu/models/LSTM_FC/model.yaml") as f:
        hparams = load_hyperyaml(f, overrides=injected,
                                 overrides_must_match=False)
    hparams.update({k: v for k, v in injected.items() if k not in hparams})
    model = SBModel(modules=hparams["modules"], hparams=hparams,
                    run_opts={"bf16": True}, checkpointer=None)
    assert model.auto_mix_prec
    model.init_params()
    model.ensure_states(INPUT_SIZE)
    model.init_optimizers()
    return model


def test_lstm_fc_amp_train_steps_match_jax(k1_tiers):
    """Three ``fit_batch`` steps of LSTM_FC under AMP against the JAX AMP
    train step (its ``lstm_layer`` in interpret mode), the dropout masks
    replayed. Each step starts from the JAX parameters, as
    ``tests/test_torch_lstm_fc.py``'s do (the recipe's lr 1.0 saturates the
    LSTM in one step); the port's Adam states carry over. Each step's
    loss, step 1's applied grads per module and the Adam moments after
    every step, in norm; every layer on K1 on both sides; f32 master
    parameters, grads and Adam states."""
    from mlvae_tpu.training.brain import Stage as JaxStage
    from mlvae_tpu_torch.bench_utils import build_lstm_fc, synth_flvl_batch
    from mlvae_tpu_torch.convert import from_jax
    jcalls, pcalls = k1_tiers
    H = FC_PORT["lstm_hidden_size"]
    jm = _jax_lstm_fc()
    step = jm._get_compiled("train", JaxStage.TRAIN)
    port = build_lstm_fc(FC_B, overrides=FC_PORT, device="cpu", bf16=True)
    assert port.auto_mix_prec
    batch = synth_flvl_batch(FC_B, FC_T, seed=3, device="cpu")
    jbatch = {k: tuple(jnp.asarray(x.numpy()) for x in v)
              for k, v in batch.items()}
    p, o, s = jax.tree_util.tree_map(jnp.array, (jm.params, jm.opt_states,
                                                 jm.states))
    for i in range(STEPS):
        rng = jax.random.PRNGKey(60 + i)
        port.load_state_dict(from_jax(jax.device_get(p), jax.device_get(s)))
        jcalls.clear()
        pcalls.clear()
        p, o, s, j_loss, _ = step(p, o, s, rng, jbatch, jnp.int32(1))
        noise = {"lstm_dropout": [torch.from_numpy(np.array(
            jax.random.bernoulli(jax.random.fold_in(rng, k), keep, shape)))
            for k, (_, kind, shape, keep, _) in enumerate(
                port.draws(FC_B, FC_T, train=True))]}
        loss, _ = port.fit_batch(batch, 1, noise=noise)
        assert pcalls == [("LSTMRecurrence", (FC_T, FC_B, 4 * H), False)] * 2
        if i == 0:   # the JAX step traces (and so calls the spy) once
            assert jcalls == [("lstm_layer", (FC_T, FC_B, 4 * H), False)] * 2
        np.testing.assert_allclose(float(loss), float(j_loss),
                                   rtol=LOSS_RTOL if i == 0 else LATER_RTOL,
                                   err_msg=f"step {i + 1}")
        assert all(q.dtype == torch.float32 for q in port.parameters())
        assert all(q.grad.dtype == torch.float32 for q in port.parameters())
        j_opt = jax.device_get(o["optimizer"])
        for mk, mod in port.param_modules().items():
            inner = j_opt[mk].inner_state[0]
            st = port.opt_states["optimizer"][mk]
            assert int(st["count"]) == int(inner.count) == i + 1
            for key in ("mu", "nu"):
                assert st[key].dtype == torch.float32
                sd = from_jax(getattr(inner, key))
                ref = torch.cat([sd[f"{mk}.{n}"].reshape(-1)
                                 for n, _ in mod.named_parameters()])
                err = float((st[key] - ref).norm() / ref.norm())
                # nu sums squared grads: twice the grads' relative error
                tol = GRAD_RTOL * (2 if key == "nu" else 1)
                assert err <= tol, (i + 1, mk, key, err)
            if i == 0:   # optax's first mu is (1 - b1) * g
                sd = from_jax(inner.mu)
                g_j = torch.cat([sd[f"{mk}.{n}"].reshape(-1)
                                 for n, _ in mod.named_parameters()]) / 0.1
                g = torch.cat([q.grad.reshape(-1) for q in mod.parameters()])
                err = float((g - g_j).norm() / g_j.norm())
                assert err <= GRAD_RTOL, (mk, err)


# ---------------------------------------------------------------------------
# the wrappers' refusals, and the bf16 entry points
# ---------------------------------------------------------------------------

def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, device="meta", dtype=dtype)


def _k1_args(T, B, H, streams=torch.bfloat16, cells=torch.float32):
    return (_meta((T, B, 4 * H), streams), _meta((4 * H, H), streams),
            _meta((T, B, H), streams), _meta((T, B, H), cells),
            _meta((T, B, H), streams), _meta((B, H), cells))


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_k1_wrappers_refuse_what_no_build_takes(direction):
    """Off the CPU the wrappers launch or raise, never run the plain
    version: mixed stream dtypes and non-f32 cells are refused
    (``ValueError``), H above 1024 raises ``NotImplementedError`` naming
    ``ROADMAP.md`` queue 2, a bf16 layer whose H is not a multiple of 128
    has no build (``ValueError`` naming ``lstm_scan``, where ``nn.rnn``
    runs such a layer), and a bf16 layer the bf16
    build takes (every H % 128 == 0, 128 to 1024) is refused for not lying
    on a CUDA device."""
    def call(args):
        gx, w, hs, cs, dhs, dc = args
        if direction == "fwd":
            return L.lstm_layer_fwd(gx, w)
        return L.lstm_layer_bwd(gx, w, hs, cs, dhs, dc)

    gx, w, hs, cs, dhs, dc = _k1_args(3, 8, 1024)
    with pytest.raises(ValueError, match="one dtype"):
        call((gx, w.float(), hs, cs, dhs, dc))
    with pytest.raises(ValueError, match="one dtype"):
        call((gx.float(), w, hs, cs, dhs, dc))
    if direction == "bwd":
        with pytest.raises(ValueError, match="one dtype"):
            call((gx, w, hs.float(), cs, dhs, dc))
        with pytest.raises(ValueError, match="must be f32"):
            call(_k1_args(3, 8, 1024, cells=torch.bfloat16))
    with pytest.raises(ValueError, match="lstm_scan"):
        call(_k1_args(3, 8, 528))
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 2"):
        call(_k1_args(3, 8, 1040))
    with pytest.raises(ValueError, match="lstm_scan"):
        call(_k1_args(3, 8, 544))
    for H in (128, 512, 640, 1024):
        with pytest.raises(ValueError, match="CUDA device"):
            call(_k1_args(3, 8, H))
    # f32 streams keep every build: only the device is refused
    with pytest.raises(ValueError, match="CUDA device"):
        call(_k1_args(3, 8, 128, streams=torch.float32))


def test_bf16_wide_kernels_are_built_registered_and_bound():
    """The bf16 wide builds are sources of their own beside the f32 ones
    (K1-fwd; K1-bwd's recurrence and its dW_hh kernel in one source), each
    entry point registered as its own kernel (its own launch count) with
    the C signature's arity and a plan; the f32 sources keep f32 only."""
    for kernel, src, f32 in ((L.LSTM_FWD_WIDE_BF16, "lstm_fwd_wide_bf16",
                              L.LSTM_FWD_WIDE),
                             (L.LSTM_BWD_WIDE_BF16, "lstm_bwd_wide_bf16",
                              L.LSTM_BWD_WIDE),
                             (L.LSTM_DW_WIDE_BF16, "lstm_bwd_wide_bf16",
                              L.LSTM_BWD_WIDE)):
        assert kernel in _build.KERNELS and kernel is not f32
        assert kernel.source == src and src in _build.SOURCES
        assert f32.source == f32.name and f32.source in _build.SOURCES
        assert kernel.symbol == f"mlvae_{kernel.name}"
        text = (CSRC / f"{src}.cu").read_text()
        sig = re.search(rf"int {kernel.symbol}\(([^)]*)\)", text).group(1)
        assert sig.count(",") + 1 == len(kernel.argtypes)
        assert f"int {kernel.symbol}_plan(" in text
        assert '#include "lstm_wide_mma.cuh"' in text
        assert f"mlvae_{kernel.name}" not in (CSRC / f"{f32.source}.cu"
                                              ).read_text()
    for f32 in ("lstm_wide.cuh", "lstm_fwd_wide.cu", "lstm_bwd_wide.cu"):
        assert not re.search(r"\bbf16\s*\*|__nv_bfloat16|template <typename",
                             (CSRC / f32).read_text())
    names = [k.name for k in _build.KERNELS]
    assert len(names) == len(set(names))
