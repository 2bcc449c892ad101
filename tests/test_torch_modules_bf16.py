"""The modules of ``test_torch_modules.py`` again, on a bf16 stream as the
AMP step runs them: weights cast to bf16 on both sides (the JAX Brain's
``_cast_floats``; the port's ``Module.to(torch.bfloat16)``, the
normalizer's statistics staying f32), bf16 inputs, and the JAX draws
replayed. Each output must come back in the JAX module's dtype: bf16 where
the JAX module keeps the stream dtype (linears, activations, dropout, the
LSTMs, the mixtures, the samples), f32 where it casts (the distribution
math, the losses).

The LSTM modules run at H=128 with the JAX module's Pallas dispatch forced
on and its fused kernels in interpret mode, as the TPU runs them (on the
CPU it would take a bf16-carry ``lax.scan``).

Tolerances, with their reasons: where both sides round once at the same
point the outputs are equal bit for bit (the linears, dropout, the
categorical sample); elsewhere XLA and PyTorch can round a bf16 sum or an
elementwise chain at other points, so values of order 1 may be one bf16
ulp (2^-8 relative) apart: RTOL 4e-3, ATOL 4e-3. The boundary detector's
samples and losses take 2e-2: they raise u to 1/beta and 1/alpha, which
turns a one-ulp difference in alpha or beta into a few per cent.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mlvae_tpu.nn.rnn as jrnn
import mlvae_tpu.ops.lstm_pallas as lp
from mlvae_tpu.modules.boundary_detector import BoundaryDetector as JBD
from mlvae_tpu.modules.decoder import Decoder as JDecoder
from mlvae_tpu.modules.fc_block import FCBlock as JFC
from mlvae_tpu.modules.gmm_vae import GMMVAE as JGMM
from mlvae_tpu.modules.h_vae import HierarchicalVAE as JHVAE
from mlvae_tpu.modules.phoneme_recognizer import PhonemeRecognizer as JPR
from mlvae_tpu.modules.vanilla_vae import VanillaVAE as JVAE
from mlvae_tpu.nn import dist as JD
from mlvae_tpu.nn import layers as JL
from mlvae_tpu.nn.layers import Linear as JLinear
from mlvae_tpu.nn.norm import InputNormalization as JNorm

from mlvae_tpu_torch.convert import from_jax
from mlvae_tpu_torch.modules.boundary_detector import BoundaryDetector
from mlvae_tpu_torch.modules.decoder import Decoder
from mlvae_tpu_torch.modules.fc_block import FCBlock
from mlvae_tpu_torch.modules.gmm_vae import GMMVAE
from mlvae_tpu_torch.modules.h_vae import HierarchicalVAE
from mlvae_tpu_torch.modules.phoneme_recognizer import PhonemeRecognizer
from mlvae_tpu_torch.modules.vanilla_vae import VanillaVAE
from mlvae_tpu_torch.nn import dist as D
from mlvae_tpu_torch.nn import layers as L
from mlvae_tpu_torch.nn.layers import Linear
from mlvae_tpu_torch.nn.norm import InputNormalization

torch.set_num_threads(2)

RTOL, ATOL = 4e-3, 4e-3
B, T = 3, 9
H = 128
KEY = jax.random.PRNGKey(5)
BF = torch.bfloat16


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().float().numpy()
    return np.array(jnp.asarray(v).astype(jnp.float32))


def _close(got, want, rtol=RTOL, atol=ATOL, exact=False):
    """Same keys, same dtypes (bf16 or f32), values within tolerance."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], rtol, atol, exact)
        return
    assert str(got.dtype).split(".")[-1] == str(want.dtype), \
        (got.dtype, want.dtype)
    if exact:
        np.testing.assert_array_equal(_np(got), _np(want))
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def _bf(a):
    """(bf16 JAX array, the same values as a bf16 torch tensor)."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(_np(j)).to(BF)


def _draw(i, kind, shape):
    k = jax.random.fold_in(KEY, i)
    fn = {"normal": jax.random.normal, "uniform": jax.random.uniform,
          "gumbel": jax.random.gumbel}[kind]
    return torch.from_numpy(np.array(fn(k, shape, jnp.float32)))


def _port(module_cls, jmod, *args, **kwargs):
    """The JAX module's weights in bf16, and the port module carrying the
    same (f32 weights cast with ``.to(bf16)``: the same bf16 values)."""
    params = jmod.init(jax.random.PRNGKey(2))
    mod = module_cls(*args, **kwargs)
    mod.load_state_dict(from_jax(params))
    return (jax.tree_util.tree_map(lambda v: v.astype(jnp.bfloat16), params),
            mod.to(BF))


def _x(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX LSTM's Pallas dispatch forced on, its fused kernels run in
    interpret mode."""
    real = lp.lstm_layer_fused

    def fused(x, w_ih, bias, w_hh, reverse=False, interpret=False):
        return real(x, w_ih, bias, w_hh, reverse, True)

    monkeypatch.setattr(jrnn, "_pallas_eligible", lambda x, H: True)
    monkeypatch.setattr(jrnn, "PALLAS_LSTM_MESH", None)
    monkeypatch.setattr(lp, "lstm_layer_fused", fused)


# -- layers -----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["linear", "fc_end", "fc_plain"])
def test_dense_layers_bf16(kind):
    jx, x = _bf(_x(B, T, 6))
    if kind == "linear":
        jmod, cls, args, kw = JLinear(6, 5), Linear, (6, 5), {}
    else:
        end = kind == "fc_end"
        jmod = JFC([6, 8, 4], end_activation=end)
        cls, args, kw = FCBlock, ([6, 8, 4],), {"end_activation": end}
    params, mod = _port(cls, jmod, *args, **kw)
    # the product rounded to bf16, then the bias added and rounded: as XLA
    _close(mod(x), jmod.apply(params, jx), exact=True)


def test_input_normalization_bf16():
    C = 7
    jf, feats = _bf(_x(B, T, C, seed=1, scale=2.0) + 0.5)
    lens = np.array([1.0, 0.8, 0.55], np.float32)
    rs = np.random.RandomState(3)
    state = {"count": np.float32(4.0),
             "glob_mean": rs.randn(C).astype(np.float32) * 0.1,
             "glob_std": (1 + rs.rand(C)).astype(np.float32)}
    out_j, new_j = JNorm(norm_type="global").apply(
        {k: jnp.asarray(v) for k, v in state.items()}, jf,
        jnp.asarray(lens), epoch=1, update=True)
    norm = InputNormalization(C)
    norm.load_state_dict(from_jax(state))
    out = norm(feats, torch.from_numpy(lens), epoch=1, update=True)
    _close(out, out_j)
    # the statistics stay f32, taken from the bf16 features in f32
    _close(dict(norm.named_buffers()), new_j, rtol=1e-5, atol=1e-6)


# -- distributions ------------------------------------------------------------

def _dist_cases():
    (jm, m), (jlv, lv) = _bf(_x(B, T, 4, seed=1)), _bf(_x(B, T, 4, seed=2,
                                                            scale=0.5))
    (jpm, pm), (jplv, plv) = _bf(_x(B, T, 4, seed=3)), _bf(_x(B, T, 4, seed=4,
                                                              scale=0.5))
    jt, tgt = _bf(_x(B, T, 4, seed=5))
    jl, logits = _bf(_x(B, T, 3, seed=6, scale=2.0))
    ja, a = _bf(np.abs(_x(10, B, T, seed=7)) + 0.1)
    jb, b = _bf(np.abs(_x(10, B, T, seed=8)) + 0.1)
    k = jax.random.fold_in
    return {
        "reparameterize": (
            lambda: D.reparameterize(m, lv, eps=_draw(0, "normal",
                                                      (B, T, 4))),
            lambda: JD.reparameterize(k(KEY, 0), jm, jlv)),
        "kld_std_normal": (lambda: D.kld_std_normal(m, lv),
                           lambda: JD.kld_std_normal(jm, jlv)),
        "kld_gaussian_prior": (
            lambda: D.kld_gaussian_prior(pm, plv, m, lv),
            lambda: JD.kld_gaussian_prior(jpm, jplv, jm, jlv)),
        "gaussian_nll": (lambda: D.gaussian_nll(m, lv, tgt),
                         lambda: JD.gaussian_nll(jm, jlv, jt)),
        "gumbel_softmax": (
            lambda: D.gumbel_softmax(logits, 0.1,
                                     g=_draw(1, "gumbel", (B, T, 3))),
            lambda: JD.gumbel_softmax(k(KEY, 1), jl, 0.1, True)),
        "kumaraswamy_sample": (
            lambda: D.kumaraswamy_sample(a, b, u=_draw(2, "uniform",
                                                       (10, B, T))),
            lambda: JD.kumaraswamy_sample(k(KEY, 2), ja, jb)),
        "kld_beta": (lambda: D.kld_beta(a, b, 1.0, 9.0),
                     lambda: JD.kld_beta(ja, jb, 1.0, 9.0)),
        "bce_with_logits": (
            lambda: D.bce_with_logits(logits[..., 0], logits[..., 1] > 0),
            lambda: JD.bce_with_logits(jl[..., 0], jl[..., 1] > 0)),
        "categorical_log_prob": (
            lambda: D.categorical_log_prob(logits, (logits[..., 1] > 0)),
            lambda: JD.categorical_log_prob(jl, (jl[..., 1] > 0))),
    }


# the math runs in f32 on both sides from the same bf16 inputs
# (digamma/lgamma and pow are separate implementations in the two libraries)
_DIST_TOL = {"kld_beta": (1e-4, 1e-5), "kumaraswamy_sample": (1e-4, 1e-5)}


@pytest.mark.parametrize("name", sorted(_dist_cases()))
def test_dist_functions_bf16(name):
    got, want = _dist_cases()[name]
    _close(got(), want(), *_DIST_TOL.get(name, (1e-5, 1e-6)))


def test_categorical_sample_bf16_replays_jax_exactly():
    """bf16 logits: ``jax.random.categorical`` draws its Gumbel noise in
    bf16 and takes the argmax of the bf16 sum; replaying that draw gives
    its sample, element for element."""
    jl, logits = _bf(_x(8, 50, 2, seed=11, scale=0.5))
    key = jax.random.fold_in(KEY, 3)
    want = np.asarray(JD.categorical_sample(key, jl))
    g = jax.random.gumbel(key, jl.shape, jnp.bfloat16)
    got = D.categorical_sample(logits, g=torch.from_numpy(_np(g)).to(BF))
    np.testing.assert_array_equal(got.numpy(), want)
    # the f32 noise of the same key gives another sample here
    g32 = _draw(3, "gumbel", jl.shape)
    assert not np.array_equal(
        D.categorical_sample(logits.float(), g=g32).numpy(), want)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_gumbel_noise_stays_on_jax_grid(dtype):
    """A million draws of ``gumbel_noise`` are finite and lie in the range
    of ``jax.random.gumbel`` in the same dtype. In bf16 both take u on the
    grid of 2^-7 in [tiny, 1): the 128 values are the same, bit for bit
    (an f32 uniform rounded to bf16 would reach 1.0 and give +inf)."""
    n = 1_000_000
    got = D.gumbel_noise((n,), generator=torch.Generator().manual_seed(5),
                         dtype=getattr(torch, dtype)).float().numpy()
    want = np.asarray(jax.random.gumbel(KEY, (n,), getattr(jnp, dtype))
                      .astype(jnp.float32))
    assert np.isfinite(got).all()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(np.unique(got), np.unique(want))
    else:
        fi = np.finfo(np.float32)
        lo = -np.log(-np.log(np.float32(fi.tiny)))
        hi = -np.log(-np.log(np.float32(1) - fi.eps))
        assert lo <= got.min() and got.max() <= hi
        assert lo <= want.min() and want.max() <= hi


def test_dropout_bf16_replays_a_jax_keep_mask():
    """bf16 x / keep takes keep in bf16 (0.8515625 for 0.85), as JAX's
    weakly typed ``x / keep`` does."""
    jx, x = _bf(_x(6, B, 8, seed=12))
    key = jax.random.fold_in(KEY, 4)
    want = JL.dropout(key, jx, 0.15, True)
    mask = torch.from_numpy(np.array(jax.random.bernoulli(key, 0.85,
                                                          jx.shape)))
    _close(L.dropout(x, 0.15, True, mask=mask), want, exact=True)


# -- modules ------------------------------------------------------------------

def test_vanilla_vae_bf16():
    jx, x = _bf(_x(B, T, 6))
    jmod = JVAE([6, 8, 8], 4)
    params, mod = _port(VanillaVAE, jmod, [6, 8, 8], 4)
    want = jmod.apply(params, jx, rng=KEY)
    got = mod(x, eps=_draw(0, "normal", (B, T, 4)))
    _close(got, want)


def test_gmm_vae_bf16():
    jx, x = _bf(_x(B, T, 6))
    jmod = JGMM([6, 8, 8], 4, 3)
    params, mod = _port(GMMVAE, jmod, [6, 8, 8], 4, 3)
    want = jmod.apply(params, jx, rng=KEY)
    got = mod(x, g=_draw(0, "gumbel", (B, T, 3)),
              eps=_draw(1, "normal", (B, T, 12)))
    for k in ("prior_mean", "prior_log_var"):
        want.pop(k)
    _close(got, want)


def test_hierarchical_vae_bf16():
    jx, x = _bf(_x(B, T, 6))
    s = (np.random.RandomState(1).rand(B, T) > 0.5).astype(np.float32)
    jpi, pi = _bf(np.stack([1 - s, s], axis=2))
    jmod = JHVAE([6, 8, 8], 4, 3)
    params, mod = _port(HierarchicalVAE, jmod, [6, 8, 8], 4, 3)
    want = jmod.apply(params, jx, jpi, rng=KEY)
    noise = {"vanilla_eps": _draw(0, "normal", (B, T, 4)),
             "gumbel_g": _draw(1, "gumbel", (B, T, 3)),
             "gmm_eps": _draw(2, "normal", (B, T, 12))}
    _close(mod(x, pi, noise=noise), want)


def _batch_bits(L=4, C=6):
    rs = np.random.RandomState(8)
    lens = np.array([1.0, 0.78, 0.56], np.float32)
    cn = rs.randint(2, 7, (B, L)).astype(np.int32)
    bnd = np.zeros((B, T), np.float32)
    for i in range(B):
        bnd[i, 0] = 1
        bnd[i, np.sort(rs.choice(np.arange(1, 5), L - 1, replace=False))] = 1
    return _x(B, T, C, seed=11), lens, cn, bnd


def test_phoneme_recognizer_bf16(pallas_interpret):
    x, lens, cn, bnd = _batch_bits()
    args = (6, H, 2, [H, 8, 7], 5)
    jmod = JPR(*args)
    params, mod = _port(PhonemeRecognizer, jmod, *args)
    (jx, tx), (jb, tb) = _bf(x), _bf(bnd)
    want = jmod.apply(params, jx, jnp.asarray(lens), jnp.asarray(cn), None,
                      jb)
    with torch.no_grad():
        got = mod(tx, torch.from_numpy(lens), torch.from_numpy(cn), tb)
    _close(got, want)


def test_boundary_detector_bf16(pallas_interpret):
    x, lens, _, bnd = _batch_bits()
    args = (6, H, 2, [H, 8, 8, 1])
    jmod = JBD(*args)
    params, mod = _port(BoundaryDetector, jmod, *args)
    (jx, tx), (jb, tb) = _bf(x), _bf(bnd)
    want = jmod.apply(params, jx, jnp.asarray(lens), jb, rng=KEY)
    with torch.no_grad():
        got = mod(tx, tb, u=_draw(0, "uniform", (10, B, T)))
    _close(got, want, rtol=2e-2, atol=2e-2)  # see the module header


def test_decoder_bf16(pallas_interpret):
    (jh, h), (jt, tgt) = _bf(_x(B, T, 4, seed=12)), _bf(_x(B, T, 6,
                                                           seed=13))
    args = (4, H, 2, 0.15, [2 * H, 8, 8, 6])
    jmod = JDecoder(*args)
    params, mod = _port(Decoder, jmod, *args)
    want = jmod.apply(params, jh, jt)
    with torch.no_grad():
        got = mod(h, tgt)
    _close(got, want)
