"""Module-by-module parity of the port against the JAX package at narrow
widths: the same weights (carried by ``convert.from_jax``), the same
inputs made with numpy, and the JAX draws replayed as explicit noise.
f32 tolerance rtol 1e-5, atol 1e-6 unless a case states its own."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

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
from mlvae_tpu.utils import tensor as jtensor

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
from mlvae_tpu_torch.utils import tensor as ttensor

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
B, T = 3, 9
KEY = jax.random.PRNGKey(5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=RTOL, atol=ATOL):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], rtol, atol)
        return
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _draw(i, kind, shape):
    k = jax.random.fold_in(KEY, i)
    fn = {"normal": jax.random.normal, "uniform": jax.random.uniform,
          "gumbel": jax.random.gumbel}[kind]
    return np.asarray(fn(k, shape, jnp.float32))


def _port(module_cls, jmod, *args, **kwargs):
    params = jmod.init(jax.random.PRNGKey(2))
    mod = module_cls(*args, **kwargs)
    mod.load_state_dict(from_jax(params))
    return params, mod


def _x(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


# -- layers -----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["linear", "fc_end", "fc_plain"])
def test_dense_layers(kind):
    x = _x(B, T, 6)
    if kind == "linear":
        jmod, args, kw = JLinear(6, 5), (6, 5), {}
        cls = Linear
    else:
        end = kind == "fc_end"
        jmod = JFC([6, 8, 4], end_activation=end)
        cls, args, kw = FCBlock, ([6, 8, 4],), {"end_activation": end}
    params, mod = _port(cls, jmod, *args, **kw)
    _close(mod(_t(x)), jmod.apply(params, jnp.asarray(x)))


@pytest.mark.parametrize("update", [False, True])
def test_input_normalization(update):
    C = 7
    feats = _x(B, T, C, seed=1, scale=2.0) + 0.5
    lens = np.array([1.0, 0.8, 0.55], np.float32)
    jnorm = JNorm(norm_type="global")
    rs = np.random.RandomState(3)
    state = {"count": np.float32(4.0),
             "glob_mean": rs.randn(C).astype(np.float32) * 0.1,
             "glob_std": (1 + rs.rand(C)).astype(np.float32)}
    out_j, new_j = jnorm.apply({k: jnp.asarray(v) for k, v in state.items()},
                               jnp.asarray(feats), jnp.asarray(lens),
                               epoch=1, update=update)
    norm = InputNormalization(C)
    norm.load_state_dict(from_jax(state))
    out = norm(_t(feats), _t(lens), epoch=1, update=update)
    _close(out, out_j)
    _close(dict(norm.named_buffers()), new_j)
    assert out.dtype == torch.float32
    assert norm(_t(feats).double(), _t(lens)).dtype == torch.float64


def test_length_conventions():
    lens = np.array([1.0, 0.8, 0.55, 0.45], np.float32)  # 0.45*10 = 4.5
    got = ttensor.abs_lengths(_t(lens), 10)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jtensor.abs_lengths(lens, 10)))
    loss = _x(4, 10, 3, seed=4)
    _close(ttensor.apply_lens_to_loss(_t(loss), _t(lens)),
           jtensor.apply_lens_to_loss(jnp.asarray(loss), jnp.asarray(lens)))
    _close(ttensor.length_mask(_t(lens), 10),
           jtensor.length_mask(jnp.asarray(lens), 10))
    for mine, theirs in zip(ttensor.undo_padding(loss, lens),
                            jtensor.undo_padding(loss, lens)):
        np.testing.assert_array_equal(mine, theirs)
    bnd = (np.random.RandomState(5).rand(4, 10) > 0.6).astype(np.float32)
    np.testing.assert_array_equal(
        ttensor.boundary_to_phoneme_index(_t(bnd)).numpy(),
        np.asarray(jtensor.boundary_to_phoneme_index(jnp.asarray(bnd))))


# -- distributions ------------------------------------------------------------

def _dist_cases():
    m, lv = _x(B, T, 4, seed=1), _x(B, T, 4, seed=2, scale=0.5)
    pm, plv = _x(B, T, 4, seed=3), _x(B, T, 4, seed=4, scale=0.5)
    tgt = _x(B, T, 4, seed=5)
    logits = _x(B, T, 3, seed=6, scale=2.0)
    a = np.abs(_x(10, B, T, seed=7)) + 0.1
    b = np.abs(_x(10, B, T, seed=8)) + 0.1
    probs = np.random.RandomState(9).rand(B, T).astype(np.float32)
    probs[0, :2] = [0.0, 1.0]
    labels = (np.random.RandomState(10).rand(B, T) > 0.5).astype(np.float32)
    eps = _draw(0, "normal", (B, T, 4))
    g = _draw(1, "gumbel", (B, T, 3))
    u = _draw(2, "uniform", (10, B, T))
    k = jax.random.fold_in
    return {
        "reparameterize": (
            lambda: D.reparameterize(_t(m), _t(lv), eps=_t(eps)),
            lambda: JD.reparameterize(k(KEY, 0), m, lv)),
        "kld_std_normal": (lambda: D.kld_std_normal(_t(m), _t(lv)),
                           lambda: JD.kld_std_normal(m, lv)),
        "kld_gaussian_prior": (
            lambda: D.kld_gaussian_prior(_t(pm), _t(plv), _t(m), _t(lv)),
            lambda: JD.kld_gaussian_prior(pm, plv, m, lv)),
        "gaussian_nll": (lambda: D.gaussian_nll(_t(m), _t(lv), _t(tgt)),
                         lambda: JD.gaussian_nll(m, lv, tgt)),
        "gumbel_softmax": (
            lambda: D.gumbel_softmax(_t(logits), 0.1, g=_t(g)),
            lambda: JD.gumbel_softmax(k(KEY, 1), logits, 0.1, True)),
        "kumaraswamy_sample": (
            lambda: D.kumaraswamy_sample(_t(a), _t(b), u=_t(u)),
            lambda: JD.kumaraswamy_sample(k(KEY, 2), a, b)),
        "kld_beta": (lambda: D.kld_beta(_t(a), _t(b), 1.0, 9.0),
                     lambda: JD.kld_beta(a, b, 1.0, 9.0)),
        "bce": (lambda: D.bce(_t(probs), _t(labels)),
                lambda: JD.bce(probs, labels)),
        "bce_with_logits": (
            lambda: D.bce_with_logits(_t(logits[..., 0]), _t(labels)),
            lambda: JD.bce_with_logits(logits[..., 0], labels)),
        "categorical_log_prob": (
            lambda: D.categorical_log_prob(_t(logits),
                                           _t(labels.astype(np.int64))),
            lambda: JD.categorical_log_prob(logits, labels.astype(np.int32))),
    }


# digamma/lgamma and pow are separate implementations in the two libraries
_DIST_RTOL = {"kld_beta": 1e-4, "kumaraswamy_sample": 1e-4}


@pytest.mark.parametrize("name", sorted(_dist_cases()))
def test_dist_functions(name):
    got, want = _dist_cases()[name]
    _close(got(), want(), rtol=_DIST_RTOL.get(name, RTOL), atol=1e-5
           if name in _DIST_RTOL else ATOL)


def test_categorical_sample_replays_jax_exactly():
    """``jax.random.categorical`` is the Gumbel-max trick on
    ``gumbel(key, logits.shape)`` for the installed jax: replaying that
    draw gives its sample, element for element."""
    logits = _x(8, 50, 2, seed=11, scale=0.5)
    key = jax.random.fold_in(KEY, 3)
    want = np.asarray(JD.categorical_sample(key, jnp.asarray(logits)))
    g = np.asarray(jax.random.gumbel(key, logits.shape, jnp.float32))
    got = D.categorical_sample(_t(logits), g=_t(g))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.mean() < 1


def test_dropout_replays_a_jax_keep_mask():
    x = _x(6, B, 8, seed=12)
    key = jax.random.fold_in(KEY, 4)
    want = JL.dropout(key, jnp.asarray(x), 0.15, True)
    mask = np.asarray(jax.random.bernoulli(key, 0.85, x.shape))
    _close(L.dropout(_t(x), 0.15, True, mask=_t(mask)), want)
    assert torch.equal(L.dropout(_t(x), 0.15, False, mask=_t(mask)), _t(x))


# -- modules --------------------------------------------------------------------

def test_vanilla_vae():
    x = _x(B, T, 6)
    jmod = JVAE([6, 8, 8], 4)
    params, mod = _port(VanillaVAE, jmod, [6, 8, 8], 4)
    want = jmod.apply(params, jnp.asarray(x), rng=KEY)
    got = mod(_t(x), eps=_t(_draw(0, "normal", (B, T, 4))))
    _close(got, want)


def test_gmm_vae():
    x = _x(B, T, 6)
    jmod = JGMM([6, 8, 8], 4, 3)
    params, mod = _port(GMMVAE, jmod, [6, 8, 8], 4, 3)
    want = jmod.apply(params, jnp.asarray(x), rng=KEY)
    got = mod(_t(x), g=_t(_draw(0, "gumbel", (B, T, 3))),
              eps=_t(_draw(1, "normal", (B, T, 12))))
    for k in ("prior_mean", "prior_log_var"):
        want.pop(k)
    _close(got, want)


def test_hierarchical_vae():
    x = _x(B, T, 6)
    s = (np.random.RandomState(1).rand(B, T) > 0.5).astype(np.float32)
    pi = np.stack([1 - s, s], axis=2)
    jmod = JHVAE([6, 8, 8], 4, 3)
    params, mod = _port(HierarchicalVAE, jmod, [6, 8, 8], 4, 3)
    want = jmod.apply(params, jnp.asarray(x), jnp.asarray(pi), rng=KEY)
    noise = {"vanilla_eps": _t(_draw(0, "normal", (B, T, 4))),
             "gumbel_g": _t(_draw(1, "gumbel", (B, T, 3))),
             "gmm_eps": _t(_draw(2, "normal", (B, T, 12)))}
    _close(mod(_t(x), _t(pi), noise=noise), want)


def _batch_bits(L=4, C=6):
    rs = np.random.RandomState(8)
    lens = np.array([1.0, 0.78, 0.56], np.float32)
    cn = rs.randint(2, 7, (B, L)).astype(np.int32)
    bnd = np.zeros((B, T), np.float32)
    for i in range(B):
        bnd[i, 0] = 1
        bnd[i, np.sort(rs.choice(np.arange(1, 5), L - 1, replace=False))] = 1
    return _x(B, T, C, seed=11), lens, cn, bnd


def test_phoneme_recognizer():
    x, lens, cn, bnd = _batch_bits()
    args = (6, 16, 2, [16, 8, 7], 5)
    jmod = JPR(*args)
    params, mod = _port(PhonemeRecognizer, jmod, *args)
    want = jmod.apply(params, jnp.asarray(x), jnp.asarray(lens),
                      jnp.asarray(cn), None, jnp.asarray(bnd))
    with torch.no_grad():
        got = mod(_t(x), _t(lens), _t(cn), _t(bnd))
    _close(got, want)


def test_boundary_detector():
    x, lens, _, bnd = _batch_bits()
    args = (6, 16, 2, [16, 8, 8, 1])
    jmod = JBD(*args)
    params, mod = _port(BoundaryDetector, jmod, *args)
    want = jmod.apply(params, jnp.asarray(x), jnp.asarray(lens),
                      jnp.asarray(bnd), rng=KEY)
    with torch.no_grad():
        got = mod(_t(x), _t(bnd), u=_t(_draw(0, "uniform", (10, B, T))))
    _close(got, want, rtol=1e-4, atol=1e-5)  # lgamma/digamma, pow


def test_decoder():
    h, tgt = _x(B, T, 4, seed=12), _x(B, T, 6, seed=13)
    args = (4, 16, 2, 0.15, [32, 8, 8, 6])
    jmod = JDecoder(*args)
    params, mod = _port(Decoder, jmod, *args)
    want = jmod.apply(params, jnp.asarray(h), jnp.asarray(tgt))
    with torch.no_grad():
        got = mod(_t(h), _t(tgt))
    _close(got, want)
