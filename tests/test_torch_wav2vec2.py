"""The port's wav2vec2 encoder (``modules/wav2vec2.py``) against the JAX
module, on the CPU, for both HF families at a tiny width (hidden 64, 2
layers, 2 heads, seven convs of 32 channels, a 16-tap positional conv in
4 groups), the JAX parameters carried across by ``from_jax`` (which
unstacks the JAX module's layer axis):

* eval outputs, f32: atol 2e-5; bf16 (both on bf16 parameters and
  waves): atol 6.25e-2, eight bf16 steps at 1.0 of the normalized output
  (every stage alone is bit-equal to the JAX ops run one by one, but XLA
  fuses the compiled layer scan's bf16 ops, which rounds differently in
  about a third of the values);
* a fine-tuned (``freeze: False``) training forward with every dropout
  site replayed from the JAX stream, and the gradients of every
  parameter and of the waves against ``jax.grad``: rel 1e-4 in norm (the
  key biases', zero but for rounding, against 1e-3 of the whole
  gradient's norm);
* ``freeze`` stops gradients; ``to_jax`` stacks the layers back;
  ``conv_output_length``; the draws' layout;
* the HF names: a tiny ``transformers`` ``Wav2Vec2Model`` of each family
  saved as a snapshot (safetensors and ``pytorch_model.bin``) loads into
  the port by ``json`` and ``torch`` alone and gives HF's
  ``last_hidden_state`` (atol 1e-4) and the JAX module's output from the
  same snapshot (skipped where ``transformers`` is not installed)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mlvae_tpu.modules.wav2vec2 import Wav2Vec2Encoder as JaxEncoder
from mlvae_tpu.nn.core import RngStream

from mlvae_tpu_torch.convert import from_jax, to_jax
from mlvae_tpu_torch.modules import wav2vec2 as W

torch.set_num_threads(2)

F32_ATOL, BF16_ATOL, RTOL = 2e-5, 6.25e-2, 1e-4
TINY = dict(conv_dim=(32,) * 7, num_conv_pos_embeddings=16,
            num_conv_pos_embedding_groups=4)
FAMILIES = {
    "large": dict(output_size=64, **TINY),
    "base": dict(output_size=768, hidden_size=64, num_hidden_layers=2,
                 num_attention_heads=2, intermediate_size=128, **TINY),
}


def replay(draws, rng):
    """The port's named draws made as the JAX step makes them: draw i from
    ``fold_in(rng, i)`` in the draw's dtype; ``bernoulli_split`` (the
    encoder's layer sites) splits that key into one a site, in order; a
    dropout mask, or a name that repeats, goes into a list."""
    names = [d[0] for d in draws]
    noise = {}
    for i, (name, kind, shape, keep, dtype) in enumerate(draws):
        k = jax.random.fold_in(rng, i)
        if kind == "bernoulli_split":
            keys = jax.random.split(k, len(shape))
            noise[name] = [torch.from_numpy(np.array(
                jax.random.bernoulli(kk, p, s)))
                for kk, p, s in zip(keys, keep, shape)]
            continue
        if kind == "bernoulli":
            v = torch.from_numpy(np.array(jax.random.bernoulli(k, keep,
                                                               shape)))
        else:
            fn = {"uniform": jax.random.uniform,
                  "normal": jax.random.normal,
                  "gumbel": jax.random.gumbel}[kind]
            jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
            v = torch.from_numpy(np.array(
                fn(k, shape, jd).astype(jnp.float32))).to(dtype)
        if kind == "bernoulli" or names.count(name) > 1:
            noise.setdefault(name, []).append(v)
        else:
            noise[name] = v
    return noise


def pair(family, **kw):
    args = dict(FAMILIES[family], **kw)
    jm = JaxEncoder(**args)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    pm = W.Wav2Vec2Encoder(**args)
    sd = {k[len("e."):]: v for k, v in from_jax({"e": params}).items()}
    pm.load_state_dict(sd, strict=True)
    return jm, params, pm


def _wav(B=3, n=4000, seed=0):
    return np.random.RandomState(seed).randn(B, n).astype(np.float32)


def _norm_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_eval_matches_jax_f32_and_bf16(family):
    jm, params, pm = pair(family)
    assert pm.feat_extract_norm == ("layer" if family == "large"
                                    else "group")
    assert pm.do_stable_layer_norm == (family == "large")
    wav = _wav()
    want = np.asarray(jm.apply(params, wav))
    got = pm(torch.from_numpy(wav))
    assert got.shape == want.shape == (3, W.conv_output_length(4000), 64)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL)
    pb = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                params)
    want_b = np.asarray(jm.apply(pb, jnp.asarray(wav, jnp.bfloat16))
                        .astype(jnp.float32))
    got_b = torch.func.functional_call(
        pm, {n: p.to(torch.bfloat16) for n, p in pm.named_parameters()},
        (torch.from_numpy(wav).to(torch.bfloat16),))
    assert got_b.dtype == torch.bfloat16
    np.testing.assert_allclose(got_b.float().numpy(), want_b,
                               atol=BF16_ATOL)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_fine_tuned_forward_and_grads_match_jax(family):
    jm, params, pm = pair(family, freeze=False)
    wav = _wav(B=2, n=3600, seed=1)
    T = W.conv_output_length(3600)
    rng = jax.random.PRNGKey(5)
    draws = pm.draws(2, T, train=True)
    assert [d[0] for d in draws] == ["w2v_feat_proj_dropout",
                                     "w2v_hidden_dropout",
                                     "w2v_layer_dropout"]
    assert len(draws[2][2]) == 4 * pm.num_hidden_layers
    assert draws[2][2][0] == (2, pm.num_attention_heads, T, T)
    noise = replay(draws, rng)
    w = np.random.RandomState(2).randn(2, T, 64).astype(np.float32)

    def jloss(p, x):
        out = jm.apply(p, x, rng=RngStream(rng), train=True)
        return jnp.sum(out * w), out
    (_, want), (jg, jdx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(wav))
    x = torch.from_numpy(wav).requires_grad_(True)
    out = pm(x, train=True, noise=noise)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=F32_ATOL)
    (out * torch.from_numpy(w)).sum().backward()
    assert _norm_err(x.grad.numpy(), jdx) <= RTOL
    want_g = {k[len("e."):]: v for k, v in
              from_jax({"e": jax.device_get(jg)}).items()}
    # the key biases' gradients are zero but for rounding (a constant
    # added to every key's score): each error is measured against at
    # least 1e-3 of the whole gradient's norm
    floor = 1e-3 * float(np.sqrt(sum(float((v ** 2).sum())
                                      for v in want_g.values())))
    for name, p in pm.named_parameters():
        err = float(np.linalg.norm(p.grad.numpy() - want_g[name].numpy()))
        assert err <= RTOL * max(float(np.linalg.norm(want_g[name])),
                                 floor), name


def test_freeze_stops_gradients_and_dropout():
    _, _, pm = pair("large", freeze=True)
    x = torch.from_numpy(_wav(B=1, n=3200)).requires_grad_(True)
    out = pm(x, train=True)
    assert not out.requires_grad
    assert pm.draws(1, 9, train=True) == []
    np.testing.assert_array_equal(out.numpy(), pm(x).numpy())


def test_to_jax_stacks_the_layers():
    jm, params, pm = pair("large")
    back, _ = to_jax({f"e.{k}": v for k, v in pm.state_dict().items()})
    flat_want = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_got = dict((jax.tree_util.keystr(p), v) for p, v in
                    jax.tree_util.tree_flatten_with_path(back["e"])[0])
    assert len(flat_got) == len(flat_want)
    for path, v in flat_want:
        np.testing.assert_array_equal(flat_got[jax.tree_util.keystr(path)],
                                      np.asarray(v))
    assert back["e"]["layers"]["q_w"].shape == (2, 64, 64)


def test_conv_output_length_and_frame_rate():
    assert W.conv_output_length(16000) == 49
    enc = W.Wav2Vec2Encoder(output_size=64, **TINY)
    assert enc(torch.zeros(2, 16000)).shape == (2, 49, 64)
    assert enc.conv_output_length(16000) == 49


# ---------------------------------------------------------------------------
# HF snapshots: the port reads them without transformers
# ---------------------------------------------------------------------------

def _make_hf(snap_dir, stable, safe):
    transformers = pytest.importorskip("transformers")
    cfg = transformers.Wav2Vec2Config(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, conv_dim=[16, 16, 16], conv_kernel=[10, 3, 2],
        conv_stride=[5, 2, 2], num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=2, do_stable_layer_norm=stable,
        feat_extract_norm="layer" if stable else "group",
        conv_bias=stable, apply_spec_augment=False, hidden_dropout=0.0,
        attention_dropout=0.0, feat_proj_dropout=0.0,
        activation_dropout=0.0, layerdrop=0.0)
    torch.manual_seed(0)
    model = transformers.Wav2Vec2Model(cfg).eval()
    model.save_pretrained(snap_dir, safe_serialization=safe)
    return model


@pytest.mark.parametrize("safe", [True, False],
                         ids=["safetensors", "pytorch_model_bin"])
@pytest.mark.parametrize("stable", [False, True],
                         ids=["base-groupnorm", "large-stable-ln"])
def test_hf_snapshot_matches_transformers_and_jax(tmp_path, stable, safe):
    snap = tmp_path / "snap"
    model = _make_hf(snap, stable, safe)
    enc = W.Wav2Vec2Encoder(source=str(snap), output_norm=False,
                            normalize_wav=False, freeze=True)
    assert enc.pretrained_loaded
    assert enc.do_stable_layer_norm == stable
    assert enc.hidden_size == 32 and enc.num_hidden_layers == 2
    wav = np.random.RandomState(1).randn(3, 2000).astype(np.float32)
    got = enc(torch.from_numpy(wav)).numpy()
    with torch.no_grad():
        theirs = model(torch.from_numpy(wav)).last_hidden_state.numpy()
    assert got.shape == theirs.shape
    np.testing.assert_allclose(got, theirs, atol=1e-4)
    jm = JaxEncoder(source=str(snap), output_norm=False, normalize_wav=False)
    jp = jm.init(jax.random.PRNGKey(0))
    np.testing.assert_allclose(got, np.asarray(jm.apply(jp, wav)),
                               atol=F32_ATOL)
    # save_path is the fallback, an absent source keeps the random init
    enc2 = W.Wav2Vec2Encoder(source=str(tmp_path / "absent"),
                             save_path=str(snap))
    assert enc2.pretrained_loaded
    assert not W.Wav2Vec2Encoder(source=str(tmp_path / "absent"),
                                 output_size=64, **TINY).pretrained_loaded
