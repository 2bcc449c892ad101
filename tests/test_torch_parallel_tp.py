"""Tensor parallelism of the wav2vec2 trunk in the port against the JAX
package's (``tests/test_parallel_tp.py``), at the tiny width of its test
(``output_size=64``: two layers, two heads, FFN 256):

* ``validate_tp`` and the split of every layer parameter against the JAX
  ``validate_tp`` and ``_W2V_LAYER_RULES``;
* the trunk's forward on two gloo ranks split over the model axis
  (``mlvae_tpu_torch.tools.parallel_step``, one torch thread a rank, the
  launch inside a ``subprocess.run`` of at most 120 s) against the JAX
  forward on a ``make_mesh_2d(1, 2)`` mesh, within 1e-4;
* w2v_LSTM_FC's training steps (the fine-tuned trunk with its dropout,
  the whole-tensor output norm over the global batch) on four ranks, data
  2 x model 2 with ZeRO-1 on the classifier, against one process: losses
  within 1e-5 relative, parameters within rtol 1e-4 / atol 1e-5; and
  their checkpoint: the JAX encoder's stacked layout, restored by every
  rank."""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from mlvae_tpu.modules.wav2vec2 import Wav2Vec2Encoder as JaxEncoder
from mlvae_tpu.parallel import tp as jtp

from mlvae_tpu_torch.bench_utils import (build_w2v_lstm_fc,
                                         synth_w2v_fc_batch)
from mlvae_tpu_torch.convert import from_jax, read_npz_flat
from mlvae_tpu_torch.modules.wav2vec2 import Wav2Vec2Encoder
from mlvae_tpu_torch.parallel import tp
from mlvae_tpu_torch.training.brain import draw_noise
from test_torch_parallel import LOSS_RTOL, RTOL, ATOL, launch

torch.set_num_threads(2)

TINY = dict(conv_dim=(32,) * 7, num_conv_pos_embeddings=16,
            num_conv_pos_embedding_groups=4)
ENC = dict(output_size=64, normalize_wav=False, output_norm=False)
B, SAMPLES = 4, 3200


@pytest.mark.parametrize("heads,inter,n", [(2, 256, 2), (2, 256, 3),
                                           (4, 256, 4), (4, 96, 8),
                                           (16, 4096, 2)])
def test_validate_tp_matches_jax(heads, inter, n):
    kw = dict(output_size=64, num_attention_heads=heads,
              intermediate_size=inter)
    want = jtp.validate_tp(JaxEncoder(**kw), n)
    got = tp.validate_tp(Wav2Vec2Encoder(**kw, **TINY), n)
    assert (got is None) == (want is None)
    if want is not None:
        assert got == want


@pytest.mark.parametrize("name", sorted(jtp._W2V_LAYER_RULES))
def test_layer_splits_match_the_jax_rules(name):
    """A stacked JAX leaf (L, ...) split at dim d is the port's per-layer
    tensor split at d - 1; a replicated one is not split."""
    spec = tuple(jtp._W2V_LAYER_RULES[name])
    want = spec.index(jtp.MODEL_AXIS) - 1 if jtp.MODEL_AXIS in spec \
        else None
    assert tp.W2V_LAYER_SPLITS.get(name) == want


def test_tp_trunk_forward_matches_the_jax_mesh(tmp_path):
    jenc = JaxEncoder(source="", **ENC)
    params = jenc.init(jax.random.PRNGKey(0))
    wav = np.array(jax.random.normal(jax.random.PRNGKey(1), (B, SAMPLES)))
    mesh = jtp.make_mesh_2d(1, 2)
    sharded = jtp.shard_tree(mesh, params,
                             jtp.wav2vec2_partition_specs(params))
    with mesh:
        want = np.asarray(jax.jit(jenc.apply)(
            sharded, jax.device_put(wav, NamedSharding(mesh, P("data")))))
    probe = build_w2v_lstm_fc(overrides={"wav2vec2_size": 64},
                              device="cpu", **ENC)
    sd = dict(probe.state_dict())
    sd.update(from_jax({"wav2vec2": jax.device_get(params)}))
    batch = {"wav": (torch.from_numpy(wav), torch.ones(B)),
             "feat": (torch.zeros(B, want.shape[1], 120), torch.ones(B))}
    (ranks,) = launch([dict(
        kind="w2v_lstm_fc", build=dict(overrides={"wav2vec2_size": 64},
                                       **ENC),
        world=2, n_model=2, device="cpu", state_dict=sd, batch=batch,
        steps=[{"epoch": 1, "trunk": True}])], tmp_path)
    for out in ranks:
        got = out["steps"][0]["preds"]["trunk"].numpy()
        assert got.shape == want.shape
        assert np.max(np.abs(got - want)) < 1e-4


@pytest.fixture(scope="module")
def dp_tp_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    build = dict(overrides={"wav2vec2_size": 64}, **TINY)
    batch = synth_w2v_fc_batch(B, SAMPLES, seed=0, device="cpu")
    probe = build_w2v_lstm_fc(device="cpu", **build)
    noise = [draw_noise(probe.step_draws(batch, True),
                        torch.Generator().manual_seed(s), "cpu")
             for s in (3, 4)]
    spec = dict(kind="w2v_lstm_fc", build=build, device="cpu",
                run_opts={"zero1": True}, batch=batch,
                steps=[{"epoch": 1, "noise": nz} for nz in noise]
                + [{"epoch": 1, "eval": True, "test": True}])
    one, four = launch([dict(spec, world=0, checkpoint=str(tmp / "one")),
                        dict(spec, world=4, n_model=2,
                             checkpoint=str(tmp / "four"))], tmp)
    return one[0], four, tmp


def test_dp_tp_steps_match_one_process(dp_tp_runs):
    one, four, _ = dp_tp_runs
    for i, want in enumerate(one["steps"]):
        for out in four:
            np.testing.assert_allclose(out["steps"][i]["loss"],
                                       want["loss"], rtol=LOSS_RTOL,
                                       err_msg=f"step {i + 1}")
    np.testing.assert_allclose(
        four[0]["steps"][-1]["preds"]["logits"].numpy(),
        one["steps"][-1]["preds"]["logits"].numpy(), atol=1e-5)
    for key, value in one["state_dict"].items():
        for out in four:
            np.testing.assert_allclose(out["state_dict"][key].numpy(),
                                       value.numpy(), rtol=RTOL, atol=ATOL,
                                       err_msg=key)
    # the trunk trained: its moments whole again, the classifier's in pieces
    assert set(four[0]["moments"]) == set(one["moments"])
    assert 0.5 < four[0]["moment_shard_fraction"] < 1.0
    assert all(out["restored"] for out in four) and one["restored"]


def test_dp_tp_checkpoint_keeps_the_jax_layout(dp_tp_runs):
    _, _, tmp = dp_tp_runs
    ckpts = {name: next((tmp / name).iterdir()) for name in ("one", "four")}
    for blob in ("params", "states", "opt__adam_opt", "opt__wav2vec_opt"):
        got = read_npz_flat(ckpts["four"] / f"{blob}.npz")
        want = read_npz_flat(ckpts["one"] / f"{blob}.npz")
        assert sorted(got) == sorted(want), blob
        for key in want:
            assert got[key].shape == want[key].shape, key
    params = read_npz_flat(ckpts["four"] / "params.npz")
    jenc = JaxEncoder(source="", output_size=64, **TINY)
    tree = jax.eval_shape(jenc.init, jax.random.PRNGKey(0))
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            {"wav2vec2": tree})[0]:
        key = jax.tree_util.keystr(path)
        assert params[key].shape == tuple(leaf.shape), key
