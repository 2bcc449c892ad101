"""Data parallelism and ZeRO-1 in the port against the JAX package's data
parallelism on a two-device CPU mesh (``tests/test_data_parallel.py``'s
step), at narrow widths (H=32, B=5 replica-padded to 6, T=24, L=4):

* the rank layout, the backend rule, the padding and the row split;
* two gloo ranks (``mlvae_tpu_torch.tools.parallel_step``, each rank on
  one torch thread, the launch inside a ``subprocess.run`` of at most 120
  s, the port from ``mesh.free_port``) against the JAX DP step with every
  draw replayed: an epoch-1 step (the normalizer's buffers update over
  the global batch), an epoch-3 VAE step, then the TEST eval step: losses
  within 1e-5 relative, parameters within ``tests/test_data_parallel.py``'s
  rtol 1e-4 / atol 1e-5, the normalizer's buffers, and the decode's outputs
  trimmed of the padding row bit for bit;
* ZeRO-1 bit-equal to replicated data parallelism (parameters and Adam
  moments), half the moments' bytes a rank, and its checkpoint read back by
  the JAX checkpointer in the JAX layout and restored by the ranks;
* ``--data_parallel`` / ``--zero1`` / ``--ckpt_opt_state False`` through
  ``Brain``'s run options and ``MDModel.checkpoint_state``;
* ``cli.train`` / ``cli.test --data_parallel True --num_devices 2
  --device cpu`` (batches of 5, padded to 6; a valid and a test batch of
  1, padded to 2) against one process on the same seed that pads its
  batches as two ranks do (``parallel_step.padded_as_ranks``): every TRAIN
  and VALID scalar as logged, the checkpoint's parameters and the TEST
  metrics."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mlvae_tpu.bench_utils import build_md_vae as jax_build_md_vae
from mlvae_tpu.bench_utils import synth_batch as jax_synth_batch
from mlvae_tpu.parallel import tp as jtp
from mlvae_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from mlvae_tpu.training.brain import Stage as JaxStage
from mlvae_tpu.training.checkpointer import Checkpointer as JaxCheckpointer

from mlvae_tpu_torch.bench_utils import RECIPE, build_md_vae, synth_batch
from mlvae_tpu_torch.convert import from_jax
from mlvae_tpu_torch.parallel import mesh as M
from mlvae_tpu_torch.parallel import zero1
from mlvae_tpu_torch.training.brain import Brain
from test_torch_train_step import SMALL, _replay

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
B, T, L = 5, 24, 4
N = 2
BP = B + (-B) % N      # the replica-padded batch
LOSS_RTOL, RTOL, ATOL = 1e-5, 1e-4, 1e-5
RUN_TIMEOUT = 120
EPOCHS = (1, 3)        # PHN_RECOG (the normalizer updates), then VAE


def launch(specs, tmp_path):
    """Run each spec through ``tools.parallel_step`` in its own process,
    all at once, each bounded; returns each run's per-rank outputs."""
    procs = []
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    for i, spec in enumerate(specs):
        spec = dict(spec, out=str(tmp_path / f"out{i}"), threads=1)
        path = tmp_path / f"spec{i}.pt"
        torch.save(spec, path)
        procs.append((spec, subprocess.Popen(
            [sys.executable, "-m", "mlvae_tpu_torch.tools.parallel_step",
             str(path)], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    outs = []
    for spec, proc in procs:
        try:
            log, _ = proc.communicate(timeout=RUN_TIMEOUT)
        except subprocess.TimeoutExpired:
            for _, p in procs:
                p.kill()
            raise
        assert proc.returncode == 0, log[-4000:]
        world = max(spec["world"], 1)
        outs.append([torch.load(Path(spec["out"]) / f"rank{r}.pt",
                                weights_only=False) for r in range(world)])
    return outs


# -- the layout ------------------------------------------------------------------
@pytest.mark.parametrize("n_data,n_model", [(1, 2), (2, 1), (2, 2), (4, 2),
                                            (2, 4)])
def test_rank_grid_matches_make_mesh_2d(n_data, n_model):
    mesh = jtp.make_mesh_2d(n_data, n_model)
    want = np.vectorize(lambda d: d.id)(mesh.devices)
    np.testing.assert_array_equal(M.rank_grid(n_data, n_model), want)


def test_split_is_checked_with_the_jax_message():
    with pytest.raises(ValueError,
                       match="num_devices=3 not divisible by "
                             "tensor_parallel=2"):
        M.check_split(3, 2)
    M.check_split(4, 2)


@pytest.mark.parametrize("device,world,cards,want", [
    ("cpu", 2, 0, "gloo"), ("cuda", 2, 1, "gloo"), ("cuda", 2, 2, "nccl"),
    ("cuda", 1, 1, "nccl"), ("cuda", 4, 2, "gloo")])
def test_backend_rule(device, world, cards, want):
    assert M.choose_backend(device, world, cards) == want


@pytest.mark.parametrize("n", [1, 4, 5, 7, 8])
def test_pad_rows_repeats_the_last_row_like_jax(n):
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    got = M.pad_rows(x, 4)
    assert got.shape[0] == M.padded_rows(n, 4) == n + (-n) % 4
    np.testing.assert_array_equal(got[:n], x)
    assert (got[n:] == x[-1]).all()
    t = M.pad_rows(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(t.numpy(), got)


@pytest.mark.parametrize("n,k", [(10, 2), (7, 3), (1, 4), (16, 4)])
def test_zero1_pieces_cover_the_vector(n, k):
    flat = torch.arange(n, dtype=torch.float32)
    pieces = []
    for r in range(k):
        mesh = M.Mesh(k, r, k, 1, "gloo", torch.device("cpu"))
        pieces.append(zero1.split_flat(flat, mesh))
    assert len({p.numel() for p in pieces}) == 1
    np.testing.assert_array_equal(torch.cat(pieces)[:n].numpy(),
                                  flat.numpy())
    assert not torch.cat(pieces)[n:].any()


def test_ported_run_options_pass_and_the_rest_name_item_12b():
    """Every run option builds a Brain (item 12b is ported): one process
    takes the options of the ranks' runs and of one run alike; only
    ``--data_parallel`` / ``--tensor_parallel`` need the ranks."""
    brain = Brain({}, run_opts={"num_devices": 2, "zero1": True,
                                "ckpt_opt_state": False, "scan_epoch": True,
                                "async_ckpt": True,
                                "cache_device_batches": False,
                                "profile": True})
    assert brain.mesh.world == 1 and brain.zero1
    assert not brain.ckpt_opt_state and brain.scan_epoch and brain.profile
    assert not brain.cache_device_batches and not brain.use_scan()
    for opts in ({"data_parallel": True}, {"tensor_parallel": 2}):
        with pytest.raises(RuntimeError, match="parallel.mesh.launch"):
            Brain({}, run_opts=opts)


def test_a_dp_brain_needs_the_ranks():
    with pytest.raises(RuntimeError, match="parallel.mesh.launch"):
        build_md_vae(batch_size=2, overrides=SMALL, device="cpu",
                     run_opts={"data_parallel": True})


def test_ckpt_opt_state_false_leaves_the_optimizer_out():
    model = build_md_vae(batch_size=2, overrides=SMALL, device="cpu",
                         run_opts={"ckpt_opt_state": False, "zero1": True})
    assert not model.zero1_keys          # no data axis: a warning only
    state = model.checkpoint_state()
    assert sorted(state) == ["params", "states"]
    model.ckpt_opt_state = True
    assert "opt__optimizer" in model.checkpoint_state()


# -- two ranks against the JAX DP step ---------------------------------------------
@pytest.fixture(scope="module")
def jax_run():
    """The JAX model's start, its DP steps on a 2-device mesh, the TEST eval
    step after them, and each step's key."""
    model = jax_build_md_vae(batch_size=B, overrides=dict(SMALL))
    model.init_params()
    model.ensure_states(RECIPE["input_size"])
    rs = np.random.RandomState(1)
    C = RECIPE["input_size"]
    model.states["normalizer"] = {
        "count": jnp.float32(12.0),
        "glob_mean": jnp.asarray(rs.randn(C).astype(np.float32) * 0.2),
        "glob_std": jnp.asarray((0.5 + rs.rand(C)).astype(np.float32))}
    model.init_optimizers()
    start = (jax.device_get(model.params), jax.device_get(model.states))
    batch = jax_synth_batch(B, T, L, seed=0)
    padded = {k: tuple(np.asarray(M.pad_rows(np.asarray(a), N))
                       for a in v) for k, v in batch.items()}
    mesh = make_mesh(N)
    p, o, s = (replicate(mesh, t) for t in (model.params, model.opt_states,
                                              model.states))
    sharded = shard_batch(mesh, padded)
    keys = [jax.random.PRNGKey(40 + e) for e in EPOCHS]
    losses = []
    for epoch, key in zip(EPOCHS, keys):
        model.on_stage_start(JaxStage.TRAIN, epoch)
        step = model._get_compiled("train", JaxStage.TRAIN)
        p, o, s, loss, ls = step(p, o, s, key, sharded, jnp.int32(epoch))
        losses.append((float(loss), {k: float(v) for k, v in ls.items()}))
    model.on_stage_start(JaxStage.TEST)
    eval_key = jax.random.PRNGKey(77)
    preds, e_loss, e_ls = model._get_compiled("eval", JaxStage.TEST)(
        p, s, eval_key, sharded, jnp.int32(EPOCHS[-1]))
    # the step donated the model's trees: keep the host copies after it
    model.params, model.states, model.opt_states = (
        jax.device_get(t) for t in (p, s, o))
    return dict(model=model, start=start, losses=losses, keys=keys,
                eval_key=eval_key, params=model.params, states=model.states,
                opt=model.opt_states,
                eval=(jax.device_get(preds), float(e_loss)))


@pytest.fixture(scope="module")
def port_runs(jax_run, tmp_path_factory):
    """Two gloo ranks, replicated and ZeRO-1 (with a checkpoint), on the JAX
    weights and draws."""
    tmp = tmp_path_factory.mktemp("dp")
    params, states = jax_run["start"]
    probe = build_md_vae(batch_size=B, overrides=SMALL, device="cpu")
    steps = []
    for epoch, key in zip(EPOCHS, jax_run["keys"]):
        probe.set_stage(probe_stage(), epoch)
        steps.append({"epoch": epoch,
                      "noise": _replay(probe.draws(BP, T, True), key)})
    probe.set_stage(_eval_stage())
    steps.append({"epoch": EPOCHS[-1], "eval": True, "test": True,
                  "noise": _replay(probe.draws(BP, T, False),
                                   jax_run["eval_key"])})
    spec = dict(kind="md_vae", build=dict(batch_size=B, overrides=SMALL),
                world=N, device="cpu", state_dict=from_jax(params, states),
                batch=synth_batch(B, T, L, seed=0, device="cpu"),
                steps=steps)
    rep, z1 = launch([spec, dict(spec, run_opts={"zero1": True},
                                 checkpoint=str(tmp / "ckpt"))], tmp)
    return dict(replicated=rep, zero1=z1, ckpt=tmp / "ckpt")


def probe_stage():
    from mlvae_tpu_torch.training.brain import Stage
    return Stage.TRAIN


def _eval_stage():
    from mlvae_tpu_torch.training.brain import Stage
    return Stage.TEST


def test_dp_steps_match_the_jax_dp_step(jax_run, port_runs):
    rank0 = port_runs["replicated"][0]
    for i, (want, want_ls) in enumerate(jax_run["losses"]):
        got = rank0["steps"][i]
        np.testing.assert_allclose(got["loss"], want, rtol=LOSS_RTOL,
                                   err_msg=f"step {i + 1}")
        assert set(got["losses"]) == set(want_ls)
        for key in want_ls:
            np.testing.assert_allclose(got["losses"][key], want_ls[key],
                                       rtol=LOSS_RTOL, atol=1e-7,
                                       err_msg=f"step {i + 1} {key}")
    want = from_jax(jax_run["params"], jax_run["states"])
    got = rank0["state_dict"]
    assert sorted(got) == sorted(want)
    for key in want:
        if key.startswith("normalizer."):
            continue
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=key)


def test_normalizer_buffers_follow_the_global_batch(jax_run, port_runs):
    want = jax_run["states"]["normalizer"]
    got = port_runs["replicated"][0]["state_dict"]
    # epoch 1 updated them over the 6 rows of the padded batch
    assert float(got["normalizer.count"]) == float(want["count"]) == 18.0
    for key in ("glob_mean", "glob_std"):
        np.testing.assert_allclose(got[f"normalizer.{key}"].numpy(),
                                   want[key], rtol=1e-5, atol=1e-6,
                                   err_msg=key)


def test_ranks_agree_and_the_eval_is_trimmed(jax_run, port_runs):
    r0, r1 = port_runs["replicated"]
    for key, value in r0["state_dict"].items():
        assert torch.equal(value, r1["state_dict"][key]), key
    preds, loss = jax_run["eval"]
    got = r0["steps"][-1]
    np.testing.assert_allclose(got["loss"], loss, rtol=LOSS_RTOL)
    for key, value in got["preds"].items():
        assert value.shape[0] == B, key      # the padding row trimmed
        np.testing.assert_array_equal(value.numpy(),
                                      np.asarray(preds[key])[:B],
                                      err_msg=key)


def test_zero1_is_bit_equal_to_replicated_dp(port_runs):
    rep, z1 = port_runs["replicated"][0], port_runs["zero1"][0]
    assert [s["loss"] for s in z1["steps"]] == [s["loss"]
                                                 for s in rep["steps"]]
    for key, value in rep["state_dict"].items():
        assert torch.equal(value, z1["state_dict"][key]), key
    assert sorted(rep["moments"]) == sorted(z1["moments"])
    for key, value in rep["moments"].items():
        assert torch.equal(value, z1["moments"][key]), key
    assert rep["moment_shard_fraction"] == 1.0
    assert abs(z1["moment_shard_fraction"] - 0.5) < 1e-3
    assert all(out["restored"] for out in port_runs["zero1"])


def test_zero1_checkpoint_reads_back_in_the_jax_layout(jax_run, port_runs):
    jm = jax_run["model"]
    restored, ckpt = JaxCheckpointer(port_runs["ckpt"]).recover_if_possible(
        jm._checkpoint_templates())
    assert ckpt is not None and set(restored) >= {"params", "states",
                                                  "opt__optimizer"}
    got = from_jax(restored["params"], restored["states"])
    want = port_runs["zero1"][0]["state_dict"]
    assert sorted(got) == sorted(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    moments = port_runs["zero1"][0]["moments"]
    opt, j_opt = restored["opt__optimizer"], jax_run["opt"]["optimizer"]
    names = {mk: [n for n, _ in mod.named_parameters()] for mk, mod in
             build_md_vae(batch_size=B, overrides=SMALL,
                          device="cpu").param_modules().items()}
    for (_, mk, key), value in moments.items():
        inner = opt[mk].inner_state[0]
        assert int(inner.count) == int(j_opt[mk].inner_state[0].count), mk
        leaves = []
        for name in names[mk]:
            leaf = getattr(inner, key)[mk]
            for part in name.split("."):
                leaf = leaf[part]
            leaves.append(np.asarray(leaf).reshape(-1))
        np.testing.assert_array_equal(np.concatenate(leaves), value.numpy(),
                                      err_msg=f"{mk} {key}")


# -- the CLI on two ranks against one process ----------------------------------
CLI_BATCH = 5
CLI_NARROW = "phn_rnn_hidden_size: 32, boundary_rnn_hidden_size: 32, " \
    "rnn_hidden_size: 32, dec_rnn_hidden_size: 32, recon_weight: 1.0, " \
    "phn_recog_bce_weight: 1.0, boundary_bce_weight: 1.0"
# one process, its batches padded and its predictions trimmed as on N data
# ranks (parallel_step.padded_as_ranks)
AS_RANKS = """
import sys
from mlvae_tpu_torch.tools.parallel_step import padded_as_ranks
n, entry = int(sys.argv[1]), sys.argv[2]
if entry == "train":
    from mlvae_tpu_torch.cli.train import main
else:
    from mlvae_tpu_torch.cli.test import main
with padded_as_ranks(n):
    main(sys.argv[3:])
"""


def _cli_args(name):
    return [str(REPO / "config/run.yaml"), "--batch_size", str(CLI_BATCH),
            "--dataset", "SynAudioMNIST", "--language", "digits",
            "--n_phonemes", "12", "--model_class", "MD_VAE",
            "--model_name", name, "--model",
            f"!include:{REPO / 'mlvae_tpu_torch/models/MD_VAE/model.yaml'}",
            "--extra_overrides",
            "{model: {n_epochs: 3, %s}}" % CLI_NARROW,
            "--debug", "--debug_batches", "2", "--device", "cpu"]


def _run_both(cmds):
    """Run (command, working directory) pairs at once, each within
    RUN_TIMEOUT."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd, cwd in cmds]
    for proc in procs:
        try:
            log, _ = proc.communicate(timeout=RUN_TIMEOUT)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise
        assert proc.returncode == 0, log[-4000:]


def _scalars(run_dir):
    out = {}
    for line in (run_dir / "scalars.jsonl").read_text().splitlines():
        rec = json.loads(line)
        out[(rec["tag"], rec["step"])] = rec["value"]
    return out


def _checkpoint_params(run_dir):
    (ckpt,) = (run_dir / "checkpoints").iterdir()
    with np.load(ckpt / "params.npz") as f:
        return json.loads((ckpt / "meta.json").read_text()), dict(f)


def test_cli_data_parallel_matches_one_process(tmp_path):
    ranks_dir, one_dir = tmp_path / "ranks", tmp_path / "one"
    ranks_dir.mkdir()
    one_dir.mkdir()
    script = tmp_path / "as_ranks.py"
    script.write_text(AS_RANKS)
    for entry in ("train", "test"):
        _run_both([
            ([sys.executable, "-m", f"mlvae_tpu_torch.cli.{entry}",
              *_cli_args("dp"), "--data_parallel", "True",
              "--num_devices", str(N)], ranks_dir),
            ([sys.executable, str(script), str(N), entry,
              *_cli_args("dp")], one_dir)])
    got_dir, want_dir = ranks_dir / "results/dp", one_dir / "results/dp"
    got, want = _scalars(got_dir), _scalars(want_dir)
    assert sorted(got) == sorted(want)
    assert {step for _, step in want} == {1, 2, 3}
    for key, value in want.items():
        if "loss" in key[0]:
            np.testing.assert_allclose(got[key], value, rtol=LOSS_RTOL,
                                       err_msg=str(key))
        else:   # the MD and boundary scores: from the decodes
            assert got[key] == value, key
    got_meta, got_params = _checkpoint_params(got_dir)
    want_meta, want_params = _checkpoint_params(want_dir)
    assert got_meta["epoch"] == want_meta["epoch"] == 3
    assert sorted(got_params) == sorted(want_params)
    for key, value in want_params.items():
        np.testing.assert_allclose(got_params[key], value, rtol=RTOL,
                                   atol=ATOL, err_msg=key)
    metrics = [(d / "test_output/test_metrics.txt").read_text()
               for d in (got_dir, want_dir)]
    assert "plvl_md.F1" in metrics[1]
    assert metrics[0] == metrics[1]
