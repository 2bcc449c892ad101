"""Training steps on the ranks of a mesh, or in one process, from one spec:
what ``tests/test_torch_parallel.py``, ``tests/test_torch_parallel_tp.py``
and ``chip_smoke.py``'s parallel phase run.

    python -m mlvae_tpu_torch.tools.parallel_step SPEC.pt

``SPEC.pt`` is a ``torch.save`` dict:

* ``kind``: ``md_vae`` (``bench_utils.build_md_vae``) or ``w2v_lstm_fc``
  (``bench_utils.build_w2v_lstm_fc``), with ``build`` (its keyword
  arguments but ``device`` and ``run_opts``);
* ``world`` (0: this process, no mesh), ``n_model`` (the model axis),
  ``device`` (``cpu`` or ``cuda``), ``run_opts`` (``zero1``, ...;
  ``data_parallel`` is set on ranks), ``threads`` (torch threads a rank,
  where given);
* ``state_dict``: whole weights (and normalizer statistics) to load, or
  None to keep the seed's;
* ``batch``: the global batch on the CPU ({key: (array, rel lens)});
* ``steps``: a list of {``epoch``, ``noise`` (the global batch's draws, or
  None: drawn from ``seed``'s generator), ``eval`` (an eval forward
  instead of a train step; ``test``: under the TEST stage), ``trunk`` (the
  wav2vec2 trunk's forward alone)};
* ``checkpoint``: a directory: after the steps rank 0 writes a checkpoint
  there (``MDModel.checkpoint_state``), and every rank restores it into a
  fresh model and reports whether the parameters and moments came back;
* ``save_keys``: parameter-name prefixes whose whole values (and
  moments, by module) to write; all without it;
* ``runs``: specs run in turn on the same ranks (each a dict of the keys
  above that differ; a run with another ``n_model`` lays the ranks out
  anew, ``mesh.set_layout``), their outputs a list (then
  ``probe_collectives``: one more entry, which collectives the backend
  takes on a tensor of the rank's device);
* ``out``: a directory.

``padded_as_ranks(N)`` makes one process pad its batches and trim its
predictions as N data ranks do: the one-process reference of a
``--data_parallel`` run whose batches do not divide N.

Each rank (or the process) writes ``out/rank<r>.pt``: per step the loss,
the losses and, for an eval step, the predictions trimmed of the padding
rows; the norm of each module's gradient as the last step applied it
(where its parameters hold one); the whole parameters and buffers after
the steps
(``full_state_dict``), every optimizer moment whole (``full_moment``);
each kernel's launches over the steps; each step's milliseconds
(``torch.cuda.synchronize`` on both ends on the card); the moments' share
this rank holds (``moment_shard_fraction``).
"""
from __future__ import annotations

import contextlib
import sys
import time
from pathlib import Path

import torch

from mlvae_tpu_torch import _build, bench_utils
# every kernel registered, so that each rank reports every count
from mlvae_tpu_torch.ops import (decode, fbank, gru, lstm,  # noqa: F401
                                 lstm_unroll_exp)
from mlvae_tpu_torch.parallel import mesh as M


@contextlib.contextmanager
def padded_as_ranks(n_data: int):
    """Within it, a one-process Brain pads its batches and trims its
    predictions as ``n_data`` data ranks do: ``Brain.pad_batch`` and
    ``Brain.trim_replica_padding`` run at a data axis of ``n_data``, and
    nothing else changes."""
    from mlvae_tpu_torch.training.brain import Brain

    def as_ranks(fn):
        def wrapped(self, *args):
            solo, self.mesh = self.mesh, M.Mesh(1, 0, n_data, 1, "none",
                                                None)
            try:
                return fn(self, *args)
            finally:
                self.mesh = solo
        return wrapped

    saved = Brain.pad_batch, Brain.trim_replica_padding
    Brain.pad_batch, Brain.trim_replica_padding = map(as_ranks, saved)
    try:
        yield
    finally:
        Brain.pad_batch, Brain.trim_replica_padding = saved


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def build(spec, device):
    run_opts = dict(spec.get("run_opts") or {})
    if M.current() is not None:
        run_opts.setdefault("data_parallel", True)
        run_opts["tensor_parallel"] = spec.get("n_model", 1)
    make = {"md_vae": bench_utils.build_md_vae,
               "w2v_lstm_fc": bench_utils.build_w2v_lstm_fc}[spec["kind"]]
    model = make(device=device, run_opts=run_opts,
                    **spec.get("build", {}))
    if spec.get("state_dict") is not None:
        model.load_state_dict(model.local_state_dict(spec["state_dict"]))
    return model


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(spec) -> dict:
    """The spec's steps here (on this rank, or in this process)."""
    if spec.get("threads"):
        torch.set_num_threads(int(spec["threads"]))
    mesh = M.current()
    device = mesh.device if mesh is not None else \
        torch.device(spec.get("device", "cpu"))
    model = build(spec, device)
    gen = torch.Generator(device=device).manual_seed(spec.get("seed", 0))
    batch = _to(spec["batch"], device)
    n_real = batch_rows(batch)
    for k in _build.KERNELS:
        k.launches = 0
    out = {"steps": [], "ms": []}
    for step in spec["steps"]:
        noise = _to(step.get("noise"), device)
        _sync(device)
        t0 = time.perf_counter()
        if step.get("trunk"):
            # the wav2vec2 trunk's forward alone, its rows gathered
            with torch.no_grad():
                preds = model._local_forward(
                    batch, None, gen, False,
                    lambda b, nz, g: {"trunk": model.wav2vec2(b["wav"][0])})
            rec = {"preds": _to(model.trim_replica_padding(preds, n_real),
                                "cpu")}
            loss, losses = torch.zeros(()), {}
        elif step.get("eval"):
            model.set_stage(_stage(model, step), step["epoch"])
            preds, loss, losses = model.eval_forward(
                batch, step["epoch"], noise=noise, generator=gen)
            preds = model.trim_replica_padding(preds, n_real)
            rec = {"preds": _to(preds, "cpu")}
        else:
            model.train()
            loss, losses = model.fit_batch(batch, step["epoch"], noise=noise,
                                           generator=gen)
            model.eval()
            rec = {}
        _sync(device)
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        rec.update(loss=float(loss),
                   losses={k: float(v) for k, v in losses.items()})
        out["steps"].append(rec)
    out["launches"] = {k.name: k.launches for k in _build.KERNELS}
    out["grad_norms"] = {
        mk: float(torch.stack([(p.grad.double() ** 2).sum() for p in
                               mod.parameters()]).sum().sqrt())
        for mk, mod in model.param_modules().items()
        if all(p.grad is not None for p in mod.parameters())}
    keep = spec.get("save_keys")
    out["state_dict"] = {k: v.detach().cpu() for k, v in
                         model.full_state_dict(keep).items()}
    out["moments"] = {
        (name, mk, key): model.full_moment(name, mk, key).cpu()
        for name, (opt, mods) in model.optimizers.items()
        for mk in model._opt_module_keys(mods) for key in opt.MOMENTS
        if keep is None or any(mk.startswith(p) for p in keep)}
    out["moment_shard_fraction"] = model.moment_shard_fraction()
    if spec.get("checkpoint"):
        out["restored"] = _checkpoint_round_trip(spec, model, device)
    return out


def _stage(model, step):
    from mlvae_tpu_torch.training.brain import Stage
    return Stage.TEST if step.get("test") else Stage.VALID


def batch_rows(batch) -> int:
    return next(v[0].shape[0] for k, v in batch.items() if k != "id")


def _checkpoint_round_trip(spec, model, device) -> bool:
    """Rank 0 writes the model's checkpoint; every rank restores it into a
    fresh model; True where parameters and moments came back whole."""
    from mlvae_tpu_torch.training.checkpointer import Checkpointer
    ckpt_dir = Path(spec["checkpoint"])
    state = model.checkpoint_state()
    if model.is_writer:
        Checkpointer(ckpt_dir).save_checkpoint(state, meta={"epoch": 1})
    M.barrier()
    fresh = build(dict(spec, state_dict=None, build=dict(
        spec.get("build", {}), seed=spec.get("build", {}).get("seed", 0)
        + 1)), device)
    fresh.checkpointer = Checkpointer(ckpt_dir)
    fresh._restore(fresh.checkpointer.find_checkpoint(), with_opt=True)
    ok = all(torch.equal(a, model.state_dict()[k])
             for k, a in fresh.state_dict().items())
    for name, (opt, mods) in model.optimizers.items():
        for mk in model._opt_module_keys(mods):
            ok &= int(fresh.opt_states[name][mk]["count"]) == int(
                model.opt_states[name][mk]["count"])
            for key in opt.MOMENTS:
                ok &= torch.equal(fresh.opt_states[name][mk][key],
                                  model.opt_states[name][mk][key])
    return bool(ok)


def run_all(spec):
    """``run`` of the spec, or of each of its ``runs`` (specs that share
    its world and device) in turn: a list then, after the collectives
    probe where ``probe_collectives`` asks for it."""
    if "runs" not in spec:
        return run(spec)
    outs = []
    for r in spec["runs"]:
        r = dict(spec, **r)
        mesh = M.current()
        if mesh is not None and mesh.n_model != r.get("n_model", 1):
            M.set_layout(r.get("n_model", 1))
        outs.append(run(r))
    if spec.get("probe_collectives"):
        outs.append({"collectives": probe_collectives()})
    return outs


def probe_collectives() -> dict:
    """Which collectives the process group's backend takes on a tensor of
    this rank's device: op -> "ok" or the error."""
    import torch.distributed as dist
    mesh = M.current()
    n = mesh.world
    t = torch.arange(4.0, device=mesh.device) + mesh.rank
    ops = {
        "all_reduce": lambda: dist.all_reduce(t.clone()),
        "broadcast": lambda: dist.broadcast(t.clone(), 0),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(t) for _ in range(n)], t),
        "reduce_scatter": lambda: dist.reduce_scatter(
            torch.empty_like(t), [t.clone() for _ in range(n)]),
    }
    out = {}
    for name, op in ops.items():
        try:
            op()
            if t.is_cuda:
                torch.cuda.synchronize(t.device)
            out[name] = "ok"
        except Exception as e:   # the backend refuses: say which and how
            out[name] = f"{type(e).__name__}: {str(e)[:120]}"
    M.barrier()
    return out


def _rank_main(spec_path: str) -> None:
    spec = torch.load(spec_path, weights_only=False)
    out = run_all(spec)
    rank = M.current().rank
    torch.save(out, Path(spec["out"]) / f"rank{rank}.pt")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    spec_path = argv[0]
    spec = torch.load(spec_path, weights_only=False)
    Path(spec["out"]).mkdir(parents=True, exist_ok=True)
    world = int(spec.get("world", 0))
    if world == 0:
        torch.save(run_all(spec), Path(spec["out"]) / "rank0.pt")
        return 0
    # by the module's name, also under ``python -m``
    from mlvae_tpu_torch.tools import parallel_step
    M.launch(parallel_step._rank_main, (spec_path,), world,
             int(spec.get("n_model", 1)), spec.get("device", "cpu"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
