"""Experiment setup (counterpart of ``mlvae_tpu/cli/experiment.py``):

parse the CLI -> pick the device and the run's generator -> load the
hparams YAML with the overrides and the ``extra_overrides`` channel ->
create the experiment directory -> prepare the dataset -> build the
datasets (both feature passes on the device) -> build
``mlvae_tpu_torch.models.<model_class>.model.SBModel``.

``--device`` picks the device; without it the run is on CUDA and raises
where there is none (``device.resolve_device``): ``--device cpu`` is the
only way onto the CPU. The device and the generator are set before the
YAML is loaded, since the loader hands both to every module it builds.

``run_ranked`` is how ``cli.train`` and ``cli.test`` take
``--data_parallel True [--num_devices N] [--tensor_parallel M]``: it
starts N ranks (``parallel.mesh.launch``; N defaults to the visible
cards, one rank on the CPU), one card a rank where there are enough
(NCCL), else sharing the cards over gloo, and runs the entry point on
each. A rank prepares its experiment on its own card; rank 0 prepares
the dataset and writes the experiment directory first, the others then
read what it wrote.
"""
from __future__ import annotations

import importlib
import logging
import shutil
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List

import torch

from mlvae_tpu_torch.cli.args import parse_arguments
from mlvae_tpu_torch.data.data_io import prepare_datasets
from mlvae_tpu_torch.device import resolve_device
from mlvae_tpu_torch.hyperyaml import (load_hyperyaml, recursive_update,
                                       resolve_references)
from mlvae_tpu_torch.hyperyaml.loader import _parse_tagged
from mlvae_tpu_torch.parallel import mesh as M

logger = logging.getLogger(__name__)

# the JAX package's datasets and recipes that the port has not ported yet,
# by the ROADMAP queue 1 item that ports them (every dataset and every
# recipe is ported)
UNPORTED_DATASETS: Dict[str, int] = {}
UNPORTED_MODELS: Dict[str, int] = {}


def _unported(what: str, name: str, table: Dict[str, int]) -> None:
    if name in table:
        raise NotImplementedError(
            f"{what} {name} is not ported to the CLI yet; it waits in "
            f"ROADMAP queue 1 item {table[name]}")


def _on_ranks(run_opts: Dict) -> bool:
    return bool(run_opts.get("data_parallel")) or \
        int(run_opts.get("tensor_parallel") or 1) > 1


def _rank_entry(module: str, name: str, argv: List[str]) -> None:
    getattr(importlib.import_module(module), name)(argv)


def run_ranked(entry: Callable, argv: List[str]):
    """``entry(argv)`` here, or on the ranks that ``--data_parallel`` /
    ``--tensor_parallel`` ask for (then None here). ``entry`` must be a
    module-level function: the ranks are new processes."""
    _, run_opts, _ = parse_arguments(argv)
    if not _on_ranks(run_opts) or M.current() is not None:
        return entry(argv)
    device_type = resolve_device(run_opts.get("device")).type
    n_model = int(run_opts.get("tensor_parallel") or 1)
    n = run_opts.get("num_devices") or (
        torch.cuda.device_count() if device_type == "cuda" else 1)
    M.check_split(n, n_model)
    if device_type == "cuda":
        # build every kernel once here: the ranks load the libraries
        from mlvae_tpu_torch import _build
        _build.build()
    module = entry.__module__
    if module == "__main__":    # python -m mlvae_tpu_torch.cli.train
        module = sys.modules["__main__"].__spec__.name
    M.launch(_rank_entry, (module, entry.__name__, argv), n, n_model,
             device_type)
    return None


def prepare_experiment(args: List[str], prepare_exp_dir: bool = True
                       ) -> Dict:
    hparams_file, run_opts, overrides_str = parse_arguments(args)
    for key in ("compile_cache", "compile_cache_dir"):
        if key in run_opts:
            logger.info("--%s has no meaning without XLA (PyTorch keeps no "
                        "compile cache here); it changes nothing", key)
    mesh = M.current()
    if _on_ranks(run_opts) and mesh is None:
        raise RuntimeError("--data_parallel / --tensor_parallel: start the "
                           "ranks with cli.experiment.run_ranked")
    device = resolve_device(run_opts.get("device")) if mesh is None \
        else resolve_device(mesh.device)
    # rank 0 prepares and writes first; the others read what it wrote
    if mesh is not None and not mesh.is_writer:
        M.barrier()
        prepare_exp_dir = False
    # the modules' weights: the YAML's torch.manual_seed seeds this one
    generator = torch.Generator(device=device)

    overrides = _parse_tagged(overrides_str) if overrides_str else {}
    overrides = overrides or {}
    extra_overrides = overrides.pop("extra_overrides", {}) or {}

    with open(hparams_file) as fin:
        hparams = load_hyperyaml(fin, [extra_overrides, overrides],
                                 device=device, generator=generator)
    # the extra_overrides channel is merged again after the load, so that
    # nested recipe values win over YAML-resolved ones
    recursive_update(hparams, extra_overrides, keep_objects=True)

    if prepare_exp_dir and "output_dir" in hparams:
        out_dir = Path(hparams["output_dir"])
        out_dir.mkdir(parents=True, exist_ok=True)
        # the overrides-resolved YAML: re-running from it repeats this run
        try:
            with open(hparams_file) as fin:
                resolved = resolve_references(
                    fin, [extra_overrides, overrides])
            (out_dir / "hyperparams.yaml").write_text(resolved.read())
        except Exception:
            logger.exception("could not dump resolved hyperparams; "
                             "copying the raw file instead")
            try:
                shutil.copy(hparams_file, out_dir / "hyperparams.yaml")
            except shutil.SameFileError:
                pass

    prepared = {"hparams": hparams, "run_opts": run_opts, "device": device}

    t_prep = time.time()
    dataset_name = hparams["dataset"]
    _unported("dataset", dataset_name, UNPORTED_DATASETS)
    prepare_mod = importlib.import_module(
        f"mlvae_tpu_torch.data.datasets.{dataset_name}.prepare")
    prepare_mod.prepare(**hparams["prepare"])

    datasets, label_encoder = prepare_datasets(hparams, device=device)
    if mesh is not None and mesh.is_writer:
        M.barrier()
    prepared["datasets"] = datasets
    prepared["label_encoder"] = label_encoder
    prepared["prepare_seconds"] = time.time() - t_prep
    logger.info("dataset prepare+load: %.1fs", prepared["prepare_seconds"])

    if "model_class" in hparams:
        model_class = hparams["model_class"]
        _unported("recipe", model_class, UNPORTED_MODELS)
        model_mod = importlib.import_module(
            f"mlvae_tpu_torch.models.{model_class}.model")
        # the step draws' generator, from the run's seed
        step_gen = torch.Generator(device=device).manual_seed(
            int(hparams.get("seed", 0)))
        prepared["model"] = model_mod.SBModel(
            label_encoder=label_encoder,
            modules=hparams["model"]["modules"],
            hparams=hparams["model"],
            run_opts=run_opts,
            checkpointer=hparams["model"].get("checkpointer"),
            generator=step_gen,
            device=device,
        )
    return prepared
