"""Score external forced-alignment and DNN-HMM results (counterpart of
``mlvae_tpu/cli/test_external.py``): with ``cli.train``'s arguments,
prepare the dataset, read its computed sets and
``external_data/dnn_hmm_test.json`` (``data/data_io_external_source``)
and print and return the test set's ``fa.*`` and ``asr.*`` metrics
(``metrics/dnn_hmm``). The YAML's modules are built on ``--device`` (the
card unless ``--device cpu``) and not used."""
import importlib
import logging
import sys

import torch

from mlvae_tpu_torch.cli.args import parse_arguments
from mlvae_tpu_torch.data.data_io_external_source import prepare_datasets
from mlvae_tpu_torch.device import resolve_device
from mlvae_tpu_torch.hyperyaml import load_hyperyaml, recursive_update
from mlvae_tpu_torch.hyperyaml.loader import _parse_tagged
from mlvae_tpu_torch.metrics.dnn_hmm import compute_dnn_hmm_metrics


def main(argv=None):
    logging.basicConfig(level=logging.INFO, stream=sys.stdout)
    args = argv if argv is not None else sys.argv[1:]
    hparams_file, run_opts, overrides_str = parse_arguments(args)
    device = resolve_device(run_opts.get("device"))

    overrides = _parse_tagged(overrides_str) if overrides_str else {}
    overrides = overrides or {}
    extra_overrides = overrides.pop("extra_overrides", {}) or {}
    with open(hparams_file) as fin:
        hparams = load_hyperyaml(fin, [extra_overrides, overrides],
                                 device=device,
                                 generator=torch.Generator(device=device))
    recursive_update(hparams, extra_overrides, keep_objects=True)

    prepare_mod = importlib.import_module(
        f"mlvae_tpu_torch.data.datasets.{hparams['dataset']}.prepare")
    prepare_mod.prepare(**hparams["prepare"])
    datasets, _ = prepare_datasets(hparams)
    return compute_dnn_hmm_metrics(datasets[2])


if __name__ == "__main__":
    main()
