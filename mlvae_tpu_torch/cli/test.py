"""Test entry point (counterpart of ``mlvae_tpu/cli/test.py``): the TEST
pass from the best checkpoint by the recipe's ``max_key`` / ``min_key``,
with the same arguments as ``cli.train``."""
import logging
import sys
import time

from mlvae_tpu_torch.cli.experiment import prepare_experiment, run_ranked


def _main(argv):
    t0 = time.time()
    logging.basicConfig(level=logging.INFO, stream=sys.stdout)
    prepared = prepare_experiment(
        argv, prepare_exp_dir=False)
    hparams = prepared["hparams"]
    _, _, test_dataset = prepared["datasets"]
    model = prepared["model"]
    logging.getLogger(__name__).info(
        "prepare_experiment: %.1fs", time.time() - t0)
    model.evaluate(
        test_dataset,
        max_key=hparams["model"].get("max_key"),
        min_key=hparams["model"].get("min_key"),
        test_loader_kwargs=hparams["test_dataloader_opts"],
    )
    return model


def main(argv=None):
    """The run's model, or None where ``--data_parallel`` /
    ``--tensor_parallel`` ran it on ranks of their own."""
    return run_ranked(_main, argv if argv is not None else sys.argv[1:])


if __name__ == "__main__":
    main()
