"""Train entry point (counterpart of ``mlvae_tpu/cli/train.py``):

    python -m mlvae_tpu_torch.cli.train config/run.yaml --dataset ... \
        --model_class MD_VAE --model_name NAME \
        --model '!include:mlvae_tpu_torch/models/MD_VAE/model.yaml' ...
"""
import logging
import sys

from mlvae_tpu_torch.cli.experiment import prepare_experiment, run_ranked


def _main(argv):
    logging.basicConfig(level=logging.INFO, stream=sys.stdout)
    prepared = prepare_experiment(
        argv, prepare_exp_dir=True)
    hparams = prepared["hparams"]
    train_dataset, valid_dataset, _ = prepared["datasets"]
    model = prepared["model"]
    model.fit(
        hparams["model"]["epoch_counter"],
        train_dataset,
        valid_dataset,
        train_loader_kwargs=hparams["train_dataloader_opts"],
        valid_loader_kwargs=hparams["valid_dataloader_opts"],
    )
    return model


def main(argv=None):
    """The run's model, or None where ``--data_parallel`` /
    ``--tensor_parallel`` ran it on ranks of their own."""
    return run_ranked(_main, argv if argv is not None else sys.argv[1:])


if __name__ == "__main__":
    main()
