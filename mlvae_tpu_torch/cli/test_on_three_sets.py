"""Evaluate on the train, valid and test sets (counterpart of
``mlvae_tpu/cli/test_on_three_sets.py``): ``evaluate`` of each set in
turn from the best checkpoint, with ``cli.train``'s arguments. Each pass
is a TEST stage, so its dumps cover every set: w2v_CRDNN_CTC_cnncl's
``saved_phn_recog_outs.pkl`` then holds every utterance, as
MD_VAE_sfl_saved_phn_recog needs; ``test_output/`` keeps the last set's
(the test set's) metrics."""
import logging
import sys

from mlvae_tpu_torch.cli.experiment import prepare_experiment


def main(argv=None):
    logging.basicConfig(level=logging.INFO, stream=sys.stdout)
    prepared = prepare_experiment(
        argv if argv is not None else sys.argv[1:], prepare_exp_dir=False)
    hparams = prepared["hparams"]
    model = prepared["model"]
    for dataset in prepared["datasets"]:
        model.evaluate(
            dataset,
            max_key=hparams["model"].get("max_key"),
            min_key=hparams["model"].get("min_key"),
            test_loader_kwargs=hparams["test_dataloader_opts"],
        )
    return model


if __name__ == "__main__":
    main()
