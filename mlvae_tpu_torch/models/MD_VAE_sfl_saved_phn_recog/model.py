"""MD_VAE_sfl_saved_phn_recog (counterpart of
``mlvae_tpu/models/MD_VAE_sfl_saved_phn_recog/model.py``): MD_VAE_sfl over
saved phoneme-recognizer posteriors instead of a recognizer of its own.

The recipe has no ``phoneme_recognizer`` module. Each utterance's
posteriors, (T, N) float32, are read from ``Path(output_dir).parent /
phn_recog_outs_path``: a pickle of ``{utt_id: array}`` (the
``w2v_CRDNN_CTC_cnncl`` recipe's TEST dump), or a ``torch.save`` file of
``{utt_id: tensor}``, read with ``weights_only=True``. ``prepare_batch``
pads them with zeros to the batch's feature length under
``saved_phn_recog_out``, and raises ``KeyError`` for an utterance that has
none. The training target cycles B_DETECTOR -> VAE by ``(epoch-1) % 2``.
"""
from __future__ import annotations

import logging
import pickle
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from mlvae_tpu_torch.models.MD_VAE.model import Target
from mlvae_tpu_torch.models.MD_VAE_sfl.model import \
    SBModel as MDVAESFLSBModel

logger = logging.getLogger(__name__)


def load_saved_outputs(path) -> Dict[str, np.ndarray]:
    """``{utt_id: (T, N) float32}`` from a pickle, or from a
    ``torch.save`` file of tensors."""
    try:
        with open(path, "rb") as f:
            data = pickle.load(f)
    except (pickle.UnpicklingError, EOFError):
        data = {k: v.numpy() for k, v in
                torch.load(path, weights_only=True).items()}
    return {k: np.asarray(v, np.float32) for k, v in data.items()}


class SBModel(MDVAESFLSBModel):
    USED_BATCH_KEYS = MDVAESFLSBModel.USED_BATCH_KEYS | {
        "saved_phn_recog_out"}
    TRAIN_CYCLE = (Target.B_DETECTOR, Target.VAE)

    def on_stage_start(self, stage, epoch=None):
        if not hasattr(self, "saved_phn_recog_outs"):
            path = Path(self.hparams["output_dir"]).parent / \
                self.hparams["phn_recog_outs_path"]
            self.saved_phn_recog_outs = load_saved_outputs(path)
            logger.info("loaded %d saved recognizer outputs from %s",
                        len(self.saved_phn_recog_outs), path)
        super().on_stage_start(stage, epoch)

    def prepare_batch(self, batch):
        """MD_VAE's checks, then each utterance's saved posteriors, cut or
        zero-padded to the batch's feature length, under
        ``saved_phn_recog_out`` with the features' relative lengths; on
        the features' device where they are tensors."""
        batch = super().prepare_batch(batch)
        feats, feat_lens = batch["feat"]
        B, T = feats.shape[0], feats.shape[1]
        missing = [u for u in batch["id"]
                   if u not in self.saved_phn_recog_outs]
        if missing:
            raise KeyError(
                f"no saved recognizer outputs for utterances {missing[:5]} "
                f"(have {len(self.saved_phn_recog_outs)}); the dump from "
                "w2v_CRDNN_CTC_cnncl must cover every set this recipe "
                "touches — produce it with cli.test_on_three_sets (its TEST "
                "pass over train/valid/test accumulates all utterances), "
                "not cli.test")
        outs = [self.saved_phn_recog_outs[u] for u in batch["id"]]
        padded = np.zeros((B, T, outs[0].shape[1]), np.float32)
        for i, o in enumerate(outs):
            n = min(T, o.shape[0])
            padded[i, :n] = o[:n]
        if isinstance(feats, torch.Tensor):
            value = (torch.from_numpy(padded).to(feats.device), feat_lens)
        else:
            value = (padded, np.asarray(feat_lens))
        if isinstance(batch, dict):
            batch = dict(batch)
        batch["saved_phn_recog_out"] = value
        return batch

    def _phn_recog_branch(self, feats, feat_lens, batch, train, generator):
        return {"out": batch["saved_phn_recog_out"][0], "losses": {}}
