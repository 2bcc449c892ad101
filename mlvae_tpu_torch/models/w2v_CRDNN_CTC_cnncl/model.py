"""w2v_CRDNN_CTC_cnncl (counterpart of
``mlvae_tpu/models/w2v_CRDNN_CTC_cnncl/model.py``): w2v_CRDNN_CTC with
the CTC on the canonical phonemes, whose TEST stage keeps each
utterance's posteriors, resampled to the fbank frame rate and trimmed to
its length, and merges them into ``<output_dir>/saved_phn_recog_outs.pkl``
(``{utt_id: (T, N) float32}``, warning on a key already there), which
``MD_VAE_sfl_saved_phn_recog`` reads."""
from __future__ import annotations

import pickle
import warnings
from pathlib import Path

from mlvae_tpu_torch.models.w2v_CRDNN_CTC.model import \
    SBModel as W2V_CRDNN_CTC
from mlvae_tpu_torch.training.brain import Stage
from mlvae_tpu_torch.utils.tensor import (resample_by_factor_np, to_host,
                                          undo_padding)


class SBModel(W2V_CRDNN_CTC):
    CTC_TARGET_KEY = "gt_cnncl_seq"

    def on_stage_start(self, stage, epoch=None):
        super().on_stage_start(stage, epoch)
        if stage == Stage.TEST:
            self.saved_pouts = {}

    def evaluate_predictions(self, predictions, batch, stage):
        super().evaluate_predictions(predictions, batch, stage)
        if stage != Stage.TEST:
            return
        pout = to_host(predictions["pout"])
        feats, feat_lens = batch["feat"]
        pout_rs = resample_by_factor_np(pout, feats.shape[1])
        for utt_id, trimmed in zip(self._batch_ids,
                                   undo_padding(pout_rs, to_host(feat_lens))):
            self.saved_pouts[utt_id] = trimmed

    def on_stage_end(self, stage, stage_loss, epoch=None):
        super().on_stage_end(stage, stage_loss, epoch)
        if stage == Stage.TEST and self.is_writer:
            path = Path(self.hparams["output_dir"]) / \
                "saved_phn_recog_outs.pkl"
            existing = {}
            if path.exists():
                with open(path, "rb") as f:
                    existing = pickle.load(f)
                for key in self.saved_pouts:
                    if key in existing:
                        warnings.warn(f"duplicate key {key}")
            existing.update(self.saved_pouts)
            with open(path, "wb") as f:
                pickle.dump(existing, f)
