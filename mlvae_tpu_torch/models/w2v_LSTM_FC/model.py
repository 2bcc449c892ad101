"""w2v_LSTM_FC (counterpart of ``mlvae_tpu/models/w2v_LSTM_FC/model.py``):
the fine-tuned trunk and an ``FCBlock`` to one logit a frame, a BCE
against the frame-level MD labels cropped to the shorter of logits and
labels and masked by the fbank relative lengths, scored with frame-level
MD metrics (selection on ``flvl_md.F1``). It has no LSTM; a step's only
draws are the trunk's."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from mlvae_tpu_torch.metrics.md import MDMetricStats
from mlvae_tpu_torch.models.md_model import MDModel, grad_if
from mlvae_tpu_torch.models.w2v_common import W2VMixin
from mlvae_tpu_torch.nn import dist as D
from mlvae_tpu_torch.utils.tensor import (apply_lens_to_loss, to_host,
                                          undo_padding)


class SBModel(W2VMixin, MDModel):
    USED_BATCH_KEYS = {"wav", "feat", "flvl_gt_md_lbl_seq"}
    EVAL_PRED_KEYS = frozenset({"logits"})

    def __init__(self, modules: Dict, hparams: Dict,
                 run_opts: Optional[Dict] = None, checkpointer=None,
                 label_encoder=None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(hparams, run_opts, checkpointer=checkpointer,
                         label_encoder=label_encoder, generator=generator)
        self.adopt_modules(modules)

    def on_stage_start(self, stage, epoch=None):
        super().on_stage_start(stage, epoch)
        self.stats_loggers["flvl_md_stats"] = MDMetricStats()

    def compute_forward(self, batch: Dict, noise: Optional[Dict] = None,
                        generator: Optional[torch.Generator] = None,
                        train: bool = False, epoch: int = 1):
        with grad_if(train):
            w2v = self._w2v_feats(batch, noise or {}, generator, train)
            return {"logits": self.classifier(w2v).squeeze(-1)}

    def compute_objectives(self, predictions: Dict, batch: Dict):
        logits = predictions["logits"]
        md = batch["flvl_gt_md_lbl_seq"][0]
        n = min(logits.shape[1], md.shape[1])
        loss_el = D.bce_with_logits(logits[:, :n],
                                    md[:, :n].to(logits.dtype))
        return apply_lens_to_loss(loss_el, batch["feat"][1]), {}

    def evaluate_predictions(self, predictions, batch, stage):
        feat_lens = to_host(batch["feat"][1])
        pred = (to_host(predictions["logits"]) > 0).astype(np.int64)
        preds = undo_padding(pred, feat_lens)
        gts = undo_padding(to_host(batch["flvl_gt_md_lbl_seq"][0]),
                           feat_lens)
        self.stats_loggers["flvl_md_stats"].append(
            self._batch_ids, pred_md_lbl_seqs=[list(p) for p in preds],
            gt_md_lbl_seqs=[list(g) for g in gts])
