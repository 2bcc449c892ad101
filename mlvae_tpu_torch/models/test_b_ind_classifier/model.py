"""Harness recipe test_b_ind_classifier (counterpart of
``mlvae_tpu/models/test_b_ind_classifier/model.py``): the boundary
detector alone, on the normalized features, trained by its BCE and Beta
KLD against the forced-alignment boundaries. The evaluation marks as
boundaries each utterance's top-k frames by mean boundary probability, k
its forced-alignment boundary count, with the JAX recipe's host-side
``np.argsort`` (so that ties fall the same way), scored by
``boundary_stats`` (selection on ``boundary.f1``).

Its two LSTM layers run K1 in f32 and K3/K4-fwd and K3-bwd under AMP.
Every forward draws the detector's Kumaraswamy noise ``kumaraswamy_u``
(10, B, T)."""
from __future__ import annotations

import numpy as np
import torch

from mlvae_tpu_torch.metrics.boundary import BoundaryMetricStats
from mlvae_tpu_torch.models.md_model import RecipeModel, grad_if
from mlvae_tpu_torch.modules.boundary_detector import BoundaryDetector
from mlvae_tpu_torch.utils.tensor import (apply_lens_to_loss, to_host,
                                          undo_padding)


class SBModel(RecipeModel):
    USED_BATCH_KEYS = {"feat", "fa_boundary_seq", "gt_boundary_seq"}
    EVAL_PRED_KEYS = frozenset({"boundary_v"})

    def on_stage_start(self, stage, epoch=None):
        super().on_stage_start(stage, epoch)
        self.stats_loggers["boundary_stats"] = BoundaryMetricStats()

    def draws(self, B: int, T: int, train: bool = False):
        """The draws of one forward (see ``MDVAE.draws``)."""
        return [("kumaraswamy_u", "uniform",
                 (BoundaryDetector.SAMPLE_TIMES, B, T), None, torch.float32)]

    def compute_forward(self, batch, noise=None, generator=None,
                        train: bool = False, epoch: int = 1):
        feats, feat_lens = batch["feat"]
        with grad_if(train):
            feats = self.normalizer(feats, feat_lens, epoch=epoch,
                                    update=train)
            return self.boundary_detector(
                feats, batch["fa_boundary_seq"][0],
                u=(noise or {}).get("kumaraswamy_u"), generator=generator,
                train=train)

    def compute_objectives(self, predictions, batch):
        feat_lens = batch["feat"][1]
        losses = {k: apply_lens_to_loss(v, feat_lens)
                  for k, v in predictions["losses"].items()}
        return self.weighted_total(losses), losses

    def evaluate_predictions(self, predictions, batch, stage):
        fa_boundary = to_host(batch["fa_boundary_seq"][0])
        boundary_v = undo_padding(to_host(predictions["boundary_v"]),
                                  to_host(batch["feat"][1]))
        preds = []
        for i, bv in enumerate(boundary_v):
            k = int(fa_boundary[i].sum())
            seq = np.zeros_like(bv)
            if k > 0:   # [-0:] would select every frame, not none
                seq[np.argsort(bv)[-k:]] = 1
            preds.append(seq)
        targets = undo_padding(*(to_host(x)
                                 for x in batch["gt_boundary_seq"]))
        self.stats_loggers["boundary_stats"].append(
            self._batch_ids, predictions=preds, targets=list(targets))
