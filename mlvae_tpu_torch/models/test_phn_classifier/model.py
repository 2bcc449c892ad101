"""Harness recipe test_phn_classifier (counterpart of
``mlvae_tpu/models/test_phn_classifier/model.py``): the phoneme recognizer
alone, on the normalized features (the normalizer's statistics update
while training), trained by its masked BCE against the canonical phoneme
of each frame and scored by frame- and phoneme-level accuracy
(``phn_acc_stats``; selection on ``phn_acc.flvl_acc``).

Its two LSTM layers run K1 in f32 (one K1-fwd a layer in a forward, one
K1-bwd a layer in a train step) and K3/K4-fwd and K3-bwd under AMP. It
draws nothing."""
from __future__ import annotations

from mlvae_tpu_torch.metrics.phn_acc import PhnAccMetricStats
from mlvae_tpu_torch.models.md_model import RecipeModel, grad_if
from mlvae_tpu_torch.utils.tensor import (apply_lens_to_loss, to_host,
                                          undo_padding)


class SBModel(RecipeModel):
    USED_BATCH_KEYS = {"feat", "gt_cnncl_seq", "fa_boundary_seq",
                       "flvl_gt_cnncl_seq", "gt_boundary_seq"}
    EVAL_PRED_KEYS = frozenset({"out"})

    def on_stage_start(self, stage, epoch=None):
        super().on_stage_start(stage, epoch)
        self.stats_loggers["phn_acc_stats"] = PhnAccMetricStats()

    def compute_forward(self, batch, noise=None, generator=None,
                        train: bool = False, epoch: int = 1):
        feats, feat_lens = batch["feat"]
        with grad_if(train):
            feats = self.normalizer(feats, feat_lens, epoch=epoch,
                                    update=train)
            return self.phoneme_recognizer(
                feats, feat_lens, batch["gt_cnncl_seq"][0],
                batch["fa_boundary_seq"][0], train=train,
                generator=generator)

    def compute_objectives(self, predictions, batch):
        losses = {"phn_recog_bce_loss": apply_lens_to_loss(
            predictions["losses"]["phn_recog_bce_loss"], batch["feat"][1])}
        return self.weighted_total(losses), losses

    def evaluate_predictions(self, predictions, batch, stage):
        feat_lens = to_host(batch["feat"][1])
        out = undo_padding(to_host(predictions["out"]), feat_lens)
        flvl, plvl, boundary = (
            undo_padding(*(to_host(x) for x in batch[key]))
            for key in ("flvl_gt_cnncl_seq", "gt_cnncl_seq",
                        "gt_boundary_seq"))
        self.stats_loggers["phn_acc_stats"].append(
            self._batch_ids, predictions=list(out),
            flvl_targets=list(flvl), plvl_targets=list(plvl),
            boundary_seqs=list(boundary))
