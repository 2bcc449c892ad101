"""The DNN-HMM forced-alignment recipe HMM_DNN_ALI (counterpart of
``mlvae_tpu/models/HMM_DNN_ALI/model.py``): ``VanillaNN`` then ``Linear``
to ``states_per_phoneme * (n_phonemes + 2)`` HMM states, the length-masked
time mean subtracted, then log-softmax. Three training types
(``init_training_type``):

* ``forward``: minus the aligner's forward score (``HMMAligner.
  forward_score``, a recursion in torch ops whose gradient autograd forms);
* ``ctc``: ``ops.ctc.ctc_loss`` against the expanded states;
* ``viterbi``: ``nll_loss`` against the stored alignments, which
  ``prepare_batch`` injects as ``prev_alignments`` (a uniform split for an
  utterance not aligned yet). With ``realign_during_train`` (the default)
  every train step is followed by an eval forward of the same prepared
  batch and ``evaluate_predictions`` on the TRAIN stage, so the targets
  refresh from every batch.

Every evaluated batch is Viterbi-aligned on the host, its alignments
stored and scored for frame accuracy (``accuracy_stats``). The recipe's
YAML selects on ``flvl_md.F1``, which it never emits, so ``evaluate``
recalls the newest checkpoint (``ALLOW_KEYLESS_CKPT``). The normalizer is
kept for its checkpoint entry and, as in the JAX recipe, never applied.

No LSTM, decode or filterbank kernel runs on this path, and no draw."""
from __future__ import annotations

import numpy as np
import torch

from mlvae_tpu_torch.metrics.metric_stats import MetricStats
from mlvae_tpu_torch.models.md_model import RecipeModel, grad_if
from mlvae_tpu_torch.training.brain import Stage
from mlvae_tpu_torch.utils.tensor import length_mask, to_host, undo_padding


class SBModel(RecipeModel):
    USED_BATCH_KEYS = {"feat", "gt_cnncl_seq", "gt_phn_end_seq",
                       "prev_alignments"}
    EVAL_PRED_KEYS = frozenset({"pout"})
    ALLOW_KEYLESS_CKPT = True

    def __init__(self, modules, hparams, **kwargs):
        super().__init__(modules, hparams, **kwargs)
        self.set_stage(Stage.TEST)

    @property
    def aligner(self):
        return self.hparams["aligner"]

    def set_stage(self, stage, epoch=None):
        self.training_type = self.hparams["init_training_type"]

    def on_stage_start(self, stage, epoch=None):
        super().on_stage_start(stage, epoch)
        if self.training_type == "viterbi":
            # prev_alignments change as the aligner's store refreshes: a
            # cached device batch would freeze them
            self.cache_device_batches = False
            self._dev_batch_cache.clear()
        self.stats_loggers["accuracy_stats"] = MetricStats(
            metric=self.aligner.calc_accuracy)

    def _realigns(self) -> bool:
        return self.training_type == "viterbi" and bool(
            self.hparams.get("realign_during_train", True))

    def _realign(self, prepared, dev_batch, epoch: int) -> None:
        """The aligner's store refreshed from this train batch: an eval
        forward of the prepared batch, then its evaluation on TRAIN."""
        preds, _, _ = self.eval_forward(
            dev_batch, epoch, noise=self._next_noise(dev_batch, False),
            generator=self.generator)
        self.evaluate_predictions(preds, prepared, Stage.TRAIN)

    def train_batch(self, batch, epoch: int):
        loss = super().train_batch(batch, epoch)
        if self._realigns():
            self._realign(self._last_prepared_batch, self._last_dev_batch,
                          epoch)
        return loss

    def fit_batch(self, batch, epoch: int, noise=None, generator=None):
        """``Brain.fit_batch`` on a device batch with its utterance ids
        under ``id``, and the realignment after it."""
        self._batch_ids = batch["id"]
        out = super().fit_batch(batch, epoch, noise=noise,
                                generator=generator)
        if self._realigns():
            self._realign(batch, batch, epoch)
        return out

    def prepare_batch(self, batch):
        """Under ``viterbi``: the stored alignments (or the uniform split)
        as ``prev_alignments``, in the batch's own kind (host arrays, or
        tensors on the batch's device)."""
        if self.training_type != "viterbi":
            return batch
        feats, pout_lens = batch["feat"]
        phns, phn_lens = (to_host(x) for x in batch["gt_cnncl_seq"])
        states = self.aligner.expand_phns_by_states_per_phoneme(phns)
        shape = (len(batch["id"]), feats.shape[1])
        prev = self.aligner.get_prev_alignments(
            batch["id"], np.zeros(shape + (1,), np.float32),
            to_host(pout_lens), states, phn_lens)
        if isinstance(feats, torch.Tensor):
            batch["prev_alignments"] = (
                torch.from_numpy(prev).to(feats.device), pout_lens)
        else:
            batch["prev_alignments"] = (prev, np.asarray(pout_lens))
        return batch

    def compute_forward(self, batch, noise=None, generator=None,
                        train: bool = False, epoch: int = 1):
        feats, feat_lens = batch["feat"]
        with grad_if(train):
            out = self.output(self.model(feats))
            # the per-utterance prior: the time mean over valid frames
            mask = length_mask(feat_lens, out.shape[1],
                               dtype=out.dtype)[..., None]
            denom = torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)
            out = out - (out * mask).sum(dim=1, keepdim=True) / denom
            return {"pout": self.hparams["log_softmax"](out)}

    def compute_objectives(self, predictions, batch):
        pout = predictions["pout"]
        pout_lens = batch["feat"][1]
        phns, phn_lens = batch["gt_cnncl_seq"]
        states = self.aligner.expand_phns_by_states_per_phoneme(phns)
        if self.training_type == "forward":
            loss = -self.aligner.forward_score(pout, pout_lens, states,
                                               phn_lens)
        elif self.training_type == "ctc":
            loss = self.hparams["compute_cost_ctc"](pout, states, pout_lens,
                                                    phn_lens)
        elif self.training_type == "viterbi":
            loss = self.hparams["compute_cost_nll"](
                pout, batch["prev_alignments"][0], length=pout_lens)
        else:
            raise ValueError(f"unknown training type: {self.training_type}")
        return loss, {}

    def evaluate_predictions(self, predictions, batch, stage):
        pout_lens = to_host(batch["feat"][1])
        phns, phn_lens = (to_host(x) for x in batch["gt_cnncl_seq"])
        states = self.aligner.expand_phns_by_states_per_phoneme(phns)
        _, alignments = self.aligner.viterbi(to_host(predictions["pout"]),
                                             pout_lens, states, phn_lens)
        self.aligner.store_alignments(self._batch_ids, alignments)
        phn_ends = undo_padding(*(to_host(x)
                                  for x in batch["gt_phn_end_seq"]))
        self.stats_loggers["accuracy_stats"].append(
            self._batch_ids, alignments, list(phn_ends),
            list(undo_padding(phns, phn_lens)))
