"""The ASR-style MD baseline CRDNN_CTC (counterpart of
``mlvae_tpu/models/CRDNN_CTC/model.py``): ``CRDNNCTC``, the training step
and the eval forward, and ``SBModel``, the recipe as the CLI builds it
from the YAML's modules.

forward = normalizer (its statistics update while training) -> ``CRDNN``
-> ``output`` (an ``SBLinear`` to n_phonemes + 2 classes) -> log-softmax,
under ``pout`` at the time-pooled length. The loss is ``ops.ctc.ctc_loss``
against the pronounced phonemes ``gt_phn_seq`` (``CTC_TARGET_KEY``; the
canonical ``gt_cnncl_seq`` in CRDNN_CTC_cnncl). The optimizer is the
YAML's (Adadelta at lr 1.0); the YAML's NewBob scheduler is built and, as
in the JAX package, never called.

The host-side evaluation (VALID and TEST; ``ErrorRateStats`` and the MD
and boundary statistics are registered outside TRAIN only): the greedy
CTC decode, its PER against the pronounced and the canonical sequences,
the MD labels from the decode aligned to both (insertions dropped), and
the phoneme boundaries from a forced alignment of the canonical labels to
the posteriors resampled to the feature rate. TEST writes
``test_output/md_result_seqs.txt``. Selection is on ``plvl_md.F1``.

A training forward's draws are the CRDNN's (``CRDNN.draws``); the eval
forward draws nothing.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from mlvae_tpu_torch.metrics.alignment import batch_align_sequences
from mlvae_tpu_torch.metrics.boundary import BoundaryMetricStats
from mlvae_tpu_torch.metrics.error_rate import ErrorRateStats
from mlvae_tpu_torch.metrics.md import MDMetricStats
from mlvae_tpu_torch.models.md_model import MDModel, grad_if
from mlvae_tpu_torch.modules.crdnn import CRDNN
from mlvae_tpu_torch.nn.norm import InputNormalization
from mlvae_tpu_torch.nn.sb_compat import SBLinear, Softmax
from mlvae_tpu_torch.ops import ctc as ctc_ops
from mlvae_tpu_torch.training.brain import Stage
from mlvae_tpu_torch.utils.tensor import (resample_by_factor_np, to_host,
                                          undo_padding)


_LOG_SOFTMAX = Softmax(apply_log=True)


class CRDNNCTC(MDModel):
    USED_BATCH_KEYS = {"feat", "gt_phn_seq", "gt_cnncl_seq",
                       "gt_boundary_seq"}
    EVAL_PRED_KEYS = frozenset({"pout"})
    CTC_TARGET_KEY = "gt_phn_seq"

    def __init__(self, hparams: Dict,
                 generator: Optional[torch.Generator] = None, device=None,
                 run_opts: Optional[Dict] = None,
                 modules: Optional[Dict] = None, **brain_kwargs):
        """The modules are built from ``hparams``'s widths with weights
        drawn from ``generator`` on ``device`` (``build_modules``), or
        taken from ``modules`` (the YAML's ``crdnn``, ``output`` and
        ``normalizer``)."""
        super().__init__(hparams, run_opts, **brain_kwargs)
        if modules is None:
            modules = self.build_modules(
                self.hparams, dict(generator=generator, device=device))
        self.adopt_modules(modules)
        norm = getattr(self, "normalizer", None)   # none in w2v_CRDNN_CTC
        if norm is not None:
            norm.ensure_size(self.hparams["input_size"])

    @staticmethod
    def build_modules(h: Dict, kw: Dict) -> Dict[str, torch.nn.Module]:
        """The recipe's modules at ``h``'s widths, in the YAML's order."""
        crdnn = CRDNN(h["input_size"], dropout=h["dropout"],
                      cnn_blocks=h["cnn_blocks"],
                      cnn_channels=h["cnn_channels"],
                      cnn_kernelsize=h["cnn_kernelsize"], time_pooling=True,
                      rnn_layers=h["rnn_layers"],
                      rnn_neurons=h["rnn_neurons"],
                      rnn_bidirectional=h["rnn_bidirectional"],
                      dnn_blocks=h["dnn_blocks"],
                      dnn_neurons=h["dnn_neurons"], **kw)
        output = SBLinear(h["dnn_neurons"], h["n_phonemes"] + 2, **kw)
        return {"crdnn": crdnn, "output": output,
                "normalizer": InputNormalization(device=kw["device"])}

    def draws(self, B: int, T: int, train: bool = False) -> List:
        """The draws of one forward: the CRDNN's dropout keep-masks while
        training, nothing otherwise."""
        return self.crdnn.draws(B, T) if train else []

    def compute_forward(self, batch: Dict, noise: Optional[Dict] = None,
                        generator: Optional[torch.Generator] = None,
                        train: bool = False, epoch: int = 1):
        """Log-probabilities (B, T', n_phonemes + 2) under ``pout``.
        ``train`` updates the normalizer's statistics, applies dropout and
        builds the graph; otherwise no graph is built."""
        feats, feat_lens = batch["feat"]
        with grad_if(train):
            feats = self.normalizer(feats, feat_lens, epoch=epoch,
                                    update=train)
            out = self.output(self.crdnn(feats, train=train,
                                         generator=generator, noise=noise))
            # the YAML's stateless Softmax(apply_log=True), kept off the
            # module tree as the JAX recipe keeps it out of its modules
            act = self.hparams.get("log_softmax", _LOG_SOFTMAX)
            return {"pout": act(out)}

    def compute_objectives(self, predictions: Dict, batch: Dict):
        targets, target_lens = batch[self.CTC_TARGET_KEY]
        loss = ctc_ops.ctc_loss(
            predictions["pout"], targets, batch["feat"][1], target_lens,
            blank_index=self.hparams.get("blank_index", 0))
        return loss, {}


class SBModel(CRDNNCTC):
    """CRDNN_CTC as ``cli.train`` / ``cli.test`` build it: the YAML's
    modules, its checkpointer and epoch counter, the run's step generator
    and the label encoder."""

    def __init__(self, modules: Dict, hparams: Dict,
                 run_opts: Optional[Dict] = None, checkpointer=None,
                 label_encoder=None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(hparams, run_opts=run_opts, modules=modules,
                         checkpointer=checkpointer,
                         label_encoder=label_encoder)
        self.generator = generator

    def on_stage_start(self, stage: Stage, epoch=None):
        super().on_stage_start(stage, epoch)
        # the decode runs at eval only, so its statistics exist outside
        # TRAIN only (a TRAIN PER would log a constant 0.0)
        if stage != Stage.TRAIN:
            self.stats_loggers["phn_per_stats"] = ErrorRateStats()
            self.stats_loggers["cnncl_per_stats"] = ErrorRateStats()
            self.stats_loggers["plvl_md_stats"] = MDMetricStats()
            self.stats_loggers["boundary_stats"] = BoundaryMetricStats()

    def evaluate_predictions(self, predictions, batch, stage):
        pout = to_host(predictions["pout"])
        pout_lens = to_host(batch["feat"][1])
        blank = self.hparams.get("blank_index", 0)
        ind2lab = self.label_encoder.decode_ndim if self.label_encoder \
            else None
        pred_phns = ctc_ops.ctc_greedy_decode(pout, pout_lens,
                                              blank_id=blank)
        phns, phn_lens = (to_host(x) for x in batch["gt_phn_seq"])
        cnncls, cnncl_lens = (to_host(x) for x in batch["gt_cnncl_seq"])
        self.stats_loggers["phn_per_stats"].append(
            ids=self._batch_ids, predict=pred_phns, target=phns,
            target_len=phn_lens, ind2lab=ind2lab)
        self.stats_loggers["cnncl_per_stats"].append(
            ids=self._batch_ids, predict=pred_phns, target=cnncls,
            target_len=cnncl_lens, ind2lab=ind2lab)

        gt_phn_seqs = [list(map(int, s)) for s in undo_padding(phns,
                                                               phn_lens)]
        gt_cnncl_seqs = [list(map(int, s))
                         for s in undo_padding(cnncls, cnncl_lens)]
        ali_gt, ali_pred, ali_cnncl = batch_align_sequences(
            gt_phn_seqs, pred_phns, gt_cnncl_seqs)
        boundary_seqs = self._ctc_segmentation(batch, pout, gt_cnncl_seqs,
                                               blank)
        gt_boundaries = [np.asarray(b) for b in undo_padding(
            *(to_host(x) for x in batch["gt_boundary_seq"]))]
        self.stats_loggers["plvl_md_stats"].append(
            self._batch_ids, pred_phn_seqs=ali_pred, gt_phn_seqs=ali_gt,
            gt_cnncl_seqs=ali_cnncl, pred_boundary_seqs=boundary_seqs,
            gt_boundary_seqs=gt_boundaries)
        self.stats_loggers["boundary_stats"].append(
            self._batch_ids, predictions=boundary_seqs,
            targets=gt_boundaries)

    def _ctc_segmentation(self, batch, pout, gt_cnncl_seqs, blank):
        """Each utterance's boundaries: the posteriors resampled to the
        feature frame rate, force-aligned to its canonical labels."""
        feats, feat_lens = batch["feat"]
        T_feat = feats.shape[1]
        pout_rs = resample_by_factor_np(pout, T_feat)
        feat_lens = to_host(feat_lens)
        out = []
        for i, labels in enumerate(gt_cnncl_seqs):
            n = int(round(float(feat_lens[i]) * T_feat))
            out.append(ctc_ops.ctc_segmentation_boundaries(
                pout_rs[i, :n], labels, blank_id=blank))
        return out

    def on_stage_end(self, stage, stage_loss, epoch=None):
        super().on_stage_end(stage, stage_loss, epoch)
        if stage == Stage.TEST:
            path = Path(self.hparams["output_dir"]) / "test_output" / \
                "md_result_seqs.txt"
            path.parent.mkdir(parents=True, exist_ok=True)
            self.stats_loggers["plvl_md_stats"].write_seqs_to_file(
                path, self.label_encoder)
