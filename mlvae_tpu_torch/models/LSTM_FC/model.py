"""The supervised frame-level MD classifier LSTM_FC (counterpart of
``mlvae_tpu/models/LSTM_FC/model.py`` ``SBModel``): an LSTM and an
``FCBlock`` give two logits a frame, trained with a class-weighted BCE
against the frame-level MD labels and scored with frame-level MD metrics.

TRAIN reads the augmented features and labels (``aug_feat``,
``aug_flvl_gt_md_lbl_seq``), every other stage the clean ones (``feat``,
``flvl_gt_md_lbl_seq``). The model keeps a ``normalizer`` whose statistics
travel with its checkpoints, and, as the JAX recipe, never applies it.
The BCE puts ``misp_weight`` on the second (mispronunciation) logit and is
the log-sigmoid form, finite at any logit, masked by the relative lengths.

Every LSTM layer runs K1 (``ops.lstm.LSTMRecurrence``): at the recipe's
H=1024 the wide K1-fwd and K1-bwd, the f32 build (``lstm_fwd_wide``,
``lstm_bwd_wide``) in the eval step and the f32 train step, the bf16
build (``lstm_fwd_wide_bf16``, ``lstm_bwd_wide_bf16``) in the AMP train
step (``run_opts["bf16"]``), where no layer fits a fused tier. The
training step's only draws are the LSTM's dropout keep-masks, one
(T, B, H) mask a gap between layers (``draws``).

``LSTMFC`` builds its modules from the widths in ``hparams``
(``bench_utils.build_lstm_fc``) or takes the YAML's; ``SBModel`` is the
recipe as ``cli.train`` / ``cli.test`` build it (selection on
``flvl_md.F1``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mlvae_tpu_torch.metrics.md import MDMetricStats
from mlvae_tpu_torch.models.md_model import MDModel, dropout_draws, grad_if
from mlvae_tpu_torch.modules.fc_block import FCBlock
from mlvae_tpu_torch.nn.norm import InputNormalization
from mlvae_tpu_torch.nn.rnn import LSTM
from mlvae_tpu_torch.training.brain import Stage
from mlvae_tpu_torch.utils.tensor import (apply_lens_to_loss, to_host,
                                          undo_padding)


def weighted_bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                             pos_weight: torch.Tensor) -> torch.Tensor:
    """-[pw * y * log s(x) + (1 - y) * log(1 - s(x))], elementwise, in the
    log-sigmoid form of ``_weighted_bce_with_logits``."""
    log_sig = -F.softplus(-logits)        # log sigmoid(x)
    log_one_minus = -F.softplus(logits)   # log(1 - sigmoid(x))
    return -(pos_weight * targets * log_sig + (1 - targets) * log_one_minus)


class LSTMFC(MDModel):
    USED_BATCH_KEYS = {"feat", "aug_feat", "flvl_gt_md_lbl_seq",
                       "aug_flvl_gt_md_lbl_seq"}
    # what the host-side evaluation reads (JAX SBModel.EVAL_PRED_KEYS)
    EVAL_PRED_KEYS = frozenset({"out"})

    def __init__(self, hparams: Dict,
                 generator: Optional[torch.Generator] = None, device=None,
                 run_opts: Optional[Dict] = None,
                 modules: Optional[Dict] = None, **brain_kwargs):
        """The modules are built from ``hparams``'s widths with weights
        drawn from ``generator`` on ``device``, or taken from ``modules``
        (the YAML's ``normalizer``, ``lstm`` and ``fc``)."""
        super().__init__(hparams, run_opts, **brain_kwargs)
        self.stage = Stage.TEST
        self.stats_loggers: Dict = {}
        if modules is None:
            modules = self.build_modules(
                self.hparams, dict(generator=generator, device=device))
        self.adopt_modules(modules)
        self.normalizer.ensure_size(self.hparams["input_size"])

    @staticmethod
    def build_modules(h: Dict, kw: Dict) -> Dict[str, torch.nn.Module]:
        """The recipe's modules at ``h``'s widths, in the YAML's order."""
        return {"normalizer": InputNormalization(h["input_size"],
                                                 device=kw["device"]),
                "lstm": LSTM(h["input_size"], h["lstm_hidden_size"],
                             h["lstm_num_layers"], dropout=h["lstm_dropout"],
                             **kw),
                "fc": FCBlock(h["fc_sizes"], **kw)}

    def set_stage(self, stage: Stage, epoch: Optional[int] = None):
        self.stage = stage

    def on_stage_start(self, stage: Stage, epoch: Optional[int] = None):
        self.set_stage(stage, epoch)
        self.stats_loggers = {"flvl_md_stats": MDMetricStats()}

    def _keys(self, train: bool) -> Tuple[str, str]:
        return (("aug_feat", "aug_flvl_gt_md_lbl_seq") if train
                else ("feat", "flvl_gt_md_lbl_seq"))

    def draws(self, B: int, T: int, train: bool = False
              ) -> List[Tuple[str, str, tuple, Optional[float],
                              torch.dtype]]:
        """The draws of one forward, in the JAX package's RngStream order:
        (name, kind, shape, keep probability, dtype), as ``MDVAE.draws``
        lists them. Only a training forward draws: the LSTM's keep-masks."""
        return dropout_draws("lstm_dropout", self.lstm, B, T) if train \
            else []

    def compute_forward(self, batch: Dict, noise: Optional[Dict] = None,
                        generator: Optional[torch.Generator] = None,
                        train: bool = False, epoch: int = 1):
        """Logits (B, T, 2) under ``out``. ``train`` reads ``aug_feat``,
        applies dropout (``noise["lstm_dropout"]``, else drawn from
        ``generator``) and builds the graph; otherwise no graph is built."""
        feats = batch[self._keys(train)[0]][0]
        with grad_if(train):
            out, _ = self.lstm(feats, train=train, generator=generator,
                               masks=(noise or {}).get("lstm_dropout"))
            return {"out": self.fc(out)}

    def compute_objectives(self, predictions: Dict, batch: Dict):
        """The masked class-weighted BCE of the current stage's labels."""
        out = predictions["out"]
        feat_key, lbl_key = self._keys(self.stage == Stage.TRAIN)
        md = batch[lbl_key][0].to(out.dtype)
        targets = torch.stack([1 - md, md], dim=-1)
        pos_weight = torch.tensor([1.0, float(self.hparams["misp_weight"])],
                                  dtype=out.dtype, device=out.device)
        loss = apply_lens_to_loss(
            weighted_bce_with_logits(out, targets, pos_weight),
            batch[feat_key][1])
        return loss, {}

    def eval_step(self, batch: Dict, noise: Optional[Dict] = None,
                  generator: Optional[torch.Generator] = None):
        """``Brain.eval_step`` in a TEST stage of its own: a fresh
        ``flvl_md_stats`` for the step's ``evaluate_predictions``."""
        self.on_stage_start(Stage.TEST)
        return self.eval_forward(batch, noise=noise, generator=generator)

    def evaluate_predictions(self, predictions: Dict, batch: Dict,
                             ids=None) -> None:
        """Host side: each frame's argmax against the clean frame labels,
        both trimmed to their lengths, into ``flvl_md_stats``. ``ids``
        name the utterances (row numbers by default)."""
        out = to_host(predictions["out"])
        feat_lens = to_host(batch["feat"][1])
        md, md_lens = (to_host(x) for x in batch["flvl_gt_md_lbl_seq"])
        pred = undo_padding(out.argmax(-1), feat_lens)
        gt = undo_padding(np.asarray(md), md_lens)
        self.stats_loggers["flvl_md_stats"].append(
            list(range(len(pred))) if ids is None else list(ids),
            pred_md_lbl_seqs=[list(p) for p in pred],
            gt_md_lbl_seqs=[list(g) for g in gt])


class SBModel(LSTMFC):
    """LSTM_FC as ``cli.train`` / ``cli.test`` build it: the YAML's
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

    def evaluate_predictions(self, predictions: Dict, batch, stage=None):
        super().evaluate_predictions(predictions, batch, self._batch_ids)
