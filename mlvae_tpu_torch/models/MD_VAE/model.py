"""Flagship recipe MD_VAE (counterpart of
``mlvae_tpu/models/MD_VAE/model.py``): ``MDVAE``, the training step of its
three alternating targets and the TEST-target eval step, and ``SBModel``,
the recipe as the CLI builds it from the YAML's modules, with the
host-side evaluation (MD and boundary statistics on VALID stages of VAE
epochs and on TEST) and the saved-MD-results dump of the TEST stage, which
a later run's data cleaning reads.

forward = normalizer (its stats update while training before
``update_until_epoch``) + phoneme recognizer + boundary detector +
[feat_fc ⊕ phn_recog_fc(stop-grad) -> concat_fc -> LSTM -> pi_fc -> π
(sampled while training, argmax otherwise) -> in-step MD Viterbi decode on
stop-gradded inputs -> HierarchicalVAE -> Decoder], with every loss key.
The training target cycles PHN_RECOG -> B_DETECTOR -> VAE by
``(epoch-1) % 3``; the branches a target runs are gated by it, and the
losses of the branches it does not train are detached.

The other recipes of the family subclass these two classes as the JAX
package's do, through its hooks: ``TRAIN_CYCLE``, ``detach_inactive``,
``save_md_on_valid``, ``PHN_FC_NAME``, ``used_batch_keys``,
``_init_stage_stats``, ``to_run_evaluation``, ``_input_feats``,
``_branch_inputs``, ``_phn_recog_branch``, ``_vae_branch``,
``_sample_draws`` and ``_build_modules``; the modules are the recipe's,
by the names its YAML gives them.

Every draw is named, and ``draws`` lists those of one forward in the JAX
package's order (``fold_in(rng, 0..k)`` of its ``RngStream``). The eval
step draws ``kumaraswamy_u`` (10, B, T), ``vanilla_eps`` (B, T, latent),
``gumbel_g`` (B, T, components) and ``gmm_eps`` (B, T, latent *
components); the VAE target's training step draws ``kumaraswamy_u``, the
``rnn_dropout`` keep-mask (T, B, H), ``pi_gumbel`` (B, T, 2), the three
encoder draws and the ``decoder_dropout`` keep-mask (T, B, 2H); the
B_DETECTOR target draws only ``kumaraswamy_u`` and PHN_RECOG nothing. Pass
them in ``noise`` to replay a run, or a ``torch.Generator`` to draw them.
Every draw is f32 but ``pi_gumbel`` under AMP, which
``jax.random.categorical`` draws in the bf16 logits' dtype.

Under AMP (``Brain.auto_mix_prec``) the forward sees bf16 weights and a
bf16 batch; each module keeps the stream dtype where the JAX module does
(linears, activations, dropout, the LSTMs, the mixtures) and casts to f32
where it does (the distribution math of ``nn/dist.py``, the decode's
inputs). ``batch["prior"]`` reaches the decode as bf16.
"""
from __future__ import annotations

import json
import logging
import warnings
from enum import Enum, auto
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mlvae_tpu_torch.metrics.boundary import BoundaryMetricStats
from mlvae_tpu_torch.metrics.loss import LossMetricStats
from mlvae_tpu_torch.metrics.md import MDMetricStats
from mlvae_tpu_torch.models.md_model import (MDModel, dropout_draws,
                                             grad_if, pi_vae_draws)
from mlvae_tpu_torch.modules.boundary_detector import BoundaryDetector
from mlvae_tpu_torch.modules.decoder import Decoder
from mlvae_tpu_torch.modules.fc_block import FCBlock
from mlvae_tpu_torch.modules.h_vae import HierarchicalVAE
from mlvae_tpu_torch.modules.phoneme_recognizer import PhonemeRecognizer
from mlvae_tpu_torch.nn import dist as D
from mlvae_tpu_torch.nn.norm import InputNormalization
from mlvae_tpu_torch.nn.rnn import LSTM
from mlvae_tpu_torch.ops import decode as dec
from mlvae_tpu_torch.training.brain import Stage, batch_feats
from mlvae_tpu_torch.utils.tensor import (abs_lengths, apply_lens_to_loss,
                                          to_host, undo_padding)

logger = logging.getLogger(__name__)

NOISE_KEYS = ("kumaraswamy_u", "vanilla_eps", "gumbel_g", "gmm_eps")


class Target(Enum):
    PHN_RECOG = auto()
    B_DETECTOR = auto()
    VAE = auto()
    TEST = auto()


class MDVAE(MDModel):
    USED_BATCH_KEYS = {"feat", "gt_cnncl_seq", "fa_boundary_seq",
                       "gt_boundary_seq", "plvl_gt_md_lbl_seq", "prior"}
    # what the host-side evaluation reads (JAX SBModel.EVAL_PRED_KEYS)
    EVAL_PRED_KEYS = frozenset({
        "decoded_boundary_seq", "decoded_plvl_md_lbl_seq",
        "decoded_t_lens", "decoded_l_lens",
    })
    # the subclass knobs of the JAX SBModel: the training targets by epoch;
    # whether the losses of the branches a target does not train are
    # detached (the joint recipes train them all); whether VALID saves MD
    # results as TEST does; the recognizer-output FC's module name
    TRAIN_CYCLE = (Target.PHN_RECOG, Target.B_DETECTOR, Target.VAE)
    detach_inactive = True
    save_md_on_valid = False
    PHN_FC_NAME = "phn_recog_fc"

    def __init__(self, hparams: Dict,
                 generator: Optional[torch.Generator] = None, device=None,
                 run_opts: Optional[Dict] = None,
                 modules: Optional[Dict] = None, **brain_kwargs):
        """The modules are built from ``hparams`` with weights drawn from
        ``generator`` on ``device`` (``_build_modules``), or taken from
        ``modules`` (name -> module, as the YAML builds them, every one
        under its YAML name); the normalizer is ``hparams["normalizer"]``
        where that is one, sized to ``input_size``."""
        super().__init__(hparams, run_opts, **brain_kwargs)
        self.target = Target.TEST
        norm = self.hparams.get("normalizer")
        self.normalizer = norm if isinstance(norm, InputNormalization) \
            else InputNormalization(device=device)
        self.normalizer.ensure_size(self.hparams["input_size"])
        if modules is None:
            modules = self._build_modules(
                self.hparams, dict(generator=generator, device=device))
        self.adopt_modules(modules)

    @staticmethod
    def _build_modules(h: Dict, kw: Dict) -> Dict[str, torch.nn.Module]:
        """The recipe's modules at ``h``'s widths, in the YAML's order (the
        order their weights are drawn in), by the YAML's names."""
        inp = h["input_size"]
        n_cls = h["n_phonemes"] + 2
        mods = {}
        mods["feat_fc"] = FCBlock(
            [inp, h["feat_fc_size"], h["feat_fc_size"]], end_activation=True,
            **kw)
        mods["phoneme_recognizer"] = PhonemeRecognizer(
            inp, h["phn_rnn_hidden_size"], h["phn_rnn_num_layers"],
            [h["phn_rnn_hidden_size"], h["phn_fc_size"], h["phn_fc_size"],
             n_cls], h["n_phonemes"], **kw)
        mods["phn_recog_fc"] = FCBlock(
            [n_cls, h["phn_recog_fc_size"], h["phn_recog_fc_size"]],
            end_activation=True, **kw)
        mods["boundary_detector"] = BoundaryDetector(
            inp, h["boundary_rnn_hidden_size"], h["boundary_rnn_num_layers"],
            [h["boundary_rnn_hidden_size"], h["boundary_fc_size"],
             h["boundary_fc_size"], 1], **kw)
        mods["concat_fc"] = FCBlock(
            [h["feat_fc_size"] + h["phn_recog_fc_size"], h["concat_fc_size"],
             h["concat_fc_size"]], end_activation=True, **kw)
        mods["rnn"] = LSTM(h["concat_fc_size"], h["rnn_hidden_size"],
                           h["rnn_num_layers"], dropout=h["rnn_dropout"],
                           **kw)
        mods["pi_fc"] = FCBlock([h["rnn_hidden_size"], h["pi_fc_size"],
                                 h["pi_fc_size"] // 2, 2], **kw)
        mods["encoder"] = HierarchicalVAE(
            [h["rnn_hidden_size"], h["enc_fc_size"], h["enc_fc_size"]],
            h["latent_size"], h["num_components"], **kw)
        mods["decoder"] = Decoder(
            h["latent_size"], h["dec_rnn_hidden_size"],
            h["dec_rnn_num_layers"], h["dec_rnn_dropout"],
            [h["dec_rnn_hidden_size"] * 2, h["dec_fc_size"],
             h["dec_fc_size"], inp], **kw)
        return mods

    def used_batch_keys(self):
        keys = set(self.USED_BATCH_KEYS)
        if self.hparams.get("use_kaldi_feat", False):
            keys.add("kaldi_feat")   # the MD_VAE_sfl input path
        return keys

    def set_stage(self, stage: Stage, epoch: Optional[int] = None):
        """TRAIN and VALID take the epoch's target, ``(epoch-1) % n`` of
        ``TRAIN_CYCLE`` (PHN_RECOG, B_DETECTOR, VAE); TEST takes the TEST
        target."""
        if stage in (Stage.TRAIN, Stage.VALID):
            if epoch is None:
                raise ValueError(f"{stage} needs the epoch")
            cycle = self.TRAIN_CYCLE
            self.target = cycle[(epoch - 1) % len(cycle)]
        elif stage == Stage.TEST:
            self.target = Target.TEST
        else:
            raise ValueError(f"invalid stage {stage}")

    def draws(self, B: int, T: int, train: bool = False
              ) -> List[Tuple[str, str, tuple, Optional[float],
                              torch.dtype]]:
        """The draws of one forward under the current target, in the JAX
        package's RngStream order: (name, kind, shape, keep probability
        for a ``bernoulli`` keep-mask, dtype). Kinds are ``uniform``,
        ``bernoulli``, ``gumbel`` and ``normal``; names that repeat (one
        dropout mask per gap between layers) are replayed as a list. The
        dtype is f32 but for ``pi_gumbel`` under AMP (bf16)."""
        t, f32 = self.target, torch.float32
        out = []
        if t in (Target.B_DETECTOR, Target.VAE, Target.TEST):
            out.append(("kumaraswamy_u", "uniform",
                        (BoundaryDetector.SAMPLE_TIMES, B, T), None, f32))
        if t in (Target.VAE, Target.TEST):
            if train:
                out += dropout_draws("rnn_dropout", self.rnn, B, T)
            out += self._sample_draws(B, T, train)
        return out

    def _sample_draws(self, B: int, T: int, train: bool) -> List:
        """The draws of one π sample and the VAE on it: π's Gumbel noise
        (training only), the encoder's three, the decoder's dropout
        masks (training only): ``pi_vae_draws``."""
        return pi_vae_draws(self, B, T, train)

    def prepare_batch(self, batch):
        """Host-side checks of what the decode indexes with: every utterance
        has at least one canonical phoneme and at least as many frames as
        phonemes (T >= L; the batched decode would otherwise emit a silently
        truncated boundary sequence), and every canonical id, padding
        included, is a class of the model with a row in the prior.
        ``batch`` is a host batch (a ``PaddedBatch``) or a dict of
        tensors."""
        feats, feat_lens = batch_feats(batch)
        cn, cn_lens = batch["gt_cnncl_seq"]
        names = batch["id"] if "id" in batch else \
            list(range(len(feat_lens)))
        t = np.round(to_host(feat_lens).astype(np.float32) * feats.shape[1])
        l = np.round(to_host(cn_lens).astype(np.float32) * cn.shape[1])
        bad = np.where((t < l) | (l < 1))[0]
        if len(bad):
            raise ValueError(
                "utterances without canonical phonemes or with fewer frames "
                f"than canonical phonemes (T < L), undecodable: "
                f"{[names[i] for i in bad[:5]]}")
        n_cls = min(self.hparams["n_phonemes"] + 2,
                    batch["prior"][0].shape[1])
        ids = to_host(cn)
        bad = np.where(((ids < 0) | (ids >= n_cls)).any(axis=1))[0]
        if len(bad):
            raise ValueError(f"canonical phoneme ids outside [0, {n_cls}) "
                             f"(the classes and the prior's labels): "
                             f"{[names[i] for i in bad[:5]]}")
        return batch

    def _decode(self, predictions, batch):
        phn_out = predictions["phn_recog_out"]
        T = phn_out.shape[1]
        plvl_cnnl, plvl_lens = batch["gt_cnncl_seq"]
        t_lens = abs_lengths(batch_feats(batch)[1], T)
        l_lens = abs_lengths(plvl_lens, plvl_cnnl.shape[1])
        # the decode sees stop-gradded inputs, built in their streams' dtype
        # and then cast to f32 as the JAX decode casts them; its outputs
        # are labels
        # the recipe's prior covers the label encoder's labels (the
        # phoneme set and the blank), one class fewer than the recognizer's
        # outputs: pad it to the decode's (N, 2) table with a row that no
        # canonical id reads (``prepare_batch`` checks the ids)
        prior = batch["prior"][0][0]
        prior = torch.nn.functional.pad(prior, (0, phn_out.shape[-1]
                                                - prior.shape[0]))
        log_p_yx, log_p_y, log_p_b, log_p_pi = (
            v.float().contiguous() for v in dec.build_viterbi_inputs(
                phn_out.detach(), predictions["boundary_v"].detach(),
                predictions["pi_logits"].detach(), prior))
        boundary, flvl, plvl = dec.md_viterbi_batch(
            log_p_yx, log_p_y, plvl_cnnl.to(torch.int32), log_p_b,
            log_p_pi, t_lens, l_lens,
            float(self.hparams.get("dec_weight", 1.0)))
        return boundary, flvl, plvl, t_lens, l_lens

    def compute_forward(self, batch: Dict, noise: Optional[Dict] = None,
                        generator: Optional[torch.Generator] = None,
                        train: bool = False, epoch: int = 1):
        """The current target's forward; returns the predictions dict with
        its per-element ``losses``. ``train`` samples π, applies dropout,
        updates the normalizer's stats before ``update_until_epoch`` and
        builds the graph; otherwise no graph is built."""
        target = self.target
        if train and target == Target.TEST:
            raise ValueError("the TEST target does not train")
        with grad_if(train):
            return self._forward(batch, noise or {}, generator, train, epoch,
                                 target)

    def _forward(self, batch, noise, generator, train, epoch, target):
        feats, feat_lens = self._input_feats(batch, train, epoch)
        inputs = self._branch_inputs(feats, target, batch, noise, generator,
                                     train)
        preds = {"losses": {}}

        if target in (Target.PHN_RECOG, Target.VAE, Target.TEST):
            phn = self._phn_recog_branch(inputs["phn_in"], feat_lens, batch,
                                         train, generator)
            preds["phn_recog_out"] = phn["out"]
            preds["losses"].update(
                self._maybe_detach(phn["losses"],
                                   target == Target.PHN_RECOG))

        if target in (Target.B_DETECTOR, Target.VAE, Target.TEST):
            bd = self.boundary_detector(
                inputs["bdet_in"], batch["fa_boundary_seq"][0],
                u=noise.get("kumaraswamy_u"), generator=generator,
                train=train)
            preds["boundary_v"] = bd["boundary_v"]
            preds["losses"].update(
                self._maybe_detach(bd["losses"],
                                   target == Target.B_DETECTOR))

        if target in (Target.VAE, Target.TEST):
            self._vae_branch(preds, feats, inputs["vae_in"], batch, noise,
                             generator, train)
        return preds

    def _maybe_detach(self, losses, active: bool):
        if active or not self.detach_inactive:
            return losses
        return {k: v.detach() for k, v in losses.items()}

    def _input_feats(self, batch, train: bool, epoch: int):
        """The model's input features and their relative lengths: the
        normalized ``feat`` (the normalizer's statistics update while
        training, before ``update_until_epoch``)."""
        feats, feat_lens = batch["feat"]
        return (self.normalizer(feats, feat_lens, epoch=epoch, update=train),
                feat_lens)

    def _branch_inputs(self, feats, target, batch, noise, generator, train):
        """Each branch's input: the features for the recognizer and the
        detector, ``feat_fc`` of them for the VAE (where the target runs
        it). The w2v recipes feed projections of wav2vec2 features."""
        vae_in = self.feat_fc(feats) \
            if target in (Target.VAE, Target.TEST) else None
        return {"phn_in": feats, "bdet_in": feats, "vae_in": vae_in}

    def _phn_recog_branch(self, feats, feat_lens, batch, train, generator):
        """The recognizer's {"out", "losses"}; MD_VAE_sfl_saved_phn_recog
        reads saved posteriors instead."""
        return self.phoneme_recognizer(
            feats, feat_lens, batch["gt_cnncl_seq"][0],
            batch["fa_boundary_seq"][0], train=train, generator=generator)

    def _pi_branch(self, preds, vae_in, noise, generator, train):
        """The π logits (into ``preds``) from the VAE input and the
        stop-gradded recognizer output; returns the LSTM's output."""
        phn_fc = getattr(self, self.PHN_FC_NAME)
        rnn_in = torch.cat([vae_in, phn_fc(preds["phn_recog_out"].detach())],
                           dim=-1)
        rnn_out, _ = self.rnn(self.concat_fc(rnn_in), train=train,
                              generator=generator,
                              masks=noise.get("rnn_dropout"))
        preds["pi_logits"] = self.pi_fc(rnn_out)
        return rnn_out

    def _decode_into(self, preds, batch):
        """The in-step MD Viterbi decode, its outputs into ``preds``;
        returns the frame-level labels."""
        boundary, flvl, plvl, t_lens, l_lens = self._decode(preds, batch)
        preds["decoded_boundary_seq"] = boundary
        preds["decoded_flvl_md_lbl_seq"] = flvl
        preds["decoded_plvl_md_lbl_seq"] = plvl
        preds["decoded_t_lens"] = t_lens
        preds["decoded_l_lens"] = l_lens
        return flvl

    def _vae_branch(self, preds, feats, vae_in, batch, noise, generator,
                    train):
        """π (sampled while training, argmax otherwise), the decode, the π
        NLL against the decoded frame labels, the VAE and the decoder."""
        rnn_out = self._pi_branch(preds, vae_in, noise, generator, train)
        pi_logits = preds["pi_logits"]
        if train:
            sampled = D.categorical_sample(pi_logits, g=noise.get("pi_gumbel"),
                                           generator=generator)
        else:
            sampled = torch.argmax(pi_logits, dim=-1)
        sampled = sampled.to(feats.dtype)  # (B, T)
        sampled_pi = torch.stack([1 - sampled, sampled], dim=2)
        preds["sampled_pi"] = sampled_pi

        flvl = self._decode_into(preds, batch)
        preds["losses"]["pi_nll_loss"] = -D.categorical_log_prob(pi_logits,
                                                                 flvl)
        enc = self.encoder(rnn_out, sampled_pi, noise=noise,
                           generator=generator)
        preds["losses"].update(enc["losses"])
        dec_out = self.decoder(enc["sampled_h"], feats, train=train,
                               generator=generator,
                               masks=noise.get("decoder_dropout"))
        preds["losses"].update(dec_out["losses"])

    def compute_objectives(self, predictions, batch):
        feat_lens = batch_feats(batch)[1]
        losses = {k: apply_lens_to_loss(v, feat_lens)
                  for k, v in predictions["losses"].items()}
        return self.weighted_total(losses), losses


class SBModel(MDVAE):
    """MD_VAE as ``cli.train`` / ``cli.test`` build it: the YAML's modules
    (``modules=hparams["model"]["modules"]``), its checkpointer and epoch
    counter, the run's step generator, and the label encoder."""

    def __init__(self, modules: Dict, hparams: Dict,
                 run_opts: Optional[Dict] = None, checkpointer=None,
                 label_encoder=None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(hparams, run_opts=run_opts, modules=modules,
                         checkpointer=checkpointer,
                         label_encoder=label_encoder)
        self.generator = generator

    # -- stage hooks ---------------------------------------------------------
    def on_stage_start(self, stage: Stage, epoch=None):
        self._stage_epoch = epoch
        self.set_stage(stage, epoch)
        logger.info("Epoch %s, stage %s: target is %s", epoch, stage,
                    self.target)
        self._init_stage_stats(stage)

    def _init_stage_stats(self, stage):
        """The stage's statistics: the losses of ``metric_keys`` in TRAIN
        and where the stage is evaluated, the MD and boundary statistics
        where it is."""
        self._pending_md_results = {}
        self.stats_loggers = {}
        if stage == Stage.TRAIN or self.to_run_evaluation(stage):
            for key in self.hparams.get("metric_keys", []):
                if key.endswith("_loss"):
                    self.stats_loggers[key + "_stats"] = LossMetricStats(key)
        if self.to_run_evaluation(stage):
            self.stats_loggers["plvl_md_stats"] = MDMetricStats()
            self.stats_loggers["boundary_stats"] = BoundaryMetricStats()

    def to_run_evaluation(self, stage) -> bool:
        """Whether the stage scores its decodes: VALID on the VAE target's
        epochs, and TEST."""
        return (stage == Stage.VALID and self.target == Target.VAE) \
            or stage == Stage.TEST

    def on_stage_end(self, stage, stage_loss, epoch=None):
        self._flush_md_results()
        # VALID off the VAE epochs is neither logged nor checkpointed
        if stage == Stage.VALID and not self.to_run_evaluation(stage):
            return
        super().on_stage_end(stage, stage_loss, epoch)

    def prepare_batch(self, batch):
        batch = super().prepare_batch(batch)
        # the recognizer's targets gather one boundary per phoneme; a
        # forced alignment with another count is clamped there, so say so
        # (a boundary pushed past the last frame by the bump-right rule is
        # a legitimate cause)
        _, cn_lens = batch["gt_cnncl_seq"]
        L = batch["gt_cnncl_seq"][0].shape[1]
        l = np.round(to_host(cn_lens).astype(np.float32) * L)
        fa_b, fa_lens = (to_host(x) for x in batch["fa_boundary_seq"])
        Tb = fa_b.shape[1]
        tmask = np.arange(Tb)[None, :] < np.round(
            fa_lens.astype(np.float32) * Tb)[:, None]
        mism = np.where((fa_b * tmask).sum(axis=1) != l)[0]
        if len(mism):
            ids = [batch["id"][i] for i in mism]
            logger.warning(
                "forced-alignment boundary count != canonical length for "
                "%d utterance(s) (recognizer targets clamped): %s%s",
                len(mism), ids[:5], "..." if len(ids) > 5 else "")
        return batch

    # -- host-side evaluation and the saved MD results -----------------------
    def evaluate_predictions(self, predictions, batch, stage):
        if not self.to_run_evaluation(stage):
            return
        boundary = to_host(predictions["decoded_boundary_seq"])
        plvl = to_host(predictions["decoded_plvl_md_lbl_seq"])
        t_lens = to_host(predictions["decoded_t_lens"])
        l_lens = to_host(predictions["decoded_l_lens"])
        B = boundary.shape[0]
        pred_boundary = [boundary[i, :t_lens[i]] for i in range(B)]
        pred_plvl = [plvl[i, :l_lens[i]] for i in range(B)]
        gt_md_seqs = undo_padding(*(to_host(x) for x in
                                    batch["plvl_gt_md_lbl_seq"]))
        gt_b_seqs = undo_padding(*(to_host(x) for x in
                                   batch["gt_boundary_seq"]))
        self.stats_loggers["plvl_md_stats"].append(
            ids=self._batch_ids, pred_md_lbl_seqs=pred_plvl,
            gt_md_lbl_seqs=gt_md_seqs, pred_boundary_seqs=pred_boundary,
            gt_boundary_seqs=gt_b_seqs)
        self.stats_loggers["boundary_stats"].append(
            ids=self._batch_ids, predictions=pred_boundary,
            targets=gt_b_seqs)
        if stage == Stage.TEST or self.save_md_on_valid:
            self.save_md_result(self._batch_ids, pred_boundary, pred_plvl)

    def save_md_result(self, utt_ids, boundary_seqs, plvl_md_seqs):
        """Each utterance's mispronounced spans, [phoneme index, start
        fraction, end fraction], for the data-cleaning round trip; kept
        per stage and written once by ``_flush_md_results``."""
        for utt_id, boundary, md in zip(utt_ids, boundary_seqs,
                                        plvl_md_seqs):
            T = len(boundary)
            idx = np.where(np.asarray(boundary) == 1)[0].tolist() + [T]
            pct = [i / T for i in idx]
            utt_results = []
            for misp_idx in np.where(np.asarray(md) == 1)[0]:
                start_pct, end_pct = pct[misp_idx], pct[misp_idx + 1]
                if start_pct == end_pct:
                    warnings.warn("empty mispronunciation span")
                    continue
                utt_results.append([int(misp_idx), start_pct, end_pct])
            self._pending_md_results[utt_id] = utt_results

    def _flush_md_results(self):
        """Merge the stage's results into
        ``datasets/<dataset>/saved_md_results/<model_name>.json``."""
        md_results = getattr(self, "_pending_md_results", None)
        if not md_results or not self.is_writer:
            return
        save_dir = Path("datasets") / self.hparams["dataset_name"] / \
            "saved_md_results"
        save_dir.mkdir(parents=True, exist_ok=True)
        save_path = save_dir / f"{self.hparams['model_name']}.json"
        if save_path.exists():
            with open(save_path) as f:
                existing = json.load(f)
            existing.update(md_results)
            md_results = existing
        with open(save_path, "w") as f:
            json.dump(md_results, f)
        self._pending_md_results = {}
