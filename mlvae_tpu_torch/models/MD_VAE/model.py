"""Flagship recipe MD_VAE (counterpart of
``mlvae_tpu/models/MD_VAE/model.py`` ``SBModel``): the training step of
its three alternating targets and the TEST-target eval step.

forward = normalizer (its stats update while training before
``update_until_epoch``) + phoneme recognizer + boundary detector +
[feat_fc ⊕ phn_recog_fc(stop-grad) -> concat_fc -> LSTM -> pi_fc -> π
(sampled while training, argmax otherwise) -> in-step MD Viterbi decode on
stop-gradded inputs -> HierarchicalVAE -> Decoder], with every loss key.
The training target cycles PHN_RECOG -> B_DETECTOR -> VAE by
``(epoch-1) % 3``; the branches a target runs are gated by it, and the
losses of the branches it does not train are detached.

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

import contextlib
from enum import Enum, auto
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mlvae_tpu_torch.models.md_model import MDModel
from mlvae_tpu_torch.modules.boundary_detector import BoundaryDetector
from mlvae_tpu_torch.modules.decoder import Decoder
from mlvae_tpu_torch.modules.fc_block import FCBlock
from mlvae_tpu_torch.modules.h_vae import HierarchicalVAE
from mlvae_tpu_torch.modules.phoneme_recognizer import PhonemeRecognizer
from mlvae_tpu_torch.nn import dist as D
from mlvae_tpu_torch.nn.norm import InputNormalization
from mlvae_tpu_torch.nn.rnn import LSTM
from mlvae_tpu_torch.ops import decode as dec
from mlvae_tpu_torch.training.brain import Stage
from mlvae_tpu_torch.utils.tensor import abs_lengths, apply_lens_to_loss

NOISE_KEYS = ("kumaraswamy_u", "vanilla_eps", "gumbel_g", "gmm_eps")


class Target(Enum):
    PHN_RECOG = auto()
    B_DETECTOR = auto()
    VAE = auto()
    TEST = auto()


TRAIN_CYCLE = (Target.PHN_RECOG, Target.B_DETECTOR, Target.VAE)


class MDVAE(MDModel):
    # what the host-side evaluation reads (JAX SBModel.EVAL_PRED_KEYS)
    EVAL_PRED_KEYS = frozenset({
        "decoded_boundary_seq", "decoded_plvl_md_lbl_seq",
        "decoded_t_lens", "decoded_l_lens",
    })

    def __init__(self, hparams: Dict,
                 generator: Optional[torch.Generator] = None, device=None,
                 run_opts: Optional[Dict] = None):
        super().__init__(hparams, run_opts)
        self.target = Target.TEST
        h = self.hparams
        kw = dict(generator=generator, device=device)
        n_cls = h["n_phonemes"] + 2
        inp = h["input_size"]
        self.normalizer = InputNormalization(inp, device=device)
        self.feat_fc = FCBlock([inp, h["feat_fc_size"], h["feat_fc_size"]],
                               end_activation=True, **kw)
        self.phoneme_recognizer = PhonemeRecognizer(
            inp, h["phn_rnn_hidden_size"], h["phn_rnn_num_layers"],
            [h["phn_rnn_hidden_size"], h["phn_fc_size"], h["phn_fc_size"],
             n_cls], h["n_phonemes"], **kw)
        self.phn_recog_fc = FCBlock(
            [n_cls, h["phn_recog_fc_size"], h["phn_recog_fc_size"]],
            end_activation=True, **kw)
        self.boundary_detector = BoundaryDetector(
            inp, h["boundary_rnn_hidden_size"], h["boundary_rnn_num_layers"],
            [h["boundary_rnn_hidden_size"], h["boundary_fc_size"],
             h["boundary_fc_size"], 1], **kw)
        self.concat_fc = FCBlock(
            [h["feat_fc_size"] + h["phn_recog_fc_size"], h["concat_fc_size"],
             h["concat_fc_size"]], end_activation=True, **kw)
        self.rnn = LSTM(h["concat_fc_size"], h["rnn_hidden_size"],
                        h["rnn_num_layers"], dropout=h["rnn_dropout"], **kw)
        self.pi_fc = FCBlock([h["rnn_hidden_size"], h["pi_fc_size"],
                              h["pi_fc_size"] // 2, 2], **kw)
        self.encoder = HierarchicalVAE(
            [h["rnn_hidden_size"], h["enc_fc_size"], h["enc_fc_size"]],
            h["latent_size"], h["num_components"], **kw)
        self.decoder = Decoder(
            h["latent_size"], h["dec_rnn_hidden_size"],
            h["dec_rnn_num_layers"], h["dec_rnn_dropout"],
            [h["dec_rnn_hidden_size"] * 2, h["dec_fc_size"],
             h["dec_fc_size"], inp], **kw)

    def on_stage_start(self, stage: Stage, epoch: Optional[int] = None):
        """TRAIN takes the epoch's target, ``(epoch-1) % 3`` of PHN_RECOG,
        B_DETECTOR, VAE; TEST takes the TEST target."""
        if stage == Stage.TRAIN:
            if epoch is None:
                raise ValueError(f"{stage} needs the epoch")
            self.target = TRAIN_CYCLE[(epoch - 1) % 3]
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
        h, t = self.hparams, self.target
        lat, nc = h["latent_size"], h["num_components"]
        f32 = torch.float32
        pi_dtype = torch.bfloat16 if self.auto_mix_prec else f32
        out = []
        if t in (Target.B_DETECTOR, Target.VAE, Target.TEST):
            out.append(("kumaraswamy_u", "uniform",
                        (BoundaryDetector.SAMPLE_TIMES, B, T), None, f32))
        if t in (Target.VAE, Target.TEST):
            if train:
                out += [("rnn_dropout", "bernoulli", s,
                         1.0 - self.rnn.dropout, f32)
                        for s in self.rnn.dropout_shapes(B, T)]
                out.append(("pi_gumbel", "gumbel", (B, T, 2), None,
                            pi_dtype))
            out += [("vanilla_eps", "normal", (B, T, lat), None, f32),
                    ("gumbel_g", "gumbel", (B, T, nc), None, f32),
                    ("gmm_eps", "normal", (B, T, lat * nc), None, f32)]
            if train:
                drop = self.decoder.rnn
                out += [("decoder_dropout", "bernoulli", s,
                         1.0 - drop.dropout, f32)
                        for s in drop.dropout_shapes(B, T)]
        return out

    def prepare_batch(self, batch: Dict) -> Dict:
        """Host-side checks of what the decode indexes with: every utterance
        has at least one canonical phoneme and at least as many frames as
        phonemes (T >= L; the batched decode would otherwise emit a silently
        truncated boundary sequence), and every canonical id, padding
        included, is a class of the model."""
        feats, feat_lens = batch["feat"]
        cn, cn_lens = batch["gt_cnncl_seq"]
        names = batch.get("id", list(range(len(feat_lens))))
        t = np.round(np.asarray(feat_lens.cpu(), np.float32) * feats.shape[1])
        l = np.round(np.asarray(cn_lens.cpu(), np.float32) * cn.shape[1])
        bad = np.where((t < l) | (l < 1))[0]
        if len(bad):
            raise ValueError(
                "utterances without canonical phonemes or with fewer frames "
                f"than canonical phonemes (T < L), undecodable: "
                f"{[names[i] for i in bad[:5]]}")
        n_cls = self.hparams["n_phonemes"] + 2
        ids = np.asarray(cn.cpu())
        bad = np.where(((ids < 0) | (ids >= n_cls)).any(axis=1))[0]
        if len(bad):
            raise ValueError(f"canonical phoneme ids outside [0, {n_cls}): "
                             f"{[names[i] for i in bad[:5]]}")
        return batch

    def _decode(self, predictions, batch):
        phn_out = predictions["phn_recog_out"]
        T = phn_out.shape[1]
        plvl_cnnl, plvl_lens = batch["gt_cnncl_seq"]
        t_lens = abs_lengths(batch["feat"][1], T)
        l_lens = abs_lengths(plvl_lens, plvl_cnnl.shape[1])
        # the decode sees stop-gradded inputs, built in their streams' dtype
        # and then cast to f32 as the JAX decode casts them; its outputs
        # are labels
        log_p_yx, log_p_y, log_p_b, log_p_pi = (
            v.float().contiguous() for v in dec.build_viterbi_inputs(
                phn_out.detach(), predictions["boundary_v"].detach(),
                predictions["pi_logits"].detach(), batch["prior"][0][0]))
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
        with contextlib.nullcontext() if train else torch.no_grad():
            return self._forward(batch, noise or {}, generator, train, epoch,
                                 target)

    def _forward(self, batch, noise, generator, train, epoch, target):
        feats, feat_lens = batch["feat"]
        feats = self.normalizer(feats, feat_lens, epoch=epoch, update=train)
        fa_boundary = batch["fa_boundary_seq"][0]
        preds = {"losses": {}}

        def maybe_detach(losses, active):
            return losses if active else {k: v.detach()
                                          for k, v in losses.items()}

        if target in (Target.PHN_RECOG, Target.VAE, Target.TEST):
            phn = self.phoneme_recognizer(
                feats, feat_lens, batch["gt_cnncl_seq"][0], fa_boundary,
                train=train, generator=generator)
            preds["phn_recog_out"] = phn["out"]
            preds["losses"].update(
                maybe_detach(phn["losses"], target == Target.PHN_RECOG))

        if target in (Target.B_DETECTOR, Target.VAE, Target.TEST):
            bd = self.boundary_detector(feats, fa_boundary,
                                        u=noise.get("kumaraswamy_u"),
                                        generator=generator, train=train)
            preds["boundary_v"] = bd["boundary_v"]
            preds["losses"].update(
                maybe_detach(bd["losses"], target == Target.B_DETECTOR))

        if target not in (Target.VAE, Target.TEST):
            return preds
        phn_in = preds["phn_recog_out"].detach()   # stop-grad
        rnn_in = torch.cat([self.feat_fc(feats), self.phn_recog_fc(phn_in)],
                           dim=-1)
        rnn_out, _ = self.rnn(self.concat_fc(rnn_in), train=train,
                              generator=generator,
                              masks=noise.get("rnn_dropout"))
        pi_logits = self.pi_fc(rnn_out)
        preds["pi_logits"] = pi_logits
        if train:
            sampled = D.categorical_sample(pi_logits, g=noise.get("pi_gumbel"),
                                           generator=generator)
        else:
            sampled = torch.argmax(pi_logits, dim=-1)
        sampled = sampled.to(feats.dtype)  # (B, T)
        sampled_pi = torch.stack([1 - sampled, sampled], dim=2)
        preds["sampled_pi"] = sampled_pi

        boundary, flvl, plvl, t_lens, l_lens = self._decode(preds, batch)
        preds["decoded_boundary_seq"] = boundary
        preds["decoded_flvl_md_lbl_seq"] = flvl
        preds["decoded_plvl_md_lbl_seq"] = plvl
        preds["decoded_t_lens"] = t_lens
        preds["decoded_l_lens"] = l_lens
        preds["losses"]["pi_nll_loss"] = -D.categorical_log_prob(pi_logits,
                                                                 flvl)

        enc = self.encoder(rnn_out, sampled_pi, noise=noise,
                           generator=generator)
        preds["losses"].update(enc["losses"])
        dec_out = self.decoder(enc["sampled_h"], feats, train=train,
                               generator=generator,
                               masks=noise.get("decoder_dropout"))
        preds["losses"].update(dec_out["losses"])
        return preds

    def compute_objectives(self, predictions, batch):
        feat_lens = batch["feat"][1]
        losses = {k: apply_lens_to_loss(v, feat_lens)
                  for k, v in predictions["losses"].items()}
        return self.weighted_total(losses), losses

    @torch.no_grad()
    def eval_step(self, batch: Dict, noise: Optional[Dict] = None,
                  generator: Optional[torch.Generator] = None):
        """One TEST-target eval step, as the JAX package's jitted eval step
        returns it: (predictions restricted to ``EVAL_PRED_KEYS``, total
        loss, per-key losses)."""
        self.on_stage_start(Stage.TEST)
        preds = self.compute_forward(batch, noise=noise, generator=generator)
        loss, losses = self.compute_objectives(preds, batch)
        return ({k: v for k, v in preds.items() if k in self.EVAL_PRED_KEYS},
                loss, losses)
