"""Harness recipe test_gmm_vae (counterpart of
``mlvae_tpu/models/test_gmm_vae/model.py``): a GMM VAE and the decoder on
the normalized features. The sampled latent is collapsed under the hard
Gumbel component weights before the decoder, and the KLD likewise before
the mask (selection on the smallest loss).

The decoder's LSTMs run as test_vanilla_vae's. Every forward draws the
encoder's ``gumbel_g`` (B, T, components) and ``gmm_eps`` (B, T, latent *
components); a training forward also ``decoder_dropout``."""
from __future__ import annotations

import torch

from mlvae_tpu_torch.models.md_model import (RecipeModel, dropout_draws,
                                             grad_if)
from mlvae_tpu_torch.utils.tensor import apply_lens_to_loss, apply_weight


class SBModel(RecipeModel):
    USED_BATCH_KEYS = {"feat"}
    EVAL_PRED_KEYS = frozenset()   # losses only

    def draws(self, B: int, T: int, train: bool = False):
        """The draws of one forward (see ``MDVAE.draws``)."""
        lat, nc = self.hparams["latent_size"], self.hparams["num_components"]
        out = [("gumbel_g", "gumbel", (B, T, nc), None, torch.float32),
               ("gmm_eps", "normal", (B, T, lat * nc), None, torch.float32)]
        if train:
            out += dropout_draws("decoder_dropout", self.decoder.rnn, B, T)
        return out

    def compute_forward(self, batch, noise=None, generator=None,
                        train: bool = False, epoch: int = 1):
        feats, feat_lens = batch["feat"]
        noise = noise or {}
        with grad_if(train):
            feats = self.normalizer(feats, feat_lens, epoch=epoch,
                                    update=train)
            enc = self.encoder(feats, g=noise.get("gumbel_g"),
                               eps=noise.get("gmm_eps"), generator=generator)
            weighted_h = apply_weight(enc["sampled_h"], enc["gmm_weight"])
            dec = self.decoder(weighted_h, feats, train=train,
                               generator=generator,
                               masks=noise.get("decoder_dropout"))
            return {"encoder_out": enc, "decoder_out": dec}

    def compute_objectives(self, predictions, batch):
        feat_lens = batch["feat"][1]
        enc = predictions["encoder_out"]
        losses = {
            "kld_loss": apply_lens_to_loss(
                apply_weight(enc["loss"], enc["gmm_weight"]), feat_lens),
            "recon_loss": apply_lens_to_loss(
                predictions["decoder_out"]["losses"]["recon_loss"],
                feat_lens),
        }
        return self.weighted_total(losses), losses
