"""Harness recipe test_vanilla_vae (counterpart of
``mlvae_tpu/models/test_vanilla_vae/model.py``): a vanilla VAE and the
decoder trained end to end on the normalized features by the masked KLD
and Gaussian NLL (selection on the smallest loss).

The decoder's two bidirectional LSTM layers run K1 in f32 (four K1-fwd in
a forward, four K1-bwd in a train step); under AMP the first layer
(In = latent) takes K3 and the second (In = 2H) K4 at H=512. Every
forward draws the encoder's ``vanilla_eps`` (B, T, latent); a training
forward also the decoder's dropout keep-mask ``decoder_dropout``
(T, B, 2H)."""
from __future__ import annotations

import torch

from mlvae_tpu_torch.models.md_model import (RecipeModel, dropout_draws,
                                             grad_if)
from mlvae_tpu_torch.utils.tensor import apply_lens_to_loss


class SBModel(RecipeModel):
    USED_BATCH_KEYS = {"feat"}
    EVAL_PRED_KEYS = frozenset()   # losses only

    def draws(self, B: int, T: int, train: bool = False):
        """The draws of one forward (see ``MDVAE.draws``)."""
        out = [("vanilla_eps", "normal", (B, T, self.hparams["latent_size"]),
                None, torch.float32)]
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
            enc = self.encoder(feats, eps=noise.get("vanilla_eps"),
                               generator=generator)
            dec = self.decoder(enc["sampled_h"], feats, train=train,
                               generator=generator,
                               masks=noise.get("decoder_dropout"))
            return {"encoder_out": enc, "decoder_out": dec}

    def compute_objectives(self, predictions, batch):
        feat_lens = batch["feat"][1]
        losses = {
            "kld_loss": apply_lens_to_loss(predictions["encoder_out"]["loss"],
                                           feat_lens),
            "recon_loss": apply_lens_to_loss(
                predictions["decoder_out"]["losses"]["recon_loss"],
                feat_lens),
        }
        return self.weighted_total(losses), losses
