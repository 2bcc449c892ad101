"""Harness recipe test_h_vae (counterpart of
``mlvae_tpu/models/test_h_vae/model.py``): an LSTM trunk on the normalized
features -> ``pi_fc`` logits -> π, a categorical sample while training
(``nn.dist.categorical_sample``) and the argmax otherwise -> the
hierarchical VAE on the trunk's output, mixed under π -> the decoder
(selection on the smallest loss).

Its LSTMs (the trunk's two layers, the decoder's two bidirectional ones)
run K1 in f32 (six K1-fwd in a forward, six K1-bwd in a train step);
under AMP the trunk's and the decoder's first layers take K3 and the
decoder's second (In = 2H) K4 at H=512. The draws of a training forward,
in the JAX package's order: the trunk's dropout keep-mask
``rnn_dropout`` (T, B, H), π's Gumbel noise ``pi_gumbel`` (B, T, 2; bf16
under AMP, as ``jax.random.categorical`` draws it for bf16 logits), the
encoder's ``vanilla_eps``, ``gumbel_g`` and ``gmm_eps``, and
``decoder_dropout``; an eval forward draws the encoder's three only."""
from __future__ import annotations

import torch

from mlvae_tpu_torch.models.md_model import (RecipeModel, dropout_draws,
                                             grad_if, pi_vae_draws)
from mlvae_tpu_torch.nn import dist as D
from mlvae_tpu_torch.utils.tensor import apply_lens_to_loss


class SBModel(RecipeModel):
    USED_BATCH_KEYS = {"feat"}
    EVAL_PRED_KEYS = frozenset()   # losses only

    def draws(self, B: int, T: int, train: bool = False):
        """The draws of one forward (see ``MDVAE.draws``)."""
        rnn = dropout_draws("rnn_dropout", self.rnn, B, T) if train else []
        return rnn + pi_vae_draws(self, B, T, train)

    def compute_forward(self, batch, noise=None, generator=None,
                        train: bool = False, epoch: int = 1):
        feats, feat_lens = batch["feat"]
        noise = noise or {}
        with grad_if(train):
            feats = self.normalizer(feats, feat_lens, epoch=epoch,
                                    update=train)
            rnn_out, _ = self.rnn(feats, train=train, generator=generator,
                                  masks=noise.get("rnn_dropout"))
            pi_logits = self.pi_fc(rnn_out)
            if train:
                sampled = D.categorical_sample(
                    pi_logits, g=noise.get("pi_gumbel"), generator=generator)
            else:
                sampled = torch.argmax(pi_logits, dim=-1)
            sampled = sampled.to(feats.dtype)
            sampled_pi = torch.stack([1 - sampled, sampled], dim=2)
            enc = self.encoder(rnn_out, sampled_pi, noise=noise,
                               generator=generator)
            dec = self.decoder(enc["sampled_h"], feats, train=train,
                               generator=generator,
                               masks=noise.get("decoder_dropout"))
            return {"encoder_out": enc, "decoder_out": dec}

    def compute_objectives(self, predictions, batch):
        feat_lens = batch["feat"][1]
        raw = dict(predictions["encoder_out"]["losses"])
        raw["recon_loss"] = predictions["decoder_out"]["losses"]["recon_loss"]
        losses = {k: apply_lens_to_loss(v, feat_lens) for k, v in raw.items()}
        return self.weighted_total(losses), losses
