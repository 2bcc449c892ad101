"""MD_VAE_sfl (counterpart of ``mlvae_tpu/models/MD_VAE_sfl/model.py``):
MD_VAE with the indicator π learned by the score function (REINFORCE)
against a learned baseline.

* The VAE target's forward decodes first (the in-step MD Viterbi decode
  on stop-gradded inputs, as MD_VAE's), then runs ``pi_mcmc_num`` π
  samples while training and one, the argmax, otherwise; each sample runs
  the hierarchical VAE and the decoder.
* π's NLL against the decoded frame labels, and each sample's NLL, are
  ``categorical_ll_onehot`` (the reference's bmm over log-softmaxed
  logits).
* Each sample's reward is −(recon_weight·recon + vae_kld_weight·kld +
  pi_nll_weight·π-NLL), from stop-gradded terms (each loss averaged over
  its last axis); its ``rif_loss`` is ``(reward − baseline.detach())·nll``,
  its ``entropy_loss`` π's negative entropy and its ``baseline_loss``
  ``(baseline − reward)²``, whose gradient reaches ``baseline_fc`` (a
  head on the LSTM's output) and the LSTM. ``vae_kld_loss``,
  ``recon_loss`` and these three are averaged over the samples.
* ``use_kaldi_feat`` (the recipe sets it) feeds ``kaldi_feat``, the Kaldi
  pass's features, unnormalized; the normalizer is neither applied nor
  updated.
* The recognizer-output FC is ``phn_recog_out_fc``; checkpoints select on
  ``plvl_md.soft_F1``.

Draws: as MD_VAE's, with the VAE target's per-sample draws (``pi_gumbel``,
``vanilla_eps``, ``gumbel_g``, ``gmm_eps``, the ``decoder_dropout``
masks) repeated once a sample in the JAX package's RngStream order. A
name that repeats is replayed as a list: ``noise[name][i]`` is sample
i's (the decoder's masks, one a gap between layers, ``gaps`` a sample).
"""
from __future__ import annotations

from typing import Dict, List

import torch

from mlvae_tpu_torch.models.MD_VAE.model import MDVAE
from mlvae_tpu_torch.models.MD_VAE.model import SBModel as MDVAESBModel
from mlvae_tpu_torch.modules.fc_block import FCBlock
from mlvae_tpu_torch.nn import dist as D

SAMPLE_KEYS = ("pi_gumbel", "vanilla_eps", "gumbel_g", "gmm_eps")
ACC_KEYS = ("vae_kld_loss", "recon_loss", "rif_loss", "entropy_loss",
            "baseline_loss")


class MDVAESFL(MDVAE):
    PHN_FC_NAME = "phn_recog_out_fc"

    @staticmethod
    def _build_modules(h: Dict, kw: Dict) -> Dict[str, torch.nn.Module]:
        """MD_VAE's modules with the recognizer-output FC under its name
        here, then ``baseline_fc``, as the recipe's YAML orders them."""
        mods = MDVAE._build_modules(
            dict(h, phn_recog_fc_size=h["phn_recog_out_fc_size"]), kw)
        mods = {("phn_recog_out_fc" if k == "phn_recog_fc" else k): v
                for k, v in mods.items()}
        mods["baseline_fc"] = FCBlock(
            [h["rnn_hidden_size"], h["baseline_fc_size"],
             h["baseline_fc_size"], 1], **kw)
        return mods

    def n_samples(self, train: bool) -> int:
        return int(self.hparams["pi_mcmc_num"]) if train else 1

    def _sample_draws(self, B: int, T: int, train: bool) -> List:
        return super()._sample_draws(B, T, train) * self.n_samples(train)

    def _input_feats(self, batch, train: bool, epoch: int):
        if self.hparams.get("use_kaldi_feat", False) is True:
            return batch["kaldi_feat"]
        return super()._input_feats(batch, train, epoch)

    def _sample_noise(self, noise: Dict, i: int, n: int) -> Dict:
        """Sample i's draws of the per-sample names (see the module
        docstring); a name given once serves a single sample only."""
        out = {}
        for key in SAMPLE_KEYS:
            v = noise.get(key)
            if isinstance(v, list):
                v = v[i]
            elif v is not None and n > 1:
                raise ValueError(f"noise {key!r}: {n} samples need a list")
            out[key] = v
        masks = noise.get("decoder_dropout")
        if masks is not None:
            gaps = len(masks) // n
            if gaps * n != len(masks):
                raise ValueError(f"noise 'decoder_dropout': {len(masks)} "
                                 f"masks for {n} samples")
            out["decoder_dropout"] = masks[i * gaps:(i + 1) * gaps]
        return out

    def _vae_branch(self, preds, feats, vae_in, batch, noise, generator,
                    train):
        h = self.hparams
        rnn_out = self._pi_branch(preds, vae_in, noise, generator, train)
        pi_logits = preds["pi_logits"]
        flvl = self._decode_into(preds, batch).to(feats.dtype)
        pi_nll = -D.categorical_ll_onehot(
            pi_logits, torch.stack([1 - flvl, flvl], dim=-1))
        preds["losses"]["pi_nll_loss"] = pi_nll

        n = self.n_samples(train)
        baseline = self.baseline_fc(rnn_out).squeeze(-1)   # (B, T)
        acc = {}
        for i in range(n):
            s_noise = self._sample_noise(noise, i, n)
            if train:
                sampled = D.categorical_sample(
                    pi_logits, g=s_noise["pi_gumbel"], generator=generator)
            else:
                sampled = torch.argmax(pi_logits, dim=-1)
            sampled = sampled.to(feats.dtype)
            sampled_pi = torch.stack([1 - sampled, sampled], dim=2)
            preds["sampled_pi"] = sampled_pi

            enc = self.encoder(rnn_out, sampled_pi, noise=s_noise,
                               generator=generator)
            dec_out = self.decoder(enc["sampled_h"], feats, train=train,
                                   generator=generator,
                                   masks=s_noise.get("decoder_dropout"))
            kld = enc["losses"]["vae_kld_loss"]
            recon = dec_out["losses"]["recon_loss"]
            nll = -D.categorical_ll_onehot(pi_logits, sampled_pi)
            reward = -(h["recon_weight"] * recon.mean(dim=-1).detach()
                       + h["vae_kld_weight"] * kld.mean(dim=-1).detach()
                       + h["pi_nll_weight"] * pi_nll.detach())   # (B, T)
            terms = {"vae_kld_loss": kld, "recon_loss": recon,
                     "rif_loss": (reward - baseline.detach()) * nll,
                     "entropy_loss": -D.categorical_entropy(pi_logits),
                     "baseline_loss": (baseline - reward).square()}
            for k in ACC_KEYS:
                acc[k] = terms[k] if i == 0 else acc[k] + terms[k]
        for k in ACC_KEYS:
            preds["losses"][k] = acc[k] / n


class SBModel(MDVAESFL, MDVAESBModel):
    """MD_VAE_sfl as ``cli.train`` / ``cli.test`` / ``cli.infer`` build it:
    ``MDVAESFL``'s step with MD_VAE's stage hooks, host-side evaluation
    and saved MD results."""
