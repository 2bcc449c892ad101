"""Multi-level VAE with grouped latents (counterpart of
``mlvae_tpu/modules/grouped_vae.py``): a frame-level latent per time step
and an utterance-level latent from a length-masked mean-pool of the trunk,
decoded from [frame ; broadcast utterance]. ``group_elbo`` counts the
utterance KLD once per utterance and masks the frame sums."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from mlvae_tpu_torch.modules.fc_block import FCBlock
from mlvae_tpu_torch.nn import dist as D
from mlvae_tpu_torch.nn.layers import Linear
from mlvae_tpu_torch.utils.tensor import length_mask


class GroupedLatentVAE(nn.Module):
    def __init__(self, fc_sizes: Sequence[int], frame_latent_size: int,
                 utt_latent_size: int, dec_fc_sizes: Sequence[int],
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        trunk_out = int(fc_sizes[-1])
        kw = dict(generator=generator, device=device)
        self.trunk = FCBlock(fc_sizes, end_activation=True, **kw)
        self.frame_mean_fc = Linear(trunk_out, frame_latent_size, **kw)
        self.frame_log_var_fc = Linear(trunk_out, frame_latent_size, **kw)
        self.utt_mean_fc = Linear(trunk_out, utt_latent_size, **kw)
        self.utt_log_var_fc = Linear(trunk_out, utt_latent_size, **kw)
        self.dec = FCBlock([frame_latent_size + utt_latent_size]
                           + [int(s) for s in dec_fc_sizes], **kw)

    def forward(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                eps_frame: Optional[torch.Tensor] = None,
                eps_utt: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """feats (B, T, C); feat_lens relative lengths (B,); the two draws
        in the JAX module's order (frame, then utterance)."""
        h = self.trunk(feats)  # (B, T, D)
        f_mean = self.frame_mean_fc(h)
        f_log_var = self.frame_log_var_fc(h)
        z_frame = D.reparameterize(f_mean, f_log_var, eps=eps_frame,
                                   generator=generator)
        mask = length_mask(feat_lens, h.shape[1], h.dtype)  # (B, T)
        denom = torch.clamp(mask.sum(1, keepdim=True), min=1.0)
        pooled = (h * mask[..., None]).sum(1) / denom
        u_mean = self.utt_mean_fc(pooled)
        u_log_var = self.utt_log_var_fc(pooled)
        z_utt = D.reparameterize(u_mean, u_log_var, eps=eps_utt,
                                 generator=generator)
        T = feats.shape[1]
        z = torch.cat([z_frame, z_utt[:, None, :].expand(
            z_utt.shape[0], T, z_utt.shape[-1])], dim=-1)
        recon = self.dec(z)
        return {
            "frame_mean": f_mean,
            "frame_log_var": f_log_var,
            "utt_mean": u_mean,
            "utt_log_var": u_log_var,
            "sampled_frame_h": z_frame,
            "sampled_utt_h": z_utt,
            "recon": recon,
            "frame_kld_loss": D.kld_std_normal(f_mean, f_log_var),
            "utt_kld_loss": D.kld_std_normal(u_mean, u_log_var),
            "recon_loss": (recon - feats) ** 2,
        }


def group_elbo(outputs, feats: torch.Tensor, feat_lens: torch.Tensor,
               kld_weight: float = 1.0) -> torch.Tensor:
    """Negative group-ELBO per utterance, averaged over the batch."""
    mask = length_mask(feat_lens, feats.shape[1], feats.dtype)  # (B, T)
    recon = (outputs["recon_loss"].sum(-1) * mask).sum(-1)
    f_kld = (outputs["frame_kld_loss"].sum(-1) * mask).sum(-1)
    u_kld = outputs["utt_kld_loss"].sum(-1)
    return (recon + kld_weight * (f_kld + u_kld)).mean()
