"""Convolutional VAE over spectrogram patches (counterpart of
``mlvae_tpu/modules/conv_vae.py``): stride-2 SAME convolutions down, a
flattened (NHWC order) latent head, and nearest-neighbour 2x upsampling
plus convolutions back up. Per-element losses; the caller reduces."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from mlvae_tpu_torch.nn import dist as D
from mlvae_tpu_torch.nn.conv import Conv2d
from mlvae_tpu_torch.nn.layers import Linear, leaky_relu


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of NHWC spatial dims."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class ConvVAE(nn.Module):
    """``patch_shape`` (H, W) must be divisible by ``2**len(channels)``;
    ``channels`` lists the encoder's feature maps per stride-2 stage, and
    the decoder mirrors them."""

    def __init__(self, patch_shape: Sequence[int], latent_size: int,
                 channels: Sequence[int] = (32, 64), kernel_size: int = 3,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.patch_shape = tuple(int(s) for s in patch_shape)
        self.channels = [int(c) for c in channels]
        H, W = self.patch_shape
        n = len(self.channels)
        if H % (2 ** n) or W % (2 ** n):
            raise ValueError(
                f"patch_shape {self.patch_shape} not divisible by 2^{n}")
        self.bottom = (H // 2 ** n, W // 2 ** n, self.channels[-1])
        flat = self.bottom[0] * self.bottom[1] * self.bottom[2]
        kw = dict(generator=generator, device=device)
        k = int(kernel_size)
        in_c = 1
        for i, c in enumerate(self.channels):
            self.add_module(f"enc{i}", Conv2d(in_c, c, k, stride=2, **kw))
            in_c = c
        self.mean_fc = Linear(flat, latent_size, **kw)
        self.log_var_fc = Linear(flat, latent_size, **kw)
        self.dec_in = Linear(latent_size, flat, **kw)
        rev = list(reversed(self.channels))
        for i in range(n):
            out_c = rev[i + 1] if i + 1 < n else rev[-1]
            self.add_module(f"dec{i}", Conv2d(rev[i], out_c, k, **kw))
        self.dec_out = Conv2d(rev[-1], 1, k, **kw)

    def encode(self, patches: torch.Tensor):
        x = patches[..., None]  # (B, H, W, 1)
        for i in range(len(self.channels)):
            x = leaky_relu(getattr(self, f"enc{i}")(x))
        flat = x.reshape(x.shape[0], -1)
        return self.mean_fc(flat), self.log_var_fc(flat)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        x = leaky_relu(self.dec_in(z)).reshape((z.shape[0],) + self.bottom)
        for i in range(len(self.channels)):
            x = leaky_relu(getattr(self, f"dec{i}")(_upsample2x(x)))
        return self.dec_out(x)[..., 0]  # (B, H, W)

    def forward(self, patches: torch.Tensor,
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        mean, log_var = self.encode(patches)
        sampled_h = D.reparameterize(mean, log_var, eps=eps,
                                     generator=generator)
        recon = self.decode(sampled_h)
        return {
            "mean": mean,
            "log_var": log_var,
            "sampled_h": sampled_h,
            "recon": recon,
            "loss": D.kld_std_normal(mean, log_var),
            "recon_loss": (recon - patches) ** 2,
        }
