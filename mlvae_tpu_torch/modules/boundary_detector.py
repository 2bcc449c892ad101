"""Phoneme-boundary detector (counterpart of
``mlvae_tpu/modules/boundary_detector.py``): LSTM -> softplus alpha/beta
heads (+1e-5), ``SAMPLE_TIMES`` Kumaraswamy draws in one batched sample,
the per-draw BCE against the forced-alignment boundaries averaged over the
draws, and KL(Beta(alpha, beta) || Beta(1, 9))."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from mlvae_tpu_torch.modules.fc_block import FCBlock
from mlvae_tpu_torch.nn import dist as D
from mlvae_tpu_torch.nn.layers import softplus
from mlvae_tpu_torch.nn.rnn import LSTM


class BoundaryDetector(nn.Module):
    PRIOR_ALPHA = 1.0
    PRIOR_BETA = 9.0
    SAMPLE_TIMES = 10

    def __init__(self, input_size: int, rnn_hidden_size: int,
                 rnn_num_layers: int, fc_sizes: Sequence[int],
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.rnn = LSTM(input_size, rnn_hidden_size, rnn_num_layers,
                        generator=generator, device=device)
        self.fc_alpha = FCBlock(fc_sizes, generator=generator, device=device)
        self.fc_beta = FCBlock(fc_sizes, generator=generator, device=device)

    def forward(self, x, boundary_seqs, u: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                train: bool = False):
        """``u``: raw uniform noise (SAMPLE_TIMES, B, T), else drawn from
        ``generator``. The draw keeps its gradient path to alpha and beta."""
        rnn_out, _ = self.rnn(x, train=train, generator=generator)
        eps = 1e-5
        v_alpha = softplus(self.fc_alpha(rnn_out)).squeeze(-1) + eps
        v_beta = softplus(self.fc_beta(rnn_out)).squeeze(-1) + eps
        kld = D.kld_beta(v_alpha, v_beta, self.PRIOR_ALPHA, self.PRIOR_BETA)
        M = self.SAMPLE_TIMES
        v_m = D.kumaraswamy_sample(v_alpha.expand(M, *v_alpha.shape),
                                   v_beta.expand(M, *v_beta.shape),
                                   u=u, generator=generator)
        targets = boundary_seqs.to(v_m.dtype).expand(v_m.shape)
        return {
            "boundary_v": v_m.mean(dim=0),
            "losses": {
                "boundary_bce_loss": D.bce(v_m, targets).mean(dim=0),
                "boundary_kld_loss": kld,
            },
        }
