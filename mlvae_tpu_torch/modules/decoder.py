"""VAE decoder (counterpart of ``mlvae_tpu/modules/decoder.py``): latent ->
bidirectional LSTM -> Gaussian mean / log-var heads, with the per-element
Gaussian NLL (the recipe's ``loss_type="likelihood"``)."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from mlvae_tpu_torch.modules.fc_block import FCBlock
from mlvae_tpu_torch.nn import dist as D
from mlvae_tpu_torch.nn.rnn import LSTM


class Decoder(nn.Module):
    def __init__(self, input_size: int, rnn_hidden_size: int,
                 rnn_num_layers: int, rnn_dropout: float,
                 fc_sizes: Sequence[int],
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.rnn = LSTM(input_size, rnn_hidden_size, rnn_num_layers,
                        dropout=rnn_dropout, bidirectional=True, **kw)
        self.mean_fc = FCBlock(fc_sizes, **kw)
        self.log_var_fc = FCBlock(fc_sizes, **kw)

    def forward(self, sampled_h, target_feats, train: bool = False,
                generator: Optional[torch.Generator] = None,
                masks: Optional[Sequence[torch.Tensor]] = None):
        """``masks``: the LSTM's dropout keep-masks while training (see
        ``LSTM.dropout_shapes``), else drawn from ``generator``."""
        rnn_out, _ = self.rnn(sampled_h, train=train, generator=generator,
                              masks=masks)
        mean = self.mean_fc(rnn_out)
        log_var = self.log_var_fc(rnn_out)
        return {"mean": mean, "log_var": log_var,
                "losses": {"recon_loss": D.gaussian_nll(mean, log_var,
                                                        target_feats)}}
