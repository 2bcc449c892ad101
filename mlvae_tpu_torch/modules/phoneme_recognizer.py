"""Frame-level phoneme recognizer (counterpart of
``mlvae_tpu/modules/phoneme_recognizer.py``): LSTM + FC -> per-frame
logits over ``n_phonemes + 2`` classes, and a masked BCE-with-logits
against the canonical phoneme active at each frame. The canonical sequence
is expanded by the forced-alignment durations with one gather:
``phoneme_index[t] = cumsum(boundary)[t] - 1``."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mlvae_tpu_torch.modules.fc_block import FCBlock
from mlvae_tpu_torch.nn import dist as D
from mlvae_tpu_torch.nn.rnn import LSTM
from mlvae_tpu_torch.utils.tensor import (boundary_to_phoneme_index,
                                          length_mask)


class PhonemeRecognizer(nn.Module):
    def __init__(self, input_size: int, rnn_hidden_size: int,
                 rnn_num_layers: int, fc_sizes: Sequence[int],
                 n_phonemes: int, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.n_phonemes = int(n_phonemes)
        self.rnn = LSTM(input_size, rnn_hidden_size, rnn_num_layers,
                        generator=generator, device=device)
        self.fc = FCBlock(fc_sizes, generator=generator, device=device)

    def forward(self, feats, feat_lens, plvl_cnnl_phn_seqs, boundary_seqs,
                train: bool = False,
                generator: Optional[torch.Generator] = None):
        rnn_out, _ = self.rnn(feats, train=train, generator=generator)
        out = self.fc(rnn_out)  # (B, T, N)
        B, T, N = out.shape
        L = plvl_cnnl_phn_seqs.shape[1]
        phn_idx = torch.clamp(boundary_to_phoneme_index(boundary_seqs),
                              max=L - 1)
        flvl_phn = torch.gather(plvl_cnnl_phn_seqs.long(), 1, phn_idx.long())
        y = F.one_hot(flvl_phn, self.n_phonemes + 2).to(out.dtype)
        loss = D.bce_with_logits(out, y)
        mask = length_mask(feat_lens, T, dtype=out.dtype)[..., None]
        return {"out": out, "losses": {"phn_recog_bce_loss": loss * mask}}
