"""What the w2v_* recipes share (counterpart of
``mlvae_tpu/models/w2v_common.py``): ``W2VMixin``.

* ``_match_len`` pads with zeros or crops the wav2vec2 frame axis to the
  fbank frame count (padded frames are masked downstream by the relative
  lengths).
* ``_w2v_feats``: the trunk on ``wav`` with the step's draws, inside
  every train and eval step. A frozen trunk (``freeze: True``) runs under
  ``no_grad`` and without dropout there. The JAX package's frozen-trunk
  feature cache (``augment_device_batch``) is not ported: it pays off
  only across epochs through the JAX Brain's device-batch cache, which
  the port's Brain does not have (``cache_device_batches``), so the port
  computes what the JAX package computes with ``MLVAE_W2V_FROZEN_CACHE=0``.
* ``step_draws``: the trunk's draws (a fine-tuned trunk's dropout, at
  the wave batch's frame count) before the recipe's own.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F


class W2VMixin:
    @staticmethod
    def _match_len(w2v: torch.Tensor, T: int) -> torch.Tensor:
        diff = T - w2v.shape[1]
        if diff > 0:
            return F.pad(w2v, (0, 0, 0, diff))
        return w2v[:, :T] if diff < 0 else w2v

    def _w2v_feats(self, batch: Dict, noise, generator, train: bool
                   ) -> torch.Tensor:
        w2v = self.wav2vec2(batch["wav"][0], train=train,
                            generator=generator, noise=noise)
        return self._match_len(w2v, batch["feat"][0].shape[1])

    def step_draws(self, dev_batch: Dict, train: bool) -> List:
        B, n = dev_batch["wav"][0].shape[:2]
        trunk = self.wav2vec2.draws(
            B, self.wav2vec2.conv_output_length(n), train)
        return trunk + super().step_draws(dev_batch, train)
