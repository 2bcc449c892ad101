"""What the w2v_* recipes share (counterpart of
``mlvae_tpu/models/w2v_common.py``): ``W2VMixin``.

* ``_match_len`` pads with zeros or crops the wav2vec2 frame axis to the
  fbank frame count (padded frames are masked downstream by the relative
  lengths).
* ``_w2v_feats``: the trunk on ``wav`` with the step's draws, inside
  every train and eval step, or the batch's cached ``w2v_feat``. A frozen
  trunk (``freeze: True``) runs under ``no_grad`` and without dropout.
* The frozen-trunk feature cache: a frozen trunk gives a batch the same
  features every epoch, so ``augment_device_batch`` runs it once a cached
  batch, inside ``fit`` only (in a one-pass evaluation nothing comes
  back), and puts the length-matched features under ``w2v_feat`` in place
  of ``wav``. Under ``--bf16`` it casts as the AMP step does (the trunk's
  bf16 parameters, with the step's ``requires_grad``, on the bf16 waves,
  cuBLAS's bf16 sums in f32), so the cached features are those of the
  step, bit for bit; the VALID pass then
  reads them too (promoted to f32), as the JAX package's does.
  ``MLVAE_W2V_FROZEN_CACHE=0`` turns the cache off. A run on ranks
  computes the features in the step (the trunk's whole-tensor norms
  reduce over the data group there).
* ``step_draws``: the trunk's draws (a fine-tuned trunk's dropout, at
  the wave batch's frame count) before the recipe's own; none for a batch
  that carries its features.
"""
from __future__ import annotations

import os
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch.func import functional_call

from mlvae_tpu_torch.training.brain import cast_floats, f32_gemm_sums

W2V_FEAT_KEY = "w2v_feat"


class W2VMixin:
    @staticmethod
    def _match_len(w2v: torch.Tensor, T: int) -> torch.Tensor:
        diff = T - w2v.shape[1]
        if diff > 0:
            return F.pad(w2v, (0, 0, 0, diff))
        return w2v[:, :T] if diff < 0 else w2v

    def _w2v_feats(self, batch: Dict, noise, generator, train: bool
                   ) -> torch.Tensor:
        cached = batch.get(W2V_FEAT_KEY)
        if cached is not None:
            # a --bf16 run's features in its f32 VALID forward: promoted,
            # as the JAX package's mixed-dtype ops promote them
            return cached[0].to(next(self.wav2vec2.parameters()).dtype)
        w2v = self.wav2vec2(batch["wav"][0], train=train,
                            generator=generator, noise=noise)
        return self._match_len(w2v, batch["feat"][0].shape[1])

    def augment_device_batch(self, dev: Dict) -> Dict:
        dev = super().augment_device_batch(dev)
        enc = getattr(self, "wav2vec2", None)
        if (enc is None or not enc.freeze or not self._fitting
                or "wav" not in dev or "feat" not in dev
                or self.mesh.world > 1
                or os.environ.get("MLVAE_W2V_FROZEN_CACHE", "1").lower()
                in ("0", "false")):
            return dev
        wavs = dev["wav"][0]
        with torch.no_grad():
            if self.auto_mix_prec:
                # the AMP step's casts (Brain.train_step), with the step's
                # requires_grad: it steers torch.matmul between one GEMM
                # and a batched one, whose bf16 sums round apart
                params = {n: p.detach().to(torch.bfloat16).requires_grad_(
                    p.requires_grad) if p.is_floating_point() else p
                    for n, p in enc.named_parameters()}
                with f32_gemm_sums():
                    w2v = functional_call(
                        enc, params,
                        (cast_floats(wavs, torch.bfloat16, 2),),
                        dict(train=False))
            else:
                w2v = enc(wavs, train=False)
        out = dict(dev)
        # the fbank frames' relative lengths: the trunk's axis is
        # length-matched to them
        out[W2V_FEAT_KEY] = (self._match_len(w2v, dev["feat"][0].shape[1]),
                             dev["feat"][1])
        out.pop("wav")
        return out

    def step_draws(self, dev_batch: Dict, train: bool) -> List:
        if W2V_FEAT_KEY in dev_batch:
            trunk = []
        else:
            B, n = dev_batch["wav"][0].shape[:2]
            trunk = self.wav2vec2.draws(
                B, self.wav2vec2.conv_output_length(n), train)
        return trunk + super().step_draws(dev_batch, train)
