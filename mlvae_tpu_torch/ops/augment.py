"""Waveform augmentation (the port's own copy of
``mlvae_tpu/ops/augment.py``): the optional ``hparams['augmentation']``
hook of the reference's data pipeline (``utils/data_io.py:204-207``),
consumed by LSTM_FC's aug_feat path.

Host-side numpy, applied once at dataset-computation time (the computed
cache stores the augmented variants); the same seed draws the same
numbers as the JAX package's augmenter, so both give the same waves. The
augmented waves' features come from the SpeechBrain pass on the card.
"""
from __future__ import annotations

import numpy as np


class WaveAugment:
    """Speed perturbation + additive noise, deterministic per call order.

    YAML-visible, e.g.::

        augmentation: !new:mlvae_tpu_torch.ops.augment.WaveAugment
            speeds: [0.95, 1.05]
            noise_snr_db: 30

    (the JAX package's name for it resolves to this class as well).
    """

    def __init__(self, speeds=(0.95, 1.0, 1.05), noise_snr_db: float = 30.0,
                 seed: int = 917):
        self.speeds = list(speeds)
        self.noise_snr_db = float(noise_snr_db)
        self._rs = np.random.RandomState(seed)

    def _speed(self, wave: np.ndarray, factor: float) -> np.ndarray:
        if factor == 1.0:
            return wave
        n_out = int(round(len(wave) / factor))
        idx = np.linspace(0, len(wave) - 1, n_out)
        lo = np.floor(idx).astype(int)
        hi = np.minimum(lo + 1, len(wave) - 1)
        frac = idx - lo
        return ((1 - frac) * wave[lo] + frac * wave[hi]).astype(np.float32)

    def __call__(self, waves, lens=None):
        waves = np.atleast_2d(np.asarray(waves, np.float32))
        if lens is None:
            lens = np.full((waves.shape[0],), waves.shape[1], np.int64)
        lens = np.atleast_1d(np.asarray(lens, np.float64))
        if lens.size and float(lens.max()) <= 1.0:
            # SpeechBrain convention (the reference calls the augmenter
            # with torch.ones(B), data_io.py:206): RELATIVE lengths — a
            # plain int cast would truncate them to 0/1 samples
            lens = np.round(lens * waves.shape[1])
        lens = lens.astype(np.int64)
        out = []
        for wave, n in zip(waves, lens):
            n = int(n)
            speed = self.speeds[self._rs.randint(len(self.speeds))]
            aug = self._speed(wave[:n], speed)
            # pad/trim back to the original length so frame-level labels
            # stay aligned (the reference asserts matching feat lengths)
            if len(aug) < n:
                aug = np.pad(aug, (0, n - len(aug)))
            else:
                aug = aug[:n]
            # SNR calibrated over the true samples only; padding stays zero
            power = np.mean(aug ** 2) + 1e-12
            noise_power = power / (10 ** (self.noise_snr_db / 10))
            aug = aug + self._rs.randn(n).astype(np.float32) * \
                np.sqrt(noise_power)
            out.append(np.pad(aug, (0, waves.shape[1] - n)))
        return np.stack(out)
