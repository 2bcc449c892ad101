"""Build the flagship MD_VAE model and synthetic batches without touching
the filesystem (counterpart of ``mlvae_tpu/bench_utils.py``).

The widths are the recipe's, copied from
``mlvae_tpu/models/MD_VAE/model.yaml``, with its Adam at ``lr``;
``overrides`` changes any of them (narrow widths for the CPU tests).
``synth_batch`` draws the same numpy values as the JAX package's
``synth_batch`` for the same arguments. ``synth_wave`` and
``synth_wav_batch`` make audio for the wav front end: tones plus noise, as
``tests/test_fbank_pallas.py`` makes them.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from mlvae_tpu_torch.device import resolve_device
from mlvae_tpu_torch.models.MD_VAE.model import MDVAE
from mlvae_tpu_torch.training.optim import Adam

N_PHONEMES = 12          # digits task (smoke-test scale)
N_CLASSES = N_PHONEMES + 2
INPUT_SIZE = 120         # 40 mel x 3 (static + delta + delta2)
SAMPLE_RATE = 16000      # the recipe's front end (config/run.yaml)
HOP = 320                # 20 ms

RECIPE = {
    "input_size": INPUT_SIZE,
    "n_phonemes": N_PHONEMES,
    "feat_fc_size": 64,
    "phn_rnn_hidden_size": 512,
    "phn_rnn_num_layers": 2,
    "phn_fc_size": 128,
    "phn_recog_fc_size": 32,
    "boundary_rnn_hidden_size": 512,
    "boundary_rnn_num_layers": 2,
    "boundary_fc_size": 128,
    "concat_fc_size": 128,
    "rnn_hidden_size": 512,
    "rnn_num_layers": 2,
    "rnn_dropout": 0.15,
    "pi_fc_size": 128,
    "latent_size": 32,
    "num_components": 3,
    "enc_fc_size": 64,
    "dec_rnn_hidden_size": 512,
    "dec_rnn_num_layers": 2,
    "dec_rnn_dropout": 0.15,
    "dec_fc_size": 64,
    # loss weights: the yaml's three, and 1.0 for the ones it defaults
    "boundary_kld_weight": 0.00001,
    "vae_kld_weight": 0.00001,
    "pi_nll_weight": 0.001,
    "phn_recog_bce_weight": 1.0,
    "boundary_bce_weight": 1.0,
    "recon_weight": 1.0,
    "kld_n_samples": 2249,
    "lr": 0.001,
}


def build_md_vae(batch_size: int = 8, overrides=None, seed: int = 0,
                 device=None, bf16: bool = False) -> MDVAE:
    """MD_VAE at the recipe's widths with weights drawn from ``seed`` on
    ``device`` (None means CUDA), its optimizer states initialised.
    ``bf16`` turns AMP on for the training step, as the JAX bench's
    default ``--bf16`` does (``bench.py``); the eval step stays f32."""
    dev = resolve_device(device)
    hparams = dict(RECIPE, batch_size=batch_size)
    hparams.update(overrides or {})
    hparams.setdefault("optimizer", Adam(lr=hparams["lr"]))
    gen = torch.Generator(device="cpu").manual_seed(seed)
    model = MDVAE(hparams, generator=gen, run_opts={"bf16": bf16}).to(
        dev).eval()
    model.init_optimizers()
    return model


def synth_batch(batch_size: int = 8, T: int = 160, L: int = 8,
                seed: int = 0, device=None) -> Dict[str, Tuple]:
    """Synthetic batch with the MD_VAE input contract, on ``device``."""
    dev = resolve_device(device)
    rs = np.random.RandomState(seed)
    feats = rs.randn(batch_size, T, INPUT_SIZE).astype(np.float32)
    feat_lens = np.linspace(1.0, 0.8, batch_size).astype(np.float32)
    cnncl = rs.randint(2, N_PHONEMES, (batch_size, L)).astype(np.int64)
    cnncl_lens = np.full((batch_size,), 1.0, np.float32)
    boundary = np.zeros((batch_size, T), np.float32)
    t_lens = np.round(feat_lens * T).astype(int)
    for i in range(batch_size):
        starts = np.sort(rs.choice(np.arange(1, t_lens[i]), L - 1,
                                   replace=False))
        boundary[i, 0] = 1
        boundary[i, starts] = 1
    prior = rs.dirichlet(np.ones(N_CLASSES)).astype(np.float32)
    prior_b = np.tile(prior, (batch_size, 1))
    md = rs.randint(0, 2, (batch_size, L)).astype(np.int64)

    def t(a):
        return torch.from_numpy(a).to(dev)

    return {
        "feat": (t(feats), t(feat_lens)),
        "gt_cnncl_seq": (t(cnncl), t(cnncl_lens)),
        "fa_boundary_seq": (t(boundary), t(feat_lens)),
        "gt_boundary_seq": (t(boundary), t(feat_lens)),
        "plvl_gt_md_lbl_seq": (t(md), t(cnncl_lens)),
        "prior": (t(prior_b), t(cnncl_lens)),
    }


def synth_wave(n: int, seed: int = 0, scale: float = 8000.0,
               am_hz: float = 0.0) -> np.ndarray:
    """(n,) float32 audio: 220 Hz and 1330 Hz tones at ``scale`` plus
    Gaussian noise at ``scale / 80``; the default is int16-scale (noise of
    100, as ``tests/test_fbank_pallas.py``), ``scale / 32768`` gives
    read_wav's [-1, 1]. ``am_hz`` > 0 modulates the whole by an envelope
    from 0.2 to 1.2 at that rate, so that every band's energy moves from
    frame to frame as in speech (a steady tone leaves a band's per-speaker
    deviation near zero, and CMVN then divides by it)."""
    rs = np.random.RandomState(seed)
    t = np.arange(n) / float(SAMPLE_RATE)
    sig = np.sin(2 * np.pi * 220 * t) + 0.3 * np.sin(2 * np.pi * 1330 * t)
    wave = scale * sig + (scale / 80.0) * rs.randn(n)
    if am_hz > 0:
        wave = wave * (0.2 + np.abs(np.sin(2 * np.pi * am_hz * t)))
    return wave.astype(np.float32)


def synth_wav_batch(batch_size: int = 64, T: int = 160, seed: int = 0,
                    device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Waves in [-1, 1], (B, (T-1)*HOP), on ``device``, and their lengths
    (B,) on the host, as a caller knows them from the files: wave i has the
    frame count ``synth_batch`` gives row i (T for the first), so that
    ``Fbank(deltas=True)`` of the batch is the ``feat`` of
    ``synth_batch(batch_size, T, ...)``."""
    dev = resolve_device(device)
    t_lens = np.round(np.linspace(1.0, 0.8, batch_size) * T).astype(int)
    lengths = (t_lens - 1) * HOP
    waves = np.zeros((batch_size, (T - 1) * HOP), np.float32)
    for i, n in enumerate(lengths):
        waves[i, :n] = synth_wave(int(n), seed + i) / 32768.0
    return (torch.from_numpy(waves).to(dev),
            torch.from_numpy(lengths.astype(np.int64)))
