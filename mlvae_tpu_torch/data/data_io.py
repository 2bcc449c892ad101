"""The Kaldi-compatible feature pass over a data set (counterpart of
``mlvae_tpu/data/data_io.py``'s ``compute_kaldi_features``).

It takes the place of the reference's four Kaldi subprocesses
(``compute-fbank-feats``, ``add-deltas``, ``compute-cmvn-stats``,
``apply-cmvn --norm-vars=true``): ``KaldiFbank`` (K6 in its Kaldi mode on
the card) and per-speaker CMVN. The JAX package's native C++ branch is not
ported: the port's extractor is K6. The rest of the data path (datasets,
annotations, the SpeechBrain feature cache) waits in ROADMAP queue 1
item 5.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from mlvae_tpu_torch.data.wav import read_wav, resample
from mlvae_tpu_torch.device import resolve_device
from mlvae_tpu_torch.ops import frontend_ref
from mlvae_tpu_torch.ops.fbank import KaldiFbank, kaldi_frame_counts


def int16_batch(waves: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Waves in [-1, 1] as Kaldi takes them, int16-scale, zero-padded to
    the longest: ((B, longest) float32, (B,) int64 lengths)."""
    lengths = np.array([len(w) for w in waves], np.int64)
    batch = np.zeros((len(waves), int(lengths.max())), np.float32)
    for i, wav in enumerate(waves):
        batch[i, :len(wav)] = wav * 32768.0
    return batch, lengths


def compute_kaldi_features(hparams, set_name: str, device=None,
                           batch_size: int = 256) -> Dict[str, np.ndarray]:
    """Fbank + deltas per utterance of ``kaldi_data/{set_name}.wav.scp``,
    then CMVN with ``norm_vars`` per speaker of ``{set_name}.utt2spk``.
    ``hparams`` is a plain dict with ``prepare.dataset_dir`` (whose parent
    holds ``kaldi_data/``) and ``kaldi_feature_params`` (sample_rate,
    hop_length, n_fft, n_mels). The utterances go to the extractor
    ``batch_size`` at a time in the list's order, each framed at its own
    length, with one K6 launch and one copy back per batch on ``device``
    (None means CUDA); each utterance's features are those of a call on it
    alone. Returns utterance id -> (T, 3 n_mels) float32."""
    device = resolve_device(device)
    dataset_dir = Path(hparams["prepare"]["dataset_dir"]).parent
    kaldi_dir = dataset_dir / "kaldi_data"
    fp = hparams["kaldi_feature_params"]
    extractor = KaldiFbank(
        sample_rate=fp["sample_rate"], hop_length=fp["hop_length"],
        n_fft=fp["n_fft"], n_mels=fp["n_mels"], device=device,
    )

    utt2spk: Dict[str, str] = {}
    with open(kaldi_dir / f"{set_name}.utt2spk") as f:
        for line in f:
            utt_id, spk = line.split()
            utt2spk[utt_id] = spk
    wav_paths: Dict[str, str] = {}
    with open(kaldi_dir / f"{set_name}.wav.scp") as f:
        for line in f:
            utt_id, path = line.split(None, 1)
            wav_paths[utt_id] = path.strip()

    feats: Dict[str, np.ndarray] = {}
    items = list(wav_paths.items())
    for start in range(0, len(items), batch_size):
        chunk = items[start:start + batch_size]
        waves = []
        for _, path in chunk:
            wav, sr = read_wav(path)
            if sr != fp["sample_rate"]:
                wav = resample(wav, sr, fp["sample_rate"])
            waves.append(wav)
        batch, lengths = int16_batch(waves)
        out = extractor(batch, lengths).cpu().numpy()
        n_frames = kaldi_frame_counts(lengths, extractor.shift)
        for i, (utt_id, _) in enumerate(chunk):
            feats[utt_id] = out[i, :n_frames[i]]

    # per-speaker sufficient statistics
    by_spk: Dict[str, List[str]] = {}
    for utt_id, spk in utt2spk.items():
        by_spk.setdefault(spk, []).append(utt_id)
    for spk, utt_ids in by_spk.items():
        total, sq, count = frontend_ref.cmvn_stats(
            [feats[u] for u in utt_ids])
        for u in utt_ids:
            feats[u] = frontend_ref.apply_cmvn(feats[u], total, sq, count)
    return feats
