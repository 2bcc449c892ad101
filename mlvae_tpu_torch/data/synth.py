"""Synthetic SynAudioMNIST-style corpus generator (the port's own copy of
``mlvae_tpu/data/synth.py``; from the same seed it writes the same wav
bytes and JSON).

The corpus has the SynAudioMNIST annotation schema: per-speaker
``{spk}_meta.json`` with ``canonical_digit_seq`` / ``pronounced_digit_seq``
/ ``segment_seq`` / ``duration`` plus WAV files, and a
``forced_alignment_segmentation.json``. Each digit renders as a distinct
two-tone chirp (per-speaker pitch offset); a mispronunciation renders a
different digit than the canonical one, so the MD task has real signal.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple, Union

import numpy as np

from mlvae_tpu_torch.data.wav import write_wav
from mlvae_tpu_torch.utils.phonemes import DIGITS

SR = 16000
_N_DIGITS = 10


def _digit_tone(digit: int, n: int, pitch_mult: float, rs) -> np.ndarray:
    t = np.arange(n) / SR
    f0 = 180.0 + 55.0 * digit
    f1 = 2.2 * f0
    env = np.minimum(1.0, np.minimum(np.arange(n), n - np.arange(n)) / (0.01 * SR))
    sig = (
        0.5 * np.sin(2 * np.pi * f0 * pitch_mult * t)
        + 0.25 * np.sin(2 * np.pi * f1 * pitch_mult * t)
    )
    return (sig * env + 0.01 * rs.randn(n)).astype(np.float32)


def generate_corpus(
    root,
    n_speakers: int = 4,
    utts_per_speaker: int = 6,
    digits_per_utt: Union[int, Tuple[int, int]] = 4,
    misp_prob: float = 0.25,
    seed: int = 1234,
) -> Path:
    """Write a synthetic corpus under ``root/original_dataset``; returns root.

    ``digits_per_utt`` may be a range ``(lo, hi)``: each utterance then
    draws its digit count from it first, so that utterances, and the
    padded shapes of their batches, differ in length. An int keeps the
    JAX package's bytes."""
    root = Path(root)
    ds_dir = root / "original_dataset"
    rs = np.random.RandomState(seed)
    fa_segmentation: Dict[str, List] = {}

    for s in range(n_speakers):
        spk = f"{s + 1:02d}"
        spk_dir = ds_dir / spk
        spk_dir.mkdir(parents=True, exist_ok=True)
        pitch = 0.9 + 0.07 * s
        meta = {}
        for u in range(utts_per_speaker):
            utt_id = f"{spk}_{u:03d}"
            n_digits = digits_per_utt
            if not isinstance(n_digits, int):
                n_digits = int(rs.randint(n_digits[0], n_digits[1] + 1))
            canonical = rs.randint(0, _N_DIGITS, n_digits)
            pronounced = canonical.copy()
            for i in range(n_digits):
                if rs.rand() < misp_prob:
                    choices = [d for d in range(_N_DIGITS) if d != canonical[i]]
                    pronounced[i] = rs.choice(choices)
            # render: leading/trailing silence + digit tones
            sil = int(0.05 * SR)
            seg_lens = rs.randint(int(0.12 * SR), int(0.25 * SR),
                                  n_digits)
            pieces = [np.zeros(sil, np.float32)]
            segments = []
            fa_segments = []
            pos = sil
            for d, n in zip(pronounced, seg_lens):
                pieces.append(_digit_tone(int(d), int(n), pitch, rs))
                start_s, end_s = pos / SR, (pos + n) / SR
                segments.append([start_s, end_s])
                # imperfect forced alignment: jitter by up to 8 ms
                jit = rs.uniform(-0.008, 0.008, 2)
                fa_segments.append([
                    max(0.0, start_s + jit[0]), end_s + jit[1],
                ])
                pos += int(n)
            pieces.append(np.zeros(sil, np.float32))
            wavdata = np.concatenate(pieces)
            duration = len(wavdata) / SR
            fa_segments[-1][1] = min(fa_segments[-1][1], duration)
            write_wav(spk_dir / f"{utt_id}.wav", wavdata, SR)
            meta[utt_id] = {
                "duration": duration,
                "canonical_digit_seq": [DIGITS[d] for d in canonical],
                "pronounced_digit_seq": [DIGITS[d] for d in pronounced],
                "segment_seq": segments,
            }
            fa_segmentation[utt_id] = fa_segments
        with open(spk_dir / f"{spk}_meta.json", "w") as f:
            json.dump(meta, f, indent=2)

    with open(ds_dir / "forced_alignment_segmentation.json", "w") as f:
        json.dump(fa_segmentation, f)
    return root
