"""Annotation -> frame-level labels, and the saved-MD-results cleaning
(the port's own copy of ``mlvae_tpu/data/annotations.py``). Host-side
numpy.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def generate_flvl_annotation(label_encoder, n_frames: int, duration: float,
                             segmentation: Sequence, phoneme_ids: np.ndarray
                             ) -> np.ndarray:
    """Paint per-segment phoneme ids onto a frame grid; silence elsewhere.

    Segment (start_sec, end_sec) maps to frames [start/duration*T,
    end/duration*T) — reference ``data_io_utils.py:15-53``.
    """
    T = int(n_frames)
    L = len(phoneme_ids)
    assert len(segmentation) == L
    out = np.full(T, label_encoder.encode_label("sil"), np.int64)
    for phoneme, (start, end) in zip(phoneme_ids, segmentation):
        a = int(start / duration * T)
        b = int(end / duration * T)
        out[a:b] = phoneme
    return out


def generate_boundary_seq(n_frames: int, duration: float,
                          segmentation: Sequence):
    """Binary start-frame indicators with collision bump-right, plus phoneme
    end positions in samples at 16 kHz — reference ``data_io_utils.py:56-96``.
    """
    T = int(n_frames)
    boundary = np.zeros(T, np.float32)
    boundary[0] = 1
    for start, _ in segmentation[1:]:
        idx = int(start / duration * T)
        while idx < T and boundary[idx] == 1:
            idx += 1
        if idx < T:
            boundary[idx] = 1
    phn_end = np.asarray(
        [int(end * 16000) for (_, end) in segmentation], np.float32
    )
    return boundary, phn_end


# -- saved-MD-results data cleaning (reference data_io_utils.py:230-314) -----

def _drop_indices(x, invalid: List[int]):
    invalid_set = set(invalid)
    keep = [i for i in range(len(x)) if i not in invalid_set]
    if isinstance(x, list):
        return [x[i] for i in keep]
    return np.asarray(x)[keep]


def apply_flvl_saved_md_results(x, saved_md_results):
    """Remove frame spans flagged as mispronounced (percent-addressed)."""
    invalid: List[int] = []
    for _, start_pct, end_pct in saved_md_results:
        a = round(start_pct * len(x))
        b = round(end_pct * len(x))
        invalid += list(range(a, b))
    return _drop_indices(x, invalid)


def apply_plvl_saved_md_results(x, saved_md_results):
    """Remove phoneme slots flagged as mispronounced (index-addressed)."""
    return _drop_indices(x, [idx for idx, _, _ in saved_md_results])


def flagged_frame_indices(boundary_seq, saved_md_results) -> List[int]:
    """Frame indices covered by the flagged phonemes' spans, where spans
    are delimited by the 1-markers of ``boundary_seq``.

    The boundary sequence can carry FEWER 1s than there are phonemes when
    ``generate_boundary_seq``'s bump-right collision rule pushed a start
    past the last frame (``annotations.py``); the reference indexes past
    the end and crashes there (``data_io_utils.py:301-303``) — we clamp
    the flagged span to the sequence tail instead."""
    x_arr = np.asarray(boundary_seq)
    idx_seq = np.where(x_arr == 1)[0].tolist() + [len(x_arr)]
    invalid: List[int] = []
    last = len(idx_seq) - 1
    for idx, _, _ in saved_md_results:
        start = idx_seq[min(idx, last)]
        end = idx_seq[min(idx + 1, last)]
        invalid += list(range(start, end))
    return invalid


def apply_frame_saved_md_results(x, invalid: List[int]):
    """Remove a precomputed invalid-frame set from a frame-length key."""
    return _drop_indices(x, invalid)


def apply_boundary_saved_md_results(x, saved_md_results):
    """Remove the frame span of each flagged phoneme from a boundary seq."""
    return _drop_indices(x, flagged_frame_indices(x, saved_md_results))


def clean_boundary_seq_remap(boundary_seq, saved_md_results,
                             invalid: List[int]):
    """Clean a boundary key against a SHARED invalid-frame set: drop the
    flagged phonemes' markers, then remap each surviving marker into the
    cleaned frame grid (``new = old - #dropped_frames_before_old``) with the
    same bump-right collision rule as ``generate_boundary_seq``.

    This keeps every cleaned boundary key the same length as the cleaned
    ``feat`` (so eval-time decoded boundaries and cleaned ground truth stay
    comparable) while its marker count tracks the cleaned phoneme count.
    When the key's own spans coincide with the invalid set (the
    ``fa_boundary_seq`` case) this is identical to dropping the invalid
    frames directly."""
    x = np.asarray(boundary_seq)
    pos = np.where(x == 1)[0]
    flagged = {idx for idx, _, _ in saved_md_results}
    keep = [int(p) for i, p in enumerate(pos) if i not in flagged]
    inv = np.asarray(sorted(set(invalid)), np.int64)
    T = len(x) - len(inv)
    out = np.zeros(T, x.dtype)
    for p in keep:
        # a marker inside a dropped span lands at the span's start slot
        q = p - int(np.searchsorted(inv, p, side="left"))
        while q < T and out[q] == 1:
            q += 1
        if q < T:
            out[q] = 1
    return out
