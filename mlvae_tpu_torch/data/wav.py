"""WAV and NIST SPHERE reading, WAV writing and resampling, on the host.

The port's own copy of ``mlvae_tpu/data/wav.py``: RIFF WAV (8-, 16- and
32-bit PCM, channels averaged) through the standard library, NIST SPHERE
(the LDC TIMIT format) as raw PCM, mu-law or shorten-compressed
(``data/shorten.py``), and a windowed-sinc polyphase resampler in numpy.
"""
from __future__ import annotations

import wave
from pathlib import Path

import numpy as np


def _read_sphere(path) -> tuple[np.ndarray, int]:
    """NIST SPHERE reader (the LDC TIMIT distribution format, which the
    reference converted with sph2pipe, ``datasets/prepare_kaldi.py:36-42``):
    1024-byte ASCII header of 'name -type value' lines, then PCM/ulaw data,
    either raw or shorten-compressed ('embedded-shorten-v*', the actual LDC
    TIMIT encoding — decoded on the host by ``data/shorten.py``)."""
    with open(path, "rb") as f:
        magic = f.read(8)
        assert magic.startswith(b"NIST_1A")
        header_size = int(f.read(8).strip())
        header = f.read(header_size - 16).decode("ascii", "replace")
        fields = {}
        for line in header.splitlines():
            parts = line.split(None, 2)
            if len(parts) == 3 and parts[1].startswith("-"):
                fields[parts[0]] = parts[2]
        f.seek(header_size)
        raw = f.read()

    coding = fields.get("sample_coding", "pcm")
    sr = int(fields.get("sample_rate", 16000))
    ch = int(fields.get("channel_count", 1))
    nbytes = int(fields.get("sample_n_bytes", 2))
    if "shorten" in coding:
        from mlvae_tpu_torch.data.shorten import (ULAW_TYPES, decode_shorten,
                                                  ulaw_to_linear)
        samples, ftype, nchan = decode_shorten(raw)
        count = fields.get("sample_count")
        if count is not None:
            samples = samples[: int(count)]
        if ftype in ULAW_TYPES or coding.startswith(("ulaw", "mu-law")):
            data = ulaw_to_linear(samples).astype(np.float32) / 8192.0
        else:
            data = samples.astype(np.float32) / 32768.0
        if nchan > 1:
            data = data.mean(axis=1)
        else:
            data = data[:, 0]
        return data, sr
    if coding.startswith("ulaw") or coding.startswith("mu-law"):
        u = np.frombuffer(raw, np.uint8).astype(np.int16)
        u = ~u & 0xFF
        sign = (u >> 7) & 1
        exp = (u >> 4) & 7
        mant = u & 0xF
        mag = ((mant.astype(np.int32) << 1) + 33).astype(np.int32)
        mag = (mag << exp) - 33
        data = np.where(sign == 1, -mag, mag).astype(np.float32) / 8192.0
    elif nbytes == 2:
        dt = np.dtype(np.int16)
        fmt = fields.get("sample_byte_format", "01")
        if fmt == "10":  # big-endian
            dt = dt.newbyteorder(">")
        data = np.frombuffer(raw, dt).astype(np.float32) / 32768.0
    else:
        raise ValueError(f"{path}: unsupported SPHERE sample_n_bytes "
                         f"{nbytes} / coding {coding!r}")
    if ch > 1:
        data = data[: len(data) // ch * ch].reshape(-1, ch).mean(axis=1)
    return data, sr


def read_wav(path) -> tuple[np.ndarray, int]:
    """Returns (float32 waveform in [-1, 1], sample_rate).  Handles RIFF
    WAV (stdlib) and NIST SPHERE (LDC TIMIT)."""
    with open(path, "rb") as probe:
        if probe.read(7) == b"NIST_1A":
            return _read_sphere(path)
    with wave.open(str(path), "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        sw = w.getsampwidth()
        ch = w.getnchannels()
        raw = w.readframes(n)
    if sw == 2:
        data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif sw == 4:
        data = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif sw == 1:
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width: {sw}")
    if ch > 1:
        data = data.reshape(-1, ch).mean(axis=1)
    return data, sr


def write_wav(path, data: np.ndarray, sr: int = 16000):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    pcm = np.clip(np.asarray(data, np.float64) * 32767.0, -32768, 32767)
    pcm = pcm.astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def resample(data: np.ndarray, sr_in: int, sr_out: int,
             num_zeros: int = 16) -> np.ndarray:
    """Windowed-sinc polyphase resampler (sox-equivalent quality class)."""
    if sr_in == sr_out:
        return np.asarray(data, np.float32)
    from math import gcd
    g = gcd(sr_in, sr_out)
    up, down = sr_out // g, sr_in // g
    # upsample by zero-stuffing, low-pass, then decimate
    n_out = int(np.ceil(len(data) * up / down))
    cutoff = 0.95 * 0.5 / max(up, down)
    half = num_zeros * max(up, down)
    t = np.arange(-half, half + 1)
    lp = 2 * cutoff * np.sinc(2 * cutoff * t) * np.hanning(len(t))
    stuffed = np.zeros(len(data) * up)
    stuffed[::up] = data * up
    filtered = np.convolve(stuffed, lp, mode="same")
    return filtered[::down][:n_out].astype(np.float32)
