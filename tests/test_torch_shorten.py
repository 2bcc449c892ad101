"""The port's shorten decoder (``mlvae_tpu_torch/data/shorten.py``) against
the JAX package's, on streams written by ``tests/test_shorten.py``'s
spec-mirror encoder: every predictor (DIFF0-3, QLPC, ZERO), running means,
bitshift and blocksize changes, verbatim chunks, stereo interleaving and
the u-law file type, each bit-equal; corrupt streams raise the same
exception type; and ``read_wav`` of an embedded-shorten SPHERE (the LDC
TIMIT container; PCM and u-law, mono and stereo, cut to the header's
sample count) equal to the JAX reader's."""
import numpy as np
import pytest

from mlvae_tpu.data import shorten as jshn
from mlvae_tpu.data import wav as jwav

from mlvae_tpu_torch.data import shorten as pshn
from mlvae_tpu_torch.data import wav as pwav
from test_shorten import (FN_DIFF0, FN_DIFF1, FN_DIFF2, FN_DIFF3, FN_ZERO,
                          TYPE_S16LH, TYPE_ULAW, _Encoder, _wave)

B = 48


def _all_predictors(nmean):
    y = _wave(7 * B, seed=21) + (5000 if nmean else 0)
    enc = _Encoder(TYPE_S16LH, nchan=1, blocksize=B, nmean=nmean)
    enc.verbatim(b"NIST header bytes stored verbatim")
    for i, fn in enumerate((FN_DIFF0, FN_DIFF1, FN_DIFF2, FN_DIFF3)):
        enc.block(0, fn, y[i * B:(i + 1) * B])
    enc.qlpc_block(0, [40, -12, 3], y[4 * B:5 * B])
    enc.qlpc_block(0, [55, -21], y[5 * B:6 * B])
    enc.block(0, FN_DIFF0, y[6 * B:7 * B])
    return enc.finish()


def _bitshift_blocksize_zero():
    y = (_wave(3 * B, seed=22) & ~3).astype(np.int64)
    enc = _Encoder(TYPE_S16LH, nchan=1, blocksize=B, nmean=2)
    enc.set_bitshift(2)
    enc.block(0, FN_DIFF1, y[:B] >> 2)
    enc.block(0, FN_DIFF2, y[B:2 * B] >> 2)
    enc.set_blocksize(24)
    enc.block(0, FN_ZERO, np.zeros(24))
    enc.block(0, FN_DIFF0, y[2 * B:2 * B + 24] >> 2)
    enc.set_bitshift(0)
    enc.block(0, FN_DIFF3, y[2 * B + 24:3 * B])
    return enc.finish()


def _stereo():
    left, right = _wave(2 * B, seed=23), _wave(2 * B, seed=24) // 2
    enc = _Encoder(TYPE_S16LH, nchan=2, blocksize=B, nmean=2)
    enc.block(0, FN_DIFF1, left[:B])
    enc.block(1, FN_DIFF2, right[:B])
    enc.block(0, FN_DIFF3, left[B:])
    enc.qlpc_block(1, [30, -5], right[B:])
    return enc.finish()


def _ulaw():
    codes = np.random.RandomState(25).randint(0, 256, 2 * B)
    enc = _Encoder(TYPE_ULAW, nchan=1, blocksize=B)
    enc.block(0, FN_DIFF1, codes[:B])
    enc.block(0, FN_DIFF0, codes[B:])
    return enc.finish()


STREAMS = {
    "predictors": lambda: _all_predictors(0),
    "predictors_running_mean": lambda: _all_predictors(4),
    "bitshift_blocksize_zero": _bitshift_blocksize_zero,
    "stereo": _stereo,
    "ulaw": _ulaw,
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_decode_shorten_bit_equal(name):
    payload = STREAMS[name]()
    got, gtype, gchan = pshn.decode_shorten(payload)
    want, wtype, wchan = jshn.decode_shorten(payload)
    assert (gtype, gchan) == (wtype, wchan)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if name == "ulaw":
        lin = pshn.ulaw_to_linear(got[:, 0])
        assert lin.dtype == np.int16
        np.testing.assert_array_equal(lin, jshn.ulaw_to_linear(want[:, 0]))


def test_ulaw_to_linear_every_code():
    codes = np.arange(256)
    np.testing.assert_array_equal(pshn.ulaw_to_linear(codes),
                                  jshn.ulaw_to_linear(codes))


@pytest.mark.parametrize("payload", [
    b"ajkg\x02\x00\x00\x00\x00",        # the header runs out
    b"nope" + bytes(16),                # no magic
    b"ajkg\x07" + bytes(16),            # an unknown version
    b"ajkg\x02" + b"\x00" * 3,          # no one bit at all
])
def test_corrupt_streams_raise_as_jax(payload):
    with pytest.raises(ValueError) as want:
        jshn.decode_shorten(payload)
    with pytest.raises(ValueError) as got:
        pshn.decode_shorten(payload)
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


def _sphere(path, payload, count, coding, channels=1):
    head = (f"NIST_1A\n   1024\nsample_rate -i 16000\n"
            f"channel_count -i {channels}\nsample_n_bytes -i 2\n"
            f"sample_count -i {count}\nsample_coding -s{len(coding)} "
            f"{coding}\nsample_byte_format -s2 01\nend_head\n").encode()
    path.write_bytes(head + b" " * (1024 - len(head)) + payload)


@pytest.mark.parametrize("name,count,coding", [
    ("predictors", 7 * B, "pcm,embedded-shorten-v2.00"),
    ("predictors_running_mean", 7 * B - 13, "pcm,embedded-shorten-v2.00"),
    ("stereo", 2 * B, "pcm,embedded-shorten-v2.00"),
    ("ulaw", 2 * B, "ulaw,embedded-shorten-v2.00"),
])
def test_read_shorten_sphere_equal_to_jax(tmp_path, name, count, coding):
    path = tmp_path / "utt.WAV"
    _sphere(path, STREAMS[name](), count, coding,
            channels=2 if name == "stereo" else 1)
    got, sr = pwav.read_wav(path)
    want, want_sr = jwav.read_wav(path)
    assert sr == want_sr == 16000 and got.dtype == want.dtype == np.float32
    assert len(got) == count
    np.testing.assert_array_equal(got, want)
