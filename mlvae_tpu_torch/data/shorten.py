"""Shorten ("ajkg") lossless audio decoder — host-side, pure numpy (the
port's own copy of ``mlvae_tpu/data/shorten.py``; its bit reader is
integer work on the host and never touches the card).

The LDC TIMIT distribution ships NIST SPHERE files whose waveform payload is
compressed with Tony Robinson's *shorten* codec (``sample_coding:
pcm,embedded-shorten-v2.00``).  The reference pipeline shells out to
``sph2pipe`` to undo this (reference ``datasets/prepare_kaldi.py:36-42``);
this module implements the decoder natively so ``cli.ingest`` and
``data/wav.py`` can read the actual LDC format with no external tool.

Format summary (independent re-implementation from the published format):

* magic ``ajkg`` + 1 version byte, then a bit stream consumed MSB-first.
* ``uvar(k)``: unary count of 0-bits terminated by a 1-bit, followed by
  ``k`` literal bits — value ``(unary << k) | literal`` (Rice code).
* ``var(k)``: ``uvar(k+1)`` with the LSB as sign: odd ``u`` decodes to
  ``-(u >> 1) - 1``, even to ``u >> 1`` (zig-zag).
* ``ulong``: ``n = uvar(2)`` then ``uvar(n)``.
* header: filetype, nchan, blocksize, maxnlpc, nmean, nskip (all ulong for
  version >= 1), then ``nskip`` bytes of ``uvar(7)``.
* commands ``uvar(2)``: DIFF0..DIFF3 / QLPC / ZERO emit one channel-block
  of samples (fixed polynomial or quantized-LPC prediction plus Rice-coded
  residuals); BLOCKSIZE / BITSHIFT / VERBATIM are housekeeping; QUIT ends.
* version >= 2 keeps a ``nmean``-deep running block-mean (``coffset``)
  that biases DIFF0/QLPC, stored left-shifted by the current bitshift.
"""
from __future__ import annotations

import numpy as np

MAGIC = b"ajkg"

# block commands
FN_DIFF0, FN_DIFF1, FN_DIFF2, FN_DIFF3 = 0, 1, 2, 3
FN_QUIT, FN_BLOCKSIZE, FN_BITSHIFT, FN_QLPC, FN_ZERO, FN_VERBATIM = (
    4, 5, 6, 7, 8, 9)
_SAMPLE_FNS = (FN_DIFF0, FN_DIFF1, FN_DIFF2, FN_DIFF3, FN_QLPC, FN_ZERO)

# literal-bit widths of the fixed-size fields
FNSIZE = 2
ENERGYSIZE = 3
BITSHIFTSIZE = 2
LPCQSIZE = 2
LPCQUANT = 5
XBYTESIZE = 7
ULONGSIZE = 2
VERBATIM_CKSIZE_SIZE = 5
VERBATIM_BYTE_SIZE = 8
NWRAP = 3

# internal file types
TYPE_AU1, TYPE_S8, TYPE_U8 = 0, 1, 2
TYPE_S16HL, TYPE_U16HL, TYPE_S16LH, TYPE_U16LH = 3, 4, 5, 6
TYPE_ULAW, TYPE_AU2, TYPE_AU3, TYPE_ALAW = 7, 8, 9, 10
ULAW_TYPES = (TYPE_AU1, TYPE_ULAW, TYPE_AU2)
UNSIGNED_MEAN = {TYPE_U8: 0x80, TYPE_U16HL: 0x8000, TYPE_U16LH: 0x8000}


class _BitReader:
    """MSB-first bit reader over the byte stream following the magic.

    The on-disk stream is organised as big-endian 32-bit words consumed
    from bit 31 down to bit 0, which is byte order 0,1,2,3 each MSB-first —
    i.e. exactly ``np.unpackbits`` order, so the word structure needs no
    special handling (beyond tolerating a partial final word)."""

    def __init__(self, data: bytes):
        self.bits = np.unpackbits(np.frombuffer(data, np.uint8))
        self.ones = np.flatnonzero(self.bits)
        self.pos = 0

    def uvar(self, k: int) -> int:
        i = np.searchsorted(self.ones, self.pos)
        if i >= len(self.ones):
            raise ValueError("shorten: bit stream exhausted mid-code")
        stop = int(self.ones[i])
        value = stop - self.pos  # unary run of 0s
        self.pos = stop + 1
        if k:
            if self.pos + k > len(self.bits):
                raise ValueError("shorten: bit stream exhausted mid-code")
            for b in self.bits[self.pos:self.pos + k]:
                value = (value << 1) | int(b)
            self.pos += k
        return value

    def var(self, k: int) -> int:
        u = self.uvar(k + 1)
        return -(u >> 1) - 1 if (u & 1) else (u >> 1)

    def ulong(self) -> int:
        return self.uvar(self.uvar(ULONGSIZE))

    def block(self, k: int, n: int) -> np.ndarray:
        """n consecutive var(k) residuals as int64."""
        out = np.empty(n, np.int64)
        for i in range(n):
            out[i] = self.var(k)
        return out


def _cdiv(a: int, b: int) -> int:
    """C-style integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def _rounded_shift_down(x: int, n: int) -> int:
    return x if n == 0 else ((x >> (n - 1)) + 1) >> 1


def decode_shorten(payload: bytes):
    """Decode a complete shorten stream.

    Returns ``(samples, ftype, nchan)`` where ``samples`` is an int32 array
    of shape (n_frames, nchan) holding the raw file-type-domain values
    (linear PCM for the S*/U* types, mu-law codes for the ULAW/AU types).
    """
    if payload[:4] != MAGIC:
        raise ValueError("not a shorten stream (missing 'ajkg' magic)")
    version = payload[4]
    if not 1 <= version <= 3:
        raise ValueError(f"unsupported shorten version {version}")
    r = _BitReader(payload[5:])

    ftype = r.ulong()
    nchan = r.ulong()
    blocksize = r.ulong()
    maxnlpc = r.ulong()
    nmean = r.ulong()
    nskip = r.ulong()
    for _ in range(nskip):
        r.uvar(XBYTESIZE)
    if nchan < 1 or blocksize < 1 or blocksize > 1 << 20:
        raise ValueError(
            f"shorten: implausible header (nchan={nchan}, "
            f"blocksize={blocksize})")
    if ftype == TYPE_ALAW or ftype == TYPE_AU3:
        raise ValueError(f"shorten: unsupported internal file type {ftype}")

    nwrap = max(NWRAP, maxnlpc)
    history = [np.zeros(nwrap, np.int64) for _ in range(nchan)]
    mean0 = UNSIGNED_MEAN.get(ftype, 0)
    offsets = [[mean0] * max(1, nmean) for _ in range(nchan)]
    out = [[] for _ in range(nchan)]
    bitshift = 0
    chan = 0

    lpcqoffset = (1 << LPCQUANT) if version >= 2 else 0

    while True:
        fn = r.uvar(FNSIZE)
        if fn == FN_QUIT:
            break
        if fn == FN_BLOCKSIZE:
            blocksize = r.ulong()
            if blocksize < 1 or blocksize > 1 << 20:
                raise ValueError(f"shorten: bad blocksize {blocksize}")
            continue
        if fn == FN_BITSHIFT:
            bitshift = r.uvar(BITSHIFTSIZE)
            continue
        if fn == FN_VERBATIM:
            # embedded non-audio bytes (e.g. an original file header) —
            # consumed and discarded
            for _ in range(r.uvar(VERBATIM_CKSIZE_SIZE)):
                r.uvar(VERBATIM_BYTE_SIZE)
            continue
        if fn not in _SAMPLE_FNS:
            raise ValueError(f"shorten: unknown command {fn}")

        if fn != FN_ZERO:
            resn = r.uvar(ENERGYSIZE)
            if version == 0:
                resn -= 1

        # running block-mean offset
        offs = offsets[chan]
        if nmean == 0:
            coffset = offs[0]
        else:
            s = (nmean // 2 if version >= 2 else 0) + sum(offs)
            coffset = (_rounded_shift_down(_cdiv(s, nmean), bitshift)
                       if version >= 2 else _cdiv(s, nmean))

        hist = history[chan]
        if fn == FN_ZERO:
            buf = np.zeros(blocksize, np.int64)
        elif fn == FN_DIFF0:
            buf = r.block(resn, blocksize) + coffset
        elif fn == FN_DIFF1:
            res = r.block(resn, blocksize)
            buf = np.empty(blocksize, np.int64)
            prev = hist[-1]
            for i in range(blocksize):
                prev = buf[i] = res[i] + prev
        elif fn == FN_DIFF2:
            res = r.block(resn, blocksize)
            buf = np.empty(blocksize, np.int64)
            p1, p2 = hist[-1], hist[-2]
            for i in range(blocksize):
                cur = res[i] + 2 * p1 - p2
                buf[i] = cur
                p2, p1 = p1, cur
        elif fn == FN_DIFF3:
            res = r.block(resn, blocksize)
            buf = np.empty(blocksize, np.int64)
            p1, p2, p3 = hist[-1], hist[-2], hist[-3]
            for i in range(blocksize):
                cur = res[i] + 3 * (p1 - p2) + p3
                buf[i] = cur
                p3, p2, p1 = p2, p1, cur
        else:  # FN_QLPC
            nlpc = r.uvar(LPCQSIZE)
            if nlpc > nwrap:
                raise ValueError(f"shorten: nlpc {nlpc} > nwrap {nwrap}")
            qlpc = [r.var(LPCQUANT) for _ in range(nlpc)]
            # prediction runs in the offset-removed domain
            work = np.concatenate([hist[len(hist) - nlpc:] - coffset,
                                   np.zeros(blocksize, np.int64)]) \
                if nlpc else np.zeros(blocksize, np.int64)
            for i in range(blocksize):
                s = lpcqoffset
                for j in range(nlpc):
                    s += qlpc[j] * int(work[nlpc + i - j - 1])
                work[nlpc + i] = r.var(resn) + (s >> LPCQUANT)
            buf = work[nlpc:] + coffset if nlpc else work + coffset

        # store the block mean (pre-bitshift domain, shifted on store)
        if nmean > 0:
            s = (blocksize // 2 if version >= 2 else 0) + int(buf.sum())
            offs.pop(0)
            m = _cdiv(s, blocksize)
            offs.append((m << bitshift) if version >= 2 else m)

        # wrap history (unshifted), then apply the bitshift to the output
        if blocksize >= nwrap:
            history[chan] = buf[blocksize - nwrap:].copy()
        else:
            history[chan] = np.concatenate([hist, buf])[-nwrap:]
        if bitshift:
            buf = buf << bitshift
        out[chan].append(buf)
        chan = (chan + 1) % nchan

    lens = [int(sum(len(b) for b in blocks)) for blocks in out]
    n = min(lens) if lens else 0
    samples = np.zeros((n, nchan), np.int32)
    for c in range(nchan):
        cat = (np.concatenate(out[c]) if out[c]
               else np.zeros(0, np.int64))[:n]
        samples[:, c] = cat.astype(np.int32)
    return samples, ftype, nchan


def ulaw_to_linear(codes: np.ndarray) -> np.ndarray:
    """mu-law byte codes -> int16 linear PCM (G.711 expansion)."""
    u = (~codes.astype(np.int64)) & 0xFF
    sign = (u >> 7) & 1
    exp = (u >> 4) & 7
    mant = u & 0xF
    mag = (((mant << 1) + 33) << exp) - 33
    return np.where(sign == 1, -mag, mag).astype(np.int16)
