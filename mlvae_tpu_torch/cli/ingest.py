"""Corpus ingestion tool: decode and resample audio into 16 kHz mono WAV
(the port's counterpart of ``mlvae_tpu/cli/ingest.py``).

Walks a corpus directory, decodes each audio file through
``data/wav.py`` (RIFF WAV, NIST SPHERE as raw PCM, mu-law or
shorten-compressed, as LDC's TIMIT ships it) and writes a resampled 16 kHz
PCM16 WAV tree: the reference's sox / sph2pipe pipelines
(``datasets/prepare_kaldi.py``). Host-side only, no device work; the JAX
package's C++ library is not ported, so this is its python path.

    python -m mlvae_tpu_torch.cli.ingest SRC_DIR DST_DIR [--rate 16000]
"""
from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

from mlvae_tpu_torch.data.wav import read_wav, resample, write_wav

logger = logging.getLogger(__name__)


def ingest(src_dir, dst_dir, rate: int = 16000) -> int:
    """Every ``.wav`` / ``.sph`` file under ``src_dir`` (any suffix case)
    -> ``dst_dir`` at the same relative path with a ``.wav`` suffix, at
    ``rate``. Returns the number of files written."""
    src_dir, dst_dir = Path(src_dir), Path(dst_dir)
    n = 0
    # one suffix-insensitive pass: two rglob patterns would double-process
    # every file on case-insensitive filesystems.  ".wav" covers both RIFF
    # and LDC TIMIT's SPHERE-with-.WAV-suffix files; ".sph" covers corpora
    # that use the explicit SPHERE suffix.
    paths = sorted(p for p in src_dir.rglob("*")
                   if p.is_file() and p.suffix.lower() in (".wav", ".sph"))
    seen_out = set()
    for path in paths:
        rel = path.relative_to(src_dir)
        out_path = (dst_dir / rel).with_suffix(".wav")
        if out_path in seen_out:
            logger.warning(
                "skipping %s: output %s already written by a sibling that "
                "differs only in suffix case", path, out_path)
            continue
        seen_out.add(out_path)
        wave, sr = read_wav(path)
        if sr != rate:
            wave = resample(wave, sr, rate)
        write_wav(out_path, wave, rate)
        n += 1
    logger.info("ingested %d files -> %s", n, dst_dir)
    return n


def main(argv=None):
    logging.basicConfig(level=logging.INFO, stream=sys.stdout)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("src_dir")
    p.add_argument("dst_dir")
    p.add_argument("--rate", type=int, default=16000)
    args = p.parse_args(argv)
    return ingest(args.src_dir, args.dst_dir, args.rate)


if __name__ == "__main__":
    main()
