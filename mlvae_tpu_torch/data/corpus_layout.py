"""Small corpora laid out as L2-ARCTIC, TIMIT and ChineseDPA, from a seed.

The repo holds no corpus and fetches none. These writers put synthetic
audio (one tone a phone, 16 kHz) and its annotations in each corpus's
on-disk layout, as that corpus's ``prepare`` reads it, so that the real
corpora's data path runs end to end: the prepare, both feature passes and
a recipe's train steps. Each writer takes ``root`` = ``datasets/<name>``
(the parent of ``original_dataset``, as ``config/run.yaml`` lays it out)
and returns the utterance ids it wrote, by speaker.

* L2-ARCTIC: ``original_dataset/<SPK>/wav/arctic_aNNNN.wav`` and
  ``<SPK>/annotation/arctic_aNNNN.TextGrid`` (tiers ``words`` and
  ``phones``; a mispronounced phone is ``CANONICAL,PRONOUNCED,s``), and
  ``fa_segmentation.json`` beside ``original_dataset``.
* TIMIT: ``original_dataset/{train,test}/dr1/<spk>/<utt>.{wav,phn}`` (or
  the LDC CD's upper case), the waves as NIST SPHERE with raw PCM, the
  ``.phn`` files in samples over the 60-phone set, and the SA sentences,
  which the prepare leaves out.
* ChineseDPA: ``original_dataset/metadata_{set}_spk_level.json``,
  ``formatted_chinese_dpa/<spk>/<utt>.{wav,TextGrid}`` (tiers
  ``initial/final`` with tone digits and ``mispronunciation``) and, for the
  valid and test sets, ``human_annotation/<spk>/<utt>.TextGrid``.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from mlvae_tpu_torch.data.textgrid import write_textgrid
from mlvae_tpu_torch.data.wav import write_wav
from mlvae_tpu_torch.utils.phonemes import get_phoneme_set

SR = 16000
# the L2-ARCTIC speaker split (data/datasets/L2_ARCTIC/prepare.py)
L2_SPEAKERS = ("ABA", "ASI", "BWC", "EBVS", "ERMS", "HKK", "HQTV", "LXC",
               "MBMPS", "NCC", "RRBI", "SKA", "SVBI", "THV", "YBAA",
               "HJK", "PNV", "YDCK",
               "NJS", "TLV", "TNI", "TXHC", "YKWK", "ZHAA")
# L2-ARCTIC's phones: the 39-phone English set without its silence and
# error tokens (ARPAbet vowels carry a stress digit in the TextGrids)
_L2_PHONES = [p for p in get_phoneme_set("english", 39)
              if p not in ("sil", "err")]
_VOWELS = ("aa", "ae", "ah", "aw", "er", "ay", "eh", "ey", "ih", "iy",
           "ow", "oy", "uh", "uw")
# pinyin initials (no tone) and finals (tone digit 1-4) of the pinyin set
_INITIALS = ("b", "p", "m", "f", "d", "t", "n", "l", "g", "k", "h", "j",
             "q", "x", "zh", "ch", "sh", "r", "z", "c", "s")
_FINALS = ("a", "ai", "an", "ang", "ao", "e", "ei", "en", "eng", "i", "ia",
           "ian", "iang", "iao", "ie", "in", "ing", "iong", "iu", "o",
           "ong", "ou", "u", "ua", "uai", "uan", "uang", "ui", "un", "uo",
           "v", "van", "ve", "vn")


def _segments(rs, seconds):
    """Phone spans (start, end) in samples covering one utterance of a
    random length in ``seconds``: a silence at each end, phones of
    60-160 ms between."""
    n = int(rs.uniform(*seconds) * SR)
    edge = int(0.1 * SR)
    bounds = [0, edge]
    while bounds[-1] < n - edge - int(0.06 * SR):
        bounds.append(min(bounds[-1] + int(rs.uniform(0.06, 0.16) * SR),
                          n - edge))
    if bounds[-1] != n - edge:
        bounds.append(n - edge)
    bounds.append(n)
    return n, list(zip(bounds[:-1], bounds[1:]))


def _render(n, spans, indices, rs) -> np.ndarray:
    """One tone a span, its pitch by the label's index (silence for -1),
    and a little noise."""
    wave = 0.003 * rs.randn(n)
    for (a, b), k in zip(spans, indices):
        if k < 0:
            continue
        t = np.arange(b - a) / SR
        ramp = np.minimum(1.0, np.minimum(np.arange(b - a), b - a
                                          - np.arange(b - a)) / (0.005 * SR))
        f0 = 140.0 + 37.0 * k
        wave[a:b] += ramp * (0.4 * np.sin(2 * np.pi * f0 * t)
                             + 0.2 * np.sin(2 * np.pi * 2.7 * f0 * t))
    return wave.astype(np.float32)


def _textgrid(path, tiers, xmax) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    write_textgrid(path, tiers, xmax=xmax)


def write_sphere(path, data: np.ndarray, sr: int = SR) -> None:
    """NIST SPHERE with raw 16-bit little-endian PCM (the LDC layout
    without its shorten compression)."""
    pcm = np.clip(np.asarray(data, np.float64) * 32767.0, -32768, 32767
                  ).astype("<i2")
    head = (f"NIST_1A\n   1024\nsample_rate -i {sr}\nchannel_count -i 1\n"
            f"sample_n_bytes -i 2\nsample_count -i {len(pcm)}\n"
            "sample_coding -s3 pcm\nsample_byte_format -s2 01\n"
            "end_head\n").encode("ascii")
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(head + b" " * (1024 - len(head)) + pcm.tobytes())


def write_l2_arctic(root, speakers: Optional[Dict[str, int]] = None,
                    seconds=(2.0, 4.0), misp_prob: float = 0.15,
                    seed: int = 0) -> Dict[str, List[str]]:
    """``speakers``: speaker -> utterances (default every speaker of the
    split, two each)."""
    root = Path(root)
    ds_dir = root / "original_dataset"
    rs = np.random.RandomState(seed)
    speakers = speakers or {s: 2 for s in L2_SPEAKERS}
    fa: Dict[str, List] = {}
    written: Dict[str, List[str]] = {}
    for spk, n_utts in speakers.items():
        for u in range(n_utts):
            stem = f"arctic_a{u + 1:04d}"
            n, spans = _segments(rs, seconds)
            tokens, sounds = [], []
            for i in range(len(spans)):
                if i in (0, len(spans) - 1):
                    tokens.append("sil")
                    sounds.append(-1)
                    continue
                k = rs.randint(len(_L2_PHONES))
                canon = _L2_PHONES[k]
                said = k
                if rs.rand() < misp_prob:
                    said = rs.randint(len(_L2_PHONES))
                arpa = lambda p: p.upper() + (  # noqa: E731
                    str(rs.randint(3)) if p in _VOWELS else "")
                tokens.append(arpa(canon) if said == k else
                              f"{arpa(canon)},{arpa(_L2_PHONES[said])},s")
                sounds.append(said)
            wave = _render(n, spans, sounds, rs)
            write_wav(ds_dir / spk / "wav" / f"{stem}.wav", wave, SR)
            secs = [(a / SR, b / SR) for a, b in spans]
            _textgrid(ds_dir / spk / "annotation" / f"{stem}.TextGrid", {
                "words": [(secs[0][1], secs[-1][0], "word")],
                "phones": [(a, b, t) for (a, b), t in zip(secs, tokens)],
            }, n / SR)
            jit = rs.uniform(-0.008, 0.008, len(secs))
            fa_seq = [[max(0.0, a + j), b + j] for (a, b), j in
                      zip(secs, jit)]
            fa_seq[0][0], fa_seq[-1][1] = 0.0, n / SR
            for prev, cur in zip(fa_seq, fa_seq[1:]):
                cur[0] = prev[1]
            fa[f"{spk}_a{u + 1:04d}"] = fa_seq
            written.setdefault(spk, []).append(f"{spk}_a{u + 1:04d}")
    with open(root / "fa_segmentation.json", "w") as f:
        json.dump(fa, f)
    return written


def write_timit(root, speakers: Optional[Dict[str, Sequence[str]]] = None,
                utts_per_speaker: int = 2, seconds=(1.5, 3.0),
                upper: bool = False, seed: int = 0) -> Dict[str, List[str]]:
    """``speakers``: ``train`` / ``test`` -> speaker directories (default
    two training speakers, a dev and a core-test speaker). Every speaker
    also gets an SA sentence. ``upper``: the LDC CD's upper-case names."""
    root = Path(root)
    ds_dir = root / "original_dataset"
    rs = np.random.RandomState(seed)
    speakers = speakers or {"train": ["mabc0", "fxyz1"],
                            "test": ["faks0", "mdab0"]}
    phones60 = [p for p in get_phoneme_set("english", 60)
                if p not in ("h#", "pau", "epi")]
    case = str.upper if upper else str
    written: Dict[str, List[str]] = {}
    for split, spks in speakers.items():
        for spk in spks:
            d = ds_dir / case(split) / case("dr1") / case(spk)
            for u in range(utts_per_speaker + 1):
                stem = case("sa1" if u == utts_per_speaker else f"si{u + 1}")
                n, spans = _segments(rs, seconds)
                labels = ["h#"] + [phones60[rs.randint(len(phones60))]
                                   for _ in spans[1:-1]] + ["h#"]
                sounds = [-1 if p in ("h#", "pau", "epi") or p.endswith("cl")
                          else phones60.index(p) for p in labels]
                write_sphere(d / f"{stem}.{case('wav')}",
                             _render(n, spans, sounds, rs))
                (d / f"{stem}.{case('phn')}").write_text("".join(
                    f"{a} {b} {p}\n" for (a, b), p in zip(spans, labels)))
                if u < utts_per_speaker:
                    written.setdefault(spk, []).append(f"{case(spk)}_{stem}")
    return written


def write_chinese_dpa(root, speakers: Optional[Dict[str, int]] = None,
                      seconds=(1.5, 3.0), misp_prob: float = 0.15,
                      seed: int = 0) -> Dict[str, List[str]]:
    """``speakers``: speaker -> utterances; the speakers go to train,
    valid and test in turn (default six speakers, two utterances each)."""
    root = Path(root)
    ds_dir = root / "original_dataset"
    corpus = ds_dir / "formatted_chinese_dpa"
    rs = np.random.RandomState(seed)
    pinyin = get_phoneme_set("pinyin", 62)
    speakers = speakers or {f"spk{i}": 2 for i in range(1, 7)}
    metas = {s: {} for s in ("train", "valid", "test")}
    written: Dict[str, List[str]] = {}
    for i, (spk, n_utts) in enumerate(speakers.items()):
        set_name = ("train", "valid", "test")[i % 3]
        metas[set_name][spk] = {}
        for u in range(n_utts):
            utt = f"{spk}_{u + 1:03d}"
            n, spans = _segments(rs, seconds)
            labels, misp, sounds = [], [], []
            for j in range(len(spans)):
                if j in (0, len(spans) - 1):
                    labels.append("sil")
                    misp.append("sil")
                    sounds.append(-1)
                    continue
                if j % 2:
                    label = _INITIALS[rs.randint(len(_INITIALS))]
                    base = label
                else:
                    base = _FINALS[rs.randint(len(_FINALS))]
                    label = f"{base}{rs.randint(1, 5)}"
                labels.append(label)
                flag = rs.rand() < misp_prob
                misp.append(("+" if rs.rand() < 0.5 else "s")
                            if flag else "")
                sounds.append(pinyin.index(base))
            wave = _render(n, spans, sounds, rs)
            write_wav(corpus / spk / f"{utt}.wav", wave, SR)
            secs = [(a / SR, b / SR) for a, b in spans]
            tiers = {"initial/final": [(a, b, t) for (a, b), t in
                                       zip(secs, labels)],
                     "mispronunciation": [(a, b, t) for (a, b), t in
                                          zip(secs, misp)]}
            _textgrid(corpus / spk / f"{utt}.TextGrid", tiers, n / SR)
            if set_name != "train":
                _textgrid(ds_dir / "human_annotation" / spk /
                          f"{utt}.TextGrid", tiers, n / SR)
            metas[set_name][spk][utt] = {"wav_path": f"{spk}/{utt}.wav",
                                         "duration": n / SR}
            written.setdefault(spk, []).append(utt)
    for set_name, meta in metas.items():
        with open(ds_dir / f"metadata_{set_name}_spk_level.json", "w") as f:
            json.dump(meta, f, indent=2)
    return written
