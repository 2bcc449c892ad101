"""TIMIT preparation: .phn transcriptions -> annotation JSON (the port's own
copy of ``mlvae_tpu/data/datasets/TIMIT/prepare.py``).

Standard train/dev/test speaker handling (dev/test speaker lists below are the
standard TIMIT core splits), 60->48->39 phoneme folding via the
PhonemeSetHandler, consecutive-silence collapsing (keep the LAST sil of a
run and stretch its start to the previous phoneme's end), SA-utterance
exclusion, and pronounced == canonical (TIMIT has no mispronunciations, so
``gt_seg_seq == fa_seg_seq``).
"""
from __future__ import annotations

import json
import logging
from pathlib import Path

from mlvae_tpu_torch.data.wav import read_wav

logger = logging.getLogger(__name__)

SAMPLERATE = 16000

# standard TIMIT dev/test speaker lists (complete test set split)
DEV_SPK = [
    "faks0", "fdac1", "fjem0", "mgwt0", "mjar0", "mmdb1", "mmdm2", "mpdf0",
    "fcmh0", "fkms0", "mbdg0", "mbwm0", "mcsh0", "fadg0", "fdms0", "fedw0",
    "mgjf0", "mglb0", "mrtk0", "mtaa0", "mtdt0", "mthc0", "mwjg0", "fnmr0",
    "frew0", "fsem0", "mbns0", "mmjr0", "mdls0", "mdlf0", "mdvc0", "mers0",
    "fmah0", "fdrw0", "mrcs0", "mrjm4", "fcal1", "mmwh0", "fjsj0", "majc0",
    "mjsw0", "mreb0", "fgjd0", "fjmg0", "mroa0", "mteb0", "mjfc0", "mrjr0",
    "fmml0", "mrws1",
]
TEST_SPK = [
    "mdab0", "mwbt0", "felc0", "mtas1", "mwew0", "fpas0", "mjmp0", "mlnt0",
    "fpkt0", "mlll0", "mtls0", "fjlm0", "mbpm0", "mklt0", "fnlp0", "mcmj0",
    "mjdh0", "fmgd0", "mgrt0", "mnjm0", "fdhc0", "mjln0", "mpam0", "fmld0",
]


def _fold_and_collapse(phonemes, segments, phoneme_set_handler):
    """Apply the phoneme folding, drop empties, collapse consecutive sils
    (reference ``prepare.py:294-329``).

    NOTE the reference's table maps the glottal stop 'q' to 'err' (its MD
    error token, ``utils/phonemes.py:47``) rather than deleting it as the
    standard Lee & Hon folding does — reproduced faithfully here, so the
    ``if p`` empty-drop below only fires for mappings a user's custom
    table maps to ''."""
    folded, segs = [], []
    for p, seg in zip(phonemes, segments):
        p = phoneme_set_handler.map_phoneme(p)
        if p:
            folded.append(p)
            segs.append(list(seg))

    if phoneme_set_handler.n_phonemes != 60:
        remove = [p == "sil" for p in folded]
        for i in range(len(remove)):
            if remove[i]:
                if i == len(remove) - 1 or not remove[i + 1]:
                    remove[i] = False
        folded = [p for i, p in enumerate(folded) if not remove[i]]
        segs = [s for i, s in enumerate(segs) if not remove[i]]
        for i, p in enumerate(folded):
            if p != "sil":
                continue
            segs[i][0] = 0.0 if i == 0 else segs[i - 1][1]
    return folded, segs


def _read_phn(path):
    phonemes, segments = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 3:
                continue
            start, end, phoneme = parts
            phonemes.append(phoneme)
            segments.append([int(start) / SAMPLERATE, int(end) / SAMPLERATE])
    return phonemes, segments


def _collect_wavs(root: Path):
    out = []
    for ext in ("wav", "WAV"):
        out += list(root.rglob(f"*.{ext}"))
    # exclude the SA dialect sentences (standard practice)
    return sorted(p for p in out if not p.stem.lower().startswith("sa"))


def prepare(dataset_dir, train_json_path, valid_json_path, test_json_path,
            phoneme_set_handler, *args, **kwargs):
    dataset_dir = Path(dataset_dir)
    json_paths = [Path(train_json_path), Path(valid_json_path),
                  Path(test_json_path)]
    for p in json_paths:
        p.parent.mkdir(parents=True, exist_ok=True)
    if all(p.exists() for p in json_paths):
        logger.info("TIMIT: annotation JSONs exist, skipping prepare.")
        return

    train_root = dataset_dir / ("train" if (dataset_dir / "train").exists()
                                else "TRAIN")
    test_root = dataset_dir / ("test" if (dataset_dir / "test").exists()
                               else "TEST")
    train_wavs = _collect_wavs(train_root)
    eval_wavs = _collect_wavs(test_root)
    dev_set = set(DEV_SPK)
    test_set = set(TEST_SPK)
    valid_wavs = [p for p in eval_wavs if p.parent.name.lower() in dev_set]
    test_wavs = [p for p in eval_wavs if p.parent.name.lower() in test_set]

    kaldi_dir = dataset_dir.parent / "kaldi_data"
    kaldi_dir.mkdir(exist_ok=True)

    for set_name, json_path, wavs in zip(
        ["train", "valid", "test"], json_paths,
        [train_wavs, valid_wavs, test_wavs],
    ):
        set_data = {}
        for wav_path in wavs:
            spk_id = wav_path.parent.name
            utt_id = f"{spk_id}_{wav_path.stem}"
            phn_path = wav_path.with_suffix(
                ".PHN" if wav_path.suffix == ".WAV" else ".phn"
            )
            if not phn_path.exists():
                logger.warning("missing phn file for %s", wav_path)
                continue
            wave, sr = read_wav(wav_path)
            duration = len(wave) / sr
            phonemes, segments = _read_phn(phn_path)
            phonemes, segments = _fold_and_collapse(
                phonemes, segments, phoneme_set_handler
            )
            set_data[utt_id] = {
                "wav_path": str(wav_path),
                "duration": duration,
                "spk_id": spk_id,
                "txt_gt_phn_seq": phonemes,
                "txt_gt_cnncl_seq": list(phonemes),  # no mispronunciations
                "gt_seg_seq": segments,
                "fa_seg_seq": [list(s) for s in segments],
            }
        with open(json_path, "w") as f:
            json.dump(set_data, f, indent=2)
        with open(kaldi_dir / f"{set_name}.wav.scp", "w") as f:
            for utt_id, d in set_data.items():
                f.write(f"{utt_id} {d['wav_path']}\n")
        with open(kaldi_dir / f"{set_name}.utt2spk", "w") as f:
            for utt_id, d in set_data.items():
                f.write(f"{utt_id} {d['spk_id']}\n")
        logger.info("TIMIT: wrote %s (%d utts)", json_path, len(set_data))
