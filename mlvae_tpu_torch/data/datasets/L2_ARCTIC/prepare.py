"""L2-ARCTIC preparation: TextGrid annotations -> annotation JSON (the
port's own copy of ``mlvae_tpu/data/datasets/L2_ARCTIC/prepare.py``).

The standard speaker split (15 train / 3 valid / 6 test L2-ARCTIC
speakers), TextGrid "phones"-tier parsing into pronounced and canonical
sequences with the TIMIT folding applied, forced-alignment segments from
``fa_segmentation.json``, and the ``kaldi_data`` speaker-mapping files
that the Kaldi feature pass's per-speaker CMVN reads. Audio is read with
``data/wav.py`` (no sox, no Kaldi).
"""
from __future__ import annotations

import json
import logging
from pathlib import Path

from mlvae_tpu_torch.data.datasets.L2_ARCTIC.parse_textgrid import parse_textgrid
from mlvae_tpu_torch.data.wav import read_wav

logger = logging.getLogger(__name__)

TRAIN_SPKS = ["ABA", "ASI", "BWC", "EBVS", "ERMS", "HKK", "HQTV", "LXC",
              "MBMPS", "NCC", "RRBI", "SKA", "SVBI", "THV", "YBAA"]
VALID_SPKS = ["HJK", "PNV", "YDCK"]
TEST_SPKS = ["NJS", "TLV", "TNI", "TXHC", "YKWK", "ZHAA"]


def prepare(dataset_dir, train_json_path, valid_json_path, test_json_path,
            phoneme_set_handler, *args, **kwargs):
    dataset_dir = Path(dataset_dir)
    json_paths = [Path(train_json_path), Path(valid_json_path),
                  Path(test_json_path)]
    for p in json_paths:
        p.parent.mkdir(parents=True, exist_ok=True)
    if all(p.exists() for p in json_paths):
        logger.info("L2_ARCTIC: annotation JSONs exist, skipping prepare.")
        return

    with open(dataset_dir.parent / "fa_segmentation.json") as f:
        fa_segmentation = json.load(f)

    kaldi_dir = dataset_dir.parent / "kaldi_data"
    kaldi_dir.mkdir(exist_ok=True)

    for set_name, json_path, spks in zip(
        ["train", "valid", "test"], json_paths,
        [TRAIN_SPKS, VALID_SPKS, TEST_SPKS],
    ):
        ann_paths = sorted(
            p for spk in spks
            for p in (dataset_dir / spk / "annotation").glob("*.TextGrid")
        )
        set_data = generate_json(json_path, ann_paths, phoneme_set_handler,
                                 fa_segmentation, dataset_dir)
        with open(kaldi_dir / f"{set_name}.wav.scp", "w") as f:
            for utt_id, d in set_data.items():
                f.write(f"{utt_id} {d['wav_path']}\n")
        with open(kaldi_dir / f"{set_name}.utt2spk", "w") as f:
            for utt_id, d in set_data.items():
                f.write(f"{utt_id} {d['spk_id']}\n")


def generate_json(json_path, ann_paths, phoneme_set_handler, fa_segmentation,
                  dataset_dir):
    json_data = {}
    for ann_path in sorted(ann_paths):
        spk_id = ann_path.parent.parent.name
        utt_name = ann_path.stem.split("_")[-1]
        utt_id = f"{spk_id}_{utt_name}"

        wav_path = dataset_dir / spk_id / "wav" / f"{ann_path.stem}.wav"
        wave, sr = read_wav(wav_path)
        duration = len(wave) / sr

        parsed = parse_textgrid(ann_path, "all")
        canonicals = [phoneme_set_handler.map_phoneme(p)
                      for _, _, p in parsed["canonical_phoneme"]]
        phonemes = []
        segments = []
        for start, end, p in parsed["phoneme"]:
            phonemes.append(phoneme_set_handler.map_phoneme(p))
            segments.append([start, end])

        json_data[utt_id] = {
            "wav_path": str(wav_path),
            "duration": duration,
            "spk_id": spk_id,
            "txt_gt_phn_seq": phonemes,
            "txt_gt_cnncl_seq": canonicals,
            "gt_seg_seq": segments,
            "fa_seg_seq": fa_segmentation[utt_id],
        }

    with open(json_path, "w") as f:
        json.dump(json_data, f, indent=4)
    logger.info("L2_ARCTIC: wrote %s (%d utts)", json_path, len(json_data))
    return json_data
