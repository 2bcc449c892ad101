"""SynAudioMNIST preparation: per-speaker meta JSON -> annotation JSON (the
port's own copy of ``mlvae_tpu/data/datasets/SynAudioMNIST/prepare.py``).

Speaker-split train/valid/test with the annotation schema the data path
reads (wav_path, duration, spk_id, txt_gt_phn_seq, txt_gt_cnncl_seq,
gt_seg_seq, fa_seg_seq), plus the ``kaldi_data`` speaker-mapping files
that the Kaldi feature pass's per-speaker CMVN reads. When the corpus is
absent it is synthesized (``data/synth.py``).
"""
from __future__ import annotations

import json
import logging
from pathlib import Path

logger = logging.getLogger(__name__)


def _speaker_splits(speakers):
    n = len(speakers)
    n_train = max(1, int(round(n * 0.5)))
    n_valid = max(1, int(round(n * 0.25)))
    train = speakers[:n_train]
    valid = speakers[n_train:n_train + n_valid] or speakers[:1]
    test = speakers[n_train + n_valid:] or speakers[-1:]
    if set(valid) & set(train) or set(test) & (set(train) | set(valid)):
        logger.warning(
            "only %d speaker(s): train/valid/test splits overlap — "
            "evaluation metrics will be inflated by speaker leakage", n)
    return train, valid, test


def prepare(dataset_dir, train_json_path, valid_json_path, test_json_path,
            *args, **kwargs):
    dataset_dir = Path(dataset_dir)
    json_paths = [Path(train_json_path), Path(valid_json_path),
                  Path(test_json_path)]
    for p in json_paths:
        p.parent.mkdir(parents=True, exist_ok=True)

    if all(p.exists() for p in json_paths):
        logger.info("SynAudioMNIST: annotation JSONs exist, skipping prepare.")
        return

    if not dataset_dir.exists():
        logger.info("SynAudioMNIST: corpus missing, synthesizing one.")
        from mlvae_tpu_torch.data.synth import generate_corpus
        generate_corpus(dataset_dir.parent)

    with open(dataset_dir / "forced_alignment_segmentation.json") as f:
        fa_segmentation = json.load(f)

    speakers = sorted(d.name for d in dataset_dir.iterdir() if d.is_dir())
    splits = _speaker_splits(speakers)
    kaldi_dir = dataset_dir.parent / "kaldi_data"
    kaldi_dir.mkdir(exist_ok=True)

    for set_name, json_path, spks in zip(
        ["train", "valid", "test"], json_paths, splits
    ):
        set_data = {}
        for spk in spks:
            meta_path = dataset_dir / spk / f"{spk}_meta.json"
            with open(meta_path) as f:
                meta = json.load(f)
            for utt_id, m in meta.items():
                set_data[utt_id] = {
                    "wav_path": str(dataset_dir / spk / f"{utt_id}.wav"),
                    "duration": m["duration"],
                    "spk_id": spk,
                    "txt_gt_phn_seq": m["pronounced_digit_seq"],
                    "txt_gt_cnncl_seq": m["canonical_digit_seq"],
                    "gt_seg_seq": m["segment_seq"],
                    "fa_seg_seq": fa_segmentation[utt_id],
                }
        with open(json_path, "w") as f:
            json.dump(set_data, f, indent=2)

        # speaker-mapping files for per-speaker CMVN
        with open(kaldi_dir / f"{set_name}.wav.scp", "w") as f:
            for utt_id, d in set_data.items():
                f.write(f"{utt_id} {d['wav_path']}\n")
        with open(kaldi_dir / f"{set_name}.utt2spk", "w") as f:
            for utt_id, d in set_data.items():
                f.write(f"{utt_id} {d['spk_id']}\n")
        logger.info("SynAudioMNIST: wrote %s (%d utts)", json_path,
                    len(set_data))
