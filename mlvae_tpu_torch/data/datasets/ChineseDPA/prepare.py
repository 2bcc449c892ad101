"""ChineseDPA preparation: pinyin initial/final TextGrids -> annotation JSON
(the port's own copy of ``mlvae_tpu/data/datasets/ChineseDPA/prepare.py``).

Per-set speaker-level metadata JSONs, the ``initial/final`` tier as the
pinyin sequence (tone digits stripped), the ``mispronunciation`` tier
mapping flagged phonemes to ``err`` in the pronounced sequence, and the
canonical sequence from the formatted corpus TextGrids.
"""
from __future__ import annotations

import json
import logging
from pathlib import Path

from mlvae_tpu_torch.data.textgrid import read_textgrid

logger = logging.getLogger(__name__)


def read_tg_file(path):
    tg = read_textgrid(path, include_empty_intervals=True)

    segment_seq, pinyin_seq = [], []
    for interval in tg.get_tier_by_name("initial/final"):
        segment_seq.append([interval.start_time, interval.end_time])
        text = interval.text
        if text and text[-1].isdigit():
            text = text[:-1]
        pinyin_seq.append(text)

    misp_seq = []
    for interval in tg.get_tier_by_name("mispronunciation"):
        text = interval.text
        if text == "sil":
            text = ""
        if len(text) > 1:
            logger.warning("Convert misp label: %s -> %s", text, text[0])
            text = text[0]
        misp_seq.append(text)
    return pinyin_seq, segment_seq, misp_seq


def prepare(dataset_dir, train_json_path, valid_json_path, test_json_path,
            *args, **kwargs):
    dataset_dir = Path(dataset_dir)
    json_paths = [Path(train_json_path), Path(valid_json_path),
                  Path(test_json_path)]
    for p in json_paths:
        p.parent.mkdir(parents=True, exist_ok=True)
    if all(p.exists() for p in json_paths):
        logger.info("ChineseDPA: annotation JSONs exist, skipping prepare.")
        return

    kaldi_dir = dataset_dir.parent / "kaldi_data"
    kaldi_dir.mkdir(exist_ok=True)

    for set_name, json_path in zip(["train", "valid", "test"], json_paths):
        with open(dataset_dir / f"metadata_{set_name}_spk_level.json") as f:
            set_metadata = json.load(f)

        set_data = {}
        for spk_id, spk_metadata in set_metadata.items():
            for utt_id, utt_metadata in spk_metadata.items():
                wav_path = dataset_dir / "formatted_chinese_dpa" / \
                    utt_metadata["wav_path"]
                duration = utt_metadata["duration"]

                tg_path = wav_path.with_suffix(".TextGrid")
                cnncl_seq, fa_seg_seq, misp_seq = read_tg_file(tg_path)
                assert len(cnncl_seq) == len(fa_seg_seq) == len(misp_seq)

                # human-annotated ground truth for valid/test when present
                gt_tg_path = dataset_dir / "human_annotation" / spk_id / \
                    f"{utt_id}.TextGrid"
                if set_name in ("valid", "test") and gt_tg_path.exists():
                    phn_seq, gt_seg_seq, misp_seq = read_tg_file(gt_tg_path)
                    # annotators merging/splitting segments would surface
                    # much later as a broadcast error in the MD pipeline —
                    # fail at the source with the utterance named
                    if len(phn_seq) != len(cnncl_seq):
                        raise ValueError(
                            f"{gt_tg_path}: human annotation has "
                            f"{len(phn_seq)} segments but the formatted "
                            f"corpus has {len(cnncl_seq)} for {utt_id}")
                else:
                    phn_seq, gt_seg_seq = list(cnncl_seq), \
                        [list(s) for s in fa_seg_seq]
                assert len(phn_seq) == len(gt_seg_seq) == len(misp_seq)

                # flagged phonemes become 'err' in the pronounced sequence
                for i, misp in enumerate(misp_seq):
                    if misp != "":
                        phn_seq[i] = "err"

                set_data[utt_id] = {
                    "wav_path": str(wav_path),
                    "duration": duration,
                    "spk_id": spk_id,
                    "txt_gt_phn_seq": phn_seq,
                    "txt_gt_cnncl_seq": cnncl_seq,
                    "gt_seg_seq": gt_seg_seq,
                    "fa_seg_seq": fa_seg_seq,
                }

        with open(json_path, "w") as f:
            json.dump(set_data, f, indent=4)
        with open(kaldi_dir / f"{set_name}.wav.scp", "w") as f:
            for utt_id, d in set_data.items():
                f.write(f"{utt_id} {d['wav_path']}\n")
        with open(kaldi_dir / f"{set_name}.utt2spk", "w") as f:
            for utt_id, d in set_data.items():
                f.write(f"{utt_id} {d['spk_id']}\n")
        logger.info("ChineseDPA: wrote %s (%d utts)", json_path,
                    len(set_data))
