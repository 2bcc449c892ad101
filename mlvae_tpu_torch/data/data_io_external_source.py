"""The computed sets with external DNN-HMM results (counterpart of
``mlvae_tpu/data/data_io_external_source.py``): the pickled computed sets
as they are (nothing is recomputed; a missing one raises), and, where
``external_data/dnn_hmm_test.json`` exists beside ``computed_dataset/``,
the external system's segments, phonemes, boundaries, phoneme ends and
MD labels on the test set (``EXT_KEYS``). An external phoneme with a
``*`` reads as ``sil``; a test utterance without results raises."""
from __future__ import annotations

import json
import logging
import pickle
from pathlib import Path

import numpy as np

from mlvae_tpu_torch.data.annotations import generate_boundary_seq
from mlvae_tpu_torch.data.data_io import OUTPUT_KEYS, SET_NAMES
from mlvae_tpu_torch.data.dataset import DynamicItemDataset
from mlvae_tpu_torch.data.encoder import get_label_encoder

logger = logging.getLogger(__name__)

EXT_KEYS = [
    "ext_dnn_hmm_seg_seq", "ext_dnn_hmm_phn_seq",
    "ext_dnn_hmm_boundary_seq", "ext_dnn_hmm_phn_end_seq",
    "ext_plvl_dnn_hmm_md_lbl_seq",
]


def prepare_datasets(hparams):
    logger.info("Preparing datasets (external source).")
    dataset_dir = Path(hparams["prepare"]["dataset_dir"]).parent
    computed_dir = dataset_dir / "computed_dataset"

    # duration-sorted data is never shuffled (as data_io.prepare_datasets)
    if hparams.get("sorting") in ("ascending", "descending") \
            and "train_dataloader_opts" in hparams:
        hparams["train_dataloader_opts"]["shuffle"] = False

    datasets = []
    for set_name in SET_NAMES:
        pkl_path = computed_dir / f"{set_name}.pkl"
        if not pkl_path.exists():
            raise FileNotFoundError(
                f"pre-computed dataset not found: {pkl_path.absolute()}")
        with open(pkl_path, "rb") as f:
            computed = pickle.load(f)
        datasets.append(DynamicItemDataset(computed, output_keys=OUTPUT_KEYS))

    label_encoder = get_label_encoder(hparams)

    results_path = dataset_dir / "external_data" / "dnn_hmm_test.json"
    if results_path.exists():
        with open(results_path) as f:
            dnn_hmm_results = json.load(f)
        test_ds = datasets[2]
        missing = [u for u in test_ds.ids if u not in dnn_hmm_results]
        if missing:
            raise ValueError(
                f"{results_path} is missing {len(missing)} test "
                f"utterance(s), e.g. {missing[:5]}: the external DNN-HMM "
                "scoring did not cover the whole test set")

        def dnn_hmm_pipeline(utt_id):
            seg_seq, phn_seq = [], []
            for start, end, phn in dnn_hmm_results[utt_id]:
                seg_seq.append([start, end])
                if "*" in phn:
                    phn = "sil"
                phn_seq.append(label_encoder.encode_label(phn))
            yield np.asarray(seg_seq, np.float64)
            yield np.asarray(phn_seq, np.int64)

        def ext_boundary_pipeline(feat, duration, seg_seq):
            boundary, phn_end = generate_boundary_seq(
                feat.shape[0], duration, seg_seq)
            yield boundary
            yield phn_end

        def ext_md_pipeline(phn_seq, gt_cnncl_seq):
            return (np.asarray(phn_seq)
                    != np.asarray(gt_cnncl_seq)).astype(np.int64)

        test_ds.add_dynamic_item(
            dnn_hmm_pipeline, ["id"],
            ["ext_dnn_hmm_seg_seq", "ext_dnn_hmm_phn_seq"])
        test_ds.add_dynamic_item(
            ext_boundary_pipeline,
            ["feat", "duration", "ext_dnn_hmm_seg_seq"],
            ["ext_dnn_hmm_boundary_seq", "ext_dnn_hmm_phn_end_seq"])
        test_ds.add_dynamic_item(
            ext_md_pipeline, ["ext_dnn_hmm_phn_seq", "gt_cnncl_seq"],
            ["ext_plvl_dnn_hmm_md_lbl_seq"])
        test_ds.set_output_keys(OUTPUT_KEYS + EXT_KEYS)

    return datasets, label_encoder
