"""Dataset assembly: annotation JSON -> computed (cached) datasets (the
port's counterpart of ``mlvae_tpu/data/data_io.py``).

The same 24 output keys, duration-sorted datasets, the pickled
computed-dataset cache under ``datasets/<name>/computed_dataset/`` (the
JAX package's layout: either package reads the other's), the phoneme
prior over the train set's canonical phonemes, and the saved-MD-results
cleaning step with the JAX package's deliberate deviation (one
invalid-frame set per utterance from the forced alignment).

Two feature passes run on the card, both through K6: the Kaldi pass
(``compute_kaldi_features``: ``KaldiFbank`` and per-speaker CMVN, which
takes the place of the reference's four Kaldi subprocesses) and the
SpeechBrain pass (the recipe's ``compute_features``, an ``ops.fbank.Fbank``,
over 256-utterance chunks), run a second time over the augmented waves
where the recipe names an ``augmentation`` (the waves themselves are
augmented on the host, ``ops/augment.py``). There is no CPU fallback: a
pass runs on the run's device or raises. The JAX package's native C++
Kaldi branch is not ported (the port's extractor is K6).
"""
from __future__ import annotations

import json
import logging
import pickle
import time
import warnings
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from mlvae_tpu_torch.data.annotations import (
    apply_boundary_saved_md_results,
    apply_flvl_saved_md_results,
    apply_frame_saved_md_results,
    apply_plvl_saved_md_results,
    clean_boundary_seq_remap,
    flagged_frame_indices,
    generate_boundary_seq,
    generate_flvl_annotation,
)
from mlvae_tpu_torch.data.dataset import DynamicItemDataset
from mlvae_tpu_torch.data.encoder import LabelEncoder, get_label_encoder
from mlvae_tpu_torch.data.wav import read_wav, resample
from mlvae_tpu_torch.device import resolve_device
from mlvae_tpu_torch.ops import frontend_ref
from mlvae_tpu_torch.ops.fbank import KaldiFbank, kaldi_frame_counts

logger = logging.getLogger(__name__)

SET_NAMES = ["train", "valid", "test"]

# the reference's output-key inventory
OUTPUT_KEYS = [
    "id",
    "wav", "aug_wav",
    "duration",
    "feat", "aug_feat",
    "kaldi_feat", "aug_kaldi_feat",
    "gt_phn_seq", "gt_cnncl_seq",
    "flvl_gt_phn_seq", "flvl_gt_cnncl_seq",
    "aug_flvl_gt_phn_seq", "aug_flvl_gt_cnncl_seq",
    "plvl_gt_md_lbl_seq", "flvl_gt_md_lbl_seq", "aug_flvl_gt_md_lbl_seq",
    "gt_seg_seq", "gt_boundary_seq", "gt_phn_end_seq",
    "fa_seg_seq", "fa_boundary_seq", "fa_phn_end_seq",
    "prior",
]

# utterances per launch of the SpeechBrain feature pass
SB_CHUNK = 256


def int16_batch(waves: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Waves in [-1, 1] as Kaldi takes them, int16-scale, zero-padded to
    the longest: ((B, longest) float32, (B,) int64 lengths)."""
    lengths = np.array([len(w) for w in waves], np.int64)
    batch = np.zeros((len(waves), int(lengths.max())), np.float32)
    for i, wav in enumerate(waves):
        batch[i, :len(wav)] = wav * 32768.0
    return batch, lengths


def compute_kaldi_features(hparams, set_name: str, device=None,
                           batch_size: int = 256) -> Dict[str, np.ndarray]:
    """Fbank + deltas per utterance of ``kaldi_data/{set_name}.wav.scp``,
    then CMVN with ``norm_vars`` per speaker of ``{set_name}.utt2spk``.
    ``hparams`` is a plain dict with ``prepare.dataset_dir`` (whose parent
    holds ``kaldi_data/``) and ``kaldi_feature_params`` (sample_rate,
    hop_length, n_fft, n_mels). The utterances go to the extractor
    ``batch_size`` at a time in the list's order, each framed at its own
    length, with one K6 launch and one copy back per batch on ``device``
    (None means CUDA); each utterance's features are those of a call on it
    alone. Returns utterance id -> (T, 3 n_mels) float32."""
    device = resolve_device(device)
    dataset_dir = Path(hparams["prepare"]["dataset_dir"]).parent
    kaldi_dir = dataset_dir / "kaldi_data"
    fp = hparams["kaldi_feature_params"]
    extractor = KaldiFbank(
        sample_rate=fp["sample_rate"], hop_length=fp["hop_length"],
        n_fft=fp["n_fft"], n_mels=fp["n_mels"], device=device,
    )

    utt2spk: Dict[str, str] = {}
    with open(kaldi_dir / f"{set_name}.utt2spk") as f:
        for line in f:
            utt_id, spk = line.split()
            utt2spk[utt_id] = spk
    wav_paths: Dict[str, str] = {}
    with open(kaldi_dir / f"{set_name}.wav.scp") as f:
        for line in f:
            utt_id, path = line.split(None, 1)
            wav_paths[utt_id] = path.strip()

    feats: Dict[str, np.ndarray] = {}
    items = list(wav_paths.items())
    for start in range(0, len(items), batch_size):
        chunk = items[start:start + batch_size]
        waves = []
        for _, path in chunk:
            wav, sr = read_wav(path)
            if sr != fp["sample_rate"]:
                wav = resample(wav, sr, fp["sample_rate"])
            waves.append(wav)
        batch, lengths = int16_batch(waves)
        out = extractor(batch, lengths).cpu().numpy()
        n_frames = kaldi_frame_counts(lengths, extractor.shift)
        for i, (utt_id, _) in enumerate(chunk):
            feats[utt_id] = out[i, :n_frames[i]]

    # per-speaker sufficient statistics
    by_spk: Dict[str, List[str]] = {}
    for utt_id, spk in utt2spk.items():
        by_spk.setdefault(spk, []).append(utt_id)
    for spk, utt_ids in by_spk.items():
        total, sq, count = frontend_ref.cmvn_stats(
            [feats[u] for u in utt_ids])
        for u in utt_ids:
            feats[u] = frontend_ref.apply_cmvn(feats[u], total, sq, count)
    return feats


def sb_features(compute_features, wavs: Dict[str, np.ndarray],
                chunk_size: int = SB_CHUNK) -> Dict[str, np.ndarray]:
    """The recipe's ``compute_features`` (an ``ops.fbank.Fbank``) over
    ``wavs``, utterance id -> wave in [-1, 1]: shortest first, one call
    (one K6 launch on the card) and one copy back per ``chunk_size``
    utterances, each framed at its own length, so each utterance's
    features are those of a call on it alone. Returns id -> (T, C)."""
    out = {}
    order = sorted(wavs, key=lambda u: len(wavs[u]))
    for i in range(0, len(order), chunk_size):
        chunk = order[i:i + chunk_size]
        lens = np.array([len(wavs[u]) for u in chunk], np.int64)
        arr = np.zeros((len(chunk), int(lens.max())), np.float32)
        for j, u in enumerate(chunk):
            arr[j, :lens[j]] = wavs[u]
        feats = compute_features(arr, lens).cpu().numpy()
        for j, u in enumerate(chunk):
            n = int(lens[j]) // compute_features.hop + 1
            out[u] = np.ascontiguousarray(feats[j, :n])
    return out


def data_io_prep(hparams, device=None) -> List[DynamicItemDataset]:
    """The three sets (train, valid, test) as dynamic-item datasets with
    both feature passes run: the Kaldi pass on ``device`` (None means
    CUDA) and the SpeechBrain pass through ``hparams["compute_features"]``
    (built on the run's device by the loader). Where ``hparams`` names an
    ``augmentation`` (``ops.augment.WaveAugment``), each utterance gets one
    augmented wave on the host, set by set in the sets' utterance order as
    the JAX package draws them, and the SpeechBrain pass runs again over
    the augmented waves (``aug_wav``, ``aug_feat``)."""

    def dataset_prep(set_name: str) -> DynamicItemDataset:
        ds = DynamicItemDataset.from_json(
            hparams["prepare"][f"{set_name}_json_path"])
        if hparams.get("sorting") in ("ascending", "descending"):
            ds = ds.filtered_sorted(
                sort_key="duration",
                reverse=hparams["sorting"] == "descending")
            if "train_dataloader_opts" in hparams:
                hparams["train_dataloader_opts"]["shuffle"] = False
        return ds

    datasets = [dataset_prep(name) for name in SET_NAMES]
    label_encoder = get_label_encoder(hparams)

    kaldi_feats: Dict[str, np.ndarray] = {}
    t0 = time.time()
    for set_name in SET_NAMES:
        kaldi_feats.update(compute_kaldi_features(hparams, set_name,
                                                  device=device))
    logger.info("kaldi feature pass: %d utts in %.1fs",
                len(kaldi_feats), time.time() - t0)

    sr = hparams["sample_rate"]
    compute_features = hparams["compute_features"]
    augmentation = hparams.get("augmentation")

    def kaldi_feat_pipeline(utt_id):
        yield kaldi_feats[utt_id]
        yield kaldi_feats[utt_id]

    def _trim_to_kaldi(feat, utt_id):
        n = kaldi_feats[utt_id].shape[0]
        if not 0 <= feat.shape[0] - n <= 1:
            fp = hparams["kaldi_feature_params"]
            raise ValueError(
                f"feature/kaldi frame-count mismatch for {utt_id}: "
                f"{feat.shape[0]} vs {n}. compute_features uses "
                f"sample_rate={hparams['sample_rate']} while "
                f"kaldi_feature_params uses {fp['sample_rate']} (hop "
                f"{fp['hop_length']} ms): both passes must share one "
                "rate/hop configuration")
        return feat[:n]

    def trimmed_sb_features(wavs):
        return {u: _trim_to_kaldi(f, u) for u, f in
                sb_features(compute_features, wavs).items()}

    wav_store: Dict[str, np.ndarray] = {}
    aug_wav_store: Dict[str, np.ndarray] = {}
    sb_feats: Dict[str, np.ndarray] = {}
    aug_sb_feats: Dict[str, np.ndarray] = {}
    t0 = time.time()
    for ds in datasets:
        wavs = {}
        for utt_id in ds.ids:
            wav, file_sr = read_wav(ds.data[utt_id]["wav_path"])
            if file_sr != sr:
                wav = resample(wav, file_sr, sr)
            wavs[utt_id] = wav
        wav_store.update(wavs)
        sb_feats.update(trimmed_sb_features(wavs))
        if augmentation is not None:
            aug = {u: np.asarray(augmentation(w[None]))[0]
                   for u, w in wavs.items()}
            aug_wav_store.update(aug)
            aug_sb_feats.update(trimmed_sb_features(aug))
    logger.info("SB feature pass (batched): %d utts in %.1fs",
                len(sb_feats), time.time() - t0)

    def audio_pipeline(utt_id):
        yield wav_store[utt_id]
        yield sb_feats[utt_id]
        yield aug_wav_store.get(utt_id, wav_store[utt_id])
        yield aug_sb_feats.get(utt_id, sb_feats[utt_id])

    def flvl_pipeline(feat, aug_feat, duration, seg_seq, txt_seq):
        # which text sequence arrives (phn vs cnncl) is set by the takes
        # list at registration; registered once per text key
        ids = label_encoder.encode_sequence(txt_seq)
        yield ids
        yield generate_flvl_annotation(
            label_encoder, feat.shape[0], duration, seg_seq, ids)
        yield generate_flvl_annotation(
            label_encoder, aug_feat.shape[0], duration, seg_seq, ids)

    def plvl_md_pipeline(gt_phn_seq, gt_cnncl_seq):
        return (np.asarray(gt_phn_seq)
                != np.asarray(gt_cnncl_seq)).astype(np.int64)

    def flvl_md_pipeline(flvl_phn, flvl_cnncl, aug_flvl_phn, aug_flvl_cnncl):
        yield (np.asarray(flvl_phn) != np.asarray(flvl_cnncl)).astype(np.int64)
        yield (np.asarray(aug_flvl_phn)
               != np.asarray(aug_flvl_cnncl)).astype(np.int64)

    def boundary_pipeline(feat, duration, seg_seq):
        boundary, phn_end = generate_boundary_seq(feat.shape[0], duration,
                                                  seg_seq)
        yield boundary
        yield phn_end

    for ds in datasets:
        ds.add_dynamic_item(kaldi_feat_pipeline, ["id"],
                            ["kaldi_feat", "aug_kaldi_feat"])
        ds.add_dynamic_item(audio_pipeline, ["id"],
                            ["wav", "feat", "aug_wav", "aug_feat"])
        ds.add_dynamic_item(
            flvl_pipeline,
            ["feat", "aug_feat", "duration", "gt_seg_seq", "txt_gt_phn_seq"],
            ["gt_phn_seq", "flvl_gt_phn_seq", "aug_flvl_gt_phn_seq"])
        ds.add_dynamic_item(
            flvl_pipeline,
            ["feat", "aug_feat", "duration", "gt_seg_seq",
             "txt_gt_cnncl_seq"],
            ["gt_cnncl_seq", "flvl_gt_cnncl_seq", "aug_flvl_gt_cnncl_seq"])
        ds.add_dynamic_item(plvl_md_pipeline, ["gt_phn_seq", "gt_cnncl_seq"],
                            ["plvl_gt_md_lbl_seq"])
        ds.add_dynamic_item(
            flvl_md_pipeline,
            ["flvl_gt_phn_seq", "flvl_gt_cnncl_seq",
             "aug_flvl_gt_phn_seq", "aug_flvl_gt_cnncl_seq"],
            ["flvl_gt_md_lbl_seq", "aug_flvl_gt_md_lbl_seq"])
        ds.add_dynamic_item(boundary_pipeline,
                            ["feat", "duration", "gt_seg_seq"],
                            ["gt_boundary_seq", "gt_phn_end_seq"])
        ds.add_dynamic_item(boundary_pipeline,
                            ["feat", "duration", "fa_seg_seq"],
                            ["fa_boundary_seq", "fa_phn_end_seq"])

    # phoneme prior over the train set's canonical phonemes
    train_ds = datasets[0]
    prior = np.zeros(len(label_encoder), np.float32)
    for utt_id in train_ds.ids:
        for p in train_ds.compute_sample(utt_id,
                                         ["gt_cnncl_seq"])["gt_cnncl_seq"]:
            prior[int(p)] += 1
    prior /= prior.sum()

    for ds in datasets:
        ds.add_dynamic_item(lambda: prior, [], ["prior"])
        ds.set_output_keys(OUTPUT_KEYS)
    return datasets


def clean_with_saved_md_results(computed: Dict, saved: Dict, set_name: str,
                                json_name: str) -> None:
    """Apply a saved-MD-results dump to one computed set in place, with the
    JAX package's semantics: every set is cleaned, ``wav`` keys are left
    as they are, and (the JAX package's deliberate deviation from the
    reference) ONE invalid-frame set per utterance, from the
    ``fa_boundary_seq`` spans of the flagged phonemes, applies to every
    frame-length key, so that feat, flvl_* and fa_boundary_seq stay
    mutually consistent; boundary keys clean against the same set by
    marker remap. Utterances whose every phoneme is flagged are dropped;
    a dump that covers none of the set's utterances warns."""
    n_covered = sum(1 for u in computed if u in saved)
    if n_covered == 0:
        warnings.warn(
            f"saved MD results '{json_name}' cover 0/{len(computed)} "
            f"utterances of split '{set_name}': cleaning is a no-op for "
            "this split.  Dumps from cli.test only cover the TEST set; use "
            "cli.test_on_three_sets to dump results for every split before "
            "a cleaned retrain.")
    else:
        logger.info("data cleaning covers %d/%d utterances of split %s",
                    n_covered, len(computed), set_name)
    fully_excised = []
    for utt_id, sample in computed.items():
        if utt_id not in saved:
            continue
        flvl_len = len(sample["feat"])
        plvl_len = len(sample["gt_phn_seq"])
        if "fa_boundary_seq" in sample:
            invalid_frames = flagged_frame_indices(sample["fa_boundary_seq"],
                                                   saved[utt_id])
        else:  # no alignment key: the reference's percent addressing
            invalid_frames = None
        for key, data in sample.items():
            if "flvl_" in key or "feat" in key:
                assert len(data) == flvl_len
                if invalid_frames is not None:
                    sample[key] = apply_frame_saved_md_results(
                        data, invalid_frames)
                else:
                    sample[key] = apply_flvl_saved_md_results(
                        data, saved[utt_id])
            elif "boundary_" in key:
                assert len(data) == flvl_len
                if invalid_frames is not None:
                    sample[key] = clean_boundary_seq_remap(
                        data, saved[utt_id], invalid_frames)
                else:
                    sample[key] = apply_boundary_saved_md_results(
                        data, saved[utt_id])
            elif "_seq" in key:
                # phoneme-length keys: phn/cnncl/md/seg/phn_end seqs
                assert len(data) == plvl_len
                sample[key] = apply_plvl_saved_md_results(data,
                                                          saved[utt_id])
        if len(sample["gt_phn_seq"]) == 0 or len(sample["feat"]) == 0:
            # every phoneme flagged: nothing left to train on
            fully_excised.append(utt_id)
    for utt_id in fully_excised:
        del computed[utt_id]
    if fully_excised:
        logger.info(
            "data cleaning fully excised %d/%d utterances (every phoneme "
            "flagged); dropped: %s%s", len(fully_excised),
            len(computed) + len(fully_excised),
            ", ".join(fully_excised[:5]),
            "..." if len(fully_excised) > 5 else "")


def prepare_datasets(hparams, device=None
                     ) -> Tuple[List[DynamicItemDataset], LabelEncoder]:
    """The computed (train, valid, test) datasets and the label encoder.
    On a cache miss both feature passes run (``data_io_prep``) and every
    sample is materialized into ``computed_dataset/{set}.pkl``; otherwise
    the pickles are read. Then the saved MD results of
    ``saved_md_results_model_name`` clean every set when
    ``apply_saved_md_results`` is on."""
    logger.info("Preparing datasets.")
    dataset_dir = Path(hparams["prepare"]["dataset_dir"]).parent
    computed_dir = dataset_dir / "computed_dataset"

    if any(not (computed_dir / f"{s}.pkl").exists() for s in SET_NAMES):
        logger.info("Computing datasets (cache miss).")
        datasets = data_io_prep(hparams, device=device)
        computed_dir.mkdir(parents=True, exist_ok=True)
        for set_name, ds in zip(SET_NAMES, datasets):
            t0 = time.time()
            computed = {}
            for utt_id in ds.ids:
                sample = ds.compute_sample(utt_id)
                computed[utt_id] = {k: v for k, v in sample.items()
                                    if k != "id"}
            with open(computed_dir / f"{set_name}.pkl", "wb") as f:
                pickle.dump(computed, f)
            logger.info("materialized %s: %d utts in %.1fs",
                        set_name, len(computed), time.time() - t0)

    # duration-sorted data is never shuffled, on a cache hit as on a miss
    if hparams.get("sorting") in ("ascending", "descending") \
            and "train_dataloader_opts" in hparams:
        hparams["train_dataloader_opts"]["shuffle"] = False

    computed_datasets = []
    for set_name in SET_NAMES:
        with open(computed_dir / f"{set_name}.pkl", "rb") as f:
            computed = pickle.load(f)
        if hparams.get("apply_saved_md_results", False) and \
                hparams.get("saved_md_results_model_name") is not None:
            json_path = (
                Path("datasets") / hparams["dataset"] / "saved_md_results"
                / (hparams["saved_md_results_model_name"] + ".json"))
            with open(json_path) as f:
                saved = json.load(f)
            logger.info("Applying saved MD results (data cleaning).")
            clean_with_saved_md_results(computed, saved, set_name,
                                        json_path.name)
        computed_datasets.append(
            DynamicItemDataset(computed, output_keys=OUTPUT_KEYS))

    label_encoder = get_label_encoder(hparams)
    label_encoder.save(computed_dir / "label_encoder.txt")
    return computed_datasets, label_encoder
