"""Inference: per-phoneme mispronunciation verdicts for one utterance
(counterpart of ``mlvae_tpu/cli/infer.py``'s ``infer``).

``infer`` takes a wav file and the canonical phonemes as strings, as the
JAX entry does: it reads and resamples the wav, runs the recipe's
``compute_features`` (an ``ops.fbank.Fbank``, K6 on the card) and encodes
the phonemes. ``infer_features`` takes features (T, input_size) and
phoneme ids. Both build the JAX entry's single-utterance batch (uniform
forced-alignment boundaries, zero MD labels) and run the TEST-target eval
step. As the JAX entry, the batch holds the features under ``kaldi_feat``
too, which MD_VAE_sfl reads: a model trained on the Kaldi pass's features
is served the recipe's ``compute_features``. ``main`` is the command line, as the JAX entry's:

    python -m mlvae_tpu_torch.cli.infer config/run.yaml \
        --dataset ... --model_class MD_VAE --model_name my_run \
        --model '!include:mlvae_tpu_torch/models/MD_VAE/model.yaml' \
        --wav path/to/utt.wav --canonical "w ah n , t uw"

It builds the run as ``cli.test`` does, restores the best checkpoint by
the recipe's ``max_key`` / ``min_key``, takes the prior of the training
set and prints one verdict a phoneme.
"""
from __future__ import annotations

import logging
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from mlvae_tpu_torch.data.wav import read_wav, resample
from mlvae_tpu_torch.device import resolve_device

# frame shift in ms when the model's hparams name none: the recipes' fbank
# features are 20 ms apart (config/run.yaml ``hop_length``)
DEFAULT_HOP_MS = 20.0


def _uniform_boundary(T: int, L: int) -> np.ndarray:
    seq = np.zeros(T, np.float32)
    for i in range(L):
        seq[min(int(i * T / L), T - 1)] = 1
    return seq


def infer(model, hparams, label_encoder, wav_path,
          canonical_phonemes: Sequence[str], prior=None, device=None,
          noise: Optional[Dict] = None) -> List[Dict]:
    """One wav file -> one verdict per canonical phoneme, with the JAX
    entry's keys: ``phoneme`` (the string), ``start_sec`` (``None`` where
    the decode placed no boundary for it) and ``mispronounced``.
    ``hparams`` holds the keys the JAX entry reads: ``sample_rate``,
    ``hop_length`` (ms) and ``compute_features``. ``prior`` defaults to
    uniform over the label encoder's labels; ``noise`` replays the eval
    step's draws (see ``infer_features``)."""
    dev = resolve_device(device)
    wave, sr = read_wav(wav_path)
    if sr != hparams["sample_rate"]:
        wave = resample(wave, sr, hparams["sample_rate"])
    feats = hparams["compute_features"](
        torch.as_tensor(wave[None], device=dev))[0]
    cnncl = label_encoder.encode_sequence(canonical_phonemes)
    if prior is None:
        prior = np.full(len(label_encoder), 1.0 / len(label_encoder),
                        np.float32)
    verdicts = infer_features(model, feats, cnncl, prior, device=dev,
                              noise=noise)
    hop_s = hparams["hop_length"] / 1000.0
    return [{"phoneme": phn,
             "start_sec": None if v["start_frame"] is None
             else round(float(v["start_frame"]) * hop_s, 3),
             "mispronounced": v["mispronounced"]}
            for phn, v in zip(canonical_phonemes, verdicts)]


def infer_features(model, feats, canonical_ids: Sequence[int],
                   prior=None, device=None,
                   noise: Optional[Dict] = None) -> List[Dict]:
    """feats (T, C), an array or a tensor -> one verdict per canonical
    phoneme: its id, start frame and time (``None`` where the decode placed
    no boundary for it; the time uses ``model.hparams["hop_length"]`` in
    ms, 20 if absent) and whether it is mispronounced. The eval step's
    noise comes from a generator seeded with 0, as the JAX entry uses
    ``PRNGKey(0)``, or from ``noise`` (see ``MDVAE.compute_forward``)."""
    dev = resolve_device(device)
    feats = torch.as_tensor(feats, dtype=torch.float32, device=dev)
    T = feats.shape[0]
    L = len(canonical_ids)
    n_cls = model.hparams["n_phonemes"] + 2
    if prior is None:
        prior = np.full(n_cls, 1.0 / n_cls, np.float32)
    one = torch.ones(1, device=dev)

    def t(a, dtype=None):
        return torch.as_tensor(np.asarray(a)[None], dtype=dtype, device=dev)

    boundary = t(_uniform_boundary(T, L))
    batch = {
        "id": ["utt"],
        "feat": (feats[None], one),
        # the same features for a recipe that reads the Kaldi pass's
        # (MD_VAE_sfl), as the JAX entry serves them
        "kaldi_feat": (feats[None], one),
        "gt_cnncl_seq": (t(canonical_ids, torch.int64), one),
        "fa_boundary_seq": (boundary, one),
        "gt_boundary_seq": (boundary, one),
        "plvl_gt_md_lbl_seq": (torch.zeros((1, L), dtype=torch.int64,
                                           device=dev), one),
        "prior": (t(prior, torch.float32), one),
    }
    batch = model.prepare_batch(batch)
    gen = torch.Generator(device=dev).manual_seed(0)
    preds, _, _ = model.eval_step(batch, noise=noise, generator=gen)
    t_len = int(preds["decoded_t_lens"][0])
    l_len = int(preds["decoded_l_lens"][0])
    bnd = preds["decoded_boundary_seq"][0, :t_len].cpu().numpy()
    plvl = preds["decoded_plvl_md_lbl_seq"][0, :l_len].cpu().numpy()
    starts = np.where(bnd == 1)[0]
    hop_s = float(model.hparams.get("hop_length", DEFAULT_HOP_MS)) / 1000.0
    results = []
    for i, phn in enumerate(canonical_ids):
        decoded = i < len(starts) and i < len(plvl)
        results.append({
            "phoneme": int(phn),
            "start_frame": int(starts[i]) if decoded else None,
            "start_sec": round(float(starts[i]) * hop_s, 3)
            if decoded else None,
            "mispronounced": bool(plvl[i]) if decoded else None,
        })
    return results


def main(argv=None):
    logging.basicConfig(level=logging.INFO, stream=sys.stdout)
    args = list(argv if argv is not None else sys.argv[1:])

    def pop_opt(name):
        i = args.index(name)
        value = args[i + 1]
        del args[i:i + 2]
        return value

    wav_path = pop_opt("--wav")
    canonical = pop_opt("--canonical").replace(",", " ").split()

    from mlvae_tpu_torch.cli.experiment import prepare_experiment
    prepared = prepare_experiment(args, prepare_exp_dir=False)
    model, hparams = prepared["model"], prepared["hparams"]
    model.on_evaluate_start(max_key=hparams["model"].get("max_key"),
                            min_key=hparams["model"].get("min_key"))
    model.eval()
    results = infer(model, hparams, prepared["label_encoder"], wav_path,
                    canonical,
                    prior=np.asarray(prepared["datasets"][0][0]["prior"]),
                    device=prepared["device"])
    for r in results:
        verdict = "MISPRONOUNCED" if r["mispronounced"] else "ok"
        start = "       -" if r["start_sec"] is None \
            else f"{r['start_sec']:8.3f}"
        print(f"{start}s  {r['phoneme']:6s} {verdict}")
    return results


if __name__ == "__main__":
    main()
