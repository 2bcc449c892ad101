"""The port's entry points on corpora laid out as the real ones
(``mlvae_tpu_torch/data/corpus_layout.py``), on the CPU:

* ``fit`` and ``evaluate`` of MD_VAE on a small L2-ARCTIC corpus against
  the JAX package's at narrow widths, as ``tests/test_torch_cli.py`` holds
  them on the synthesized corpus: from the JAX model's weights with every
  draw replayed, each epoch's train and valid loss within rel 1e-4, then
  ``evaluate`` from the JAX run's best checkpoint with the decodes, the MD
  and boundary statistics and the saved MD results equal;
* ``prepare_experiment`` with ``--dataset L2_ARCTIC``, ``TIMIT`` (its
  waves as SPHERE) and ``ChineseDPA`` (``--language pinyin``):
  ``config/run.yaml``'s ``prepare:`` block resolves, the corpus is
  prepared and both feature passes run;
* ``cli.train`` of LSTM_FC with ``augmentation`` in the run YAML: its
  TRAIN stage reads the augmented features;
* ``cli.ingest`` over a TIMIT-like tree (raw and shorten SPHERE, RIFF at
  another rate, suffixes in either case): the written WAV files byte-equal
  to the JAX package's python path."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax

from mlvae_tpu import native as jax_native
from mlvae_tpu.cli.experiment import prepare_experiment as jax_prepare
from mlvae_tpu.cli.ingest import ingest as jax_ingest
from mlvae_tpu.data import data_io as jdio
from mlvae_tpu.data.wav import write_wav as jax_write_wav

from mlvae_tpu_torch.cli import ingest as ingest_cli
from mlvae_tpu_torch.cli import train as train_cli
from mlvae_tpu_torch.cli.experiment import prepare_experiment
from mlvae_tpu_torch.convert import from_jax
from mlvae_tpu_torch.data import corpus_layout
from mlvae_tpu_torch.training.checkpointer import Checkpointer
from test_shorten import FN_DIFF1, FN_DIFF2, TYPE_S16LH, _Encoder, _wave
from test_torch_cli import NARROW, RTOL, WEIGHTS, _JaxDraws, _Recorder

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
RECIPE = REPO / "mlvae_tpu_torch/models/MD_VAE/model.yaml"
JAX_RECIPE = REPO / "mlvae_tpu/models/MD_VAE/model.yaml"
# batches of 6: the train set's 15 utterances (12 in two debug batches),
# the valid set's 6 and the test set's 6 in one batch each, so that the
# JAX side compiles one step per target
BATCH = 6
L2_SPEAKERS = {s: 2 if s in ("HJK", "PNV", "YDCK") else 1
               for s in corpus_layout.L2_SPEAKERS}
CORPUS = {"L2_ARCTIC": ("english", 39), "TIMIT": ("english", 39),
          "ChineseDPA": ("pinyin", 62)}


def _write(name, seed=0):
    root = Path("datasets") / name
    if name == "L2_ARCTIC":
        return corpus_layout.write_l2_arctic(root, L2_SPEAKERS,
                                             seconds=(0.8, 1.4), seed=seed)
    if name == "TIMIT":
        return corpus_layout.write_timit(root, seconds=(0.8, 1.4),
                                         seed=seed)
    return corpus_layout.write_chinese_dpa(root, seconds=(0.8, 1.4),
                                           seed=seed)


def _args(name, dataset="L2_ARCTIC", recipe_class="MD_VAE", recipe=RECIPE,
          extra="", device=True, batch_size=BATCH, epochs=3, hparams=None):
    language, n_phonemes = CORPUS[dataset]
    args = [str(hparams or REPO / "config/run.yaml"),
            "--batch_size", str(batch_size), "--dataset", dataset,
            "--language", language, "--n_phonemes", str(n_phonemes),
            "--model_class", recipe_class, "--model_name", name,
            "--model", f"!include:{recipe}",
            "--extra_overrides", "{model: {n_epochs: %d%s}}" % (epochs,
                                                                extra),
            "--debug", "--debug_batches", "2"]
    return args + (["--device", "cpu"] if device else [])


@pytest.fixture()
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_fit_and_evaluate_on_l2_arctic_match_jax(workdir, monkeypatch):
    monkeypatch.setattr(jdio, "_native_lib", lambda: None)
    _write("L2_ARCTIC")
    extra = f", {WEIGHTS}, {NARROW}"
    jp = jax_prepare(_args("jx", recipe=JAX_RECIPE, extra=extra,
                           device=False), prepare_exp_dir=True)
    pp = prepare_experiment(_args("px", extra=extra))
    jm, pm = jp["model"], pp["model"]
    # the same batches: the port read the JAX package's computed sets
    for jds, pds in zip(jp["datasets"], pp["datasets"]):
        assert pds.ids == jds.ids and len(pds.ids) == 6 + 9 * (
            jds is jp["datasets"][0])
    jm.init_params()
    missing, unexpected = pm.load_state_dict(
        from_jax(jax.device_get(jm.params)), strict=False)
    assert not unexpected and all(k.startswith("normalizer.")
                                  for k in missing)
    pm.noise_source = _JaxDraws(jm.rng)
    jrec, prec = _Recorder(jm, np.asarray), \
        _Recorder(pm, lambda t: t.cpu().numpy())
    for prep, model in ((jp, jm), (pp, pm)):
        h = prep["hparams"]
        model.fit(h["model"]["epoch_counter"], prep["datasets"][0],
                  prep["datasets"][1],
                  train_loader_kwargs=h["train_dataloader_opts"],
                  valid_loader_kwargs=h["valid_dataloader_opts"])
    assert [s[:2] for s in prec.stages] == [s[:2] for s in jrec.stages] == \
        [(st, e) for e in (1, 2, 3) for st in ("TRAIN", "VALID")]
    for (name, epoch, got), (_, _, want) in zip(prec.stages, jrec.stages):
        np.testing.assert_allclose(got, want, rtol=RTOL,
                                   err_msg=f"{name} epoch {epoch}")

    jck = jm.checkpointer.find_checkpoint(max_key="plvl_md.F1")
    pm.checkpointer = Checkpointer(jck.path.parent)
    jrec.decodes.clear()
    prec.decodes.clear()
    pm.noise_source = _JaxDraws(jm.rng)
    for prep, model in ((jp, jm), (pp, pm)):
        model.evaluate(prep["datasets"][2], max_key="plvl_md.F1",
                       test_loader_kwargs=prep["hparams"][
                           "test_dataloader_opts"])
    assert len(prec.decodes) == len(jrec.decodes) == 1
    for (_, pids, got), (_, jids, want) in zip(prec.decodes, jrec.decodes):
        assert pids == jids
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for stats in ("plvl_md_stats", "boundary_stats"):
        assert pm.stats_loggers[stats].scores_list == \
            jm.stats_loggers[stats].scores_list
    md = workdir / "datasets/L2_ARCTIC/saved_md_results"
    assert json.loads((md / "px.json").read_text()) == \
        json.loads((md / "jx.json").read_text())


@pytest.mark.parametrize("dataset", sorted(CORPUS))
def test_prepare_experiment_on_each_corpus(workdir, dataset):
    written = _write(dataset, seed=1)
    prepared = prepare_experiment(_args(
        "prep", dataset=dataset, recipe_class="test_phn_classifier",
        recipe=REPO / "mlvae_tpu_torch/models/test_phn_classifier/"
        "model.yaml", extra=", phn_rnn_hidden_size: 16, phn_fc_size: 8",
        epochs=1))
    h = prepared["hparams"]
    assert h["dataset"] == dataset
    assert h["prepare"]["dataset_dir"] == \
        f"datasets/{dataset}/original_dataset"
    ids = [u for ds in prepared["datasets"] for u in ds.ids]
    assert sorted(ids) == sorted(u for utts in written.values()
                                 for u in utts)
    sample = prepared["datasets"][0].data[prepared["datasets"][0].ids[0]]
    assert sample["feat"].shape[1] == sample["kaldi_feat"].shape[1] == 120
    assert sample["feat"].shape[0] == sample["kaldi_feat"].shape[0]
    assert np.isfinite(sample["feat"]).all()
    # no augmentation named: the aug_* keys repeat the clean ones
    np.testing.assert_array_equal(sample["aug_feat"], sample["feat"])
    # the phoneme set and the blank
    assert len(prepared["label_encoder"]) == len(
        h["prepare"]["phoneme_set_handler"].get_phoneme_set()) + 1


def test_lstm_fc_trains_on_augmented_features(workdir):
    _write("L2_ARCTIC", seed=2)
    run_yaml = workdir / "run_aug.yaml"
    run_yaml.write_text((REPO / "config/run.yaml").read_text() + (
        "augmentation: !new:mlvae_tpu_torch.ops.augment.WaveAugment\n"
        "  speeds: [0.9, 1.1]\n"))
    model = train_cli.main(_args(
        "fc_aug", recipe_class="LSTM_FC",
        recipe=REPO / "mlvae_tpu_torch/models/LSTM_FC/model.yaml",
        extra=", lstm_hidden_size: 32, lstm_num_layers: 2, fc_size: 16, "
        "lr: 0.001", epochs=1, hparams=run_yaml))
    assert [e["epoch"] for e in model.epoch_log] == [1]
    assert np.isfinite(model.epoch_log[0]["loss"])
    import pickle
    with open(workdir / "datasets/L2_ARCTIC/computed_dataset/train.pkl",
              "rb") as f:
        train = pickle.load(f)
    for sample in train.values():
        assert sample["aug_feat"].shape == sample["feat"].shape
        assert not np.allclose(sample["aug_feat"], sample["feat"])
        assert not np.array_equal(sample["aug_wav"], sample["wav"])


@pytest.fixture()
def one_blas_thread():
    """The resampler's ``np.convolve`` runs on OpenBLAS's ``dot``: with its
    default of a thread a core it waited minutes for cores busy with other
    test processes (473 s in a six-worker run, 5 s alone). One thread, on
    both packages alike, takes seconds under any load."""
    with threadpool_limits(limits=1, user_api="blas"):
        yield


def test_ingest_wav_bytes_equal_to_jax(workdir, monkeypatch,
                                       one_blas_thread):
    def no_native():
        raise OSError("the native library is left out of this test")
    monkeypatch.setattr(jax_native, "load", no_native)
    src = workdir / "src"
    corpus_layout.write_timit(src, seconds=(0.3, 0.6), upper=True, seed=3)
    spk = src / "original_dataset/TRAIN/DR1/MABC0"
    y = _wave(4 * 64, seed=12)
    enc = _Encoder(TYPE_S16LH, nchan=1, blocksize=64)
    for i, fn in enumerate((FN_DIFF2, FN_DIFF1, FN_DIFF2, FN_DIFF1)):
        enc.block(0, fn, y[i * 64:(i + 1) * 64])
    payload = enc.finish()
    head = (b"NIST_1A\n   1024\nsample_rate -i 16000\nchannel_count -i 1\n"
            b"sample_n_bytes -i 2\nsample_count -i 250\n"
            b"sample_coding -s26 pcm,embedded-shorten-v2.00\n"
            b"sample_byte_format -s2 01\nend_head\n")
    (spk / "SX9.sph").write_bytes(head + b" " * (1024 - len(head))
                                  + payload)
    t = np.arange(2205) / 22050.0
    jax_write_wav(src / "riff/a.wav", 0.3 * np.sin(2 * np.pi * 220 * t),
                  22050)
    jax_write_wav(src / "riff/a.WAV", 0.1 * np.sin(2 * np.pi * 330 * t),
                  22050)   # same output name: skipped
    n_port = ingest_cli.main([str(src), str(workdir / "port"),
                              "--rate", "16000"])
    n_jax = jax_ingest(src, workdir / "jax", rate=16000)
    # four speakers' three SPHERE files, the shorten one, one of the RIFFs
    assert n_port == n_jax == 4 * 3 + 1 + 1
    files = sorted(p.relative_to(workdir / "jax")
                   for p in (workdir / "jax").rglob("*") if p.is_file())
    assert sorted(p.relative_to(workdir / "port")
                  for p in (workdir / "port").rglob("*")
                  if p.is_file()) == files
    for rel in files:
        assert (workdir / "port" / rel).read_bytes() == \
            (workdir / "jax" / rel).read_bytes(), rel
    assert Path("original_dataset/TRAIN/DR1/MABC0/SX9.wav") in files
