"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package (nor ``transformers``: the wav2vec2 snapshot loader reads its
files with ``json`` and ``torch``), its entry points refuse to run without
CUDA unless asked for the CPU, and its chip smoke refuses to run without a
card or without the repo."""
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mlvae_tpu_torch.bench_utils import build_md_vae, synth_batch
from mlvae_tpu_torch.bench_utils import synth_wav_batch
from mlvae_tpu_torch.cli import infer as infer_cli
from mlvae_tpu_torch.cli import test as test_cli
from mlvae_tpu_torch.cli import test_external as test_external_cli
from mlvae_tpu_torch.cli import test_on_three_sets as three_sets_cli
from mlvae_tpu_torch.cli import train as train_cli
from mlvae_tpu_torch.cli.experiment import prepare_experiment
from mlvae_tpu_torch.cli.infer import infer, infer_features
from mlvae_tpu_torch.data.data_io import compute_kaldi_features
from mlvae_tpu_torch.device import resolve_device
from mlvae_tpu_torch.hyperyaml import load_hyperyaml
from mlvae_tpu_torch.ops.decode import md_viterbi_batch
from mlvae_tpu_torch.ops.fbank import (KALDI, SB, Fbank, KaldiFbank,
                                        fbank_frames)
from mlvae_tpu_torch.ops.lstm import lstm_layer_fwd

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "mlvae_tpu_torch"
# the CLI's arguments without --device: the run is on CUDA
CLI_ARGS = [str(REPO / "config/run.yaml"), "--dataset", "SynAudioMNIST",
            "--language", "digits", "--n_phonemes", "12", "--model_class",
            "MD_VAE", "--model_name", "x", "--model",
            f"!include:{PORT / 'models/MD_VAE/model.yaml'}"]


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        parts = list(path.relative_to(REPO).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'mlvae_tpu', 'transformers'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", sorted(
    p.relative_to(REPO).as_posix() for p in
    list(PORT.rglob("*.py")) + list(PORT.rglob("*.cu"))
    + [REPO / "chip_smoke.py", REPO / "chip_w2v.py"]))
def test_port_sources_never_name_jax(path):
    text = (REPO / path).read_text()
    assert not re.search(r"^\s*(import|from)\s+jax", text, re.M), path
    assert not re.search(r"\bmlvae_tpu\.", text), path
    assert not re.search(r"^\s*(import|from)\s+transformers", text,
                         re.M), path


def test_encoder_attention_is_plain_torch_ops():
    """The wav2vec2 attention is matmuls and a softmax, as the JAX
    module's, never ``scaled_dot_product_attention``."""
    text = (PORT / "modules/wav2vec2.py").read_text()
    code = "\n".join(ln for ln in text.splitlines()
                     if not ln.lstrip().startswith(("#", "``")))
    assert "scaled_dot_product_attention(" not in code
    assert "torch.softmax(scores" in code


@pytest.mark.parametrize("entry", ["resolve_device", "build_md_vae",
                                   "synth_batch", "infer_features", "infer",
                                   "Fbank", "KaldiFbank",
                                   "compute_kaldi_features",
                                   "synth_wav_batch", "load_hyperyaml",
                                   "prepare_experiment", "cli.train",
                                   "cli.test", "cli.infer",
                                   "cli.test_on_three_sets",
                                   "cli.test_external"])
def test_entry_points_default_to_cuda(entry, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    calls = {
        "resolve_device": lambda: resolve_device(None),
        "build_md_vae": lambda: build_md_vae(),
        "synth_batch": lambda: synth_batch(2, 8, 2),
        "infer_features": lambda: infer_features(None, [[0.0]], [1]),
        "infer": lambda: infer(None, {}, None, "utt.wav", ["a"]),
        "Fbank": lambda: Fbank(deltas=True)([0.0] * 800),
        "KaldiFbank": lambda: KaldiFbank()([0.0] * 800),
        "compute_kaldi_features": lambda: compute_kaldi_features({}, "test"),
        "synth_wav_batch": lambda: synth_wav_batch(2, 8),
        "load_hyperyaml": lambda: load_hyperyaml(
            "fc: !new:modules.fc_block.FCBlock\n    fc_sizes: [2, 3]\n"),
        "prepare_experiment": lambda: prepare_experiment(CLI_ARGS),
        "cli.train": lambda: train_cli.main(CLI_ARGS),
        "cli.test": lambda: test_cli.main(CLI_ARGS),
        "cli.infer": lambda: infer_cli.main(
            CLI_ARGS + ["--wav", "utt.wav", "--canonical", "one"]),
        "cli.test_on_three_sets": lambda: three_sets_cli.main(CLI_ARGS),
        "cli.test_external": lambda: test_external_cli.main(CLI_ARGS),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()
    assert resolve_device("cpu").type == "cpu"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    """A tensor that lies neither on the CPU nor on a CUDA device is
    refused, never quietly decoded or run by the plain version."""
    gx = torch.empty((4, 2, 64), device="meta")
    with pytest.raises(ValueError):
        lstm_layer_fwd(gx, torch.empty((64, 16), device="meta"))
    yx = torch.empty((2, 4, 5, 2), device="meta")
    with pytest.raises(ValueError):
        md_viterbi_batch(yx, torch.empty((5, 2), device="meta"),
                         torch.empty((2, 3), dtype=torch.int32,
                                     device="meta"),
                         torch.empty((2, 4, 2), device="meta"),
                         torch.empty((2, 4, 2), device="meta"),
                         torch.empty((2,), device="meta"),
                         torch.empty((2,), device="meta"))


@pytest.mark.parametrize("mode", [KALDI, SB])
def test_fbank_wrapper_takes_the_plain_version_only_on_the_cpu(mode):
    """K6's wrapper refuses a tensor on neither the CPU nor a CUDA device
    (never computing it with the plain version), and on the CPU gives the
    plain version's (rows, n_mels)."""
    n = 512 if mode == KALDI else 400
    with pytest.raises(ValueError):
        fbank_frames(torch.empty((4, n), device="meta"), mode)
    assert fbank_frames(torch.zeros((3, n)), mode).shape == (3, 40)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card_or_the_repo(alone, tmp_path):
    script = REPO / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    res = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout == ""
