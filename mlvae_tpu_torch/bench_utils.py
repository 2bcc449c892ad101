"""Build the flagship MD_VAE model and synthetic batches without touching
the filesystem (counterpart of ``mlvae_tpu/bench_utils.py``).

The widths are the recipe's, copied from
``mlvae_tpu/models/MD_VAE/model.yaml`` (and MD_VAE_sfl's from its
``model.yaml``), with its Adam at ``lr``; ``overrides`` changes any of
them (narrow widths for the CPU tests).
``synth_batch`` draws the same numpy values as the JAX package's
``synth_batch`` for the same arguments. ``build_lstm_fc`` builds the
LSTM_FC recipe (``LSTM_FC_RECIPE``, from
``mlvae_tpu/models/LSTM_FC/model.yaml``) and ``synth_flvl_batch`` its
frame-level batches. ``build_crdnn_ctc`` builds the CRDNN_CTC recipe
(``CRDNN_RECIPE``, from ``mlvae_tpu/models/CRDNN_CTC/model.yaml``) and
``synth_ctc_batch`` its batches with pronounced and canonical phoneme
sequences. ``synth_wave`` and
``synth_wav_batch`` make audio for the wav front end: tones plus noise, as
``tests/test_fbank_pallas.py`` makes them.

The four BASELINE gate configs (``BASELINE.json`` ``configs[0..3]``) are
composed here as ``tests/test_gate_configs.py`` composes them in the JAX
package, each with its train step (``Gate``): gate 1 a ``VanillaVAE`` and a
``Linear`` head, gate 2 a ``ConvVAE``, gate 3 a GRU sequence VAE over
variable-length utterances, gate 4 a ``GroupedLatentVAE`` with
``group_elbo``. ``gate_batch`` draws the JAX test's inputs.
"""
from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import yaml
from torch import nn
from torch.func import functional_call

from mlvae_tpu_torch.device import resolve_device
from mlvae_tpu_torch.models.CRDNN_CTC.model import CRDNNCTC
from mlvae_tpu_torch.models.LSTM_FC.model import LSTMFC
from mlvae_tpu_torch.models.MD_VAE.model import MDVAE
from mlvae_tpu_torch.models.MD_VAE_sfl.model import MDVAESFL
from mlvae_tpu_torch.modules.conv_vae import ConvVAE
from mlvae_tpu_torch.modules.grouped_vae import GroupedLatentVAE, group_elbo
from mlvae_tpu_torch.modules.vanilla_vae import VanillaVAE
from mlvae_tpu_torch.nn import dist as D
from mlvae_tpu_torch.nn.layers import Linear
from mlvae_tpu_torch.nn.rnn import GRU
from mlvae_tpu_torch.training.brain import cast_floats, f32_gemm_sums
from mlvae_tpu_torch.training.optim import Adadelta, Adam
from mlvae_tpu_torch.utils.tensor import apply_lens_to_loss

N_PHONEMES = 12          # digits task (smoke-test scale)
N_CLASSES = N_PHONEMES + 2
INPUT_SIZE = 120         # 40 mel x 3 (static + delta + delta2)
SAMPLE_RATE = 16000      # the recipe's front end (config/run.yaml)
HOP = 320                # 20 ms

RECIPE = {
    "input_size": INPUT_SIZE,
    "n_phonemes": N_PHONEMES,
    "feat_fc_size": 64,
    "phn_rnn_hidden_size": 512,
    "phn_rnn_num_layers": 2,
    "phn_fc_size": 128,
    "phn_recog_fc_size": 32,
    "boundary_rnn_hidden_size": 512,
    "boundary_rnn_num_layers": 2,
    "boundary_fc_size": 128,
    "concat_fc_size": 128,
    "rnn_hidden_size": 512,
    "rnn_num_layers": 2,
    "rnn_dropout": 0.15,
    "pi_fc_size": 128,
    "latent_size": 32,
    "num_components": 3,
    "enc_fc_size": 64,
    "dec_rnn_hidden_size": 512,
    "dec_rnn_num_layers": 2,
    "dec_rnn_dropout": 0.15,
    "dec_fc_size": 64,
    # loss weights: the yaml's three, and 1.0 for the ones it defaults
    "boundary_kld_weight": 0.00001,
    "vae_kld_weight": 0.00001,
    "pi_nll_weight": 0.001,
    "phn_recog_bce_weight": 1.0,
    "boundary_bce_weight": 1.0,
    "recon_weight": 1.0,
    "kld_n_samples": 2249,
    "lr": 0.001,
}


# MD_VAE_sfl at the widths of mlvae_tpu/models/MD_VAE_sfl/model.yaml:
# MD_VAE's, the recognizer-output FC under its name there, a baseline head
# [512, 16, 16, 1], five π samples a training step, the Kaldi pass's
# features in, and every loss weight 1
SFL_RECIPE = {k: v for k, v in RECIPE.items() if k != "phn_recog_fc_size"}
SFL_RECIPE.update({
    "phn_recog_out_fc_size": 32,
    "baseline_fc_size": 16,
    "pi_mcmc_num": 5,
    "use_kaldi_feat": True,
    "boundary_kld_weight": 1.0,
    "vae_kld_weight": 1.0,
    "pi_nll_weight": 1.0,
    "rif_weight": 1.0,
    "entropy_weight": 1.0,
    "baseline_weight": 1.0,
})
# the recipes ``build_md_vae`` builds: widths and the step's class
MD_VAE_RECIPES = {"MD_VAE": (RECIPE, MDVAE),
                  "MD_VAE_sfl": (SFL_RECIPE, MDVAESFL)}


# the loss weights of the MD_VAE family; a recipe may leave some out of its
# YAML, and the model then takes 1.0 with a warning
# (``models/md_model.weighted_total``)
LOSS_WEIGHTS = ("recon_weight", "phn_recog_bce_weight",
                "boundary_bce_weight", "boundary_kld_weight",
                "vae_kld_weight", "pi_nll_weight", "rif_weight",
                "entropy_weight", "baseline_weight")


def unset_loss_weights(yaml_path) -> List[str]:
    """The ``LOSS_WEIGHTS`` that the recipe at ``yaml_path`` leaves out of
    its top-level keys (the YAML read with its tags ignored): the weights a
    run pins to 1.0 so that none falls to the warning's default."""
    class Keys(yaml.SafeLoader):
        pass
    Keys.add_multi_constructor("!", lambda loader, suffix, node: None)
    keys = yaml.load(Path(yaml_path).read_text(), Loader=Keys) or {}
    return [k for k in LOSS_WEIGHTS if k not in keys]


def build_md_vae(batch_size: int = 8, overrides=None, seed: int = 0,
                 device=None, bf16: bool = False,
                 recipe: str = "MD_VAE", run_opts=None) -> MDVAE:
    """``recipe`` (MD_VAE, or MD_VAE_sfl) at its widths with weights drawn
    from ``seed`` on ``device`` (None means CUDA), its optimizer states
    initialised. ``bf16`` turns AMP on for the training step, as the JAX
    bench's default ``--bf16`` does (``bench.py``); the eval step stays
    f32. ``run_opts`` adds run options (``data_parallel``, ``zero1``: the
    model is then placed on the rank's mesh)."""
    dev = resolve_device(device)
    widths, cls = MD_VAE_RECIPES[recipe]
    hparams = dict(widths, batch_size=batch_size)
    hparams.update(overrides or {})
    hparams.setdefault("optimizer", Adam(lr=hparams["lr"]))
    gen = torch.Generator(device="cpu").manual_seed(seed)
    model = cls(hparams, generator=gen,
                run_opts={"bf16": bf16, **(run_opts or {})}).to(dev).eval()
    return ready_to_step(model)


def ready_to_step(model):
    """A built model placed on its rank's mesh (none: nothing happens),
    its optimizer states initialised and, under ``--zero1``, split."""
    model.place_on_mesh()
    model.init_optimizers()
    model.setup_zero1()
    return model


# w2v_LSTM_FC at its recipe's widths (mlvae_tpu/models/w2v_LSTM_FC/
# model.yaml): the fine-tuned trunk, FC [1024, 64, 64, 1], Adam at 3e-4 on
# the classifier and 1e-4 on the trunk
W2V_FC_RECIPE = {"wav2vec2_size": 1024, "fc_size": 64, "lr": 3e-4,
                 "lr_wav2vec": 1e-4}


def build_w2v_lstm_fc(overrides=None, seed: int = 0, device=None,
                      bf16: bool = False, run_opts=None, **encoder_kw):
    """w2v_LSTM_FC's ``SBModel`` with weights drawn from ``seed`` on
    ``device``: the trunk at wav2vec2-large-lv60's topology for
    ``wav2vec2_size`` 1024 (24 layers, 16 heads, FFN 4096; a narrower size
    shrinks it as the recipe's ``output_size`` does; ``encoder_kw`` go to
    the encoder), ``freeze: False``."""
    from mlvae_tpu_torch.models.w2v_LSTM_FC.model import SBModel
    from mlvae_tpu_torch.modules.fc_block import FCBlock
    from mlvae_tpu_torch.modules.wav2vec2 import Wav2Vec2Encoder
    dev = resolve_device(device)
    h = dict(W2V_FC_RECIPE, **(overrides or {}))
    gen = torch.Generator(device="cpu").manual_seed(seed)
    size = h["wav2vec2_size"]
    modules = {
        "wav2vec2": Wav2Vec2Encoder(**{
            "source": "", "output_size": size, "output_norm": True,
            "freeze": False, "generator": gen, **encoder_kw}),
        "classifier": FCBlock([size, h["fc_size"], h["fc_size"], 1],
                              generator=gen)}
    hparams = {"optimizers": {
        "adam_opt": {"opt_class": Adam(lr=h["lr"]),
                     "modules": ["classifier"]},
        "wav2vec_opt": {"opt_class": Adam(lr=h["lr_wav2vec"]),
                        "modules": ["wav2vec2"]}}}
    model = SBModel(modules, hparams,
                    run_opts={"bf16": bf16, **(run_opts or {})}).to(
        dev).eval()
    return ready_to_step(model)


def synth_w2v_fc_batch(batch_size: int = 4, samples: int = 16000,
                       seed: int = 0, device=None, conv_output_length=None
                       ) -> Dict[str, Tuple]:
    """A synthetic w2v_LSTM_FC batch on ``device``: ``wav`` (B, samples),
    ``feat`` (B, T, 120) and ``flvl_gt_md_lbl_seq`` (B, T) at the trunk's
    frame count T, relative lengths 1.0 down to 0.8."""
    from mlvae_tpu_torch.modules.wav2vec2 import conv_output_length as col
    dev = resolve_device(device)
    rs = np.random.RandomState(seed)
    T = (conv_output_length or col)(samples)
    wav = rs.randn(batch_size, samples).astype(np.float32)
    lens = np.linspace(1.0, 0.8, batch_size).astype(np.float32)
    feats = rs.randn(batch_size, T, INPUT_SIZE).astype(np.float32)
    md = (rs.rand(batch_size, T) < MISP_RATE).astype(np.int64)

    def t(a):
        return torch.from_numpy(a).to(dev)

    return {"wav": (t(wav), t(lens)), "feat": (t(feats), t(lens)),
            "flvl_gt_md_lbl_seq": (t(md), t(lens))}


def synth_batch(batch_size: int = 8, T: int = 160, L: int = 8,
                seed: int = 0, device=None) -> Dict[str, Tuple]:
    """Synthetic batch with the MD_VAE input contract, on ``device``."""
    dev = resolve_device(device)
    rs = np.random.RandomState(seed)
    feats = rs.randn(batch_size, T, INPUT_SIZE).astype(np.float32)
    feat_lens = np.linspace(1.0, 0.8, batch_size).astype(np.float32)
    cnncl = rs.randint(2, N_PHONEMES, (batch_size, L)).astype(np.int64)
    cnncl_lens = np.full((batch_size,), 1.0, np.float32)
    boundary = np.zeros((batch_size, T), np.float32)
    t_lens = np.round(feat_lens * T).astype(int)
    for i in range(batch_size):
        starts = np.sort(rs.choice(np.arange(1, t_lens[i]), L - 1,
                                   replace=False))
        boundary[i, 0] = 1
        boundary[i, starts] = 1
    prior = rs.dirichlet(np.ones(N_CLASSES)).astype(np.float32)
    prior_b = np.tile(prior, (batch_size, 1))
    md = rs.randint(0, 2, (batch_size, L)).astype(np.int64)

    def t(a):
        return torch.from_numpy(a).to(dev)

    batch = {
        "feat": (t(feats), t(feat_lens)),
        "gt_cnncl_seq": (t(cnncl), t(cnncl_lens)),
        "fa_boundary_seq": (t(boundary), t(feat_lens)),
        "gt_boundary_seq": (t(boundary), t(feat_lens)),
        "plvl_gt_md_lbl_seq": (t(md), t(cnncl_lens)),
        "prior": (t(prior_b), t(cnncl_lens)),
    }
    return batch


# LSTM_FC at the widths of mlvae_tpu/models/LSTM_FC/model.yaml: fbank with
# deltas in, a 4-layer LSTM at H=1024 with dropout 0.1 between layers,
# FCBlock [1024, 64, 64, 2], BCE with the mispronunciation logit weighted
# 10, Adam at the recipe's lr 1.0
LSTM_FC_RECIPE = {
    "input_size": INPUT_SIZE,
    "lstm_hidden_size": 1024,
    "lstm_num_layers": 4,
    "lstm_dropout": 0.1,
    "fc_sizes": [1024, 64, 64, 2],
    "misp_weight": 10,
    "lr": 1.0,
}


def build_lstm_fc(batch_size: int = 8, overrides=None, seed: int = 0,
                  device=None, bf16: bool = False) -> LSTMFC:
    """LSTM_FC at ``LSTM_FC_RECIPE``'s widths with weights drawn from
    ``seed`` on ``device`` (None means CUDA), its optimizer states
    initialised. ``overrides`` changes any width (``fc_sizes[0]`` must be
    ``lstm_hidden_size``). ``bf16`` turns AMP on for the training step, as
    the JAX bench's ``--bf16`` does; the eval step stays f32."""
    dev = resolve_device(device)
    hparams = dict(LSTM_FC_RECIPE, batch_size=batch_size)
    hparams.update(overrides or {})
    hparams.setdefault("optimizer", Adam(lr=hparams["lr"]))
    gen = torch.Generator(device="cpu").manual_seed(seed)
    model = LSTMFC(hparams, generator=gen, run_opts={"bf16": bf16}).to(
        dev).eval()
    model.init_optimizers()
    return model


MISP_RATE = 0.2   # the share of frames labelled mispronounced


def synth_flvl_batch(batch_size: int = 8, T: int = 160, seed: int = 0,
                     device=None) -> Dict[str, Tuple]:
    """A synthetic LSTM_FC batch on ``device``: ``feat`` (B, T, 120) and its
    augmented twin ``aug_feat`` (the same plus noise at 0.1), and the
    frame-level MD labels ``flvl_gt_md_lbl_seq`` and
    ``aug_flvl_gt_md_lbl_seq`` (B, T), 1 on ``MISP_RATE`` of the frames,
    every one with ``synth_batch``'s relative lengths (1.0 down to 0.8)."""
    dev = resolve_device(device)
    rs = np.random.RandomState(seed)
    feats = rs.randn(batch_size, T, INPUT_SIZE).astype(np.float32)
    aug = (feats + 0.1 * rs.randn(batch_size, T, INPUT_SIZE)).astype(
        np.float32)
    lens = np.linspace(1.0, 0.8, batch_size).astype(np.float32)
    md = (rs.rand(batch_size, T) < MISP_RATE).astype(np.int64)

    def t(a):
        return torch.from_numpy(a).to(dev)

    return {"feat": (t(feats), t(lens)), "aug_feat": (t(aug), t(lens)),
            "flvl_gt_md_lbl_seq": (t(md), t(lens)),
            "aug_flvl_gt_md_lbl_seq": (t(md.copy()), t(lens))}


# CRDNN_CTC at the widths of mlvae_tpu/models/CRDNN_CTC/model.yaml: two CNN
# blocks of (128, 256) channels with 3x3 kernels, time pooling 2, a 4-layer
# bidirectional LSTM at H=512 (its first layer's input 256 x 30 = 7,680),
# two DNN blocks of 512, dropout 0.15, n_phonemes + 2 outputs, Adadelta at
# lr 1.0, rho 0.95, eps 1e-8
CRDNN_RECIPE = {
    "input_size": INPUT_SIZE,
    "n_phonemes": N_PHONEMES,
    "dropout": 0.15,
    "cnn_blocks": 2,
    "cnn_channels": (128, 256),
    "cnn_kernelsize": (3, 3),
    "rnn_layers": 4,
    "rnn_neurons": 512,
    "rnn_bidirectional": True,
    "dnn_blocks": 2,
    "dnn_neurons": 512,
    "blank_index": 0,
    "lr": 1.0,
    "rho": 0.95,
    "eps": 1e-8,
}


def build_crdnn_ctc(batch_size: int = 8, overrides=None, seed: int = 0,
                    device=None, bf16: bool = False) -> CRDNNCTC:
    """CRDNN_CTC at ``CRDNN_RECIPE``'s widths with weights drawn from
    ``seed`` on ``device`` (None means CUDA), its Adadelta states
    initialised. ``bf16`` turns AMP on for the training step, as
    ``--bf16`` does; the eval forward stays f32."""
    dev = resolve_device(device)
    hparams = dict(CRDNN_RECIPE, batch_size=batch_size)
    hparams.update(overrides or {})
    hparams.setdefault("optimizer", Adadelta(
        lr=hparams["lr"], rho=hparams["rho"], eps=hparams["eps"]))
    gen = torch.Generator(device="cpu").manual_seed(seed)
    model = CRDNNCTC(hparams, generator=gen, device="cpu",
                     run_opts={"bf16": bf16}).to(dev).eval()
    model.init_optimizers()
    return model


def synth_ctc_batch(batch_size: int = 8, T: int = 160, L: int = 32,
                    seed: int = 0, device=None) -> Dict[str, Tuple]:
    """A synthetic CRDNN_CTC batch on ``device``: ``feat`` (B, T, 120) with
    ``synth_batch``'s relative lengths (1.0 down to 0.8); the pronounced
    phonemes ``gt_phn_seq`` (B, L), ids 1 .. n_phonemes (0 is the blank),
    relative lengths 1.0 down to 0.75; the canonical ``gt_cnncl_seq``, the
    same with about a fifth of the phonemes substituted; and
    ``gt_boundary_seq`` (B, T), one start frame per canonical phoneme."""
    dev = resolve_device(device)
    rs = np.random.RandomState(seed)
    feats = rs.randn(batch_size, T, INPUT_SIZE).astype(np.float32)
    feat_lens = np.linspace(1.0, 0.8, batch_size).astype(np.float32)
    phn = rs.randint(1, N_PHONEMES + 1, (batch_size, L)).astype(np.int64)
    sub = rs.rand(batch_size, L) < MISP_RATE
    cnncl = np.where(sub, rs.randint(1, N_PHONEMES + 1, (batch_size, L)),
                     phn).astype(np.int64)
    phn_lens = np.linspace(1.0, 0.75, batch_size).astype(np.float32)
    l_abs = np.round(phn_lens * L).astype(int)
    t_abs = np.round(feat_lens * T).astype(int)
    boundary = np.zeros((batch_size, T), np.float32)
    for i in range(batch_size):
        starts = np.sort(rs.choice(np.arange(1, t_abs[i]), l_abs[i] - 1,
                                   replace=False))
        boundary[i, 0] = 1
        boundary[i, starts] = 1

    def t(a):
        return torch.from_numpy(a).to(dev)

    return {"feat": (t(feats), t(feat_lens)),
            "gt_phn_seq": (t(phn), t(phn_lens)),
            "gt_cnncl_seq": (t(cnncl), t(phn_lens)),
            "gt_boundary_seq": (t(boundary), t(feat_lens))}


def synth_wave(n: int, seed: int = 0, scale: float = 8000.0,
               am_hz: float = 0.0) -> np.ndarray:
    """(n,) float32 audio: 220 Hz and 1330 Hz tones at ``scale`` plus
    Gaussian noise at ``scale / 80``; the default is int16-scale (noise of
    100, as ``tests/test_fbank_pallas.py``), ``scale / 32768`` gives
    read_wav's [-1, 1]. ``am_hz`` > 0 modulates the whole by an envelope
    from 0.2 to 1.2 at that rate, so that every band's energy moves from
    frame to frame as in speech (a steady tone leaves a band's per-speaker
    deviation near zero, and CMVN then divides by it)."""
    rs = np.random.RandomState(seed)
    t = np.arange(n) / float(SAMPLE_RATE)
    sig = np.sin(2 * np.pi * 220 * t) + 0.3 * np.sin(2 * np.pi * 1330 * t)
    wave = scale * sig + (scale / 80.0) * rs.randn(n)
    if am_hz > 0:
        wave = wave * (0.2 + np.abs(np.sin(2 * np.pi * am_hz * t)))
    return wave.astype(np.float32)


def synth_wav_batch(batch_size: int = 64, T: int = 160, seed: int = 0,
                    device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Waves in [-1, 1], (B, (T-1)*HOP), on ``device``, and their lengths
    (B,) on the host, as a caller knows them from the files: wave i has the
    frame count ``synth_batch`` gives row i (T for the first), so that
    ``Fbank(deltas=True)`` of the batch is the ``feat`` of
    ``synth_batch(batch_size, T, ...)``."""
    dev = resolve_device(device)
    t_lens = np.round(np.linspace(1.0, 0.8, batch_size) * T).astype(int)
    lengths = (t_lens - 1) * HOP
    waves = np.zeros((batch_size, (T - 1) * HOP), np.float32)
    for i, n in enumerate(lengths):
        waves[i, :n] = synth_wave(int(n), seed + i) / 32768.0
    return (torch.from_numpy(waves).to(dev),
            torch.from_numpy(lengths.astype(np.int64)))


# ---------------------------------------------------------------------------
# The BASELINE gate configs
# ---------------------------------------------------------------------------

# gate 3 at the recipe's widths: fbank with deltas in, H=512 as every RNN of
# the recipe, MD_VAE's latent; one layer each, as the gate composes them
GATE3_RECIPE = {"C": INPUT_SIZE, "H": 512, "LAT": 32}
# each gate's shapes in tests/test_gate_configs.py
GATE_TEST = {1: {"B": 1, "T": 50, "C": 80},
             2: {"B": 8, "H": 16, "W": 40},
             3: {"B": 4, "T": 24, "C": 20, "H": 32, "LAT": 8},
             4: {"B": 6, "T": 20, "C": 24}}
GATE_LENS = {3: [1.0, 0.9, 0.75, 0.5], 4: [1.0, 1.0, 0.8, 0.7, 0.6, 0.5]}


class Gate(nn.Module):
    """One gate composition and its train step: the loss of ``forward``'s
    predictions (``objective``), its gradient by autograd, then one step of
    the port's ``Adam`` over all the parameters, as ``optax.adam`` steps
    them in the JAX test (no clip). ``noise`` holds the step's standard
    normal draws by the names and shapes of ``draws``. With ``amp`` the
    forward runs on bf16 parameters and a bf16 batch
    (``training.brain.cast_floats``, the relative lengths kept f32), as
    ``Brain.train_step`` runs it under ``auto_mix_prec``; the predictions
    come back in f32, the grads reach the f32 parameters, and the Adam
    states stay f32."""

    lr = 1e-2   # the JAX test's optax.adam(1e-2)

    def __init__(self, amp: bool = False):
        super().__init__()
        self.amp = bool(amp)

    def init_optimizer(self) -> None:
        self.opt = Adam(lr=self.lr)
        self.opt_state = self.opt.init(list(self.parameters()))

    def draws(self, batch: Dict) -> Dict[str, Tuple[int, ...]]:
        raise NotImplementedError

    def objective(self, preds: Dict, batch: Dict) -> torch.Tensor:
        raise NotImplementedError

    def loss(self, batch: Dict, noise: Dict) -> torch.Tensor:
        if not self.amp:
            return self.objective(self(batch, noise), batch)
        params = {n: p.to(torch.bfloat16)
                  for n, p in self.named_parameters()}
        preds = functional_call(
            self, params, (cast_floats(batch, torch.bfloat16, 2), noise))
        return self.objective(cast_floats(preds, torch.float32), batch)

    def train_step(self, batch: Dict, noise: Dict) -> torch.Tensor:
        """One step; returns the loss before it, detached. Afterwards each
        parameter's ``.grad`` holds the gradient that was applied. Under
        AMP the GEMMs of the forward and the backward sum in f32."""
        params = list(self.parameters())
        for p in params:
            p.grad = None
        with (f32_gemm_sums() if self.amp else contextlib.nullcontext()):
            loss = self.loss(batch, noise)
            loss.backward()
        grad = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1)
                          for p in params])
        self.opt.step(params, grad, self.opt_state)
        return loss.detach()


class DenseGate(Gate):
    """Gate 1: a dense MLP-VAE on the log-mel frames of one utterance and a
    linear reconstruction head."""

    def __init__(self, C: int, amp: bool = False,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(amp)
        kw = dict(generator=generator, device=device)
        self.vae = VanillaVAE([C, 32, 32], 8, **kw)
        self.head = Linear(8, C, **kw)

    def draws(self, batch):
        B, T, _ = batch["feats"].shape
        return {"eps": (B, T, 8)}

    def forward(self, batch, noise):
        out = self.vae(batch["feats"], eps=noise["eps"])
        return {"recon": self.head(out["sampled_h"]), "loss": out["loss"]}

    def objective(self, preds, batch):
        return ((preds["recon"] - batch["feats"]) ** 2).mean() \
            + 1e-3 * preds["loss"].mean()


class ConvGate(Gate):
    """Gate 2: the conv encoder/decoder VAE on fixed-size spectrogram
    patches."""

    def __init__(self, patch_shape: Sequence[int], amp: bool = False,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(amp)
        self.vae = ConvVAE(patch_shape, 16, channels=(8, 16),
                           generator=generator, device=device)

    def draws(self, batch):
        return {"eps": (batch["patches"].shape[0], 16)}

    def forward(self, batch, noise):
        return self.vae(batch["patches"], eps=noise["eps"])

    def objective(self, preds, batch):
        return preds["recon_loss"].mean() + 1e-3 * preds["loss"].mean()


class GRUGate(Gate):
    """Gate 3: a GRU encoder, mean / log-var heads, the reparameterised
    per-frame latent, a bidirectional GRU decoder and an output head, under
    the masked loss ``apply_lens_to_loss(recon^2) + 1e-3 *
    apply_lens_to_loss(kld)``. Each step launches K5-fwd three times (the
    encoder, the decoder's two directions) and K5-bwd three times."""

    def __init__(self, C: int, H: int, LAT: int, amp: bool = False,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(amp)
        kw = dict(generator=generator, device=device)
        self.enc = GRU(C, H, num_layers=1, **kw)
        self.dec = GRU(LAT, H, num_layers=1, bidirectional=True, **kw)
        self.mean = Linear(H, LAT, **kw)
        self.log_var = Linear(H, LAT, **kw)
        self.out = Linear(2 * H, C, **kw)
        self.latent = LAT

    def draws(self, batch):
        B, T, _ = batch["feats"].shape
        return {"eps": (B, T, self.latent)}

    def forward(self, batch, noise):
        h, _ = self.enc(batch["feats"])
        mean, log_var = self.mean(h), self.log_var(h)
        z = D.reparameterize(mean, log_var, eps=noise["eps"])
        dh, _ = self.dec(z)
        return {"recon": self.out(dh), "mean": mean, "log_var": log_var}

    def objective(self, preds, batch):
        lens = batch["lens"]
        return apply_lens_to_loss((preds["recon"] - batch["feats"]) ** 2,
                                  lens) \
            + 1e-3 * apply_lens_to_loss(
                D.kld_std_normal(preds["mean"], preds["log_var"]), lens)


class GroupedGate(Gate):
    """Gate 4: the multi-level VAE with grouped (utterance and frame)
    latents under the group-ELBO."""

    def __init__(self, C: int, amp: bool = False,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(amp)
        self.vae = GroupedLatentVAE([C, 32, 32], 6, 4, [32, C],
                                    generator=generator, device=device)

    def draws(self, batch):
        B, T, _ = batch["feats"].shape
        return {"eps_frame": (B, T, 6), "eps_utt": (B, 4)}

    def forward(self, batch, noise):
        return self.vae(batch["feats"], batch["lens"], **noise)

    def objective(self, preds, batch):
        return group_elbo(preds, batch["feats"], batch["lens"],
                          kld_weight=1e-3)


def build_gate(n: int, seed: int = 0, device=None, amp: bool = False,
               full_width: bool = False) -> Gate:
    """Gate ``n`` (1-4) at the JAX test's shapes, weights drawn from
    ``seed`` on ``device`` (None means CUDA), its Adam state initialised;
    ``full_width`` builds gate 3 at ``GATE3_RECIPE``'s widths."""
    dev = resolve_device(device)
    kw = dict(amp=amp, generator=torch.Generator(device="cpu").manual_seed(
        seed))
    if n == 1:
        gate = DenseGate(GATE_TEST[1]["C"], **kw)
    elif n == 2:
        gate = ConvGate((GATE_TEST[2]["H"], GATE_TEST[2]["W"]), **kw)
    elif n == 3:
        w = GATE3_RECIPE if full_width else GATE_TEST[3]
        gate = GRUGate(w["C"], w["H"], w["LAT"], **kw)
    elif n == 4:
        gate = GroupedGate(GATE_TEST[4]["C"], **kw)
    else:
        raise ValueError(f"no gate {n}: the gates are 1-4")
    gate = gate.to(dev)
    gate.init_optimizer()
    return gate


def gate_batch(n: int, device=None, B: Optional[int] = None,
               T: Optional[int] = None, C: Optional[int] = None
               ) -> Dict[str, torch.Tensor]:
    """Gate ``n``'s batch as ``tests/test_gate_configs.py`` draws it (the
    same numpy values), on ``device``. Gate 3 also takes other ``B``, ``T``
    and ``C`` (its full width); its relative lengths are then those of
    ``synth_batch``'s rows."""
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    if n not in GATE_TEST:
        raise ValueError(f"no gate {n}: the gates are 1-4")
    S = GATE_TEST[n]
    rs = np.random.RandomState({1: 0, 2: 1, 3: 2, 4: 4}[n])
    if n == 2:
        return {"patches": t(rs.randn(S["B"], S["H"], S["W"]) * 0.3)}
    if n == 3 and (B, T, C) != (None, None, None):
        B, T, C = B or S["B"], T or S["T"], C or S["C"]
        return {"feats": t(rs.randn(B, T, C) * 0.3),
                "lens": t(np.linspace(1.0, 0.8, B))}
    feats = t(rs.randn(S["B"], S["T"], S["C"]) * 0.3)
    return {"feats": feats} if n == 1 else \
        {"feats": feats, "lens": t(GATE_LENS[n])}
