#!/usr/bin/env python3
"""Time the port's recurrence kernels and its steps in two checkouts on one
NVIDIA card, in turns.

    python3 chip_ab.py [--only lstm_bwd|fbank|unroll|fused_f32_bwd|
                              fused_f32_fwd] OTHER_CHECKOUT [...]

runs OTHER_CHECKOUT, this checkout, this checkout, OTHER_CHECKOUT (with
several, the others in order, this checkout twice, the others in reverse
order), each in a fresh process that builds that checkout's kernels and
times, with CUDA events after warm-up, K1-fwd (B=64 and 128), K1-bwd,
K3/K4-fwd (In=128, 512, 1024) and K3-bwd (In=512), K4-bwd (In=1024) at
T=160, B=64, H=512, the MD_VAE eval step and the AMP and f32 VAE train
steps at B=64, T=160, on inputs from fixed seeds, a digest of each
kernel's outputs (K1-bwd also at the ragged B=70) and of each train
step's first loss; and, in a checkout that has them, the wide K1-fwd and
K1-bwd at H=1024 (digests at B=64, K1-bwd also at B=70, and times) and
LSTM_FC's f32 train step (time, digest of its first loss), and where they
exist the same for the wide builds on bf16 streams (K1-bwd's dW_hh also
digested alone) and LSTM_FC's AMP train step; and K5 (the GRU recurrence
kernels) in f32 and on bf16 streams, digests of K5-fwd's and K5-bwd's
outputs at B=64 and 70, both directions, their times at gate 3's shape
(T=160, B=64, H=512), and gate 3's f32 and AMP train steps (time, digest
of the first loss); and K2 (the MD-Viterbi decode at B=64, T=160, L=8)
and K6 (the filterbank on the Kaldi pass's batch and, in SpeechBrain
mode, the wav-in eval batch: the build the frame width takes, and the
DFT build ``csrc/fbank.cu`` alone where a checkout has more than one
build), a digest and a time each. Each run prints one line
``AB <root> <JSON of ms and digests>``; the card's name and power limit
come first. It compares
two versions of code that both checkouts have (a parent and its change):
a change that may slow an earlier path is held against its parent here.
``--only lstm_bwd`` times K1-bwd alone (B=64, and its digests at B=64 and
70 from inputs of their own), and ``--only fbank`` K6 alone (the build
each width takes, on the Kaldi pass's batch and the wav-in eval batch:
digests, and ``FBANK_SAMPLES`` times each), and ``--only unroll`` the
K-unrolled forwards alone (K7a in f32 and on bf16 streams, K7b on bf16
streams, at the unroll bench's B=128, T=160, H=512, In=512: digests of
each at K 2, 4, 8 and of its one-step twin, both directions, and their
times), and ``--only fused_f32_bwd`` the fused backwards on f32 streams
alone (K3-bwd at In=128, K4-bwd at In=512, T=160, H=512: times at B=64,
70 and 256, digests of both directions' outputs at B=64 and 70; and
digests of K3/K4-fwd f32 at In 128 and 512 and of K7b f32 at K 2, 4, 8,
both directions, at B=64 and 128), and ``--only fused_f32_fwd`` the fused
forwards on f32 streams alone (K3/K4-fwd at In 128 and 512, T=160,
H=512: times at B=64, 70 and 128, digests of both directions at B=64 and
70; K7b at B=128, In=512, K 2, 4, 8: times and digests; and the
digests of K3-bwd (In=128) and K4-bwd (In=512) at B=64 and 70, both
directions, on the plain forward's hs and cs, so that they read the same
inputs in every checkout), to hold the steps of a redesign against each
other in one run. After the runs a last line ``AB digests`` names the
digests equal in every checkout and those that differ.
It needs a CUDA card and exits non-zero without one.
"""
from __future__ import annotations

import functools
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def digest(tensors) -> str:
    import hashlib
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.float().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def time_lstm_bwd(root: Path) -> dict:
    """K1-bwd alone in one checkout, in this process: its time at B=64 and
    the digests of its outputs at B=64 and 70."""
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from mlvae_tpu_torch import _build
    from mlvae_tpu_torch.device import resolve_device
    from mlvae_tpu_torch.ops import lstm as L
    import torch
    dev = resolve_device(None)
    _build.build(["lstm_fwd", "lstm_bwd"])
    g = torch.Generator(device=dev).manual_seed(12)
    T, H = 160, 512
    bwd = cs.bwd_problem(g, dev, T, 64, H, False)
    bwd70 = cs.bwd_problem(g, dev, T, 70, H, False)
    return {"digest_lstm_bwd": digest(L.lstm_layer_bwd(*bwd, False)),
            "digest_lstm_bwd_B70": digest(L.lstm_layer_bwd(*bwd70, False)),
            "lstm_bwd": cs.cuda_ms(lambda: L.lstm_layer_bwd(*bwd, False),
                                   iters=20)}


FBANK_SAMPLES = 5   # times of 20 calls each, a checkout, in --only fbank


def time_fbank_alone(root: Path) -> dict:
    """K6 alone in one checkout, in this process: the digest of the build
    each width takes on the Kaldi pass's batch and the wav-in eval batch,
    and ``FBANK_SAMPLES`` times of each."""
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from mlvae_tpu_torch import _build
    from mlvae_tpu_torch.device import resolve_device
    from mlvae_tpu_torch.ops import fbank as fb
    dev = resolve_device(None)
    _build.build([n for n in _build.SOURCES if n in ("fbank", "fbank_fft")])
    out = {}
    for key, mode, frames in main_fbank_cases(cs, fb, dev):
        out[f"digest_fbank_{key}"] = digest(
            [fb.fbank_frames_cuda(frames, mode)])
        out[f"fbank_{key}"] = [
            cs.cuda_ms(lambda: fb.fbank_frames_cuda(frames, mode), iters=20)
            for _ in range(FBANK_SAMPLES)]
    return out


def main_fbank_cases(cs, fb, dev):
    """(key, mode, frames) of K6 on the Kaldi pass's batch ("kaldi") and
    the wav-in eval batch ("sb")."""
    for _, mode, frames, _ in cs.fbank_cases(dev):
        if frames.shape[0] >= 1000 and frames.shape[1] in (400, 512):
            yield ("kaldi" if mode == fb.KALDI else "sb"), mode, frames


UNROLL_KS = (2, 4, 8)


def time_unroll_alone(root: Path) -> dict:
    """K7a (f32 and bf16 streams) and K7b (bf16) in one checkout, in this
    process, at B=128, T=160, H=512, In=512: the digests of each build's
    outputs at K 2, 4, 8 and of its one-step twin's (K1-fwd of the stream
    dtype, K3/K4-fwd), both directions, and the forward times of each."""
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from mlvae_tpu_torch import _build
    from mlvae_tpu_torch.device import resolve_device
    from mlvae_tpu_torch.ops import lstm as L
    from mlvae_tpu_torch.ops import lstm_unroll_exp as LU
    import torch
    dev = resolve_device(None)
    _build.build([n for n in _build.SOURCES if n in (
        "lstm_fwd", "lstm_fwd_wide_bf16", "lstm_fused_fwd", "lstm_unroll_fwd",
        "lstm_unroll_fwd_bf16", "lstm_unroll_fused_fwd")])
    g = torch.Generator(device=dev).manual_seed(16)
    T, B, H, In = 160, 128, 512, 512
    builds = {
        "lstm_unroll_fwd": (cs.unroll_problem(g, dev, T, B, H, torch.float32),
                            LU.run_fwd_k, L.lstm_layer_fwd),
        "lstm_unroll_fwd_bf16": (
            cs.unroll_problem(g, dev, T, B, H, torch.bfloat16), LU.run_fwd_k,
            L.lstm_layer_fwd),
        "lstm_unroll_fused_fwd": (cs.fused_problem(g, dev, T, B, In, H),
                                  LU.run_fwd_fused_k, L.lstm_fused_fwd)}
    out = {}
    for name, (prob, run, twin) in builds.items():
        for reverse in (False, True):
            sfx = "_reverse" if reverse else ""
            out[f"digest_{name}_twin{sfx}"] = digest(twin(*prob, reverse))
            for K in UNROLL_KS:
                out[f"digest_{name}_K{K}{sfx}"] = digest(
                    run(*prob, reverse, K))
        out[f"{name}_twin"] = cs.cuda_ms(lambda: twin(*prob, False),
                                         iters=10)
        for K in UNROLL_KS:
            out[f"{name}_K{K}"] = cs.cuda_ms(lambda: run(*prob, False, K),
                                             iters=10)
    return out


F32_BWD_BATCHES = (64, 70, 256)


def time_fused_f32_bwd(root: Path) -> dict:
    """K3-bwd (In=128) and K4-bwd (In=512) on f32 streams in one checkout,
    in this process, at T=160, H=512: their times at B=64, 70 and 256, the
    digests of their outputs in both directions at B=64 and 70 (on K3/K4-fwd
    f32's trajectory), and the digests of the forward builds of the same
    source family, K3/K4-fwd f32 (In 128 and 512, B=64) and K7b f32 (K 2,
    4, 8 at the unroll bench's B=128, In=512), both directions."""
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from mlvae_tpu_torch import _build
    from mlvae_tpu_torch.device import resolve_device
    from mlvae_tpu_torch.ops import lstm as L
    from mlvae_tpu_torch.ops import lstm_unroll_exp as LU
    import torch
    dev = resolve_device(None)
    _build.build(["lstm_fused_fwd_f32", "lstm_fused_bwd_f32"])
    T, H = 160, 512
    out = {}
    for In, name in ((128, "lstm_fused_bwd"), (512, "lstm_semi_bwd")):
        g = torch.Generator(device=dev).manual_seed(17)
        for B in F32_BWD_BATCHES:
            prob = cs.f32_problem(g, dev, T, B, In, H)
            for reverse in (False, True):
                hs, cs_ = L.lstm_fused_fwd(*prob, reverse)
                dhs, dc = cs.f32_cotangents(g, dev, T, B, H)
                args = (*prob, hs, cs_, dhs, dc, reverse)
                sfx = f"In{In}_B{B}" + ("_reverse" if reverse else "")
                if B != 256:
                    out[f"digest_{name}_f32_{sfx}"] = digest(
                        getattr(L, name)(*args))
                if not reverse:
                    out[f"{name}_f32_In{In}_B{B}"] = cs.cuda_ms(
                        lambda: getattr(L, name)(*args), iters=10)
        for reverse in (False, True):
            prob = cs.f32_problem(g, dev, T, 64, In, H)
            out[f"digest_lstm_fused_fwd_f32_In{In}"
                + ("_reverse" if reverse else "")] = digest(
                L.lstm_fused_fwd(*prob, reverse))
    g = torch.Generator(device=dev).manual_seed(18)
    prob = cs.f32_problem(g, dev, T, 128, 512, H)
    for reverse in (False, True):
        for K in UNROLL_KS:
            out[f"digest_lstm_unroll_fused_fwd_f32_K{K}"
                + ("_reverse" if reverse else "")] = digest(
                LU.run_fwd_fused_k(*prob, reverse, K))
    return out


F32_FWD_BATCHES = (64, 70, 128)


def time_fused_f32_fwd(root: Path) -> dict:
    """K3/K4-fwd (In 128 and 512) and K7b (K 2, 4, 8 at B=128, In=512) on
    f32 streams in one checkout, in this process, at T=160, H=512: their
    times (K3/K4-fwd at B=64, 70 and 128), the digests of their outputs in
    both directions (K3/K4-fwd at B=64 and 70), and the digests of K3-bwd
    (In=128) and K4-bwd (In=512) on f32 streams at B=64 and 70, both
    directions, on the plain forward's hs and cs: the backwards' bits on
    inputs that do not depend on the forward kernel."""
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from mlvae_tpu_torch import _build
    from mlvae_tpu_torch.device import resolve_device
    from mlvae_tpu_torch.ops import lstm as L
    from mlvae_tpu_torch.ops import lstm_unroll_exp as LU
    import torch
    dev = resolve_device(None)
    _build.build(["lstm_fused_fwd_f32", "lstm_fused_bwd_f32"])
    T, H = 160, 512
    out = {}
    for In, bwd in ((128, "lstm_fused_bwd"), (512, "lstm_semi_bwd")):
        g = torch.Generator(device=dev).manual_seed(19)
        for B in F32_FWD_BATCHES:
            prob = cs.f32_problem(g, dev, T, B, In, H)
            out[f"lstm_fused_fwd_f32_In{In}_B{B}"] = cs.cuda_ms(
                lambda: L.lstm_fused_fwd(*prob), iters=10)
            if B == 128:
                continue
            for reverse in (False, True):
                sfx = f"In{In}_B{B}" + ("_reverse" if reverse else "")
                out[f"digest_lstm_fused_fwd_f32_{sfx}"] = digest(
                    L.lstm_fused_fwd(*prob, reverse))
                hs, cs_ = L.lstm_fused_fwd_ref(*prob, reverse)
                dhs, dc = cs.f32_cotangents(g, dev, T, B, H)
                out[f"digest_{bwd}_f32_on_plain_{sfx}"] = digest(
                    getattr(L, bwd)(*prob, hs, cs_, dhs, dc, reverse))
    g = torch.Generator(device=dev).manual_seed(20)
    prob = cs.f32_problem(g, dev, T, 128, 512, H)
    for K in UNROLL_KS:
        out[f"lstm_unroll_fused_fwd_f32_K{K}"] = cs.cuda_ms(
            lambda: LU.run_fwd_fused_k(*prob, False, K), iters=10)
        for reverse in (False, True):
            out[f"digest_lstm_unroll_fused_fwd_f32_K{K}"
                + ("_reverse" if reverse else "")] = digest(
                LU.run_fwd_fused_k(*prob, reverse, K))
    return out


ONLY = {"lstm_bwd": time_lstm_bwd, "fbank": time_fbank_alone,
        "unroll": time_unroll_alone, "fused_f32_bwd": time_fused_f32_bwd,
        "fused_f32_fwd": time_fused_f32_fwd}


def time_checkout(root: Path) -> dict:
    """The times of one checkout, in this process (its chip_smoke.py
    supplies the inputs and the timer)."""
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from mlvae_tpu_torch import _build
    from mlvae_tpu_torch.bench_utils import build_md_vae, synth_batch
    from mlvae_tpu_torch.device import resolve_device
    from mlvae_tpu_torch.ops import lstm as L
    import torch
    dev = resolve_device(None)
    _build.build([n for n in _build.SOURCES if n in (
        "lstm_fwd", "lstm_bwd", "lstm_fused_fwd", "lstm_fused_bwd",
        "lstm_semi_bwd", "md_viterbi", "lstm_fwd_wide", "lstm_bwd_wide",
        "lstm_fwd_wide_bf16", "lstm_bwd_wide_bf16", "fbank", "fbank_fft")])
    g = torch.Generator(device=dev).manual_seed(11)
    T, B, H = 160, 64, 512
    gx = torch.randn((T, B, 4 * H), generator=g, device=dev) * 0.5
    w = (torch.rand((4 * H, H), generator=g, device=dev) * 2 - 1) / H ** 0.5
    bwd = cs.bwd_problem(g, dev, T, B, H, False)
    fwd3 = cs.fused_problem(g, dev, T, B, 512, H)
    bwd3 = cs.fused_bwd_problem(g, dev, T, B, 512, H, False)
    bwd4 = cs.fused_bwd_problem(g, dev, T, B, 1024, H, False)
    gx128 = torch.randn((T, 128, 4 * H), generator=g, device=dev) * 0.5
    fwd_in = {In: cs.fused_problem(g, dev, T, B, In, H) for In in (128, 1024)}
    bwd70 = cs.bwd_problem(g, dev, T, 70, H, False)
    out = {
        # a digest of each kernel's outputs: equal digests mean outputs
        # bit-identical to the other checkout's
        "digest_lstm_fwd": digest(L.lstm_layer_fwd(gx, w, False)),
        "digest_lstm_bwd": digest(L.lstm_layer_bwd(*bwd, False)),
        "digest_lstm_fused_fwd": digest(L.lstm_fused_fwd(*fwd3)),
        "digest_lstm_fused_bwd": digest(L.lstm_fused_bwd(*bwd3)),
        "digest_lstm_semi_bwd": digest(L.lstm_semi_bwd(*bwd4)),
        "lstm_fwd": cs.cuda_ms(lambda: L.lstm_layer_fwd(gx, w, False),
                               iters=30),
        "lstm_bwd": cs.cuda_ms(lambda: L.lstm_layer_bwd(*bwd, False),
                               iters=20),
        "lstm_fused_fwd": cs.cuda_ms(lambda: L.lstm_fused_fwd(*fwd3),
                                     iters=20),
        "lstm_fused_bwd": cs.cuda_ms(lambda: L.lstm_fused_bwd(*bwd3),
                                     iters=20),
        "lstm_semi_bwd": cs.cuda_ms(lambda: L.lstm_semi_bwd(*bwd4),
                                    iters=20),
    }
    out["digest_lstm_bwd_B70"] = digest(L.lstm_layer_bwd(*bwd70, False))
    out["digest_lstm_fwd_B128"] = digest(L.lstm_layer_fwd(gx128, w, False))
    out["lstm_fwd_B128"] = cs.cuda_ms(
        lambda: L.lstm_layer_fwd(gx128, w, False), iters=20)
    for In, prob in fwd_in.items():
        out[f"digest_lstm_fused_fwd_In{In}"] = digest(L.lstm_fused_fwd(*prob))
        out[f"lstm_fused_fwd_In{In}"] = cs.cuda_ms(
            lambda: L.lstm_fused_fwd(*prob), iters=20)
    model = build_md_vae(batch_size=B, seed=0, device=dev)
    batch = model.prepare_batch(synth_batch(B, T, 8, seed=0, device=dev))
    noise = cs.eval_noise(model, B, T, dev, seed=3)
    out["eval_step"] = cs.cuda_ms(
        lambda: model.eval_step(batch, noise=noise), iters=10)
    del model
    # the AMP VAE train step (each call trains on: the same work each time)
    from mlvae_tpu_torch.training.brain import Stage
    amp = build_md_vae(batch_size=B, seed=0, device=dev, bf16=True)
    amp.on_stage_start(Stage.TRAIN, 3)
    amp_batch = synth_batch(B, T, 8, seed=0, device=dev)
    amp_noise = cs.train_noise(amp, B, T, dev,
                               torch.Generator(device=dev).manual_seed(6))
    loss, _ = amp.fit_batch(amp_batch, 3, noise=amp_noise)
    out["digest_amp_vae_loss"] = digest([torch.as_tensor(loss).reshape(1)])
    out["amp_vae_step"] = cs.cuda_ms(
        lambda: amp.fit_batch(amp_batch, 3, noise=amp_noise), iters=5,
        warmup=1)
    del amp
    # the f32 VAE train step: six K1-bwd launches a step
    f32 = build_md_vae(batch_size=B, seed=0, device=dev)
    f32.on_stage_start(Stage.TRAIN, 3)
    f32_noise = cs.train_noise(f32, B, T, dev,
                               torch.Generator(device=dev).manual_seed(6))
    loss, _ = f32.fit_batch(amp_batch, 3, noise=f32_noise)
    out["digest_f32_vae_loss"] = digest([torch.as_tensor(loss).reshape(1)])
    out["f32_vae_step"] = cs.cuda_ms(
        lambda: f32.fit_batch(amp_batch, 3, noise=f32_noise), iters=5,
        warmup=1)
    del f32
    out.update(time_wide(cs, dev))
    out.update(time_gru(cs, dev))
    out.update(time_decode_fbank(cs, dev))
    return out


def time_decode_fbank(cs, dev) -> dict:
    """K2 at the eval step's decode (B=64, T=160, L=8; the checkout's
    ``md_viterbi_batch_cuda``, weight folded in) and K6 on the Kaldi
    pass's batch and the wav-in eval batch: the build each width takes
    (a digest that changes with that build by design) and the DFT build
    (``ops.fbank._launch("dft", ...)`` where the checkout has more than
    one build, else the same call), digests and times."""
    import numpy as np
    from mlvae_tpu_torch.ops import decode as dec
    from mlvae_tpu_torch.ops import fbank as fb
    prob = cs.viterbi_problem(np.random.RandomState(7), dev, 64, 160, 14, 8,
                              1.0)
    out = {"digest_md_viterbi": digest(dec.md_viterbi_batch_cuda(*prob)),
           "md_viterbi": cs.cuda_ms(lambda: dec.md_viterbi_batch_cuda(*prob),
                                    iters=50)}
    dft = (functools.partial(fb._launch, "dft") if hasattr(fb, "_launch")
           else fb.fbank_frames_cuda)
    for key, mode, frames in main_fbank_cases(cs, fb, dev):
        for sfx, run in (("", fb.fbank_frames_cuda), ("_dft", dft)):
            out[f"digest_fbank{sfx}_{key}"] = digest([run(frames, mode)])
            out[f"fbank{sfx}_{key}"] = cs.cuda_ms(
                lambda: run(frames, mode), iters=20)
    return out


def time_gru(cs, dev) -> dict:
    """K5-fwd and K5-bwd, f32 and on bf16 streams, at gate 3's layers (T=160,
    H=512): digests of their outputs at B=64 and 70, both directions, their
    times at B=64; gate 3's f32 and AMP train steps at full width: the
    digest of the first loss and the step's time."""
    from mlvae_tpu_torch import bench_utils
    from mlvae_tpu_torch.ops import gru as G
    import torch
    T, H = 160, 512
    out = {}
    for bf16 in (False, True):
        sfx = "_bf16" if bf16 else ""
        g = torch.Generator(device=dev).manual_seed(15)
        for B in (64, 70):
            for reverse in (False, True):
                gx, w, b, hs, hs32, dhs = cs.gru_problem(g, dev, T, B, H,
                                                         bf16, reverse)
                key = sfx + ("_B70" if B == 70 else "") + (
                    "_reverse" if reverse else "")
                out[f"digest_gru_fwd{key}"] = digest(
                    [x for x in G.gru_layer_fwd(gx, w, b, reverse)
                     if x is not None])
                out[f"digest_gru_bwd{key}"] = digest(
                    G.gru_layer_bwd(gx, w, b, hs, hs32, dhs, reverse))
                if B == 64 and not reverse:
                    out[f"gru_fwd{sfx}"] = cs.cuda_ms(
                        lambda: G.gru_layer_fwd(gx, w, b), iters=20)
                    out[f"gru_bwd{sfx}"] = cs.cuda_ms(
                        lambda: G.gru_layer_bwd(gx, w, b, hs, hs32, dhs),
                        iters=10)
    for amp in (False, True):
        label = "amp" if amp else "f32"
        gate = bench_utils.build_gate(3, seed=0, device=dev, amp=amp,
                                      full_width=True)
        batch = bench_utils.gate_batch(3, device=dev, B=64, T=T,
                                       C=bench_utils.GATE3_RECIPE["C"])
        noise = cs.gate_noise(gate, batch,
                              torch.Generator(device=dev).manual_seed(43))
        loss = gate.train_step(batch, noise)
        out[f"digest_gate3_{label}_loss"] = digest(
            [torch.as_tensor(loss).reshape(1)])
        out[f"gate3_{label}_step"] = cs.cuda_ms(
            lambda: gate.train_step(batch, noise), iters=5, warmup=1)
        del gate
    return out


def time_wide(cs, dev) -> dict:
    """The wide K1 builds (H=1024) and LSTM_FC's f32 train step in a
    checkout that has them (none before they were added): digests of
    K1-fwd's outputs at B=64 and of K1-bwd's at B=64 and 70, their times,
    and the digest of the first train step's loss and that step's time."""
    from mlvae_tpu_torch import bench_utils
    from mlvae_tpu_torch.ops import lstm as L
    import torch
    if not hasattr(bench_utils, "build_lstm_fc"):
        return {}
    T, H = 160, 1024
    g = torch.Generator(device=dev).manual_seed(13)
    bwd = cs.bwd_problem(g, dev, T, 64, H, False)
    bwd70 = cs.bwd_problem(g, dev, T, 70, H, False)
    out = {"digest_lstm_fwd_wide": digest(L.lstm_layer_fwd(*bwd[:2])),
           "digest_lstm_bwd_wide": digest(L.lstm_layer_bwd(*bwd, False)),
           "digest_lstm_bwd_wide_B70": digest(L.lstm_layer_bwd(*bwd70,
                                                               False)),
           "lstm_fwd_wide": cs.cuda_ms(lambda: L.lstm_layer_fwd(*bwd[:2]),
                                       iters=10),
           "lstm_bwd_wide": cs.cuda_ms(lambda: L.lstm_layer_bwd(*bwd, False),
                                       iters=5)}
    model = bench_utils.build_lstm_fc(batch_size=64, seed=0, device=dev)
    batch = bench_utils.synth_flvl_batch(64, T, seed=0, device=dev)
    noise = cs.train_noise(model, 64, T, dev,
                           torch.Generator(device=dev).manual_seed(6))
    loss, _ = model.fit_batch(batch, 1, noise=noise)
    out["digest_lstm_fc_loss"] = digest([torch.as_tensor(loss).reshape(1)])
    out["lstm_fc_step"] = cs.cuda_ms(
        lambda: model.fit_batch(batch, 1, noise=noise), iters=5, warmup=1)
    del model
    if hasattr(L, "LSTM_FWD_WIDE_BF16"):
        out.update(time_wide_bf16(cs, dev, batch))
    return out


def time_wide_bf16(cs, dev, batch) -> dict:
    """The wide K1 builds on bf16 streams (H=1024): digests of K1-fwd's
    outputs at B=64 and of K1-bwd's at B=64 and 70 (dgx and dW_hh
    together, and dW_hh alone), their times; LSTM_FC's AMP train step:
    the digest of its first loss and its time."""
    from mlvae_tpu_torch import bench_utils
    from mlvae_tpu_torch.ops import lstm as L
    import torch
    T, H = 160, 1024
    g = torch.Generator(device=dev).manual_seed(14)
    bwd = cs.bwd_problem(g, dev, T, 64, H, False, bf16=True)
    bwd70 = cs.bwd_problem(g, dev, T, 70, H, False, bf16=True)
    got, got70 = L.lstm_layer_bwd(*bwd, False), L.lstm_layer_bwd(*bwd70, False)
    out = {"digest_lstm_fwd_wide_bf16": digest(L.lstm_layer_fwd(*bwd[:2])),
           "digest_lstm_bwd_wide_bf16": digest(got),
           "digest_lstm_bwd_wide_bf16_B70": digest(got70),
           "digest_lstm_dw_wide_bf16": digest(got[1:]),
           "digest_lstm_dw_wide_bf16_B70": digest(got70[1:]),
           "lstm_fwd_wide_bf16": cs.cuda_ms(
               lambda: L.lstm_layer_fwd(*bwd[:2]), iters=10),
           "lstm_bwd_wide_bf16": cs.cuda_ms(
               lambda: L.lstm_layer_bwd(*bwd, False), iters=5)}
    model = bench_utils.build_lstm_fc(batch_size=64, seed=0, device=dev,
                                      bf16=True)
    noise = cs.train_noise(model, 64, T, dev,
                           torch.Generator(device=dev).manual_seed(6))
    loss, _ = model.fit_batch(batch, 1, noise=noise)
    out["digest_lstm_fc_amp_loss"] = digest(
        [torch.as_tensor(loss).reshape(1)])
    out["lstm_fc_amp_step"] = cs.cuda_ms(
        lambda: model.fit_batch(batch, 1, noise=noise), iters=5, warmup=1)
    return out


def main(argv) -> int:
    if len(argv) in (3, 4) and argv[1] == "--time":
        root = Path(argv[2]).resolve()
        res = ONLY[argv[3]](root) if argv[3:] else time_checkout(root)
        print("AB", root, json.dumps(res), flush=True)
        return 0
    args = argv[1:]
    only = []
    if args[:1] == ["--only"]:
        if len(args) < 2 or args[1] not in ONLY:
            print(__doc__, file=sys.stderr)
            return 2
        only, args = args[1:2], args[2:]
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    others = [Path(a).resolve() for a in args]
    for other in others:
        if not (other / "chip_smoke.py").is_file():
            print(f"chip_ab: {other} is not a checkout of this repo",
                  file=sys.stderr)
            return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    digests = {}   # key -> {checkout: digest}
    for root in (*others, HERE, HERE, *others[::-1]):
        res = subprocess.run([sys.executable, str(HERE / "chip_ab.py"),
                              "--time", str(root), *only], cwd=root,
                             timeout=900, capture_output=True, text=True)
        print(res.stdout, end="", flush=True)
        print(res.stderr, end="", file=sys.stderr, flush=True)
        if res.returncode:
            return res.returncode
        for line in res.stdout.splitlines():
            if line.startswith("AB "):
                _, where, payload = line.split(" ", 2)
                for k, v in json.loads(payload).items():
                    if k.startswith("digest_"):
                        digests.setdefault(k, {}).setdefault(
                            where, set()).add(v)
    roots = {str(r) for r in (*others, HERE)}
    seen = {k: by for k, by in digests.items() if set(by) == roots}
    equal = sorted(k for k, by in seen.items()
                   if len(set().union(*by.values())) == 1)
    print("AB digests", json.dumps({
        "equal": equal, "differ": sorted(set(seen) - set(equal)),
        "not_in_every_checkout": sorted(set(digests) - set(seen))}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
