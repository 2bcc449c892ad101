#!/usr/bin/env python3
"""Time the port's LSTM kernels and its eval step in two checkouts on one
NVIDIA card, in turns.

    python3 chip_ab.py OTHER_CHECKOUT

runs OTHER_CHECKOUT, this checkout, this checkout, OTHER_CHECKOUT, each in
a fresh process that builds that checkout's kernels and times, with CUDA
events after warm-up, K1-fwd (B=64 and 128), K1-bwd, K3/K4-fwd (In=128,
512, 1024) and K3-bwd (In=512), K4-bwd (In=1024) at T=160, B=64, H=512,
the MD_VAE eval step and the AMP VAE train step at B=64, T=160, on inputs
from fixed seeds, a digest of each kernel's outputs and of the AMP step's
first loss. Each run prints one line ``AB <root> <JSON of ms and
digests>``; the card's name and power limit come first. It compares
two versions of code that both checkouts have (a parent and its change):
a change that may slow an earlier path is held against its parent here.
It needs a CUDA card and exits non-zero without one.
"""
from __future__ import annotations

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
    _build.build(["lstm_fwd", "lstm_bwd", "lstm_fused_fwd", "lstm_fused_bwd",
                  "lstm_semi_bwd", "md_viterbi"])
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
    return out


def main(argv) -> int:
    if len(argv) == 3 and argv[1] == "--time":
        root = Path(argv[2]).resolve()
        print("AB", root, json.dumps(time_checkout(root)), flush=True)
        return 0
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(argv[1]).resolve()
    if not (other / "chip_smoke.py").is_file():
        print(f"chip_ab: {other} is not a checkout of this repo",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    for root in (other, HERE, HERE, other):
        res = subprocess.run([sys.executable, str(HERE / "chip_ab.py"),
                              "--time", str(root)], cwd=root, timeout=900)
        if res.returncode:
            return res.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
