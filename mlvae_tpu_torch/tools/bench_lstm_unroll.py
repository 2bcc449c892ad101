"""A/B of the K-unrolled LSTM forwards (K7a, K7b) against their one-step
twins: the port's counterpart of the JAX package's
``tools/bench_lstm_unroll.py``, at its shape (B=128, T=160, H=512, In=512)
and its K in {2, 4, 8}.

    python -m mlvae_tpu_torch.tools.bench_lstm_unroll [--iters N]
        [--device cpu] [--shape B,T,H,In]

Arms, each on one set of inputs made from a ``torch.Generator`` seeded 0 at
the JAX tool's scales (x and gx N(0, 0.1^2), the weights N(0, 0.05^2), the
bias zero):

- plain, f32: K1-fwd (``ops.lstm.lstm_layer_fwd``), then K7a at each K;
- plain, bf16: K1-fwd on bf16 streams (``ops.lstm.lstm_layer_fwd``, its
  tensor-core build), then K7a at each K;
- fused, bf16: K3/K4-fwd (``ops.lstm.lstm_fused_fwd``), then K7b at each K;
- fused, f32: K3/K4-fwd on f32 streams, then K7b on f32 streams at each K.

For each arm it gives the twin's time and, for each K, the time and the
largest absolute difference of hs and cs from the twin's, which must be 0;
the bound (the larger of the operations at the card's peak for the stream
dtype and the bytes moved once at its memory rate); and one
``torch.nn.LSTM`` layer with its input projection in the arm's dtype
(cuDNN on the card, TF32 off) as the yardstick. Times come from CUDA events
after warm-up on the card, from the host clock on the CPU. It prints one JSON
line, naming the card and its power limit on the card, and exits non-zero
when a difference is not 0; a launch that fails raises.

It runs on the card unless asked for the CPU (``--device cpu``: the plain
versions); without CUDA it raises.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Dict, Optional, Sequence

import torch

from mlvae_tpu_torch.device import resolve_device
from mlvae_tpu_torch.ops import lstm as L
from mlvae_tpu_torch.ops import lstm_unroll_exp as LU

SHAPE = (128, 160, 512, 512)   # B, T, H, In of the JAX tool
KS = (2, 4, 8)
WARMUP = 2

# H100 SXM, NVIDIA's data sheet (dense rates)
MEM_BW = 3.35e12      # HBM3, bytes/s
F32_PEAK = 67e12      # f32 outside the tensor cores, FLOP/s
BF16_PEAK = 989e12    # bf16 tensor cores, FLOP/s


def _bound(flops: float, nbytes: float, peak: float):
    t_o, t_b = flops / peak, nbytes / MEM_BW
    return max(t_o, t_b) * 1e3, "operations" if t_o > t_b else "bytes"


def plain_bound(T: int, B: int, H: int, bf16: bool):
    """K7a and K1-fwd: the recurrent product per step at the stream dtype's
    peak, against gx, W_hh read and hs, cs written once."""
    item = 2.0 if bf16 else 4.0
    flops = 2.0 * B * H * 4 * H * T
    nbytes = item * (T * B * 4 * H + 4 * H * H + T * B * H) + 4.0 * T * B * H
    return _bound(flops, nbytes, BF16_PEAK if bf16 else F32_PEAK)


def fused_bound(T: int, B: int, In: int, H: int, bf16: bool = True):
    """K7b and K3/K4-fwd: one product over [x_t | h_{t-1}] per step at the
    stream dtype's peak, against x, hs and the weights in the stream dtype,
    cs and the bias (f32) moved once."""
    item = 2.0 if bf16 else 4.0
    flops = 2.0 * B * 4 * H * (In + H) * T
    nbytes = (item * (T * B * In + T * B * H + 4 * H * (In + H))
              + 4.0 * T * B * H + 4.0 * 4 * H)
    return _bound(flops, nbytes, BF16_PEAK if bf16 else F32_PEAK)


def time_ms(fn, dev: torch.device, iters: int,
            warmup: int = WARMUP) -> float:
    """Mean ms a call: CUDA events on the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def make_inputs(dev: torch.device, B: int, T: int, H: int, In: int):
    """x (T, B, In), gx (T, B, 4H), w_ih (4H, In), w_hh (4H, H) f32 and the
    f32 bias, from a generator seeded 0."""
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((T, B, In), generator=g, device=dev) * 0.1
    gx = torch.randn((T, B, 4 * H), generator=g, device=dev) * 0.1
    w_ih = torch.randn((4 * H, In), generator=g, device=dev) * 0.05
    w_hh = torch.randn((4 * H, H), generator=g, device=dev) * 0.05
    bias = torch.zeros((4 * H,), device=dev)
    return x, gx, w_ih, w_hh, bias


def _max_abs(got, want) -> float:
    return max(float((a.float() - b.float()).abs().max())
               for a, b in zip(got, want))


def _library_ms(dev, In, H, dtype, x, iters) -> float:
    """One ``torch.nn.LSTM`` layer, its input projection included (in f32
    without TF32)."""
    lstm = torch.nn.LSTM(In, H, 1).to(dev, dtype)
    lstm.flatten_parameters()
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return time_ms(lambda: lstm(x), dev, iters)
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def _arm(arm, dtype, twin_name, twin, unrolled, Ks, dev, iters, bound,
         library_ms) -> Dict:
    """The twin's output and time, then each K's difference from it and
    time. ``unrolled(K)`` returns the K-step kernel's (hs, cs)."""
    want = twin()
    out = {"arm": arm, "dtype": dtype, "twin": twin_name,
           "twin_ms": time_ms(twin, dev, iters), "bound_ms": bound[0],
           "bound_by": bound[1], "library_ms": library_ms, "K": {}}
    for K in Ks:
        err = _max_abs(unrolled(K), want)
        out["K"][str(K)] = {"max_abs": err,
                            "ms": time_ms(lambda: unrolled(K), dev, iters)}
    return out


def bench(dev: torch.device, B: int = SHAPE[0], T: int = SHAPE[1],
          H: int = SHAPE[2], In: int = SHAPE[3], Ks: Sequence[int] = KS,
          iters: int = 20) -> Dict:
    """Every arm at (B, T, H, In); K in ``Ks`` must divide T. On the card
    each timed kernel launches 1 + WARMUP + ``iters`` times."""
    x, gx, w_ih, w_hh, bias = make_inputs(dev, B, T, H, In)
    bf = torch.bfloat16
    x16, gx16, wih16, whh16 = (v.to(bf) for v in (x, gx, w_ih, w_hh))
    lib = {"f32": _library_ms(dev, In, H, torch.float32, x, iters),
           "bf16": _library_ms(dev, In, H, bf, x16, iters)}
    arms = [
        _arm("plain", "f32", "lstm_fwd",
             lambda: L.lstm_layer_fwd(gx, w_hh, False),
             lambda K: LU.run_fwd_k(gx, w_hh, False, K), Ks, dev, iters,
             plain_bound(T, B, H, False), lib["f32"]),
        _arm("plain", "bf16", "lstm_fwd",
             lambda: L.lstm_layer_fwd(gx16, whh16, False),
             lambda K: LU.run_fwd_k(gx16, whh16, False, K), Ks, dev, iters,
             plain_bound(T, B, H, True), lib["bf16"]),
        _arm("fused", "bf16", "lstm_fused_fwd",
             lambda: L.lstm_fused_fwd(x16, wih16, bias, whh16, False),
             lambda K: LU.run_fwd_fused_k(x16, wih16, bias, whh16, False, K),
             Ks, dev, iters, fused_bound(T, B, In, H), lib["bf16"]),
        _arm("fused", "f32", "lstm_fused_fwd",
             lambda: L.lstm_fused_fwd(x, w_ih, bias, w_hh, False),
             lambda K: LU.run_fwd_fused_k(x, w_ih, bias, w_hh, False, K),
             Ks, dev, iters, fused_bound(T, B, In, H, bf16=False),
             lib["f32"]),
    ]
    return {"shape": {"B": B, "T": T, "H": H, "In": In}, "iters": iters,
            "arms": arms}


def worst_max_abs(res: Dict) -> float:
    return max(k["max_abs"] for a in res["arms"]
               for k in a.get("K", {}).values())


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20,
                    help="timed calls per kernel (default %(default)s)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--shape", default=None,
                    help="B,T,H,In (default %s)" % ",".join(map(str, SHAPE)))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    shape = (tuple(int(v) for v in args.shape.split(",")) if args.shape
             else SHAPE)
    res = bench(dev, *shape, iters=args.iters)
    head = {"tool": "bench_lstm_unroll", "device": str(dev)}
    if dev.type == "cuda":
        head.update(device=torch.cuda.get_device_name(dev),
                    nvidia_smi=_card())
    print(json.dumps({**head, **res}), flush=True)
    worst = worst_max_abs(res)
    if worst != 0.0:
        print(f"bench_lstm_unroll: an unrolled kernel differs from its "
              f"twin by {worst}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
