"""Where the wide K1 kernels' time goes, by ablation, on the card.

    python -m mlvae_tpu_torch.tools.bench_wide_ablation [--iters N]

Builds ``csrc/lstm_fwd_wide.cu`` and ``csrc/lstm_bwd_wide.cu`` (f32;
K1-bwd's recurrence and its dW_hh kernel), and ``csrc/lstm_fwd_wide_bf16.cu``
and ``csrc/lstm_bwd_wide_bf16.cu`` (bf16 streams; K1-bwd's recurrence
without its dW_hh kernel), once as they are and once for each entry of
``ABLATIONS``: a copy of ``csrc/`` (under
``mlvae_tpu_torch/_build/ablation/``) in which one phase is taken out by a
text substitution (its FMAs, its copies of h_{t-1} or of the dgates or of
dW_hh's operands, its exchange), so that the time it saves is that
phase's share. The ablated
outputs are wrong by design; each is reported beside its time. It runs at
LSTM_FC's shape (T=160, B=64, H=1024) on inputs from a generator seeded 0,
times each build with CUDA events after warm-up in two rounds (the lower
kept), and prints one JSON line naming the card and its power limit. It
needs the card and raises without CUDA; a substitution that no longer
finds its text fails the build (``tests/test_torch_lstm_wide.py`` holds
every one against the sources).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from typing import Dict, Optional, Sequence

import torch

from mlvae_tpu_torch import _build
from mlvae_tpu_torch.device import resolve_device
from mlvae_tpu_torch.ops import lstm as L

T, B, H = 160, 64, 1024
ROUNDS = 2

# the f32 builds' TMA boxes of h_{t-1}: as the bf16 builds' below
_TMA = ("    mbar_expect(bar, BOX * sizeof(float));\n"
        "    asm volatile(\n"
        "        \"cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::\"\n"
        "        \"complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\" ::\"r\"(\n"
        "            smem_u32(my_ring + (size_t)(n % RING) * BOX)),\n")
_TMA_END = "        : \"memory\");\n"
# the bf16 builds' TMA copies: each copy's mbarrier expects no bytes, so
# it completes at once and the tile keeps what it held
_STAGE_BF16 = ("lstm_wide_mma.cuh",
               "    mbar_expect(&bar[ks], SLICE * sizeof(bf16));\n"
               "    fused::tma_half(dst, c, 0, &bar[ks]);\n"
               "    fused::tma_half(dst + BT * fused::HALF, c, 1, &bar[ks]);",
               "    mbar_expect(&bar[ks], 0);")
# (kernel source, [(file, text, replacement)]); "" keeps the build as it is
ABLATIONS = {
    "fwd": ("lstm_fwd_wide", []),
    "fwd-product_fmas": ("lstm_fwd_wide", [(
        "lstm_fwd_wide.cu", "for (int k4 = 0; k4 < part / 4; ++k4) {",
        "for (int k4 = 0; k4 < 0; ++k4) {")]),
    "fwd-staging": ("lstm_fwd_wide", [(
        "lstm_fwd_wide.cu",
        _TMA + "        \"l\"(&map_h), \"r\"(b0), \"r\"(kb), \"r\"(slot), "
        "\"r\"(smem_u32(bar))\n" + _TMA_END, "    mbar_expect(bar, 0);\n")]),
    "bwd": ("lstm_bwd_wide", []),
    "bwd-recompute_fmas": ("lstm_bwd_wide", [(
        "lstm_bwd_wide.cu", "for (int k4 = 0; k4 < part / 4; ++k4) {",
        "for (int k4 = 0; k4 < 0; ++k4) {")]),
    "bwd-recompute_staging": ("lstm_bwd_wide", [(
        "lstm_bwd_wide.cu",
        _TMA + "        \"l\"(&map_h), \"r\"(kb), \"r\"(b0), \"r\"(tp), "
        "\"r\"(smem_u32(bar))\n" + _TMA_END, "    mbar_expect(bar, 0);\n")]),
    "bwd-partials": ("lstm_bwd_wide", [(
        "lstm_bwd_wide.cu", "for (int bb = 0; bb < nb; bb += 4) {",
        "for (int bb = 0; bb < 0; bb += 4) {")]),
    # the dW_hh kernel after the recurrence: its FMAs, its copies
    "bwd-dw": ("lstm_bwd_wide", [(
        "lstm_bwd_wide.cu", "for (int kk = 0; kk < DW_BK; ++kk) {",
        "for (int kk = 0; kk < 0; ++kk) {")]),
    "bwd-dw_staging": ("lstm_bwd_wide", [(
        "lstm_bwd_wide.cu",
        "      cp_async16(as + c4, a_ok ? a_row + c4 : dgx, a_ok);\n"
        "      cp_async16(bs + c4, b_ok ? b_row + c4 : hs, b_ok);\n", "")]),
    # the reduce's loads of every block's partials
    "bwd-reduce": ("lstm_bwd_wide", [(
        "lstm_bwd_wide.cu", "      red_v[u] = red_ok(b0, c, u)\n",
        "      red_v[u] = false\n")]),
    "fwd_bf16": ("lstm_fwd_wide_bf16", []),
    "fwd_bf16-staging": ("lstm_fwd_wide_bf16", [_STAGE_BF16]),
    "bwd_bf16": ("lstm_bwd_wide_bf16", []),
    "bwd_bf16-recompute_staging": ("lstm_bwd_wide_bf16", [_STAGE_BF16]),
    "bwd_bf16-exchange_staging": ("lstm_bwd_wide_bf16", [(
        "lstm_bwd_wide_bf16.cu",
        "      mbar_expect(&bars[slot], XCHUNK_ELEMS * sizeof(bf16));\n"
        "      fused::tma_half(bufs + (size_t)slot * XCHUNK_ELEMS, c, 0, "
        "&bars[slot]);",
        "      mbar_expect(&bars[slot], 0);")]),
}
# the build each ablation saves time against
BASE = {"lstm_fwd_wide": "fwd", "lstm_bwd_wide": "bwd",
        "lstm_fwd_wide_bf16": "fwd_bf16", "lstm_bwd_wide_bf16": "bwd_bf16"}
ROOT = _build.BUILD_DIR / "ablation"


def patched(subs) -> Dict[str, str]:
    """The sources of ``csrc/`` with the substitutions made, by file name;
    raises if a text is not found exactly once."""
    files = {p.name: p.read_text() for p in _build.CSRC.iterdir()
             if p.suffix in (".cu", ".cuh")}
    for name, text, repl in subs:
        if files[name].count(text) != 1:
            raise ValueError(f"ablation text not found once in {name}: "
                             f"{text[:60]!r}")
        files[name] = files[name].replace(text, repl)
    return files


def build() -> Dict[str, ctypes.CDLL]:
    """Every entry of ``ABLATIONS`` into its own library, in parallel."""
    nvcc = _build._nvcc()
    procs = {}
    for name, (src, subs) in ABLATIONS.items():
        d = ROOT / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for fname, text in patched(subs).items():
            (d / fname).write_text(text)
        out = d / "lib.so"
        procs[name] = (subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(out), str(d / f"{src}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the ablation {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(out))
    return libs


def _launcher(lib, src, prob):
    gx, w, hs, cs, dhs, dc_last = prob
    P, I = ctypes.c_void_p, ctypes.c_int
    dev = gx.device
    fn = getattr(lib, f"mlvae_{src}")
    if src == "lstm_fwd_wide_bf16":
        fn.argtypes = [P] * 5 + [I] * 4 + [P]

        def run():
            h = torch.empty_like(hs)
            c = torch.empty_like(cs)
            bar = torch.zeros((1,), device=dev, dtype=torch.int32)
            code = fn(gx.data_ptr(), w.data_ptr(), h.data_ptr(), c.data_ptr(),
                      bar.data_ptr(), T, B, H, 0, _build.stream_handle(dev))
            if code:
                raise RuntimeError(f"{src}: CUDA error {code}")
            return h, c
        return run
    if src == "lstm_bwd_wide_bf16":
        fn.argtypes = [P] * 9 + [I] * 4 + [P]

        def run():
            dgx = torch.empty_like(gx)
            dh_buf, dc_buf, bar = L.k1_bf16_bwd_scratch(gx, dc_last)
            code = fn(gx.data_ptr(), w.data_ptr(), hs.data_ptr(),
                      cs.data_ptr(), dhs.data_ptr(), dgx.data_ptr(),
                      dh_buf.data_ptr(), dc_buf.data_ptr(), bar.data_ptr(),
                      T, B, H, 0, _build.stream_handle(dev))
            if code:
                raise RuntimeError(f"{src}: CUDA error {code}")
            return (dgx,)
        return run
    if src == "lstm_fwd_wide":
        fn.argtypes = [P] * 6 + [I] * 4 + [P]

        def run():
            h = torch.empty_like(hs)
            c = torch.empty_like(cs)
            hbuf = torch.zeros((2, H, L.hbuf_pitch(B)), device=dev)
            bar = torch.zeros((1,), device=dev, dtype=torch.int32)
            code = fn(gx.data_ptr(), w.data_ptr(), h.data_ptr(), c.data_ptr(),
                      hbuf.data_ptr(), bar.data_ptr(), T, B, H, 0,
                      _build.stream_handle(dev))
            if code:
                raise RuntimeError(f"{src}: CUDA error {code}")
            return h, c
        return run
    fn.argtypes = [P] * 10 + [I] * 4 + [P]
    dw_fn = lib.mlvae_lstm_dw_wide
    dw_fn.argtypes = [P] * 3 + [I] * 4 + [P]

    def run():
        dgx = torch.empty_like(gx)
        dw = torch.zeros_like(w)
        part, dh_buf, dc_buf, bar = L.k1_bwd_scratch(gx, dc_last)
        st = _build.stream_handle(dev)
        code = fn(gx.data_ptr(), w.data_ptr(), hs.data_ptr(), cs.data_ptr(),
                  dhs.data_ptr(), dgx.data_ptr(), part.data_ptr(),
                  dh_buf.data_ptr(), dc_buf.data_ptr(), bar.data_ptr(), T, B,
                  H, 0, st)
        code = code or dw_fn(dgx.data_ptr(), hs.data_ptr(), dw.data_ptr(), T,
                             B, H, 0, st)
        if code:
            raise RuntimeError(f"{src}: CUDA error {code}")
        return dgx, dw
    return run


def cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bench(dev, iters: int = 5) -> Dict:
    libs = build()
    g = torch.Generator(device=dev).manual_seed(0)
    gx = torch.randn((T, B, 4 * H), generator=g, device=dev) * 0.5
    w = (torch.rand((4 * H, H), generator=g, device=dev) * 2 - 1) / H ** 0.5
    hs, cs = L.lstm_layer_ref(gx, w)
    dhs = torch.randn((T, B, H), generator=g, device=dev) * 0.1
    dc_last = torch.randn((B, H), generator=g, device=dev) * 0.1
    prob = (gx, w, hs, cs, dhs, dc_last)
    # the same draws on bf16 streams, the trajectory from the plain
    # recurrence in bf16
    bf = torch.bfloat16
    hs16, cs16 = L.lstm_layer_ref(gx.to(bf), w.to(bf))
    prob16 = (gx.to(bf), w.to(bf), hs16, cs16, dhs.to(bf), dc_last)
    want = {"lstm_fwd_wide": (hs, cs),
            "lstm_bwd_wide": L.lstm_layer_bwd_ref(*prob),
            "lstm_fwd_wide_bf16": (hs16, cs16),
            "lstm_bwd_wide_bf16": L.lstm_layer_bwd_ref(*prob16)[:1]}
    rows = {}
    for _ in range(ROUNDS):
        for name, lib in libs.items():
            src = ABLATIONS[name][0]
            run = _launcher(lib, src, prob16 if src in (
                "lstm_fwd_wide_bf16", "lstm_bwd_wide_bf16") else prob)
            got = run()
            torch.cuda.synchronize()
            err = max(float((a.float() - b.float()).abs().max()
                            / b.float().abs().max())
                      for a, b in zip(got, want[src]))
            ms = cuda_ms(run, iters)
            row = rows.setdefault(name, {"ms": ms, "max_rel_err": err})
            row["ms"] = min(row["ms"], ms)
    for name, row in rows.items():
        base = BASE[ABLATIONS[name][0]]
        row["saved_ms"] = rows[base]["ms"] - row["ms"]
    return {"card": _card(), "T": T, "B": B, "H": H, "rows": rows}


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    print(json.dumps(bench(dev, args.iters)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
