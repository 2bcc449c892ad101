"""Build and bind the port's CUDA kernels at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface under ``mlvae_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, so that an edited source is never served
from a stale build. The libraries are loaded with
``ctypes``; every entry point returns a ``cudaError_t`` and :class:`Kernel`
raises when it is not 0.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# the decode must round exactly like its plain version: no FMA contraction
EXTRA_FLAGS = {"md_viterbi": ["-fmad=false"]}
SOURCES = ("lstm_fwd", "lstm_bwd", "md_viterbi", "lstm_fused_fwd",
           "lstm_fused_bwd", "lstm_semi_bwd", "fbank", "gru_fwd", "gru_bwd",
           "lstm_unroll_fwd", "lstm_unroll_fwd_bf16", "lstm_unroll_fused_fwd",
           "lstm_fwd_wide",
           "lstm_bwd_wide", "lstm_fwd_wide_bf16", "lstm_bwd_wide_bf16",
           "gru_fwd_bf16", "gru_bwd_bf16", "fbank_fft", "lstm_fused_fwd_f32",
           "lstm_fused_bwd_f32")
# second builds of a source under their own library names: the fused
# backwards with the step timeline of tools/bench_bwd_timeline.py (a
# %globaltimer stamp at each phase boundary of each step and block), and
# with it the ablation that reads only the first r rows of each staged chunk
# from L2 (r = 0, 32; wrong outputs by design); K1-bwd, the wide K1-bwd on
# bf16 streams and K5-bwd on bf16 streams with their own step timeline in
# the same tool (their own define), and so K5-bwd and the wide K1-bwd in
# f32; the forwards K1-fwd, K3/K4-fwd, the wide K1-fwd and K5-fwd in f32
# and on bf16 streams, K7a (f32 and bf16) and K7b on bf16 streams, and
# K3/K4-fwd and K7b on f32 streams (one library, both entries), with the
# step timeline of tools/bench_fwd_timeline.py; and K3-bwd and
# K4-bwd on f32 streams (one library, both entries) with the first define.
# No build in SOURCES has any of these defines.
TIMELINE_DEFINE = "-DMLVAE_BWD_TIMELINE"
K1_BWD_TIMELINE_DEFINE = "-DMLVAE_K1_BWD_TIMELINE"
FWD_TIMELINE_DEFINE = "-DMLVAE_FWD_TIMELINE"
FWD_TIMED = ("lstm_fwd", "lstm_fused_fwd", "lstm_fwd_wide_bf16",
             "gru_fwd_bf16", "gru_fwd", "lstm_fwd_wide", "lstm_unroll_fwd",
             "lstm_unroll_fwd_bf16", "lstm_unroll_fused_fwd",
             "lstm_fused_fwd_f32")
ABLATION_ROWS = (0, 32)
VARIANTS = {f"{src}_timeline{suffix}": (src, [TIMELINE_DEFINE, *flags])
            for src in ("lstm_fused_bwd", "lstm_semi_bwd")
            for suffix, flags in (("", []), *(
                (f"_rows{r}", [f"-DMLVAE_BWD_STAGE_ROWS={r}"])
                for r in ABLATION_ROWS))}
VARIANTS["lstm_fused_bwd_f32_timeline"] = ("lstm_fused_bwd_f32",
                                           [TIMELINE_DEFINE])
VARIANTS.update({f"{src}_timeline": (src, [K1_BWD_TIMELINE_DEFINE])
                 for src in ("lstm_bwd", "lstm_bwd_wide_bf16",
                             "gru_bwd_bf16", "gru_bwd", "lstm_bwd_wide")})
VARIANTS.update({f"{src}_timeline": (src, [FWD_TIMELINE_DEFINE])
                 for src in FWD_TIMED})


def timeline_define(name: str) -> str:
    """The timing define of the build ``name`` of ``VARIANTS``."""
    return VARIANTS[name][1][0]


_libs: Dict[str, ctypes.CDLL] = {}
# name -> (seconds to build, ptxas report) for the builds this process ran
BUILD_LOG: Dict[str, tuple] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def source_of(name: str) -> str:
    """The ``csrc/<source>.cu`` that the build ``name`` compiles."""
    return VARIANTS[name][0] if name in VARIANTS else name


def _flags(name: str) -> List[str]:
    extra = VARIANTS[name][1] if name in VARIANTS else []
    return NVCC_FLAGS + EXTRA_FLAGS.get(source_of(name), []) + extra


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{source_of(name)}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + " ".join(_flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile the named sources that have no current build, one ``nvcc``
    process per source, all started together. Returns seconds per build."""
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(name), "-o", str(tmp),
               str(CSRC / f"{source_of(name)}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
        BUILD_LOG[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {n: BUILD_LOG[n][0] for n in todo}


def library(name: str) -> ctypes.CDLL:
    if name not in _libs:
        build([name])
        _libs[name] = ctypes.CDLL(str(_lib_path(name)))
    return _libs[name]


class Kernel:
    """One C entry point of a kernel library, with its launch count.

    ``launches`` rises by one for each call whose launch the CUDA runtime
    accepted, and nowhere else: a call under CUDA graph capture records
    the launch into the graph and launches nothing, and a graph's replay
    makes no call (the profiler counts a replay's kernels)."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def _bind(self):
        if self._fn is None:
            lib = library(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = getattr(lib,
                          f"mlvae_{source_of(self.source)}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fn, self._err = fn, err
        return self._fn

    def __call__(self, *args) -> None:
        code = self._bind()(*args)
        if code != 0:
            raise RuntimeError(f"{self.name}: CUDA error {code}: "
                               f"{self._err(code).decode()}")
        import torch
        if not (torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing()):
            self.launches += 1


def stream_handle(device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream


KERNELS: List[Kernel] = []


def register(kernel: Kernel) -> Kernel:
    KERNELS.append(kernel)
    return kernel
