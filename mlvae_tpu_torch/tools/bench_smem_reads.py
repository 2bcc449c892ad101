"""What a 16-byte shared-memory read costs a warp on the card, by pattern.

    python -m mlvae_tpu_torch.tools.bench_smem_reads

Builds a small probe kernel (``nvcc``, into ``mlvae_tpu_torch/_build/``):
one block an SM, eight warps, each issuing LDS.128 reads in a loop whose
32 lanes read the same float4 (a broadcast), 32 distinct consecutive
float4s, 8 distinct consecutive ones (each quarter-warp the same eight),
4 distinct ones (one a quarter-warp), or 8 distinct ones that share a bank
quad. It prints one JSON line naming the card and its power limit with
the SM clocks a warp instruction of each pattern takes (``clock64`` over
the loop, eight warps sharing the SM's shared-memory pipe). The wide K1
kernels' products rest on the broadcast and the 8-distinct patterns
(``csrc/lstm_wide.cuh``). It needs the card and raises without CUDA.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from typing import Dict, Optional, Sequence

from mlvae_tpu_torch import _build

PATTERNS = ("broadcast", "32 distinct consecutive", "8 distinct consecutive",
            "4 distinct, one a quarter-warp", "8 distinct, one bank quad")
ITERS = 4096

SOURCE = r"""
#include <cuda_runtime.h>
__global__ void probe(float* out, long long* cyc, int mode, int iters) {
  __shared__ float4 s[2048];
  for (int i = threadIdx.x; i < 2048; i += blockDim.x)
    s[i] = make_float4(i, i + 1, i + 2, i + 3);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int idx = mode == 0 ? 0 : mode == 1 ? lane : mode == 2 ? (lane & 7)
                  : mode == 3 ? (lane >> 3) : (lane & 7) * 8;
  float4 a0 = make_float4(0, 0, 0, 0), a1 = a0, a2 = a0, a3 = a0;
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    const int b = (i * 64) & 2047;
    const float4 v0 = s[(idx + b) & 2047];
    const float4 v1 = s[(idx + b + 512) & 2047];
    const float4 v2 = s[(idx + b + 1024) & 2047];
    const float4 v3 = s[(idx + b + 1536) & 2047];
    a0.x += v0.x; a1.y += v1.y; a2.z += v2.z; a3.w += v3.w;
  }
  __syncthreads();
  const long long t1 = clock64();
  out[blockIdx.x * blockDim.x + threadIdx.x] = a0.x + a1.y + a2.z + a3.w;
  if (threadIdx.x == 0) cyc[blockIdx.x] = t1 - t0;
}
extern "C" int mlvae_smem_probe(float* out, long long* cyc, int mode,
                                int iters, int blocks) {
  probe<<<blocks, 256>>>(out, cyc, mode, iters);
  cudaError_t err = cudaDeviceSynchronize();
  return err != cudaSuccess ? err : cudaGetLastError();
}
"""


def build() -> ctypes.CDLL:
    """The probe's library, built from ``SOURCE`` (keyed by its text)."""
    import hashlib
    digest = hashlib.sha1(SOURCE.encode()).hexdigest()[:12]
    lib = _build.BUILD_DIR / f"libsmem_probe-{digest}.so"
    if not lib.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = lib.with_suffix(".cu")
        src.write_text(SOURCE)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                        str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


def bench(dev) -> Dict[str, float]:
    import torch
    fn = build().mlvae_smem_probe
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty((blocks * 256,), device=dev)
    cyc = torch.empty((blocks,), device=dev, dtype=torch.int64)
    res = {}
    for mode, name in enumerate(PATTERNS):
        for _ in range(2):      # the second run is kept: warm
            code = fn(out.data_ptr(), cyc.data_ptr(), mode, ITERS, blocks)
            if code:
                raise RuntimeError(f"smem probe: CUDA error {code}")
        # eight warps, four LDS.128 an iteration each
        res[name] = float(cyc[0]) / (8 * ITERS * 4)
    return res


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    from mlvae_tpu_torch.device import resolve_device
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    dev = resolve_device(None)
    print(json.dumps({"tool": "bench_smem_reads", "nvidia_smi": _card(),
                      "sm_clocks_a_warp_lds128": bench(dev)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
