#!/usr/bin/env python3
"""Run chip_smoke.py's wav2vec2 phase alone on one NVIDIA card.

    python3 chip_w2v.py

builds the port's kernels, then runs ``chip_smoke.run_cli_w2v``: the six
w2v_* recipes through ``cli.train`` (and ``cli.test``,
``cli.test_on_three_sets``, ``cli.test_external``) with the encoder at
wav2vec2-large-lv60's topology, each against its plain versions with
exact kernel launches. Prints the card, every line of the phase, and at
the end the phase's kernel launches (f32 and ``--bf16`` runs) and its
seconds as one JSON object; exits 1 when a check fails."""
import json
import sys

import chip_smoke as cs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_w2v: no CUDA device", file=sys.stderr)
        return 1
    from mlvae_tpu_torch import _build
    # every kernel's wrapper registered: the launch checks count them all
    from mlvae_tpu_torch.ops import (decode, fbank, gru, lstm,  # noqa: F401
                                     lstm_unroll_exp)
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    _build.build([*_build.SOURCES, *_build.VARIANTS])
    try:
        counts, amp, out = cs.run_cli_w2v(
            torch.device("cuda"), lambda line: print(line, flush=True), smi)
    except cs.SmokeFailure as e:
        print(f"FAILED: {e}", flush=True)
        return 1
    print(json.dumps({"launches": {k: v for k, v in counts.items() if v},
                      "bf16_launches": {k: v for k, v in amp.items() if v},
                      "seconds": out["seconds"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
