"""CLI argument parsing (the port's own copy of ``mlvae_tpu/cli/args.py``,
``sb.parse_arguments`` as the reference drives it):

    python -m mlvae_tpu_torch.cli.train config/run.yaml \
        --dataset SynAudioMNIST --model_class X \
        --model '!include:mlvae_tpu_torch/models/X/model.yaml' \
        --extra_overrides "{model: {n_epochs: 1}}" --debug --debug_batches 2

Positional: the hparams YAML.  ``--key value`` pairs become a YAML
overrides string (tags like ``!include:`` preserved); the keys of
``RUN_OPT_KEYS`` become run options: the JAX package's, every one of
which the port takes (``training/brain.py``).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

RUN_OPT_KEYS = {
    "debug": bool,
    "debug_batches": int,
    "debug_epochs": int,
    "device": str,
    "bf16": bool,
    "auto_mix_prec": bool,
    "max_grad_norm": float,
    "noprogressbar": bool,
    "data_parallel": bool,
    "num_devices": int,
    "tensor_parallel": int,
    "profile": bool,
    "scan_epoch": bool,
    "scan_chunk": int,
    "allow_stale_ckpt": bool,
    "cache_device_batches": bool,
    "device_batch_cache_mb": int,
    "compile_cache": bool,
    "compile_cache_dir": str,
    "async_ckpt": bool,
    "zero1": bool,
    "ckpt_opt_state": bool,
}


def parse_arguments(args: List[str]) -> Tuple[str, Dict, str]:
    if not args:
        raise ValueError("expected a hparams yaml file as first argument")
    hparams_file = args[0]
    rest = args[1:]

    run_opts: Dict = {}
    override_lines: List[str] = []
    i = 0
    while i < len(rest):
        arg = rest[i]
        if not arg.startswith("--"):
            raise ValueError(f"unexpected argument: {arg}")
        key = arg[2:]
        # flag or key-value?
        has_value = i + 1 < len(rest) and not rest[i + 1].startswith("--")
        if key in RUN_OPT_KEYS:
            typ = RUN_OPT_KEYS[key]
            if typ is bool and not has_value:
                run_opts[key] = True
                i += 1
            else:
                if not has_value:
                    raise ValueError(f"run option --{key} needs a value")
                raw = rest[i + 1]
                if typ is bool:
                    lowered = raw.lower()
                    if lowered in ("1", "true", "yes", "on"):
                        run_opts[key] = True
                    elif lowered in ("0", "false", "no", "off"):
                        run_opts[key] = False
                    else:
                        # a typo ('ture') must not silently become False
                        raise ValueError(
                            f"--{key} expects a boolean, got {raw!r}")
                else:
                    run_opts[key] = typ(raw)
                i += 2
        else:
            if not has_value:
                raise ValueError(f"override --{key} needs a value")
            value = rest[i + 1]
            override_lines.append(f"{key}: {value}")
            i += 2

    return hparams_file, run_opts, "\n".join(override_lines)
