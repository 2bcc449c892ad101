"""Strict parsing of the environment switches (the port's copy of
``mlvae_tpu/utils/envflags.py``, same spellings and errors).

A switch that an A/B run flips must not read a misspelled value as "off":
an unrecognized value raises ``ValueError`` when the module that reads the
switch is imported.
"""
from __future__ import annotations

import os

_TRUTHY = {"1", "true", "yes", "on", "y"}
_FALSY = {"0", "false", "no", "off", "n"}


def env_bool(name: str, default: bool) -> bool:
    """A boolean switch in any of the common spellings (case-insensitive);
    unset or empty gives ``default``, anything else raises."""
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return default
    val = raw.strip().lower()
    if val in _TRUTHY:
        return True
    if val in _FALSY:
        return False
    raise ValueError(
        f"{name}={raw!r} is not a recognized boolean "
        f"(use one of {sorted(_TRUTHY | _FALSY)})")


def env_tristate(name: str, default: str = "auto"):
    """A boolean-or-``"auto"`` switch: True, False or ``"auto"``; unset or
    empty gives ``default``, anything else raises."""
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return default
    if raw.strip().lower() == "auto":
        return "auto"
    return env_bool(name, default=False)
