"""Diagnostics on stderr with [Component] prefixes; stdout carries only
generated text (the reference's convention, qwen3_tpu/utils/logging.py).

The JAX package reads QWEN3_TPU_QUIET when its module is imported; here
only an entry point reads the environment (config.py::quiet_from_env) and
passes the result to set_quiet."""

from __future__ import annotations

import sys

_quiet = False


def set_quiet(quiet: bool) -> None:
    """Silence (or restore) every later log() line."""
    global _quiet
    _quiet = quiet


def log(component: str, msg: str) -> None:
    if not _quiet:
        print(f"[{component}] {msg}", file=sys.stderr, flush=True)
