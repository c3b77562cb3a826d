"""Device checks and compile-cache setup for the measuring entry points.

The package computes on JAX's default backend for every stream dtype;
nothing here routes work between devices. These helpers serve the
scripts that measure on the card (``chip_smoke.py``, ``bench.py``,
``benches/bench_*.py``): they refuse to run without a GPU instead of
timing the CPU, keep JAX's persistent compile cache at a fixed path,
and report which card and power limit a number was taken on.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

import jax

# <checkout>/.jax_cache: a fixed path, because the cache key includes it
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def require_gpu():
    """Return ``jax.devices()`` when JAX's default backend is a GPU;
    raise ``RuntimeError`` otherwise (a measurement never falls back to
    the CPU)."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"needs an NVIDIA GPU; JAX's default backend is "
            f"{devs[0].platform!r} ({devs[0].device_kind})")
    return devs


def configure_compile_cache() -> str:
    """Enable JAX's persistent compilation cache and return its path.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is (JAX reads
    it itself; no other path is set here). Otherwise the cache lives in
    ``<checkout>/.jax_cache``, which ``.gitignore`` lists."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)


def card_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for every card, one
    line each, read by a child process that never imports JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
