"""Start-up checks shared by the entry points (cli.py, bench.py,
chip_smoke.py): refuse a silent CPU run and place JAX's compile cache."""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Optional

import jax

_REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", ".."))
CACHE_DIR = os.path.join(_REPO_ROOT, ".jax_cache")


def compile_cache_dir() -> Optional[str]:
    """The compile cache this process should set: None when
    JAX_COMPILATION_CACHE_DIR is set (JAX reads it itself), else the fixed
    `.jax_cache/` at the checkout's root."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return CACHE_DIR


def cpu_requested() -> bool:
    """Whether JAX_PLATFORMS explicitly asks for the CPU."""
    platforms = os.environ.get("JAX_PLATFORMS", "").lower().split(",")
    return "cpu" in (p.strip() for p in platforms)


def require_device() -> jax.Device:
    """Return the first device, or exit with code 2 when JAX fell back to
    the CPU without JAX_PLATFORMS asking for it (a CUDA plugin that failed
    to start must not pass CPU times off as the card's).  On an
    accelerator, point the compile cache at `compile_cache_dir()`; a CPU
    run asked for on purpose is a test run and keeps no cache."""
    backend = jax.default_backend()
    if backend == "cpu":
        if not cpu_requested():
            print("error: JAX found no accelerator (backend 'cpu') and "
                  "JAX_PLATFORMS does not ask for the CPU; set "
                  "JAX_PLATFORMS=cpu to run on the CPU on purpose",
                  file=sys.stderr)
            raise SystemExit(2)
    else:
        cache = compile_cache_dir()
        if cache is not None:
            jax.config.update("jax_compilation_cache_dir", cache)
    return jax.devices()[0]


def gpu_name_and_power_limit() -> str:
    """The card's name and power limit as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them (one line per card), or why they could not be read."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable: {exc}"
    if proc.returncode != 0:
        return f"nvidia-smi failed (rc={proc.returncode})"
    return proc.stdout.strip()
