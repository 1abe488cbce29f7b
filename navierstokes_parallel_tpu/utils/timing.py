"""Timing / profiling utilities.

The reference's observability is a host clock() bracket around the SOR call
whose cumulative seconds go to stderr (main.c:84-125,153) — that protocol
lives in cli.py.  This module adds what the reference lacked: a timer that
waits for the device, MLUPS accounting, and jax.profiler trace capture (the
Nsight analogue README.md:50 recommends).
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import jax


class Timer:
    """Wall timer whose stop waits for the device work it is given."""

    def __init__(self):
        self.elapsed = 0.0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self, fence_on=None) -> float:
        if fence_on is not None:
            jax.block_until_ready(fence_on)
        self.elapsed = time.perf_counter() - self._t0
        return self.elapsed

    def __exit__(self, *exc):
        if self._t0 is not None and self.elapsed == 0.0:
            self.elapsed = time.perf_counter() - self._t0
        return False


def mlups(total_sweeps: int, i_max: int, j_max: int, seconds: float) -> float:
    """Million lattice-site updates per second of the SOR solve — the
    north-star throughput metric (BASELINE.md)."""
    if seconds <= 0:
        return float("inf")
    return total_sweeps * i_max * j_max / seconds / 1e6


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """Capture a jax.profiler trace around a block (view with TensorBoard
    or xprof) — the deep-profiling path the reference delegates to Nsight."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
