"""Test configuration: force CPU with 8 virtual devices so the multi-chip
sharded path runs under CI without a GPU cluster (SURVEY.md §4), and enable
x64 so parity tests against the float64 serial oracle are exact.

Tests marked `gpu` need the card (the CUDA SOR kernel has no CPU mode) and
skip on the CPU.  On a machine with a GPU run them with

    NSP_TEST_GPU=1 python -m pytest -m gpu tests/

which leaves JAX on its default platform."""

import os

_ON_GPU = os.environ.get("NSP_TEST_GPU") == "1"
# Must happen before jax import.
if not _ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not _ON_GPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import gc  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from navierstokes_parallel_tpu.config import Params  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips elsewhere; run with "
                   "NSP_TEST_GPU=1 python -m pytest -m gpu tests/)")


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided here, at test time, never at
    import or collection)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: run NSP_TEST_GPU=1 python -m "
                    "pytest -m gpu tests/ on the card")


_modules_since_clear = 0


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Drop compiled executables between test modules.

    The full suite compiles thousands of distinct programs onto the
    8-virtual-device CPU mesh; letting them accumulate in one process
    was observed to segfault the XLA CPU client around the 50% mark
    (round-3 verdict).  Clearing bounds peak native memory at the cost
    of duplicate compiles.  NSP_TEST_CLEAR_EVERY (default 4; set 1 for
    the conservative round-4 every-module behavior) trades a longer
    clearing stride for fewer recompiles of the programs adjacent modules
    share; an RSS backstop clears regardless once the process passes
    8 GB — 3.5x the 2.3 GB full-suite peak measured at stride 4 — to
    bound accumulation under long strides.  (The round-3 segfault's
    exact trigger threshold was never measured, so treat the backstop
    as a growth bound, not a proven segfault guard; stride 1 remains
    the conservative fallback.)"""
    global _modules_since_clear
    yield
    _modules_since_clear += 1
    try:
        stride = int(os.environ.get("NSP_TEST_CLEAR_EVERY", "4"))
    except ValueError:
        stride = 4
    if _modules_since_clear >= stride or _rss_gb() > 8.0:
        jax.clear_caches()
        gc.collect()
        _modules_since_clear = 0


def _rss_gb() -> float:
    try:
        with open("/proc/self/statm") as fh:
            pages = int(fh.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / 2**30
    except (OSError, ValueError, IndexError):
        return float("inf")  # can't measure -> clear every module


@pytest.fixture
def small_params() -> Params:
    """A fast CPU-runnable cavity configuration."""
    return Params(
        problem=1,
        i_max=16,
        j_max=16,
        a=1.0,
        b=1.0,
        T=0.05,
        Re=100.0,
        tau=0.5,
        omega=1.7,
        epsilon=1e-4,
        max_it=500,
        dtype="float64",
    )


def assert_close_reference_contract(a, b, tol=1e-4):
    """The notebook comparator's contract: relative tolerance where |x| > 1,
    absolute otherwise (single implementation in utils/io.py)."""
    from navierstokes_parallel_tpu.utils.io import tolerance_errors

    err = tolerance_errors(a, b)
    assert np.max(err) <= tol, f"max contract err {np.max(err)} > {tol}"
