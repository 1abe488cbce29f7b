"""Time the CUDA SOR kernel's launch shapes (tile x sweeps per launch) per
grid size on the GPU, each checked against the XLA twin.

For every size it prints the twin `_roll_sweeps_xla`'s time per sweep, then
one line per (k, tile) candidate: blocks launched, max |d delta| / max |delta|
after 64 sweeps against the jitted twin, and time per sweep; last, the shape
`launch_shape` ships and the fastest one measured.  It also prints how far
the twin run op by op (eager) drifts from the jitted twin when dx != dy --
why every comparison here and in chip_smoke.py is made jitted.

Exits non-zero when any candidate differs from the twin by more than 1e-5
relative, or when JAX finds no GPU.

Usage: python scripts/sor_tile_probe.py [--sizes 256 512 1024 2048 4096]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from navierstokes_parallel_tpu.config import Params  # noqa: E402
from navierstokes_parallel_tpu.ops import sor_kernel as sk  # noqa: E402
from navierstokes_parallel_tpu.utils.device import (  # noqa: E402
    gpu_name_and_power_limit, require_device)

TOL = 1e-5
CHECK_SWEEPS = 64
KS = (4, 8, 16)
TILES = ((16, 32), (32, 32), (32, 64), (64, 64), (64, 128))


def per_sweep(fn, rhs, n, repeats=3):
    jax.block_until_ready(fn(rhs, n))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(rhs, n))
        best = min(best, time.perf_counter() - t0)
    return best / n


def random_rhs(params, seed):
    rhs = np.zeros(params.shape, np.float32)
    rhs[1:-1, 1:-1] = np.random.default_rng(seed).standard_normal(
        (params.i_max, params.j_max))
    return jnp.asarray(rhs)


def eager_drift() -> float:
    """max |eager - jitted| / max |jitted| of the twin, 256^2, dx != dy."""
    params = Params(i_max=256, j_max=256, b=1.3, omega=1.7, dtype="float32")
    rhs = random_rhs(params, 0)
    jitted = np.asarray(jax.jit(
        lambda r: sk._roll_sweeps_xla(r, CHECK_SWEEPS, params))(rhs))
    eager = np.asarray(sk._roll_sweeps_xla(rhs, CHECK_SWEEPS, params))
    return float(np.max(np.abs(eager - jitted)) / np.max(np.abs(jitted)))


def probe_size(n: int) -> float:
    """Print one size's table; return the worst relative error."""
    params = Params(i_max=n, j_max=n, omega=1.7, dtype="float32")
    rhs = random_rhs(params, n)
    timed = max(64, min(1024, (1 << 28) // (n * n)))
    want = np.asarray(jax.jit(
        lambda r: sk._roll_sweeps_xla(r, CHECK_SWEEPS, params))(rhs))
    scale = np.max(np.abs(want))
    xla = jax.jit(lambda r, m: sk._roll_sweeps_xla(r, m, params))
    print(f"n={n} xla_roll {per_sweep(xla, rhs, timed) * 1e6:.2f} us/sweep "
          f"({timed} sweeps timed)", flush=True)
    shipped = sk.launch_shape(params.shape)
    times, worst = {}, 0.0
    for k in KS:
        for tile in TILES:
            try:
                ls = sk.launch_shape(params.shape, k, tile)
            except ValueError:       # over the shared-memory limit
                continue
            got = np.asarray(jax.jit(lambda r, ls=ls: sk._launch(
                r, CHECK_SWEEPS, params, CHECK_SWEEPS, ls))(rhs))
            rel = float(np.max(np.abs(got - want)) / scale)
            worst = max(worst, rel)
            fn = jax.jit(lambda r, m, ls=ls: sk._launch(r, m, params, timed,
                                                        ls))
            times[k, tile] = per_sweep(fn, rhs, timed)
            print(f"n={n} k={k} tile={tile} blocks={ls.grid[0] * ls.grid[1]}"
                  f" rel_err={rel:.2e} {times[k, tile] * 1e6:.2f} us/sweep",
                  flush=True)
    best = min(times, key=times.get)
    print(f"n={n} shipped k={shipped.k} tile={shipped.tile} "
          f"{times[shipped.k, shipped.tile] * 1e6:.2f} us/sweep; fastest "
          f"k={best[0]} tile={best[1]} {times[best] * 1e6:.2f} us/sweep",
          flush=True)
    return worst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+",
                    default=[256, 512, 1024, 2048, 4096])
    args = ap.parse_args()

    dev = require_device()
    if dev.platform != "gpu":
        print(f"error: needs a GPU; JAX runs on {dev.platform!r}",
              file=sys.stderr)
        return 2
    print(f"card: {gpu_name_and_power_limit()}", flush=True)
    print(f"eager vs jitted XLA twin, 256^2, b=1.3, {CHECK_SWEEPS} sweeps: "
          f"{eager_drift():.2e} relative", flush=True)
    worst = max(probe_size(n) for n in args.sizes)
    if worst > TOL:
        print(f"error: a launch shape differs from the XLA twin by "
              f"{worst:.2e} > {TOL}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
