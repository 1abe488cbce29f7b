"""Time the two DCT transform routes of the fft pressure solver per grid size
on the GPU: the Makhoul rfft butterflies and the cosine matmuls at
precision HIGHEST (ops/fft.py).

For each size it prints both routes' time per direct solve (a chain of
solves in one program, so launches are amortised), the route the size
heuristic `_pick_transform_route` takes, and how far the two solutions are
apart, relative to the largest.  Exits non-zero when they are more than
1e-4 apart (both are f32; the matmul route's rounding grows with n) or when
JAX finds no GPU.

Usage: python scripts/dct_route_probe.py [--sizes 512 1024 2048 4096]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax import lax  # noqa: E402

from navierstokes_parallel_tpu.config import Params  # noqa: E402
from navierstokes_parallel_tpu.ops import fft  # noqa: E402
from navierstokes_parallel_tpu.utils.device import (  # noqa: E402
    gpu_name_and_power_limit, require_device)

TOL = 1e-4


def per_solve(solve, rhs, chain: int, repeats: int = 3) -> float:
    """Seconds per solve over a chain of `chain` solves in one program; each
    solve's input differs, so none is hoisted out of the loop."""
    def run(r):
        def body(i, acc):
            return acc + solve(r + i.astype(jnp.float32) * 1e-6)
        return lax.fori_loop(0, chain, body, jnp.zeros_like(r))

    run = jax.jit(run)
    jax.block_until_ready(run(rhs))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(run(rhs))
        best = min(best, time.perf_counter() - t0)
    return best / chain


def probe_size(n: int) -> float:
    """Print one size's line; return the routes' relative difference."""
    params = Params(i_max=n, j_max=n, dtype="float32")
    lam = jnp.asarray(fft._lambda_grid(params))
    rng = np.random.default_rng(n)
    rhs = rng.standard_normal((n, n)).astype(np.float32)
    rhs = jnp.asarray(rhs - rhs.mean())

    def rfft(r):
        return fft._solve_rfft(r, lam)

    def matmul(r):
        return fft._solve_matmul(r, lam, n, n, "highest")

    a = np.asarray(jax.jit(rfft)(rhs))
    b = np.asarray(jax.jit(matmul)(rhs))
    rel = float(np.max(np.abs(a - b)) / np.max(np.abs(b)))
    chain = max(4, min(64, (1 << 26) // (n * n)))
    t_rfft = per_solve(rfft, rhs, chain)
    t_matmul = per_solve(matmul, rhs, chain)
    print(f"dct {n}^2: rfft {t_rfft * 1e3:.3f} ms/solve, matmul(HIGHEST) "
          f"{t_matmul * 1e3:.3f} ms/solve ({chain} solves chained), "
          f"heuristic picks {fft._pick_transform_route(params)}, "
          f"max|diff|/max {rel:.2e}", flush=True)
    return rel


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+",
                    default=[512, 1024, 2048, 4096])
    args = ap.parse_args()

    dev = require_device()
    if dev.platform != "gpu":
        print(f"error: needs a GPU; JAX runs on {dev.platform!r}",
              file=sys.stderr)
        return 2
    print(f"card: {gpu_name_and_power_limit()}", flush=True)
    worst = max(probe_size(n) for n in args.sizes)
    if worst > TOL:
        print(f"error: the DCT routes differ by {worst:.2e} > {TOL}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
