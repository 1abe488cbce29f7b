"""Decompose the 256^2 parity headline into kernel / outer / step costs.

Attributes the end-to-end time of a max_it-bound parity workload on the
GPU:

  1. inner-stage per-sweep rate alone (the CUDA kernel for pallas_sor, its
     XLA twin for rb_sor);
  2. end-to-end per-sweep rate: difference two max_it values (the parity
     workloads are max_it-bound, so sweep count scales exactly);
  3. refinement-outer cost: difference two sor_refine_every values at
     fixed max_it (K=2048 -> 10 outer passes/step vs K=max_it -> 1);
  4. non-SOR per-step cost (momentum + BCs + projection + dt reduction):
     a max_it=64 run is almost all step overhead.

Usage: python scripts/parity_breakdown.py [--config configs/1.in]
                                          [--method pallas_sor|rb_sor]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import numpy as np

jax.config.update("jax_enable_x64", True)

from navierstokes_parallel_tpu.config import Params  # noqa: E402
from navierstokes_parallel_tpu.grid import allocate_state  # noqa: E402


def solve_time(params: Params, method: str, repeats: int = 3):
    """Min-over-repeats AOT-compiled full-solve seconds + stats."""
    from navierstokes_parallel_tpu.solver import _solve_on_device

    state = allocate_state(params)
    compiled = (
        jax.jit(_solve_on_device, static_argnums=(0, 2))
        .lower(params, state, method)
        .compile()
    )
    jax.block_until_ready(compiled(state))  # warm
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out, stats = jax.block_until_ready(compiled(state))
        best = min(best, time.perf_counter() - t0)
    return best, int(stats.total_sor_iterations), int(stats.steps)


def inner_per_sweep(params: Params, method: str, n: int = 2048,
                    repeats: int = 3) -> float:
    """Seconds per sweep of the inner stage alone."""
    from navierstokes_parallel_tpu.ops import sor_kernel

    if method == "pallas_sor":
        def fn(r, m):
            return sor_kernel.inner_sweeps(r, m, params, n)
    else:
        def fn(r, m):
            return sor_kernel._roll_sweeps_xla(r, m, params)
    fn = jax.jit(fn)
    rhs = np.zeros(params.shape, np.float32)
    rhs[1:-1, 1:-1] = np.random.default_rng(0).standard_normal(
        (params.i_max, params.j_max))
    rhs = jax.numpy.asarray(rhs)
    jax.block_until_ready(fn(rhs, n))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(rhs, n))
        best = min(best, time.perf_counter() - t0)
    return best / n


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="configs/1.in")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--method", choices=["pallas_sor", "rb_sor"],
                    default="pallas_sor")
    args = ap.parse_args()

    dev = jax.devices()[0]
    print(f"device: {dev.platform} {dev.device_kind}", file=sys.stderr)
    base = Params.from_file(args.config, dtype="float32")
    n = base.i_max
    m = args.method

    # 1. inner stage alone.
    kern = inner_per_sweep(base, m, repeats=args.repeats)
    print(f"[1] inner stage:      {kern * 1e6:7.3f} us/sweep")

    # 2. end-to-end per-sweep rate from two max_it values.
    pA = base.replace(max_it=20000, sor_refine_every=2048)
    pB = base.replace(max_it=10000, sor_refine_every=2048)
    tA, sweepsA, stepsA = solve_time(pA, m, args.repeats)
    tB, sweepsB, stepsB = solve_time(pB, m, args.repeats)
    if stepsA != stepsB:
        print(f"warning: step counts differ ({stepsA} vs {stepsB}); "
              "per-sweep differencing includes step-cost drift",
              file=sys.stderr)
    e2e = (tA - tB) / max(1, sweepsA - sweepsB)
    print(f"[2] end-to-end:       {e2e * 1e6:7.3f} us/sweep "
          f"(tA={tA:.4f}s/{sweepsA}, tB={tB:.4f}s/{sweepsB})")

    # 3. refinement-outer cost: K=2048 vs K=max_it (1 outer pass per step).
    pC = base.replace(max_it=20000, sor_refine_every=20000)
    tC, sweepsC, stepsC = solve_time(pC, m, args.repeats)
    outersA = stepsA * -(-pA.max_it // pA.sor_refine_every)
    outersC = stepsC * 1
    if sweepsC == sweepsA and outersA > outersC:
        per_outer = (tA - tC) / (outersA - outersC)
        print(f"[3] outer pass:       {per_outer * 1e3:7.3f} ms/pass "
              f"({outersA - outersC} fewer passes save {tA - tC:.4f}s)")
    else:
        print(f"[3] outer pass:       n/a (sweeps {sweepsA} vs {sweepsC})")

    # 4. non-SOR step cost: nearly-zero-sweep run.
    pD = base.replace(max_it=64, sor_refine_every=64)
    tD, sweepsD, stepsD = solve_time(pD, m, args.repeats)
    step_cost = tD / max(1, stepsD) - sweepsD / max(1, stepsD) * kern
    print(f"[4] non-SOR step:    ~{step_cost * 1e3:7.3f} ms/step "
          f"(tD={tD:.4f}s, {stepsD} steps, {sweepsD} sweeps)")

    total_model = (sweepsA * kern
                   + (outersA - outersC) * ((tA - tC) / max(1, outersA - outersC))
                   + stepsA * step_cost)
    print(f"model: kernel {sweepsA * kern:.4f}s + outers "
          f"{tA - tC:.4f}s + steps {stepsA * step_cost:.4f}s "
          f"= {total_model:.4f}s vs measured {tA:.4f}s at {n}^2")


if __name__ == "__main__":
    main()
