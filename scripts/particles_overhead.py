"""Measure the cost of riding N tracer particles on the flow solve.

Times solver.solve vs particles.solve_with_particles on the same workload
(AOT-warmed, min-over-repeats, each run ending in block_until_ready)
and prints one line per particle count.  The particle stage is ~12 gathers
per step — it should be invisible next to the pressure solve.

Usage: python scripts/particles_overhead.py [--config configs/1.in]
           [--counts 1024,16384,262144] [--repeats 3] [--method rb_sor]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="configs/1.in")
    ap.add_argument("--counts", default="1024,16384,262144")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--method", default="rb_sor")
    ap.add_argument("--T", type=float, default=0.0,
                    help="override the config's end time (longer runs "
                         "amortize dispatch noise over more steps)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    from navierstokes_parallel_tpu import particles as P
    from navierstokes_parallel_tpu import solver
    from navierstokes_parallel_tpu.config import Params
    from navierstokes_parallel_tpu.grid import allocate_state

    params = Params.from_file(args.config)
    if args.T > 0:
        import dataclasses
        params = dataclasses.replace(params, T=args.T)

    def timed(fn, *a, **kw):
        out = jax.block_until_ready(fn(*a, **kw))  # warm (compile)
        best = float("inf")
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            out = jax.block_until_ready(fn(*a, **kw))
            best = min(best, time.perf_counter() - t0)
        return best, out

    state = allocate_state(params)
    base, (final, stats) = timed(solver.solve, params, state,
                                 pressure_method=args.method)
    steps = int(stats.steps)
    print(f"baseline solve: {base:.4f}s  ({steps} steps, "
          f"{params.i_max}x{params.j_max}, {args.method})")

    for n in [int(x) for x in args.counts.split(",")]:
        side = max(1, int(np.sqrt(n)))
        seeds = P.grid_of_particles(params, side, side)
        tp, _ = timed(P.solve_with_particles, params, seeds,
                      pressure_method=args.method)
        print(f"particles n={side * side:>7}: {tp:.4f}s  "
              f"overhead {100 * (tp - base) / base:+.1f}%  "
              f"({(tp - base) / steps * 1e6:+.0f} us/step)")


if __name__ == "__main__":
    main()
