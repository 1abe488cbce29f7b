#!/usr/bin/env python
"""Backend parity runner — the framework's colab-runner.ipynb equivalent.

Runs the native C serial backend and the GPU backend(s) on the same
workloads, applies the reference's tolerance comparator (relative for
|x| > 1 else absolute, tol=1e-4) to the center observables and full fields,
and reports CORRECT/INCORRECT plus the speedup — computed only on CORRECT
runs, exactly like the notebook.

    python scripts/parity_check.py --configs configs/1.in --backends jnp,pallas,gspmd
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np


def _tol_ok(a, b, tol=1e-4):
    from navierstokes_parallel_tpu.utils.io import tolerance_errors

    err = tolerance_errors(a, b)
    return bool(np.max(err) <= tol), float(np.max(err))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="configs/1.in")
    ap.add_argument("--backends", default="jnp",
                    help="comma list: jnp,pallas,sharded,gspmd")
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument("--max-t", type=float, default=None,
                    help="override T (serial side gets slow on big configs)")
    args = ap.parse_args(argv)

    from navierstokes_parallel_tpu.backends import serial_c
    from navierstokes_parallel_tpu.config import Params
    from navierstokes_parallel_tpu.grid import allocate_state
    from navierstokes_parallel_tpu.parallel.sharded import solve_sharded
    from navierstokes_parallel_tpu.solver import _solve_on_device

    failures = 0
    for cfg in args.configs.split(","):
        overrides = {"dtype": "float32"}
        if args.max_t is not None:
            overrides["T"] = args.max_t
        params = Params.from_file(cfg, **overrides)
        print(f"== {cfg}: {params.i_max}x{params.j_max}, Re={params.Re}, "
              f"T={params.T} ==")

        t0 = time.perf_counter()
        res_c = serial_c.solve(params)
        t_serial = time.perf_counter() - t0
        print(f"serial C: {t_serial:.3f}s  steps={res_c.steps}")

        for backend in args.backends.split(","):
            if backend in ("sharded", "gspmd"):
                if backend == "gspmd":
                    from navierstokes_parallel_tpu.parallel.gspmd import \
                        solve_gspmd as solve_fn
                else:
                    solve_fn = solve_sharded
                jax.block_until_ready(solve_fn(params))  # warmup/compile
                t0 = time.perf_counter()
                state, stats = jax.block_until_ready(solve_fn(params))
                t_b = time.perf_counter() - t0
            else:
                method = {"jnp": "rb_sor", "pallas": "pallas_sor"}[backend]
                state0 = allocate_state(params)
                compiled = (
                    jax.jit(_solve_on_device, static_argnums=(0, 2))
                    .lower(params, state0, method)
                    .compile()
                )
                t0 = time.perf_counter()
                state, stats = jax.block_until_ready(compiled(state0))
                t_b = time.perf_counter() - t0

            ok_u, err_u = _tol_ok(np.asarray(state.u)[1:-1, 1:-1],
                                  res_c.u[1:-1, 1:-1], args.tol)
            ok_v, err_v = _tol_ok(np.asarray(state.v)[1:-1, 1:-1],
                                  res_c.v[1:-1, 1:-1], args.tol)
            ok = ok_u and ok_v and int(stats.steps) == res_c.steps
            verdict = "CORRECT" if ok else "INCORRECT"
            speed = f", speedup {t_serial / t_b:.1f}x" if ok else ""
            print(f"{backend}: {verdict} (max err {max(err_u, err_v):.2e}, "
                  f"{t_b:.3f}s{speed})")
            failures += 0 if ok else 1
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
