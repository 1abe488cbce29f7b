"""Attribute a spectral/multigrid time step's cost to its components.

The fft/mg methods run K=1 refinement: per direct solve the outer does a
full-grid f64 defect + L2 + master update, and per step the driver does
momentum (FG + RHS), projection, BCs, and the adaptive-dt reduction.  At
2048^2+ the outer passes can rival the transforms themselves — this script
measures each piece on the GPU with chained (fori_loop) timings differenced
between two chain lengths:

  1. DCT solve alone, both transform routes (ms/solve);
  2. one f64 outer pass (residual + L2 + update) (ms/pass);
  3. momentum FG + RHS (f32) (ms/step);
  4. end-to-end step rate from two max-step counts;
and prints a closure check: modeled step cost vs measured.

Usage: python scripts/step_breakdown.py [--config configs/4.in]
       [--method fft] [--repeats 3]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_enable_x64", True)

from navierstokes_parallel_tpu.config import Params  # noqa: E402
from navierstokes_parallel_tpu.grid import allocate_state  # noqa: E402


def chained_ms(fn, arg_specs, args, n1=4, n2=24, repeats=3):
    """ms per application of fn, latency-differenced over chained calls."""
    def run(n_iters, *xs):
        def body(_, c):
            out = fn(*c)
            return out if isinstance(out, tuple) else (out,)
        return jax.lax.fori_loop(0, n_iters, body, xs)[0]

    n_spec = jax.ShapeDtypeStruct((), jnp.int32)
    compiled = jax.jit(run).lower(n_spec, *arg_specs).compile()

    fence = jax.block_until_ready

    fence(compiled(np.int32(n1), *args))
    fence(compiled(np.int32(n2), *args))
    best = [float("inf"), float("inf")]
    for _ in range(repeats):
        for slot, n in ((0, n1), (1, n2)):
            t0 = time.perf_counter()
            fence(compiled(np.int32(n), *args))
            best[slot] = min(best[slot], time.perf_counter() - t0)
    return (best[1] - best[0]) / (n2 - n1) * 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="configs/4.in")
    ap.add_argument("--method", default="fft", choices=["fft", "mg"])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--steps", type=int, default=8,
                    help="steps per end-to-end timing segment")
    ap.add_argument("--platform", default=None,
                    help="jax platform override (e.g. cpu; consumed before "
                         "jax initializes)")
    args = ap.parse_args()

    print(f"device: {jax.devices()[0].device_kind}", file=sys.stderr)
    params = Params.from_file(args.config, dtype="float32")
    ni, nj = params.i_max, params.j_max
    shape = params.shape
    rng = np.random.default_rng(0)

    from navierstokes_parallel_tpu.ops import fft as fftmod
    from navierstokes_parallel_tpu.ops import sor

    lam = fftmod._lambda_grid(params)
    rhs32 = (rng.standard_normal((ni, nj)) -
             0.0).astype(np.float32)
    rhs32 -= rhs32.mean()
    spec32 = jax.ShapeDtypeStruct((ni, nj), jnp.float32)

    # 1. transforms, both routes.
    t_mat = chained_ms(lambda r: fftmod._solve_matmul(r, lam, ni, nj),
                       (spec32,), (rhs32,), repeats=args.repeats)
    print(f"[1] DCT solve matmul: {t_mat:8.3f} ms/solve")
    # Matmul precision ladder (Params.fft_precision): below HIGHEST the card
    # may round the operands to TF32; the refinement outer absorbs
    # the per-solve error as extra solves, so ms/solve here must be weighed
    # against the solve-count change bench.py --fft-precision reports.
    for prec in ("high", "default"):
        t_p = chained_ms(
            lambda r, _p=prec: fftmod._solve_matmul(r, lam, ni, nj, _p),
            (spec32,), (rhs32,), repeats=args.repeats)
        print(f"    matmul @{prec:7s}: {t_p:8.3f} ms/solve")
    try:
        t_rfft = chained_ms(lambda r: fftmod._solve_rfft(r, lam),
                            (spec32,), (rhs32,), repeats=args.repeats)
        print(f"    DCT solve rfft:   {t_rfft:8.3f} ms/solve")
    except Exception as exc:
        t_rfft = float("nan")
        print(f"    DCT solve rfft:   unavailable ({exc})")

    # 2. one f64 outer pass: ghost fill + residual + L2 + master update.
    dx2 = np.float64(1.0 / (params.dx * params.dx))
    dy2 = np.float64(1.0 / (params.dy * params.dy))

    def outer_pass(p64, rhs64, delta32):
        p64 = p64.at[1:-1, 1:-1].add(delta32[1:-1, 1:-1].astype(jnp.float64))
        r64 = sor.residual(sor.ghost_fill(p64), rhs64, dx2, dy2)
        norm = jnp.sqrt(jnp.mean(r64 * r64))
        return p64 + 0.0 * norm, rhs64, delta32

    p64_0 = rng.standard_normal(shape)
    rhs64_0 = rng.standard_normal((ni, nj))
    d32_0 = rng.standard_normal(shape).astype(np.float32)
    spec64 = jax.ShapeDtypeStruct(shape, jnp.float64)
    speci64 = jax.ShapeDtypeStruct((ni, nj), jnp.float64)
    specd = jax.ShapeDtypeStruct(shape, jnp.float32)
    t_outer = chained_ms(lambda p, r, d: outer_pass(p, r, d),
                         (spec64, speci64, specd), (p64_0, rhs64_0, d32_0),
                         repeats=args.repeats)
    print(f"[2] f64 outer pass:   {t_outer:8.3f} ms/pass")

    # 2b. the compensated two-float outer pass (ops/compensated.py): same
    # structure — master update + ghost fill + defect + L2 — no f64 ops.
    from navierstokes_parallel_tpu.ops import compensated as comp

    def outer_pass_df(hi, lo, rhs32f, delta32):
        h2, l2 = comp.df_add_f32(hi[1:-1, 1:-1], lo[1:-1, 1:-1],
                                 delta32[1:-1, 1:-1])
        hi = hi.at[1:-1, 1:-1].set(h2)
        lo = lo.at[1:-1, 1:-1].set(l2)
        r = comp.residual_df(sor.ghost_fill(hi), sor.ghost_fill(lo), rhs32f,
                             jnp.float32(dx2), jnp.float32(dy2))
        norm = jnp.sqrt(jnp.mean(r * r))
        return hi + 0.0 * norm, lo, rhs32f, delta32

    hi_0 = np.float32(p64_0)
    lo_0 = np.float32(p64_0 - np.float64(hi_0))
    speci32 = jax.ShapeDtypeStruct((ni, nj), jnp.float32)
    t_outer_df = chained_ms(
        outer_pass_df, (specd, specd, speci32, specd),
        (hi_0, lo_0, rhs32, d32_0), repeats=args.repeats)
    print(f"    compensated outer:{t_outer_df:8.3f} ms/pass "
          f"(--outer compensated)")

    # 3. momentum (FG + RHS), f32.
    from navierstokes_parallel_tpu.ops import momentum

    def mom(u, v):
        F, G = momentum.compute_fg(u, v, np.float32(1e-4), np.float32(0.9),
                                   params)
        rhs = momentum.compute_rhs(F, G, np.float32(1e-4), params)
        return u + 1e-30 * rhs.astype(u.dtype)[..., : u.shape[-1]], v

    state = allocate_state(params)
    specu = jax.ShapeDtypeStruct(shape, jnp.float32)
    u0 = np.asarray(state.u, np.float32)
    v0 = np.asarray(state.v, np.float32)
    t_mom = chained_ms(mom, (specu, specu), (u0, v0), repeats=args.repeats)
    print(f"[3] momentum FG+RHS:  {t_mom:8.3f} ms/step")

    # 4. end-to-end step rate from two capped step counts.
    from navierstokes_parallel_tpu.solver import SolveStats, _solve_capped

    def timed_steps(max_steps):
        zero = jnp.zeros((), jnp.int32)
        stats0 = SolveStats(steps=zero, total_sor_iterations=zero,
                            sor_failures=zero,
                            last_res_norm=jnp.zeros((), jnp.float32))
        t0 = time.perf_counter()
        out, stats = _solve_capped(params, allocate_state(params), stats0,
                                   max_steps, args.method)
        jax.device_get(out.u[1, 1])
        return time.perf_counter() - t0, int(stats.steps), int(
            stats.total_sor_iterations)

    # warm (compile) then measure both counts.
    nA, nB = args.steps, max(1, args.steps // 4)
    timed_steps(nA)
    timed_steps(nB)
    bestA = min(timed_steps(nA)[0] for _ in range(args.repeats))
    tB, stepsB, solvesB = timed_steps(nB)
    bestB = min([tB] + [timed_steps(nB)[0] for _ in range(args.repeats - 1)])
    tA, stepsA, solvesA = timed_steps(nA)
    bestA = min(bestA, tA)
    if stepsA == stepsB:
        print(f"[4] end-to-end step:  n/a — both segments ran {stepsA} "
              f"steps (T-capped or --steps too small); raise T or --steps",
              file=sys.stderr)
        return
    step_ms = (bestA - bestB) / (stepsA - stepsB) * 1e3
    solves_per_step = solvesA / max(1, stepsA)
    print(f"[4] end-to-end step:  {step_ms:8.3f} ms/step "
          f"({solves_per_step:.2f} solves/step; A: {stepsA} steps "
          f"{bestA:.3f}s, B: {stepsB} steps {bestB:.3f}s)")

    t_solve = t_rfft if t_rfft == t_rfft and t_rfft < t_mat else t_mat
    model = solves_per_step * (t_solve + t_outer) + t_outer + t_mom
    print(f"model: {solves_per_step:.2f}x(solve {t_solve:.3f} + outer "
          f"{t_outer:.3f}) + init outer + momentum {t_mom:.3f} "
          f"= {model:.3f} ms/step vs measured {step_ms:.3f}")


if __name__ == "__main__":
    main()
