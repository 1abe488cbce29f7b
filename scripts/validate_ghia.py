#!/usr/bin/env python
"""Physics validation: lid-driven cavity centerline profiles vs Ghia et al.
1982 (the reference's validation mechanism, src/plot_ghia.py + README.md:61).

Runs the cavity to steady state on the available accelerator, reports the
max deviation of the u(y)/v(x) centerline profiles from the Ghia tables,
writes the comparison plots, and exits nonzero if the deviation exceeds the
tolerance for the chosen Re/resolution.

    python scripts/validate_ghia.py --re 100 --n 128 --T 20
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np


# Generous-but-meaningful accuracy expectations for a first-order-upwind
# staggered scheme at moderate resolution (donor-cell gamma upwinding is
# diffusive; these catch sign/structure errors, not discretization order).
# Re=10000 (the reference's default-config Reynolds number): the physical
# flow is unsteady at this Re and the Re^-1/2 boundary layers are barely
# resolved even at 257^2, so donor-cell diffusion flattens the near-wall
# profile extrema substantially; the tolerance documents what a long-horizon
# (T >= 50) 257^2 run actually achieves — structure/sign fidelity, not
# pointwise accuracy (see docs/numerics.md).
DEFAULT_TOL = {100: 0.03, 400: 0.05, 1000: 0.08, 10000: 0.30}
# Resolution-aware override: at >= 512^2 with --time-average the Re=10000
# windowed-mean profiles reach 0.150/0.141 (u/v, T=50 + 10-unit window,
# mg, 32.5k steps, sor_failures=0) — donor-cell diffusion
# at the Re^-1/2 boundary layers is the remaining error, not unsteadiness.
DEFAULT_TOL_512 = {100: 0.03, 400: 0.03, 1000: 0.08, 10000: 0.16}
# At 1024^2 the windowed mean reaches 0.128/0.137 (248 samples, 73.7k
# steps).  The 512->1024 improvement is already asymptoting:
# Ghia's 1982 tables are a STEADY-solver solution at a Reynolds number
# where the true flow is unsteady, so the time-mean flow need not converge
# to them — the residual ~0.13 measures that modeling difference plus
# donor-cell diffusion, not resolution.
DEFAULT_TOL_1024 = {100: 0.03, 400: 0.03, 1000: 0.08, 10000: 0.15}

# Primary-vortex strength (Ghia Table III) relative tolerance, measured on
# converged runs (psi errors are dominated by donor-cell diffusion of the
# vortex core, so they are larger than the centerline errors): rel err
# 0.0034 @ Re100/128^2; 0.063 -> 0.015 @ Re400 128^2 -> 256^2; 0.133 ->
# 0.074 @ Re1000.  Re=10000 is report-only: the flow is unsteady and the
# instantaneous psi_min fluctuates about Ghia's steady-solver value.
PSI_TOL = {100: 0.02, 400: 0.10, 1000: 0.18}
PSI_TOL_256 = {100: 0.015, 400: 0.04, 1000: 0.12}
VORTEX_CENTER_TOL = 0.05  # measured center distances are all < 0.01


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--re", type=int, default=100,
                    choices=[100, 400, 1000, 10000])
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--T", type=float, default=20.0)
    ap.add_argument("--tol", type=float, default=None)
    ap.add_argument("--plot-prefix", default="results/ghia")
    ap.add_argument("--backend", choices=["auto", "jnp"], default="auto")
    ap.add_argument("--method", choices=["auto", "rb_sor", "mg"], default="mg",
                    help="pressure solver (mg converges every step and is "
                         "~10x faster; auto = parity red-black)")
    ap.add_argument("--tau", type=float, default=0.9)
    ap.add_argument("--steps-per-dispatch", type=int, default=0,
                    help="segment the integration into host-bounded "
                         "dispatches (0 = one monolithic dispatch, the "
                         "default)")
    ap.add_argument("--time-average", type=float, default=0.0,
                    help="continue integrating for this extra time window "
                         "after T, averaging u/v over it (sampled every 50 "
                         "steps).  The Re=10000 cavity is physically "
                         "unsteady, so comparing an instantaneous snapshot "
                         "against Ghia's (steady-solver) tables conflates "
                         "fluctuation with discretization error; the "
                         "windowed mean is the honest comparison.")
    args = ap.parse_args(argv)

    from navierstokes_parallel_tpu.models import cavity
    from navierstokes_parallel_tpu.ops.sor import default_method
    from navierstokes_parallel_tpu.solver import solve
    from navierstokes_parallel_tpu.utils.timing import Timer

    params = cavity.lid_driven_cavity(
        Re=float(args.re), n=args.n, T=args.T, dtype="float32",
        epsilon=1e-4, max_it=5000, tau=args.tau, sor_refine_every=64,
    )
    if args.method == "mg":
        method = "mg"
    elif args.method == "rb_sor" or args.backend == "jnp":
        method = "rb_sor"
    else:
        method = default_method(params)
    print(f"Re={args.re} {args.n}^2 cavity to T={args.T} "
          f"({method}, {jax.devices()[0].device_kind})...", flush=True)

    from navierstokes_parallel_tpu.grid import allocate_state
    from navierstokes_parallel_tpu.solver import _solve_on_device

    state0 = allocate_state(params)
    if args.steps_per_dispatch:
        from navierstokes_parallel_tpu.solver import solve_segmented

        with Timer() as timer:
            state, stats = solve_segmented(
                params, state0, pressure_method=method,
                steps_per_dispatch=args.steps_per_dispatch)
            timer.stop(fence_on=state)
    else:
        with Timer() as ct:
            compiled = (
                jax.jit(_solve_on_device, static_argnums=(0, 2))
                .lower(params, state0, method)
                .compile()
            )
            ct.stop()
        print(f"compile: {ct.elapsed:.1f}s", flush=True)

        with Timer() as timer:
            state, stats = compiled(state0)
            timer.stop(fence_on=state)

    u_eval, v_eval = state.u, state.v
    if args.time_average > 0:
        from navierstokes_parallel_tpu.solver import _solve_capped

        # Round the window target to the state dtype so the host-loop
        # condition below agrees with _solve_capped's on-device cond (a
        # full-precision target that rounds DOWN on device would spin on
        # zero-step dispatches once t reaches it).
        target = float(np.asarray(float(state.t) + args.time_average,
                                  np.asarray(state.t).dtype))
        aparams = params.replace(T=target)
        acc_u = np.asarray(state.u, np.float64).copy()
        acc_v = np.asarray(state.v, np.float64).copy()
        k = 1
        with Timer() as avg_timer:
            while float(state.t) < target:
                state, stats = _solve_capped(aparams, state, stats, 50,
                                             method)
                acc_u += np.asarray(state.u)
                acc_v += np.asarray(state.v)
                k += 1
            avg_timer.stop(fence_on=state)
        u_eval, v_eval = acc_u / k, acc_v / k
        print(f"time-averaged over [{target - args.time_average:.1f}, "
              f"{target:.1f}]: {k} samples, {avg_timer.elapsed:.1f}s",
              flush=True)

    errs = cavity.ghia_errors(u_eval, v_eval, params, args.re)
    from navierstokes_parallel_tpu.utils import diagnostics

    vort = diagnostics.primary_vortex(
        diagnostics.stream_function(u_eval, params), params)
    verrs = diagnostics.ghia_vortex_errors(u_eval, params, args.re)
    gx, gy = diagnostics.GHIA_VORTEX_CENTER[args.re]
    print(f"primary vortex: psi={vort.psi:.6f} at ({vort.x:.4f}, "
          f"{vort.y:.4f}); Ghia {diagnostics.GHIA_PSI_MIN[args.re]:.6f} at "
          f"({gx}, {gy}) -> rel err {verrs.psi_rel_err:.4f}, "
          f"center dist {verrs.center_dist:.4f}")
    print(f"steps={int(stats.steps)} sor_iterations="
          f"{int(stats.total_sor_iterations)} "
          f"sor_failures={int(stats.sor_failures)} wall={timer.elapsed:.1f}s")
    print(f"max |u - Ghia| = {errs.max_u_err:.4f}")
    print(f"max |v - Ghia| = {errs.max_v_err:.4f}")

    if args.plot_prefix:
        os.makedirs(os.path.dirname(args.plot_prefix) or ".", exist_ok=True)
        from navierstokes_parallel_tpu.utils import plotting
        paths = plotting.plot_ghia(
            np.asarray(u_eval), np.asarray(v_eval), params, args.re,
            args.plot_prefix,
        )
        psi_path = plotting.plot_streamlines(
            np.asarray(u_eval), params, f"{args.plot_prefix}_psi.png",
            Re=args.re)
        print("plots:", *paths, psi_path)

    if args.n >= 1024:
        table = DEFAULT_TOL_1024
    elif args.n >= 512:
        table = DEFAULT_TOL_512
    else:
        table = DEFAULT_TOL
    tol = args.tol if args.tol is not None else table[args.re]
    if errs.max_u_err > tol or errs.max_v_err > tol:
        print(f"FAIL: deviation exceeds tol={tol}")
        return 1
    psi_table = PSI_TOL_256 if args.n >= 256 else PSI_TOL
    if args.re in psi_table:
        psi_tol = psi_table[args.re]
        if (verrs.psi_rel_err > psi_tol
                or verrs.center_dist > VORTEX_CENTER_TOL):
            print(f"FAIL: primary vortex exceeds tol "
                  f"(psi rel {psi_tol}, center {VORTEX_CENTER_TOL})")
            return 1
    print(f"PASS (tol={tol})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
