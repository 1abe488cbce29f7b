"""Command-line driver.

Protocol-compatible with the reference executables (src/serial/main.c:31-158,
src/parallel/main.cu:954-1129):

    python -m navierstokes_parallel_tpu <param-file> [options]

  * argv[1] = 15-line parameter file (defaults to parameters.txt); the CUDA
    build's block-size argument (main.cu:987-1000) has no analogue — the
    SOR kernel picks its tile from the grid (ops/sor_kernel.py)
  * stdout: "U-CENTER: %.6f" / "V-CENTER: %.6f" (main.c:148-149)
  * stderr: a single "%.6f" float — solver seconds (main.c:153's protocol,
    scraped by the benchmark harness, run.sh:57-66)

Unlike the reference (which comments out its periodic output, main.c:138-143),
`--output-dir` actually writes `<dir>/<n>_{u,v,p}.txt` every n_print steps so
the plotting/animation tooling has frames to consume, and `--checkpoint-every`
/ `--resume` give real checkpoint/resume.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import jax
import numpy as np

from .config import Params
from .grid import State, allocate_state
from .solver import center_values, make_step_fn
from .utils import io as nsio
from .utils.checkpoint import load_checkpoint, save_checkpoint


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="navierstokes_parallel_tpu",
        description="GPU-accelerated incompressible Navier-Stokes cavity "
                    "solver",
    )
    ap.add_argument("param_file", nargs="?", default="parameters.txt",
                    help="15-line parameter file (reference .in format)")
    ap.add_argument("--backend",
                    choices=["auto", "jnp", "pallas", "sharded", "gspmd"],
                    default="auto",
                    help="compute path (pallas = red-black SOR through the "
                         "CUDA kernel of csrc/rb_sor.cu, single GPU; "
                         "sharded = manual shard_map+ppermute; "
                         "gspmd = auto-sharded jit+NamedSharding, any method)")
    ap.add_argument("--method",
                    choices=["rb_sor", "rb_sor_sync", "jacobi", "mg", "cg",
                             "fft"],
                    default="rb_sor",
                    help="pressure solver (mg = multigrid V-cycles; fft = "
                         "direct DCT spectral solve; rb_sor_sync "
                         "= sharded backend's legacy exchange-per-half-sweep "
                         "path, for comparison with the default deep-halo "
                         "communication-avoiding inner)")
    ap.add_argument("--time-order", type=int, choices=[1, 2], default=1,
                    help="momentum time integrator: 1 = the reference's "
                         "explicit Euler (default), 2 = variable-step "
                         "Adams-Bashforth 2 (solver.step_ab2; problems 1-4 "
                         "on every backend incl. sharded/gspmd, problem 5 "
                         "single-chip via thermal_step_ab2; problem 6 is "
                         "excluded by design — reflagging invalidates the "
                         "carried tendency). A resumed run re-bootstraps "
                         "with one Euler step (checkpoints carry the "
                         "State, not the AB2 tendency)")
    ap.add_argument("--mesh", default=None, metavar="PxQ",
                    help="device mesh shape for the sharded/gspmd backends, "
                         "e.g. 2x4 (default: auto — pad-optimal for sharded, "
                         "near-square for gspmd).  gspmd rejects 1xN/Nx1 "
                         "shapes (XLA partitioner miscompilation, "
                         "docs/parallelism.md)")
    ap.add_argument("--dtype", choices=["float32", "float64"], default=None,
                    help="override dtype (default: config / float32)")
    ap.add_argument("--refine-every", type=int, default=None,
                    help="f64 re-baseline / convergence-check interval K for "
                         "the SOR methods (default 64; benchmarks use 2048 — "
                         "docs/performance.md)")
    ap.add_argument("--outer", choices=["float64", "compensated"],
                    default=None,
                    help="refinement-outer precision: float64 (default) "
                         "or compensated two-float f32 "
                         "(ops/compensated.py — same convergence contract, "
                         "no f64 ops, no x64 requirement)")
    ap.add_argument("--obstacle", action="append", default=None,
                    metavar="I0:I1:J0:J1",
                    help="mark an interior cell rectangle solid (1-based "
                         "inclusive; repeatable).  Flag-field domains "
                         "(Griebel sect. 5.1, e.g. the backward-facing "
                         "step) run on the masked rb_sor/mg solvers; "
                         "fft/cg and the sharded backend reject them")
    ap.add_argument("--output-dir", default=None,
                    help="write <n>_{u,v,p}.txt frames every n_print steps")
    ap.add_argument("--final-output-prefix", default=None,
                    help="write one final <prefix>_{u,v,p}.txt")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="save a checkpoint every N steps (0 = off)")
    ap.add_argument("--checkpoint-path", default="checkpoint.npz")
    ap.add_argument("--resume", default=None,
                    help="resume from a checkpoint file")
    ap.add_argument("--stats", action="store_true",
                    help="print SOR iteration / convergence stats to stderr")
    ap.add_argument("--debug-nans", action="store_true",
                    help="fault on the first NaN-producing op (jax_debug_nans)")
    ap.add_argument("--history-file", default=None,
                    help="write per-step diagnostics CSV (step,t,dt,"
                         "sor_iterations,res_norm) — the working version of "
                         "the reference's commented-out residual print "
                         "(integration.c:162)")
    ap.add_argument("--history-physics", action="store_true",
                    help="append physics monitor columns (kinetic_energy,"
                         "enstrophy,max_divergence,psi_min — "
                         "utils/diagnostics.py) to the --history-file CSV")
    ap.add_argument("--log-every", type=int, default=0,
                    help="print per-step diagnostics to stderr every N steps")
    ap.add_argument("--free-wall", choices=["noslip", "freeslip"],
                    default="noslip",
                    help="problem-6 container-wall condition (freeslip is "
                         "the standard dam-break setting — no-slip pins a "
                         "particle film to the walls)")
    ap.add_argument("--max-steps", type=int, default=0,
                    help="stop after N steps (exit code 3 if t < T remains; "
                         "combine with --checkpoint-every/--resume for "
                         "crash-tolerant incremental runs)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from .utils.device import require_device

    require_device()

    overrides = {}
    if args.dtype:
        overrides["dtype"] = args.dtype
    if args.refine_every is not None:
        if args.refine_every < 1:
            # K=0 (Params-level 'refinement off') is deliberately NOT
            # reachable from the CLI: the refinement is load-bearing for
            # f32 convergence (docs/numerics.md), not an optimization.
            print(f"error: --refine-every must be >= 1, got "
                  f"{args.refine_every}", file=sys.stderr)
            return 1
        overrides["sor_refine_every"] = args.refine_every
    if args.outer:
        overrides["outer_precision"] = args.outer
    if args.obstacle:
        rects = []
        for spec in args.obstacle:
            parts = spec.split(":")
            if len(parts) != 4 or not all(
                    p.lstrip("-").isdigit() for p in parts):
                print(f"error: --obstacle expects I0:I1:J0:J1 (got "
                      f"{spec!r})", file=sys.stderr)
                return 1
            rects.append(tuple(int(p) for p in parts))
        overrides["obstacles"] = tuple(rects)
    if args.history_physics and not args.history_file:
        print("error: --history-physics requires --history-file",
              file=sys.stderr)
        return 1
    if args.resume and args.history_file and os.path.exists(args.history_file) \
            and os.path.getsize(args.history_file) > 0:
        # Resume appends to the existing CSV; the column set must match or
        # the rows under the old header would be ragged (corrupting every
        # consumer, including plot_history).
        with open(args.history_file) as fh:
            have = fh.readline().strip()
        want = _history_columns(args)
        if have != want:
            print(f"error: --history-file {args.history_file!r} has columns "
                  f"[{have}] but this run would append [{want}] — pass the "
                  f"same --history-physics setting as the original run, or "
                  f"use a fresh --history-file", file=sys.stderr)
            return 1
    try:
        params = Params.from_file(args.param_file, **overrides)
    except (OSError, ValueError) as e:
        # Reference parity: perror + EXIT_FAILURE on a bad param file
        # (io.c:18-22, main.c:105-108) — but with the actual problem named.
        print(f"error: cannot load parameter file {args.param_file!r}: {e}",
              file=sys.stderr)
        return 1
    # x64 is always enabled: the default float32 state relies on the f64
    # master in the mixed-precision SOR (ops/sor.py); explicit dtypes keep
    # the compute path f32 everywhere else.
    jax.config.update("jax_enable_x64", True)

    if args.debug_nans:
        from .utils.checks import enable_nan_debugging
        enable_nan_debugging()

    pressure_method = args.method
    if pressure_method == "rb_sor_sync" and args.backend != "sharded":
        pressure_method = "rb_sor"  # sync vs deep only differs across shards
    if args.backend == "pallas":
        pressure_method = "pallas_sor"
    elif args.backend == "auto" and pressure_method == "rb_sor":
        # Tested against the REMAPPED method so a single-chip rb_sor_sync
        # request gets the same auto choice as rb_sor — sync vs deep is
        # meaningless on one chip and must not silently change the
        # performance path.
        from .ops.sor import default_method
        pressure_method = default_method(params)

    if args.time_order == 2:
        if params.problem == 6:
            # Deliberately unsupported: the free-surface reflagging changes
            # the fluid domain between steps, so a tendency extrapolated
            # across a topology change is evaluated on the wrong cell set —
            # AB2 across reflags is ill-defined, not merely unimplemented.
            print("error: --time-order 2 does not apply to problem 6 "
                  "(free surfaces reflag the fluid domain every step; an "
                  "Adams-Bashforth tendency carried across a reflag is "
                  "ill-defined)", file=sys.stderr)
            return 1
        if params.problem == 5 and args.backend in ("sharded", "gspmd"):
            print("error: --time-order 2 for problem 5 runs single-chip "
                  "(the multi-chip thermal steppers integrate first-order; "
                  "drop --backend or --time-order)", file=sys.stderr)
            return 1
        if params.tau > 0.5:
            # AB2's real-axis stability interval is half of Euler's
            # (solver.py::step_ab2 docstring): the viscous-limited dt
            # needs tau <= 0.5 or the integrator is silently unstable.
            print(f"warning: --time-order 2 with tau={params.tau} > 0.5 "
                  "exceeds the AB2 stability bound on the viscous dt "
                  "limit; expect blow-up (use tau <= 0.5)",
                  file=sys.stderr)

    thermal_cfg = None
    if params.problem == 5:
        from .models.convection import allocate_thermal, config_from_params

        thermal_cfg = config_from_params(params)
    if args.resume:
        try:
            state = load_checkpoint(args.resume, params)
        except (OSError, ValueError, KeyError) as e:
            print(f"error: cannot resume from {args.resume!r}: {e}",
                  file=sys.stderr)
            return 1
    elif thermal_cfg is not None:
        state = allocate_thermal(params, thermal_cfg)
    elif params.problem == 6:
        from .models.freesurface import initial_free_state

        state = initial_free_state(params)
    else:
        state = allocate_state(params)

    host_loop = bool(args.output_dir or args.checkpoint_every
                     or args.history_file or args.log_every or args.max_steps)

    # Build + AOT-compile the solve path BEFORE starting the timer: the C
    # reference has no JIT and its stderr protocol times only the solver
    # loop (run.sh:57-66), so the harness-scraped float and the --stats
    # MLUPS must exclude compilation (bench.py does the same).
    try:
        if thermal_cfg is not None:
            run = _build_thermal_runner(params, thermal_cfg, state, args,
                                        pressure_method, host_loop)
        elif params.problem == 6:
            run = _build_free_runner(params, state, args, pressure_method,
                                     host_loop)
        else:
            run = _build_runner(params, state, args, pressure_method,
                                host_loop)
    except ValueError as e:  # e.g. sharded mg on a non-divisible grid
        print(f"error: {e}", file=sys.stderr)
        return 1

    if hasattr(run, "run_device"):
        # Sharded full solve: time the device phase only; the reference
        # protocol times the solver, not the result download
        # (main.cu:1112-1117 fetches after the timer).
        start = time.perf_counter()
        outs = jax.block_until_ready(run.run_device())
        elapsed = time.perf_counter() - start
        state, stats = run.gather(outs)
    else:
        start = time.perf_counter()
        state, stats = jax.block_until_ready(run())
        elapsed = time.perf_counter() - start

    if params.problem == 6 and not hasattr(state, "u"):
        # FreeSurfaceState from the whole-solve path: the protocol outputs
        # below read the grid fields (the particle set was only needed by
        # checkpoint writes, which the host loop handles).
        state = state.state

    from .utils.checks import validate_state
    validate_state(state, where="end of integration")

    uc, vc = center_values(state, params)
    print(f"U-CENTER: {uc:.6f}")
    print(f"V-CENTER: {vc:.6f}")

    if args.final_output_prefix:
        nsio.output(np.asarray(state.u), np.asarray(state.v),
                    np.asarray(state.p), float(state.t), params.a, params.b,
                    args.final_output_prefix,
                    temperature=(np.asarray(state.T)
                                 if hasattr(state, "T") else None))

    if args.stats:
        from .utils.timing import mlups
        print(
            f"steps={int(stats.steps)} "
            f"sor_iterations={int(stats.total_sor_iterations)} "
            f"sor_failures={int(stats.sor_failures)} "
            f"last_res_norm={float(stats.last_res_norm):.3e} "
            f"mlups={mlups(int(stats.total_sor_iterations), params.i_max, params.j_max, elapsed):.1f}",
            file=sys.stderr,
        )
        print("", file=sys.stderr)

    # The harness-scraped timing float (reference stderr protocol). The
    # reference reports cumulative SOR seconds only; we report the full
    # solve wall time — a strict upper bound, conservative in comparisons.
    print(f"{elapsed:.6f}", file=sys.stderr, end="")
    if args.max_steps and float(state.t) < float(
            np.asarray(params.T, params.jnp_dtype)):
        return 3  # incomplete: resume from the checkpoint to continue
    return 0


def _history_columns(args) -> str:
    """The --history-file CSV header for this run's flag set (single source
    of truth for the header write and the resume-append mismatch check)."""
    cols = "step,t,dt,sor_iterations,res_norm"
    if getattr(args, "history_physics", False):
        cols += ",kinetic_energy,enstrophy,max_divergence,psi_min"
    return cols


def parse_mesh_arg(spec):
    """'PxQ' -> a 2D ("x","y") Mesh over the first P*Q visible devices;
    None -> None (backends pick their own default)."""
    if spec is None:
        return None
    from .parallel.topology import MESH_AXES

    try:
        px, py = (int(tok) for tok in spec.lower().split("x"))
        if px < 1 or py < 1:
            raise ValueError
    except ValueError:
        raise ValueError(f"--mesh expects PxQ (e.g. 2x4), got {spec!r}")
    devs = jax.devices()
    if px * py > len(devs):
        raise ValueError(
            f"--mesh {px}x{py} needs {px * py} devices, "
            f"{len(devs)} visible")
    return jax.sharding.Mesh(
        np.asarray(devs[: px * py]).reshape(px, py), MESH_AXES)


def _build_runner(params, state, args, pressure_method, host_loop):
    """Construct (and AOT-warm) the backend's solve callable.  Raises
    ValueError for invalid backend/method combinations."""
    mesh = parse_mesh_arg(args.mesh)
    if mesh is not None and args.backend not in ("sharded", "gspmd"):
        raise ValueError(
            f"--mesh applies to the sharded/gspmd backends, not "
            f"{args.backend!r}")
    if args.backend == "sharded":
        from .parallel import sharded
        method = pressure_method
        if method not in ("rb_sor", "rb_sor_sync", "jacobi", "mg", "cg",
                          "fft", "pallas_sor"):
            print(f"warning: --backend sharded does not support pressure "
                  f"method {method!r}; using rb_sor (hint: --backend gspmd "
                  f"runs every jnp method multi-chip, including {method!r})",
                  file=sys.stderr)
            method = "rb_sor"
        t_ord = getattr(args, "time_order", 1)
        if host_loop:
            stepper = sharded.ShardedStepper(params, state, mesh=mesh,
                                             pressure_method=method,
                                             time_order=t_ord)
            stepper.warm()
            mon_fn = _make_monitor_fn(params, state, args)
            return lambda: _run_host_loop(params, stepper, args, mon_fn)
        return sharded.compile_sharded_solve(params, state, mesh,
                                             pressure_method=method,
                                             time_order=t_ord)
    if args.backend == "gspmd":
        from .parallel import gspmd
        t_ord = getattr(args, "time_order", 1)
        if host_loop:
            stepper = gspmd.GspmdStepper(params, state, mesh=mesh,
                                         pressure_method=pressure_method,
                                         time_order=t_ord)
            stepper.warm()
            mon_fn = _make_monitor_fn(params, state, args)
            return lambda: _run_host_loop(params, stepper, args, mon_fn)
        return gspmd.compile_gspmd_solve(params, state, mesh,
                                         pressure_method=pressure_method,
                                         time_order=t_ord)
    if getattr(args, "time_order", 1) == 2:
        from . import solver as _s

        if host_loop:
            stepper = _AB2Stepper(params, state, pressure_method)
            stepper.warm()
            mon_fn = _make_monitor_fn(params, state, args)
            return lambda: _run_host_loop(params, stepper, args, mon_fn)
        ab2 = _s.ab2_init(state)
        compiled = (
            jax.jit(_s._solve_ab2_on_device, static_argnums=(0, 2))
            .lower(params, ab2, pressure_method)
            .compile()
        )
        return lambda: (lambda out: (out[0].s, out[1]))(compiled(ab2))
    if host_loop:
        stepper = _SingleChipStepper(params, state, pressure_method)
        stepper.warm()
        mon_fn = _make_monitor_fn(params, state, args)
        return lambda: _run_host_loop(params, stepper, args, mon_fn)
    from .solver import _solve_on_device

    compiled = (
        jax.jit(_solve_on_device, static_argnums=(0, 2))
        .lower(params, state, pressure_method)
        .compile()
    )
    return lambda: compiled(state)


def _build_thermal_runner(params, cfg, state, args, pressure_method,
                          host_loop):
    """Runner for problem 5 (natural convection, models/convection.py):
    single-chip jnp/pallas, multi-chip `--backend gspmd` (the GSPMD
    recipe shards u/v/p/T alike — no thermal-specific communication
    code), or multi-chip `--backend sharded` (the shard_map deep-halo
    twin in parallel/sharded_thermal.py exchanges T halos alongside
    u/v)."""
    if args.backend == "sharded":
        from .parallel import sharded_thermal

        mesh = parse_mesh_arg(args.mesh)
        method = pressure_method
        if method not in ("rb_sor", "rb_sor_sync", "jacobi", "mg", "cg",
                          "fft", "pallas_sor"):
            print(f"warning: --backend sharded does not support pressure "
                  f"method {method!r}; using rb_sor", file=sys.stderr)
            method = "rb_sor"
        if host_loop:
            stepper = sharded_thermal.ThermalShardedStepper(
                params, cfg, state, mesh=mesh, pressure_method=method)
            stepper.warm()
            mon_fn = _make_monitor_fn(params, state, args)
            return lambda: _run_host_loop(params, stepper, args, mon_fn)
        return sharded_thermal.compile_sharded_thermal_solve(
            params, cfg, state, mesh, pressure_method=method)
    if args.backend == "gspmd":
        from .models.convection import (ThermalGspmdStepper,
                                        _make_thermal_gspmd, fetch_thermal,
                                        place_thermal)

        mesh = _gspmd_mesh(args)
        if host_loop:
            stepper = ThermalGspmdStepper(params, cfg, state, mesh=mesh,
                                          pressure_method=pressure_method)
            stepper.warm()
            mon_fn = _make_monitor_fn(params, state, args)
            return lambda: _run_host_loop(params, stepper, args, mon_fn)
        fn = _make_thermal_gspmd(params, cfg, mesh, pressure_method,
                                 whole_solve=True)
        placed = place_thermal(state, params, mesh)
        compiled = fn.lower(placed).compile()

        def run():
            out, stats = compiled(placed)
            return fetch_thermal(out, params), stats

        return run
    if parse_mesh_arg(args.mesh) is not None:
        raise ValueError(
            f"--mesh applies to the gspmd backend, not {args.backend!r}")
    from .models.convection import (_thermal_solve_ab2_on_device,
                                    _thermal_solve_on_device,
                                    make_thermal_step_ab2_fn,
                                    make_thermal_step_fn, thermal_ab2_init)

    if getattr(args, "time_order", 1) == 2:
        # Second-order Boussinesq stepping (thermal_step_ab2) — the
        # host-loop stepper carries the ThermalAB2State; the monitor /
        # output paths read .ts through _AB2Stepper-style unwrapping.
        if host_loop:
            stepper = _ThermalAB2Stepper(
                thermal_ab2_init(state),
                make_thermal_step_ab2_fn(params, cfg, pressure_method))
            stepper.warm()
            mon_fn = _make_monitor_fn(params, state, args)
            return lambda: _run_host_loop(params, stepper, args, mon_fn)
        ab2 = thermal_ab2_init(state)
        compiled = (
            _thermal_solve_ab2_on_device
            .lower(params, cfg, ab2, pressure_method)
            .compile()
        )
        return lambda: (lambda out: (out[0].ts, out[1]))(compiled(ab2))
    if host_loop:
        stepper = _SingleChipStepper(
            params, state, pressure_method,
            fn=make_thermal_step_fn(params, cfg, pressure_method))
        stepper.warm()
        mon_fn = _make_monitor_fn(params, state, args)
        return lambda: _run_host_loop(params, stepper, args, mon_fn)
    compiled = (
        _thermal_solve_on_device
        .lower(params, cfg, state, pressure_method)
        .compile()
    )
    return lambda: compiled(state)


def _gspmd_mesh(args):
    """--mesh for the gspmd backend, falling back to the backend's own
    near-square default (shared by the thermal and free-surface runners)."""
    mesh = parse_mesh_arg(args.mesh)
    if mesh is None:
        from .parallel import gspmd
        mesh = gspmd._default_mesh()
    return mesh


def _build_free_runner(params, state, args, pressure_method, host_loop):
    """Runner for problem 6 (free-surface flow, models/freesurface.py):
    single-chip, or multi-chip via `--backend gspmd` (grid fields sharded,
    particles replicated — freesurface.place_free) or `--backend sharded`
    (parallel/sharded_free.py: replicated master, shard_mapped correction
    sweeps).  The pressure solve is the family's own traced-flag-field
    operator (the Dirichlet surface condition rebuilds the system every
    step), so `--method` does not apply."""
    from .models import freesurface as F

    if args.backend == "sharded":
        from .parallel import sharded_free as SF

        mesh = parse_mesh_arg(args.mesh)
        if mesh is None:
            from .parallel.topology import make_grid_mesh

            mesh = make_grid_mesh(i_max=params.i_max, j_max=params.j_max)
        wall = args.free_wall
        if host_loop:
            stepper = _FreeStepper(params, state, wall, step_fn=SF.
                                   make_free_step_sharded(params, mesh,
                                                          wall=wall))
            stepper.warm()
            mon_fn = _make_monitor_fn(params, state.state, args)
            return lambda: _run_host_loop(params, stepper, args, mon_fn)
        inner = SF.make_free_inner(params, mesh)
        compiled = F._solve_free.lower(params, state, wall, None,
                                       "interpolated", inner).compile()
        return lambda: compiled(state)
    if args.method != "rb_sor":
        print(f"warning: problem 6 uses the free-surface traced pressure "
              f"operator; --method {args.method!r} is ignored",
              file=sys.stderr)
    if args.backend == "pallas":
        print("warning: problem 6 runs the jnp free-surface path; "
              "--backend pallas is ignored", file=sys.stderr)
    wall = args.free_wall
    if args.backend == "gspmd":
        mesh = _gspmd_mesh(args)
        if host_loop:
            stepper = _FreeStepper(params, state, wall, mesh=mesh)
            stepper.warm()
            mon_fn = _make_monitor_fn(params, state.state, args)
            return lambda: _run_host_loop(params, stepper, args, mon_fn)
        fn = F._make_free_gspmd(params, mesh, wall, None, "interpolated",
                                whole_solve=True)
        placed = F.place_free(state, params, mesh)
        compiled = fn.lower(placed).compile()

        def run():
            out, stats = compiled(placed)
            return F.fetch_free(out, params), stats

        return run
    if parse_mesh_arg(args.mesh) is not None:
        raise ValueError(
            f"--mesh applies to the gspmd backend, not {args.backend!r}")
    if host_loop:
        stepper = _FreeStepper(params, state, wall)
        stepper.warm()
        mon_fn = _make_monitor_fn(params, state.state, args)
        return lambda: _run_host_loop(params, stepper, args, mon_fn)
    compiled = F._solve_free.lower(params, state, wall, None,
                                   "interpolated").compile()
    return lambda: compiled(state)


class _FreeStepper:
    """Host-loop adapter for problem 6: steps a FreeSurfaceState, exposes
    the flat FreeView (grid fields + particle set) so frames, monitors and
    particle-carrying checkpoints all work unchanged."""

    def __init__(self, params: Params, fs, wall: str, mesh=None,
                 step_fn=None):
        from .models import freesurface as F

        self._F = F
        self._params = params
        if step_fn is not None:
            # Caller-built step (the sharded_free twin: replicated state,
            # no placement/gather needed).
            self._fn = step_fn
            self._fs = fs
            self._mesh = None
        elif mesh is not None:
            self._fn = F.make_free_step_gspmd(params, mesh, wall=wall)
            self._fs = F.place_free(fs, params, mesh)
            self._mesh = mesh
        else:
            self._fn = F.make_free_step_fn(params, wall)
            self._fs = fs
            self._mesh = None

    def warm(self) -> None:
        self._fn = self._fn.lower(self._fs).compile()

    @property
    def t(self) -> float:
        return float(self._fs.state.t)

    @property
    def n(self) -> int:
        return int(self._fs.state.n)

    def step(self):
        self._fs, diag = self._fn(self._fs)
        return diag

    def state(self):
        fs = (self._F.fetch_free(self._fs, self._params)
              if self._mesh is not None else self._fs)
        return self._F.free_view(fs)


class _AB2Stepper:
    """Host-loop adapter for --time-order 2: steps an AB2State (State +
    previous-step tendency, solver.step_ab2) while exposing the plain
    State to frames/monitors/checkpoints.  A checkpoint saves the State
    only; resuming re-bootstraps the tendency with one Euler step."""

    def __init__(self, params: Params, state: State, pressure_method: str):
        from .solver import ab2_init, make_ab2_step_fn

        self._fn = make_ab2_step_fn(params, pressure_method)
        self._ab2 = ab2_init(state)

    def warm(self) -> None:
        self._fn = self._fn.lower(self._ab2).compile()

    @property
    def t(self) -> float:
        return float(self._ab2.s.t)

    @property
    def n(self) -> int:
        return int(self._ab2.s.n)

    def step(self):
        self._ab2, diag = self._fn(self._ab2)
        return diag

    def state(self) -> State:
        return self._ab2.s


class _ThermalAB2Stepper:
    """Host-loop adapter for --time-order 2 on problem 5: steps a
    ThermalAB2State (models/convection.py::thermal_step_ab2) while
    exposing the plain ThermalState to frames/monitors/checkpoints.
    Like _AB2Stepper, a checkpoint saves the state only; resume
    re-bootstraps the tendencies with one Euler step."""

    def __init__(self, ab2, fn):
        self._fn = fn
        self._ab2 = ab2

    def warm(self) -> None:
        self._fn = self._fn.lower(self._ab2).compile()

    @property
    def t(self) -> float:
        return float(self._ab2.ts.t)

    @property
    def n(self) -> int:
        return int(self._ab2.ts.n)

    def step(self):
        self._ab2, diag = self._fn(self._ab2)
        return diag

    def state(self):
        return self._ab2.ts


class _SingleChipStepper:
    """Host-loop adapter for the single-chip backends (jitted step closure);
    the sharded twin is parallel/sharded.py::ShardedStepper.  `fn`
    overrides the step closure (the thermal family passes its own)."""

    def __init__(self, params: Params, state: State, pressure_method: str,
                 fn=None):
        self._fn = fn if fn is not None else make_step_fn(params,
                                                          pressure_method)
        self._state = state

    def warm(self) -> None:
        """AOT-compile the step so timed host loops exclude compilation."""
        self._fn = self._fn.lower(self._state).compile()

    @property
    def t(self) -> float:
        return float(self._state.t)

    @property
    def n(self) -> int:
        return int(self._state.n)

    def step(self):
        self._state, diag = self._fn(self._state)
        return diag

    def state(self) -> State:
        return self._state


def _make_monitor_fn(params: Params, state: State, args):
    """AOT-warmed fused physics-monitor program for --history-physics
    (warmed here so host-loop rows never pay a compile inside the timed
    region), or None when the flag is off."""
    if not (getattr(args, "history_physics", False) and args.history_file):
        return None
    from .utils import diagnostics

    fn = jax.jit(lambda u, v: diagnostics.physics_monitors(u, v, params))
    jax.block_until_ready(fn(state.u, state.v))
    return fn


def _run_host_loop(params: Params, stepper, args, mon_fn=None):
    """Host-driven loop for output/checkpoint side effects (the working
    version of the reference's commented-out n_print path, main.c:138-143).
    Works over any stepper (single-chip or sharded): fields are only
    gathered off-device when an output frame or checkpoint is written."""
    from .solver import SolveStats

    steps = 0
    total_iters = 0
    failures = 0
    last_norm = 0.0
    # Frame index and output cadence follow the ABSOLUTE step count carried
    # in state.n, so --resume continues the numbering instead of clobbering
    # frames written before a restart.
    hist_exists = bool(args.history_file) and os.path.exists(args.history_file) \
        and os.path.getsize(args.history_file) > 0
    hist_mode = "a" if (args.resume and hist_exists) else "w"
    hist_fh = open(args.history_file, hist_mode) if args.history_file else None
    if hist_fh and hist_mode == "w":
        hist_fh.write(_history_columns(args) + "\n")
    n_print = max(params.n_print, 1)
    # Async frame writer: formatting+disk IO of a frame triple costs up to
    # seconds at large grids (0.5 s at 2048^2 with the C writer, which
    # releases the GIL) — a single-worker executor overlaps it with the
    # NEXT segment's device compute while keeping frames strictly ordered.
    # The device fetch itself stays synchronous (the arrays below are host
    # copies before submit).  Writer errors surface on the next frame
    # boundary or at loop end, never silently.
    executor = None
    out_futures: list = []
    if args.output_dir:
        from concurrent.futures import ThreadPoolExecutor

        executor = ThreadPoolExecutor(max_workers=1)

    def _drain_output(block: bool) -> None:
        remaining = []
        for f in out_futures:
            if block or f.done():
                f.result()  # re-raises writer exceptions
            else:
                remaining.append(f)
        out_futures[:] = remaining

    # T in the solver dtype, matching solve()'s on-device cond — keeps the
    # host loop's step count identical to the monolithic path when the
    # python T is not exactly representable (solver.py:117 note).
    T = float(np.asarray(params.T, params.jnp_dtype))
    while stepper.t < T:
        if args.max_steps and steps >= args.max_steps:
            break
        n_abs = stepper.n
        if args.output_dir and n_abs % n_print == 0:
            st = stepper.state()
            u, v, p = np.asarray(st.u), np.asarray(st.v), np.asarray(st.p)
            temp = np.asarray(st.T) if hasattr(st, "T") else None
            _drain_output(block=False)
            out_futures.append(executor.submit(
                nsio.output, u, v, p, float(st.t), params.a, params.b,
                f"{args.output_dir}/{n_abs // n_print}", verbose=False,
                temperature=temp))
        diag = stepper.step()
        steps += 1
        total_iters += int(diag.sor_iterations)
        failures += 0 if bool(diag.sor_converged) else 1
        last_norm = float(diag.sor_res_norm)
        # Post-step state is gathered AT MOST ONCE per step and shared by
        # the physics monitors and the checkpoint write: on the sharded
        # backends stepper.state() is a full device-to-host block gather,
        # so paying it twice per step would dominate large-grid runs.
        post_st = None

        def _post_state():
            nonlocal post_st
            if post_st is None:
                post_st = stepper.state()
            return post_st

        if hist_fh:
            row = (f"{stepper.n},{stepper.t:.8f},"
                   f"{float(diag.dt):.8f},"
                   f"{int(diag.sor_iterations)},{last_norm:.6e}")
            if mon_fn is not None:
                st = _post_state()
                m = mon_fn(st.u, st.v)
                row += (f",{float(m.kinetic_energy):.8e}"
                        f",{float(m.enstrophy):.8e}"
                        f",{float(m.max_divergence):.6e}"
                        f",{float(m.psi_min):.8e}")
            hist_fh.write(row + "\n")
        if args.log_every and steps % args.log_every == 0:
            print(f"step={steps} t={stepper.t:.5f} dt={float(diag.dt):.5f}"
                  f" sor_iters={int(diag.sor_iterations)} res={last_norm:.3e}",
                  file=sys.stderr)
        if args.checkpoint_every and steps % args.checkpoint_every == 0:
            save_checkpoint(args.checkpoint_path, _post_state())
    if hist_fh:
        hist_fh.close()
    if executor is not None:
        _drain_output(block=True)
        executor.shutdown()
    stats = SolveStats(
        steps=np.int32(steps),
        total_sor_iterations=np.int32(total_iters),
        sor_failures=np.int32(failures),
        last_res_norm=np.asarray(last_norm),
    )
    return stepper.state(), stats


if __name__ == "__main__":
    sys.exit(main())
