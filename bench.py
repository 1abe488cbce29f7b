"""Benchmark harness entry point.

Runs the reference's headline workload — tests/1.in: Re=1000 lid-driven
cavity, 256^2, T=0.01, SOR omega=1.7, eps=1e-4, max_it=20000 (BASELINE.md) —
on the GPU and prints ONE JSON line:

    {"metric": ..., "value": ..., "unit": "s", "vs_baseline": ...}

`value` is the solver wall time (our analogue of the reference's stderr
cumulative-SOR-seconds protocol, main.c:153 — ours covers the WHOLE solve,
momentum included, so the comparison is conservative in the reference's
favor).  `vs_baseline` is the speedup over the reference CUDA build's 3.349 s
on the same workload (speedup.csv:2, sm_60, block=16): > 1 means faster than
the reference GPU implementation.

The device kind and count, and the card's name and power limit as
nvidia-smi reports them, go to stderr.  A run in which JAX found no
accelerator exits with code 2 (utils/device.py) unless JAX_PLATFORMS=cpu
asks for the CPU.

Usage: python bench.py [--config configs/1.in] [--backend jnp|sharded]
"""

import argparse
import json
import sys
import time

import jax

jax.config.update("jax_enable_x64", True)

# Reference numbers for this workload (BASELINE.md; speedup.csv:2).
CUDA_BASELINE_S = {256: 3.349, 512: 18.176, 1024: 182.39, 2048: 2653.29}
SERIAL_BASELINE_S = {256: 48.58, 512: 759.90, 1024: 12134.53, 2048: 198116.11}

def _bench_ensemble(params, args):
    """Batched-ensemble benchmark: N perturbed members
    integrated in ONE vmapped program vs the same N members solved
    sequentially.  Both sides run the jnp formulations (solve_ensemble
    forces disable_pallas), so the ratio isolates the batching win."""
    import numpy as np

    import jax.numpy as jnp

    from navierstokes_parallel_tpu.grid import State, allocate_state
    from navierstokes_parallel_tpu.solver import (
        _solve_on_device,
        solve_ensemble,
        stack_states,
    )

    N = args.ensemble
    method = "rb_sor" if args.method in ("auto", "pallas_sor") else args.method
    print(f"pressure solver: {method} (ensemble N={N})", file=sys.stderr)
    rng = np.random.default_rng(0)
    eparams = params.replace(disable_pallas=True)

    def member(i):
        base = allocate_state(eparams)
        # Small divergence-free-enough lid-scale perturbation of the initial
        # velocity; the first BC application + projection clean it up.
        pert = 1e-3 * rng.standard_normal(base.u.shape).astype(np.float32)
        return State(u=base.u + jnp.asarray(pert), v=base.v, p=base.p,
                     t=base.t, n=base.n)

    members = [member(i) for i in range(N)]
    batched = stack_states(members)

    # --- solo: N sequential solves (AOT-compiled once; identical math) ----
    compiled = (
        jax.jit(_solve_on_device, static_argnums=(0, 2))
        .lower(eparams, members[0], method)
        .compile()
    )
    reps = max(1, args.repeats)
    jax.block_until_ready(compiled(members[0]))  # warm
    # Min-over-repeats on both sides.
    t_solo_total = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for m in members:
            out = compiled(m)
        jax.block_until_ready(out)
        t_solo_total = min(t_solo_total, time.perf_counter() - t0)
    t_solo = t_solo_total / N

    # --- batched: one vmapped program ------------------------------------
    jax.block_until_ready(
        solve_ensemble(eparams, batched, pressure_method=method))  # compile
    t_ens = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        bstate, bstats = jax.block_until_ready(
            solve_ensemble(eparams, batched, pressure_method=method))
        t_ens = min(t_ens, time.perf_counter() - t0)
    per_member = t_ens / N

    n = params.i_max
    print(
        f"members={N} solo={t_solo:.4f}s/member ensemble_total={t_ens:.4f}s "
        f"per_member={per_member:.4f}s members_per_s={N / t_ens:.2f} "
        f"steps={int(np.max(np.asarray(bstats.steps)))} "
        f"device={jax.devices()[0].device_kind}",
        file=sys.stderr,
    )
    print(json.dumps({
        "metric": f"cavity{n}_ensemble{N}_per_member_seconds",
        "value": round(per_member, 6),
        "unit": "s",
        "vs_baseline": round(t_solo / per_member, 3),
    }))
    return 0


def _time_solver(run, args):
    """Min-over-repeats wall time of one full solve, each run ending in
    jax.block_until_ready.  Returns (best, out, stats); callers must have
    warmed/compiled `run` already."""
    best = float("inf")
    for _ in range(max(1, args.repeats)):
        t0 = time.perf_counter()
        out, stats = jax.block_until_ready(run())
        best = min(best, time.perf_counter() - t0)
    return best, out, stats


def _bench_thermal(params, args, mesh_arg):
    """Problem-5 (natural convection) benchmark arm: times the Boussinesq
    `while t < T` integration on the requested backend.  Beyond-reference
    workload — its own metric name, no vs_baseline (like problem 3)."""
    import jax

    from navierstokes_parallel_tpu.models import convection as conv

    if getattr(args, "time_order", 1) == 2 and args.backend in ("sharded",
                                                                "gspmd"):
        # Mirror cli.py's gate: the multi-chip thermal steppers integrate
        # first-order — silently benchmarking Euler under an AB2 flag
        # would corrupt the Euler-vs-AB2 A/B.
        print("error: --time-order 2 for problem 5 runs single-chip "
              "(the multi-chip thermal steppers integrate first-order; "
              "drop --backend or --time-order)", file=sys.stderr)
        return 2

    cfg = conv.config_from_params(params)
    state = conv.allocate_thermal(params, cfg)
    if args.method != "auto":
        method = args.method
    elif args.backend in ("sharded", "gspmd"):
        method = "rb_sor"
    else:
        from navierstokes_parallel_tpu.ops.sor import default_method

        method = default_method(params)
    if args.backend == "sharded":
        from navierstokes_parallel_tpu.parallel.sharded_thermal import (
            compile_sharded_thermal_solve,
        )

        print(f"pressure solver: {method} (sharded thermal)",
              file=sys.stderr)
        runner = compile_sharded_thermal_solve(params, cfg, state, mesh_arg,
                                               pressure_method=method)

        def run():
            uo, vo, po, To, t, stats = runner.run_device()
            return uo, stats
    elif args.backend == "gspmd":
        from navierstokes_parallel_tpu.models.convection import (
            _make_thermal_gspmd, place_thermal,
        )
        from navierstokes_parallel_tpu.parallel import gspmd

        if method == "pallas_sor":
            print("warning: gspmd backend cannot run pallas_sor; using "
                  "rb_sor", file=sys.stderr)
            method = "rb_sor"
        print(f"pressure solver: {method} (gspmd thermal)", file=sys.stderr)
        mesh = mesh_arg if mesh_arg is not None else gspmd._default_mesh()
        fn = _make_thermal_gspmd(params, cfg, mesh, method,
                                 whole_solve=True)
        placed = place_thermal(state, params, mesh)
        compiled = fn.lower(placed).compile()

        def run():
            out, stats = compiled(placed)
            return out.u, stats
    elif getattr(args, "time_order", 1) == 2:
        print(f"pressure solver: {method} (thermal, AB2)", file=sys.stderr)
        ab2 = conv.thermal_ab2_init(state)
        compiled = (
            conv._thermal_solve_ab2_on_device
            .lower(params, cfg, ab2, method)
            .compile()
        )

        def run():
            out, stats = compiled(ab2)
            return out.ts.u, stats
    else:
        print(f"pressure solver: {method} (thermal)", file=sys.stderr)
        compiled = (
            conv._thermal_solve_on_device
            .lower(params, cfg, state, method)
            .compile()
        )

        def run():
            out, stats = compiled(state)
            return out.u, stats

    jax.block_until_ready(run())  # warm + compile
    best, out, stats = _time_solver(run, args)

    n = params.i_max
    total_iters = int(stats.total_sor_iterations)
    mlups = total_iters * params.i_max * params.j_max / best / 1e6
    print(
        f"steps={int(stats.steps)} sor_iterations={total_iters} "
        f"sor_failures={int(stats.sor_failures)} "
        f"seconds={best:.6f} mlups={mlups:.1f}",
        file=sys.stderr,
    )
    print(json.dumps({
        "metric": f"convection{n}_ra{params.Ra:g}_solver_seconds",
        "value": round(best, 6),
        "unit": "s",
        "vs_baseline": None,
    }))
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="configs/1.in")
    ap.add_argument("--backend",
                    choices=["auto", "jnp", "pallas", "sharded", "gspmd"],
                    default="auto")
    ap.add_argument("--method", choices=["auto", "rb_sor", "pallas_sor", "mg", "fft"],
                    default="auto",
                    help="pressure solver; auto = reference-parity red-black "
                         "SOR (ops.sor.default_method) up to 1024^2, the "
                         "direct DCT spectral solve (fft) at 2048^2+ where "
                         "plain SOR is impractical (and the reference "
                         "itself never converges); pallas_sor = red-black "
                         "SOR through the CUDA kernel (GPU only)")
    ap.add_argument("--mesh", default=None, metavar="PxQ",
                    help="device mesh shape for --backend sharded/gspmd "
                         "(e.g. 2x4; default auto)")
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--ensemble", type=int, default=0,
                    help="N > 0: benchmark solver.solve_ensemble with N "
                         "perturbed members (vmap-batched trajectories) "
                         "against N sequential solo solves; prints "
                         "per-member seconds with vs_baseline = solo/"
                         "per-member (the batching speedup)")
    ap.add_argument("--refine-every", type=int, default=0,
                    help="f64 re-baseline interval K for the SOR parity "
                         "methods; 0 = benchmark-tuned (2048).  The "
                         "block-size analogue: the reference harness sweeps "
                         "CUDA block sizes and its headline uses the best "
                         "(bs=16, speedup.csv); ours sweeps K "
                         "(run_benchmarks.py --tile-sweep).  The benchmark "
                         "workloads are max_it-bound, so K changes only how "
                         "often the f64 defect pass runs — the sweep count "
                         "and the result are identical.")
    ap.add_argument("--fft-precision", choices=["highest", "high", "default"],
                    default="highest",
                    help="matmul precision of the DCT matmul route: lower "
                         "lets the card use TF32; the refinement outer "
                         "absorbs the per-solve error as extra direct "
                         "solves (contract unchanged)")
    ap.add_argument("--outer", choices=["float64", "compensated"],
                    default="float64",
                    help="refinement-outer precision: the f64 defect/L2/"
                         "master pass (default) or the compensated "
                         "two-float f32 outer (ops/compensated.py) — same "
                         "convergence contract")
    ap.add_argument("--fft-solves", type=int, default=0,
                    help="fft method: direct solves chained per f64 "
                         "refinement pass (Params.fft_solves_per_outer; "
                         "0 = default 1).  >1 amortizes the f64 outer "
                         "pass at large grids")
    ap.add_argument("--dispatch",
                    choices=["auto", "monolithic", "segmented", "stepwise"],
                    default="auto",
                    help="single-chip dispatch granularity: one jitted "
                         "while_loop program (monolithic, = auto), "
                         "--dispatch-steps steps per dispatch (segmented), "
                         "or one step per dispatch (stepwise)")
    ap.add_argument("--dispatch-steps", type=int, default=8,
                    help="steps per dispatch for --dispatch segmented")
    ap.add_argument("--time-order", type=int, choices=[1, 2], default=1,
                    help="momentum time integrator: 1 = explicit Euler "
                         "(the reference's), 2 = variable-step AB2 "
                         "(solver.step_ab2 / thermal_step_ab2 for problem "
                         "5; sharded/gspmd twins for problems 1-4).  AB2 "
                         "requires the monolithic dispatch (the default)")
    ap.add_argument("--mg-cycles", type=int, default=0,
                    help="mg method: V-cycles chained per f64 refinement "
                         "pass (Params.mg_cycles_per_outer; 0 = default 1). "
                         ">1 amortizes the f64 outer pass at large grids "
                         "(~10%% extra cycles, half the outer passes at 2)")
    args = ap.parse_args(argv)

    from navierstokes_parallel_tpu.utils.device import (
        gpu_name_and_power_limit, require_device)

    dev = require_device()
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}",
          file=sys.stderr)
    if dev.platform == "gpu":
        print(f"card: {gpu_name_and_power_limit()}", file=sys.stderr)

    from navierstokes_parallel_tpu.config import Params
    from navierstokes_parallel_tpu.grid import allocate_state
    from navierstokes_parallel_tpu.solver import _solve_on_device

    params = Params.from_file(args.config, dtype="float32")
    if args.refine_every < 0:
        ap.error(f"--refine-every must be >= 0 (0 = tuned default), got "
                 f"{args.refine_every}")
    if args.dispatch_steps < 1:
        ap.error(f"--dispatch-steps must be >= 1, got {args.dispatch_steps}")
    try:
        if args.fft_solves:
            params = params.replace(fft_solves_per_outer=args.fft_solves)
        if args.mg_cycles:
            params = params.replace(mg_cycles_per_outer=args.mg_cycles)
        if args.outer != "float64":
            params = params.replace(outer_precision=args.outer)

        if args.fft_precision != "highest":
            params = params.replace(fft_precision=args.fft_precision)
    except ValueError as e:
        ap.error(str(e))
    mesh_arg = None
    if args.mesh is not None:
        from navierstokes_parallel_tpu.cli import parse_mesh_arg

        try:
            mesh_arg = parse_mesh_arg(args.mesh)
        except ValueError as e:
            ap.error(str(e))
    if args.method in ("auto", "rb_sor", "pallas_sor"):
        # The parity workloads are max_it-bound: a larger K runs the same
        # sweeps with fewer f64 outer passes.
        params = params.replace(
            sor_refine_every=args.refine_every or 2048)
    state = allocate_state(params)

    if args.ensemble > 0:
        if args.time_order == 2:
            ap.error("--ensemble benchmarks solve_ensemble, which "
                     "integrates first-order — drop --time-order 2 "
                     "(silently timing Euler under an AB2 flag would "
                     "corrupt the A/B)")
        return _bench_ensemble(params, args)

    if params.problem == 5:
        return _bench_thermal(params, args, mesh_arg)

    if args.backend == "sharded":
        # Honor --method: auto takes the pencil-decomposed all_to_all DCT
        # (ops/fft.py::make_sharded_inner) at 2048^2+ when the grid tiles
        # the mesh, mg when it doesn't.
        if args.method != "auto":
            sharded_method = args.method
        elif params.i_max >= 2048:
            from navierstokes_parallel_tpu.parallel.topology import (
                local_block_dims, make_grid_mesh,
            )

            mesh = mesh_arg or make_grid_mesh(
                i_max=params.i_max, j_max=params.j_max)
            px, py = mesh.devices.shape
            li, lj = local_block_dims((px, py), params.i_max, params.j_max)
            pencil_ok = (px * li == params.i_max and py * lj == params.j_max
                         and li % py == 0 and lj % px == 0)
            sharded_method = "fft" if pencil_ok else "mg"
        else:
            sharded_method = "rb_sor"
        print(f"pressure solver: {sharded_method} (sharded)", file=sys.stderr)
        from navierstokes_parallel_tpu.parallel.sharded import (
            compile_sharded_solve,
        )

        _runner = compile_sharded_solve(params, state, mesh_arg,
                                        pressure_method=sharded_method,
                                        time_order=args.time_order)

        def run():
            # Device phase only: the reference protocol times the solver,
            # not the download (the jnp arm pays no gather either).  The
            # output stays in the sharded block layout — no State wrapper,
            # which would misrepresent the grid contract.
            uo, vo, po, t, stats = _runner.run_device()
            return uo, stats
    elif args.backend == "gspmd":
        from navierstokes_parallel_tpu.parallel.gspmd import (
            compile_gspmd_solve,
        )

        # Honor --method, mirroring the single-chip auto policy (fft at
        # 2048^2+ where plain SOR is impractical; gspmd supports fft).
        if args.method == "pallas_sor":
            print("warning: gspmd backend cannot run pallas_sor (a foreign "
                  "call is opaque to the SPMD partitioner); using rb_sor",
                  file=sys.stderr)
            gspmd_method = "rb_sor"
        elif args.method != "auto":
            gspmd_method = args.method
        else:
            gspmd_method = "fft" if params.i_max >= 2048 else "rb_sor"
        print(f"pressure solver: {gspmd_method} (gspmd)", file=sys.stderr)

        run = compile_gspmd_solve(params, state, mesh_arg,
                                  pressure_method=gspmd_method,
                                  time_order=args.time_order)
    else:
        if args.method != "auto":
            method = args.method
        elif args.backend == "auto":
            if params.i_max >= 2048:
                # Plain SOR is impractical here (the reference itself never
                # converges); fft is the direct DCT solve.
                method = "fft"
            else:
                from navierstokes_parallel_tpu.ops.sor import default_method
                method = default_method(params)
        else:
            method = {"jnp": "rb_sor", "pallas": "pallas_sor"}[args.backend]
        print(f"pressure solver: {method}", file=sys.stderr)
        dispatch = args.dispatch
        if dispatch == "auto":
            dispatch = "monolithic"
        if args.time_order == 2 and dispatch != "monolithic":
            ap.error("--time-order 2 runs as one monolithic while_loop "
                     "program (the AB2 carry is while_loop state); drop "
                     f"--dispatch {dispatch}")
        if args.time_order == 2:
            from navierstokes_parallel_tpu.solver import (
                _solve_ab2_on_device, ab2_init,
            )

            ab2 = ab2_init(state)
            # Already @jit-decorated (solver.py) — lower directly, like
            # the thermal twin above.
            compiled_ab2 = (
                _solve_ab2_on_device.lower(params, ab2, method).compile()
            )

            def run():
                out, stats = compiled_ab2(ab2)
                return out.s, stats
        elif dispatch == "stepwise":
            from navierstokes_parallel_tpu.solver import solve_stepwise

            def run():
                return solve_stepwise(params, state, pressure_method=method)
        elif dispatch == "segmented":
            from navierstokes_parallel_tpu.solver import solve_segmented

            def run():
                return solve_segmented(params, state, pressure_method=method,
                                       steps_per_dispatch=args.dispatch_steps)
        else:
            # AOT-compile so the timed run excludes compilation (the C
            # reference has no JIT; its harness times only the solver loop,
            # run.sh:57-66).  Already @jit-decorated — lower directly.
            compiled = _solve_on_device.lower(params, state,
                                              method).compile()

            def run():
                return compiled(state)

    # Warmup (also compiles the sharded path), then the timed runs.
    jax.block_until_ready(run())
    best, out_state, stats = _time_solver(run, args)

    n = params.i_max
    total_iters = int(stats.total_sor_iterations)
    steps = int(stats.steps)
    mlups = total_iters * params.i_max * params.j_max / best / 1e6

    # The reference baselines are its Re=1000 cavity workloads; a channel
    # run (problem 3, beyond-reference) gets its own metric name and no
    # vs_baseline.
    channel = params.problem == 3
    baseline = None if channel else CUDA_BASELINE_S.get(n)
    result = {
        "metric": (f"channel{n}_solver_seconds" if channel
                   else f"cavity{n}_re1000_solver_seconds"),
        "value": round(best, 6),
        "unit": "s",
        "vs_baseline": round(baseline / best, 3) if baseline else None,
    }
    # Diagnostics on stderr (never pollute the JSON stdout line).
    print(
        f"steps={steps} sor_iterations={total_iters} "
        f"sor_failures={int(stats.sor_failures)} "
        f"seconds={best:.6f} mlups={mlups:.1f} "
        f"serial_baseline={SERIAL_BASELINE_S.get(n)}s "
        f"cuda_baseline={baseline}s",
        file=sys.stderr,
    )
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
