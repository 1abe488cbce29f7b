#!/usr/bin/env python
"""Benchmark harness — the framework's run.sh (reference run.sh:120-160).

Reproduces the reference's CSV artifacts with identical schemas:

  results/navierstokes_speedup.csv   test,serial_time,serial_std,parallel_time,parallel_std,speedup
  results/serial_time.csv            test,serial_time,serial_std
  results/tile_size_comparison.csv   test,block_size,avg_time,std_dev
                                     (block_size column = sor_refine_every K,
                                      our analogue of the CUDA block size)

"serial" = the native C backend executable (csrc/, timed via its stderr
cumulative-SOR-seconds protocol, like the reference scrapes run.sh:57-66).
"parallel" = the GPU solve (the CLI's default method, ops.sor.default_method),
AOT-compiled so the timing excludes jit compilation — the C side has no JIT
either.

The reference's serial baselines run for hours at 1024^2/2048^2
(BASELINE.md); by default only the workloads in --tests run, and
--skip-serial substitutes the published reference serial numbers.
"""

import argparse
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

REFERENCE_SERIAL_S = {1: 48.5840, 2: 759.9033, 3: 12134.5333, 4: 198116.1122}
REFERENCE_SERIAL_STD = {1: 0.0985, 2: 1.7200, 3: 3.0559, 4: 5.8741}


def time_serial(config_path: str, runs: int):
    """Run the native C executable; scrape the stderr seconds float."""
    from navierstokes_parallel_tpu.backends import serial_c

    exe = serial_c.executable_path()
    times = []
    for _ in range(runs):
        proc = subprocess.run([exe, config_path], capture_output=True, text=True)
        proc.check_returncode()
        times.append(float(proc.stderr.strip()))
    return statistics.mean(times), statistics.stdev(times) if runs > 1 else 0.0


def time_gpu(config_path: str, runs: int, refine_every=2048):
    """refine_every defaults to the benchmark-tuned K=2048 (same as
    bench.py; the block-size analogue — the reference's harness also runs
    its best block size for the headline, speedup.csv bs=16)."""
    import jax

    jax.config.update("jax_enable_x64", True)
    from navierstokes_parallel_tpu.config import Params
    from navierstokes_parallel_tpu.utils.device import require_device
    from navierstokes_parallel_tpu.grid import allocate_state
    from navierstokes_parallel_tpu.ops.sor import default_method
    from navierstokes_parallel_tpu.solver import _solve_on_device

    overrides = {"dtype": "float32"}
    if refine_every is not None:
        overrides["sor_refine_every"] = refine_every
    require_device()
    params = Params.from_file(config_path, **overrides)
    state = allocate_state(params)
    method = default_method(params)
    compiled = (
        jax.jit(_solve_on_device, static_argnums=(0, 2))
        .lower(params, state, method)
        .compile()
    )

    def once():
        jax.block_until_ready(compiled(state))

    once()  # warmup
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        once()
        times.append(time.perf_counter() - t0)
    return statistics.mean(times), statistics.stdev(times) if runs > 1 else 0.0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tests", default="1",
                    help="comma-separated workload ids from configs/ (1..4)")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--results-dir", default="results")
    ap.add_argument("--skip-serial", action="store_true",
                    help="use the reference's published serial numbers")
    ap.add_argument("--tile-sweep", default=None,
                    help="comma-separated sor_refine_every values to sweep")
    args = ap.parse_args(argv)

    tests = [int(t) for t in args.tests.split(",")]
    cfg_dir = os.path.join(os.path.dirname(__file__), "..", "configs")
    os.makedirs(args.results_dir, exist_ok=True)

    if args.tile_sweep:
        sweep = [int(k) for k in args.tile_sweep.split(",")]
        path = os.path.join(args.results_dir, "tile_size_comparison.csv")
        with open(path, "w") as fh:
            fh.write("test,block_size,avg_time,std_dev\n")
            for k in sweep:
                for t in tests:
                    cfg = os.path.join(cfg_dir, f"{t}.in")
                    mean, std = time_gpu(cfg, args.runs, refine_every=k)
                    print(f"test {t} K={k}: {mean:.4f}s ± {std:.4f}")
                    fh.write(f"{t},{k},{mean:.4f},{std:.4f}\n")
        print(f"wrote {path}")
        return 0

    speedup_path = os.path.join(args.results_dir, "navierstokes_speedup.csv")
    serial_path = os.path.join(args.results_dir, "serial_time.csv")
    with open(speedup_path, "w") as fs, open(serial_path, "w") as fser:
        fs.write("test,serial_time,serial_std,parallel_time,parallel_std,speedup\n")
        fser.write("test,serial_time,serial_std\n")
        for t in tests:
            cfg = os.path.join(cfg_dir, f"{t}.in")
            if args.skip_serial:
                s_mean, s_std = REFERENCE_SERIAL_S[t], REFERENCE_SERIAL_STD[t]
            else:
                print(f"test {t}: timing native serial ({args.runs} runs)...")
                s_mean, s_std = time_serial(cfg, args.runs)
            print(f"test {t}: timing GPU solve ({args.runs} runs)...")
            p_mean, p_std = time_gpu(cfg, args.runs)
            speedup = s_mean / p_mean if p_mean else 0.0
            print(
                f"Test {t}: Serial={s_mean:.4f}s±{s_std:.4f}, "
                f"GPU={p_mean:.4f}s±{p_std:.4f}, Speedup={speedup:.4f}x"
            )
            fs.write(f"{t},{s_mean:.4f},{s_std:.4f},{p_mean:.4f},{p_std:.4f},"
                     f"{speedup:.4f}\n")
            fser.write(f"{t},{s_mean:.4f},{s_std:.4f}\n")
    print(f"wrote {speedup_path} and {serial_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
