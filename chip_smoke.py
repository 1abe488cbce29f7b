#!/usr/bin/env python
"""Smoke test of the solver on NVIDIA GPUs: the quickest proof that the
system still starts, and is right, on the card.

    python chip_smoke.py               # one GPU: phases 1-4
    python chip_smoke.py --four-cards  # four GPUs: phase 5 only

Every phase runs in this one process (the CLI is called in-process), so one
JAX process holds the card.  Phases:

  1. device: platform, device kind and count; the card's name and power
     limit from nvidia-smi.
  2. main path, 256^2: configs/1.in through the CLI's default path; its
     U-CENTER / V-CENTER agree with the native C serial backend within the
     reference's 1e-4 comparator (utils/io.py tolerance_errors).
  3. the CUDA SOR kernel (csrc/rb_sor.cu) against its XLA twin
     `_roll_sweeps_xla` at 256^2, 1024^2 and 2048^2 (max |d delta| <=
     1e-5 max |delta|: both are float32 with the same per-cell operations,
     only FMA contraction may differ), each route's time per sweep, and
     configs/1.in and configs/3.in end to end under pallas_sor and rb_sor.
  4. converging path: configs/4.in (2048^2) under fft and mg, both with
     sor_failures=0 and centre values within 1e-4 of each other.
  5. (--four-cards) --backend sharded with rb_sor on configs/3.in, sharded
     and gspmd with fft on configs/4.in, each on a 2x2 mesh and within 1e-4
     of the one-card run of the same method.

Exits non-zero when any phase fails or JAX finds no GPU.  The last line of
stdout, printed only when every phase passed, is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

import argparse
import contextlib
import io
import json
import os
import sys
import time

import jax

jax.config.update("jax_enable_x64", True)

HERE = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-4          # the reference's comparator tolerance
KERNEL_TOL = 1e-5   # kernel vs XLA twin, relative to max |delta|


def log(msg: str) -> None:
    print(msg, flush=True)


def config(name: str) -> str:
    return os.path.join(HERE, "configs", name)


def run_cli(argv):
    """cli.main in-process; returns (u_center, v_center, stats, seconds)."""
    from navierstokes_parallel_tpu import cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(list(argv) + ["--stats"])
    if rc != 0:
        raise RuntimeError(f"cli {' '.join(argv)} exited {rc}: "
                           f"{err.getvalue()[-2000:]}")
    lines = out.getvalue().split("\n")
    uc = float(lines[0].split()[1])
    vc = float(lines[1].split()[1])
    errtxt = err.getvalue()
    stats = {}
    for tok in errtxt.split():
        if "=" in tok:
            key, val = tok.split("=", 1)
            stats[key] = val
    seconds = float(errtxt.strip().split()[-1])
    return uc, vc, stats, seconds


def center_error(a, b) -> float:
    import numpy as np

    from navierstokes_parallel_tpu.utils.io import tolerance_errors

    return float(np.max(tolerance_errors(np.asarray(a), np.asarray(b))))


def phase_main_path() -> None:
    from navierstokes_parallel_tpu.backends import serial_c
    from navierstokes_parallel_tpu.config import Params

    uc, vc, stats, seconds = run_cli([config("1.in")])
    params = Params.from_file(config("1.in"), dtype="float64")
    t0 = time.perf_counter()
    ref = serial_c.solve(params)
    t_c = time.perf_counter() - t0
    ic, jc = params.i_max // 2, params.j_max // 2
    err = center_error([uc, vc], [ref.u[ic, jc], ref.v[ic, jc]])
    log(f"[2] configs/1.in (256^2) default path: U-CENTER {uc:.6f} "
        f"V-CENTER {vc:.6f}, steps={stats['steps']} "
        f"sor_iterations={stats['sor_iterations']} solve {seconds:.6f} s; "
        f"C serial U {ref.u[ic, jc]:.6f} V {ref.v[ic, jc]:.6f} "
        f"({t_c:.3f} s); max comparator error {err:.3e}")
    if int(stats["steps"]) != ref.steps or err > TOL:
        raise AssertionError(f"256^2 cavity disagrees with the C serial "
                             f"backend (err {err:.3e} > {TOL})")


def _per_sweep(fn, rhs, n):
    jax.block_until_ready(fn(rhs, n))
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(rhs, n))
        best = min(best, time.perf_counter() - t0)
    return best / n


def phase_kernel() -> None:
    import jax.numpy as jnp
    import numpy as np

    from navierstokes_parallel_tpu.config import Params
    from navierstokes_parallel_tpu.ops import sor_kernel as sk

    worst = 0.0
    for n, timed_sweeps in ((256, 1024), (1024, 256), (2048, 128)):
        params = Params(i_max=n, j_max=n, omega=1.7, dtype="float32")
        rng = np.random.default_rng(n)
        rhs = np.zeros(params.shape, np.float32)
        rhs[1:-1, 1:-1] = rng.standard_normal((n, n))
        rhs = jnp.asarray(rhs)
        check = 8 * sk.SWEEPS_PER_LAUNCH
        want = np.asarray(jax.jit(
            lambda r: sk._roll_sweeps_xla(r, check, params))(rhs))
        got = np.asarray(jax.jit(
            lambda r: sk.inner_sweeps(r, check, params, check))(rhs))
        rel = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
        worst = max(worst, rel)
        xla = jax.jit(lambda r, m: sk._roll_sweeps_xla(r, m, params))
        kern = jax.jit(lambda r, m: sk.inner_sweeps(r, m, params,
                                                    timed_sweeps))
        t_xla = _per_sweep(xla, rhs, timed_sweeps)
        t_kern = _per_sweep(kern, rhs, timed_sweeps)
        ls = sk.launch_shape(params.shape)
        log(f"[3] kernel {n}^2: {check} sweeps max|d|/max|delta| "
            f"{rel:.2e} (<= {KERNEL_TOL}); per sweep: kernel "
            f"{t_kern * 1e6:.2f} us (tile {ls.tile}, k={ls.k}) vs XLA "
            f"{t_xla * 1e6:.2f} us")
    if worst > KERNEL_TOL:
        raise AssertionError(f"CUDA kernel differs from _roll_sweeps_xla "
                             f"by {worst:.2e} > {KERNEL_TOL}")
    for cfg in ("1.in", "3.in"):
        res = {}
        for label, flags in (("pallas_sor", ["--backend", "pallas"]),
                             ("rb_sor", ["--backend", "jnp",
                                         "--method", "rb_sor"])):
            res[label] = run_cli([config(cfg)] + flags)
        err = center_error(res["pallas_sor"][:2], res["rb_sor"][:2])
        log(f"[3] configs/{cfg} end to end: pallas_sor "
            f"{res['pallas_sor'][3]:.6f} s vs rb_sor {res['rb_sor'][3]:.6f} s"
            f" (sor_iterations {res['pallas_sor'][2]['sor_iterations']} vs "
            f"{res['rb_sor'][2]['sor_iterations']}); centre values agree to "
            f"{err:.3e}")
        if err > TOL:
            raise AssertionError(f"pallas_sor and rb_sor disagree on "
                                 f"configs/{cfg} ({err:.3e} > {TOL})")


def phase_converging() -> None:
    res = {}
    for method in ("fft", "mg"):
        res[method] = run_cli([config("4.in"), "--method", method])
        uc, vc, stats, seconds = res[method]
        log(f"[4] configs/4.in (2048^2) {method}: U-CENTER {uc:.6f} "
            f"V-CENTER {vc:.6f}, steps={stats['steps']} "
            f"sor_iterations={stats['sor_iterations']} "
            f"sor_failures={stats['sor_failures']} solve {seconds:.6f} s")
        if int(stats["sor_failures"]) != 0:
            raise AssertionError(f"{method} left {stats['sor_failures']} "
                                 f"unconverged pressure solves")
    err = center_error(res["fft"][:2], res["mg"][:2])
    log(f"[4] fft vs mg centre values agree to {err:.3e}")
    if err > TOL:
        raise AssertionError(f"fft and mg disagree ({err:.3e} > {TOL})")


def phase_four_cards() -> None:
    runs = (("3.in", "rb_sor", "sharded", ["--backend", "jnp"]),
            ("4.in", "fft", "sharded", []),
            ("4.in", "fft", "gspmd", []))
    one_card = {}
    for cfg, method, backend, single_flags in runs:
        if (cfg, method) not in one_card:
            one_card[cfg, method] = run_cli(
                [config(cfg), "--method", method] + single_flags)
        ref = one_card[cfg, method]
        got = run_cli([config(cfg), "--method", method, "--backend", backend,
                       "--mesh", "2x2"])
        err = center_error(got[:2], ref[:2])
        log(f"[5] configs/{cfg} {method} --backend {backend} on 2x2: "
            f"U {got[0]:.6f} V {got[1]:.6f} ({got[3]:.6f} s, "
            f"sor_iterations={got[2]['sor_iterations']}) vs one card "
            f"U {ref[0]:.6f} V {ref[1]:.6f} ({ref[3]:.6f} s); "
            f"error {err:.3e}")
        if err > TOL:
            raise AssertionError(f"{backend} {method} on 2x2 disagrees with "
                                 f"one card ({err:.3e} > {TOL})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phase (needs 4 GPUs)")
    args = ap.parse_args(argv)

    from navierstokes_parallel_tpu.utils.device import (
        gpu_name_and_power_limit, require_device)

    dev = require_device()
    count = len(jax.devices())
    if dev.platform != "gpu":
        print(f"error: chip_smoke.py needs a GPU; JAX runs on "
              f"{dev.platform!r}", file=sys.stderr)
        return 2
    need = 4 if args.four_cards else 1
    if count < need:
        print(f"error: {need} GPUs needed, {count} visible", file=sys.stderr)
        return 2
    log(f"[1] device: {dev.platform} {dev.device_kind} x{count}; "
        f"nvidia-smi name, power.limit:")
    log(gpu_name_and_power_limit())

    phases = ([phase_four_cards] if args.four_cards
              else [phase_main_path, phase_kernel, phase_converging])
    failed = []
    for phase in phases:
        t0 = time.perf_counter()
        try:
            phase()
        except Exception as exc:  # report every phase, then fail
            failed.append(phase.__name__)
            log(f"FAILED {phase.__name__}: {type(exc).__name__}: {exc}")
        log(f"    ({phase.__name__}: {time.perf_counter() - t0:.1f} s "
            f"wall, compilation included)")
    if failed:
        print(f"error: phases failed: {', '.join(failed)}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
