"""Rayleigh-Benard validation: critical-Ra onset + supercritical Nusselt.

Two independent checks of the heated-from-below Boussinesq family
(models/convection.py::rayleigh_benard_setup):

1. --mode onset: measure the linear growth rate of the single-roll mode
   in the critical free-slip box (width pi/3.117) at two near-critical
   Rayleigh numbers and extrapolate sigma=0 linearly.  Must land on
   Chandrasekhar's rigid-rigid Ra_c = 1707.762 — closed-form theory, no
   fitted constants (measured 0.002% off at 32x32 on CPU).
   Writes artifacts/rb_onset.csv.

2. --mode branch: run the critical free-slip box TO STEADY STATE across
   onset: subcritical Ra must relax back to conduction (Nu = 1), and the
   supercritical Nu(Ra) branch is linear near onset (Schlueter-Lortz-
   Busse), so extrapolating Nu-1 -> 0 recovers Ra_c from the NONLINEAR
   side — a second no-fitted-constants estimate, independent of mode 1.
   Writes artifacts/rb_branch.csv.

3. --mode nusselt: run the SQUARE no-slip cavity (adiabatic sidewalls)
   to steady state from a seeded single-roll perturbation and compare
   the plate Nusselt numbers against Ouertatani et al. (2008):
   2.154 / 3.907 / 6.363 for Ra = 1e4/1e5/1e6, plus the exact
   bottom/top flux balance.  Writes artifacts/rb_nusselt.csv.

Usage:
  python scripts/validate_rb.py --mode onset --n 64 [--platform cpu]
  python scripts/validate_rb.py --mode nusselt --ra 1e4 1e5 --n 128
"""

import argparse
import csv
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _write_onset_csv(out, rows):
    with open(out, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["Ra", "n", "method", "sigma", "E0_or_ref",
                    "E1_or_rel", "t0", "t1", "wall_s"])
        w.writerows(rows)
    print(f"wrote {out}")


def run_onset(args, cv):
    if len(args.onset_ra) < 2:
        print("--onset-ra needs at least two Rayleigh numbers to "
              "extrapolate sigma=0", file=sys.stderr)
        return False
    rows = []
    sig = []
    out = args.out or "artifacts/rb_onset.csv"
    for ra in args.onset_ra:
        t0 = time.time()
        r = cv.rb_growth_rate(ra, n=args.n, t_transient=args.transient,
                              t_measure=args.measure,
                              pressure_method=args.method)
        wall = time.time() - t0
        print(f"Ra={ra:g} n={args.n}: sigma={r['sigma']:+.6f} "
              f"(E {r['E0']:.3e} -> {r['E1']:.3e}) [{wall:.0f}s]")
        sig.append(r)
        rows.append([ra, args.n, args.method, r["sigma"], r["E0"],
                     r["E1"], r["t0"], r["t1"], wall])
        # Persist per-Ra results as they land: a long run must not
        # lose its measurements to a crash in the extrapolation below.
        _write_onset_csv(out, rows)
    r1, r2 = sig[0], sig[-1]
    if r2["sigma"] == r1["sigma"]:
        print(f"  FAIL: equal growth rates at Ra={r1['Ra']:g} and "
              f"Ra={r2['Ra']:g} — cannot extrapolate (per-Ra rows kept "
              f"in {out})", file=sys.stderr)
        return False
    ra_c = r1["Ra"] - r1["sigma"] * (r2["Ra"] - r1["Ra"]) / (
        r2["sigma"] - r1["sigma"])
    rel = abs(ra_c - cv.RB_CRITICAL_RA) / cv.RB_CRITICAL_RA
    print(f"extrapolated Ra_c = {ra_c:.2f} (theory "
          f"{cv.RB_CRITICAL_RA}, rel err {rel:.2e})")
    rows.append(["extrapolated_Ra_c", args.n, args.method, ra_c,
                 cv.RB_CRITICAL_RA, rel, "", "", ""])
    ok = rel <= args.tol
    if not ok:
        print(f"  FAIL: Ra_c rel err {rel:.4f} > tol {args.tol}",
              file=sys.stderr)
    _write_onset_csv(out, rows)
    return ok


def run_branch(args, cv):
    """Steady Nu(Ra) branch in the critical free-slip box: subcritical
    Ra relax back to conduction (Nu=1 exactly); the supercritical branch
    is linear near onset (Schlueter-Lortz-Busse weakly nonlinear
    theory), so a linear fit of Nu-1 extrapolates to Ra_c from the
    NONLINEAR side — independent of the growth-rate route."""
    import numpy as np

    rows = []
    branch = []
    ok = True
    for ra in args.branch_ra:
        t0 = time.time()
        params, cfg = cv.rayleigh_benard_setup(
            ra, n=args.n, aspect=cv.RB_CRITICAL_ASPECT,
            sidewalls="freeslip")
        state = cv.seed_rb_perturbation(
            cv.allocate_thermal(params, cfg), params, cfg, amp=0.05)
        state, info = cv.solve_convection(params, cfg, state,
                                          pressure_method=args.method,
                                          steady_tol=args.steady_tol)
        nu_b = cv.nusselt_bottom(state.T, params)
        nu_t = cv.nusselt_top(state.T, params)
        wall = time.time() - t0
        sub = ra < cv.RB_CRITICAL_RA
        print(f"Ra={ra:g} n={args.n}: Nu_bottom={nu_b:.5f} "
              f"Nu_top={nu_t:.5f} steps={info['steps']} "
              f"steady={info['steady']} [{wall:.0f}s]"
              + ("  (subcritical)" if sub else ""))
        rows.append([ra, args.n, args.method, nu_b, nu_t, info["steps"],
                     wall])
        if sub:
            if abs(nu_b - 1.0) > 0.005:
                print(f"  FAIL: subcritical Nu {nu_b:.5f} != 1",
                      file=sys.stderr)
                ok = False
        else:
            branch.append((ra, nu_b))
        if abs(nu_b - nu_t) > 0.02 * max(abs(nu_b), 1.0):
            print(f"  FAIL: plate imbalance {nu_b:.4f} vs {nu_t:.4f}",
                  file=sys.stderr)
            ok = False
    if len(branch) >= 2:
        ras = np.array([b[0] for b in branch])
        nus = np.array([b[1] for b in branch])
        slope, icept = np.polyfit(ras, nus - 1.0, 1)
        ra_c = -icept / slope
        rel = abs(ra_c - cv.RB_CRITICAL_RA) / cv.RB_CRITICAL_RA
        # Schlueter-Lortz-Busse 1965 initial slope for rigid-rigid
        # plates: d(Nu)/d(Ra/Ra_c) = 1/(0.69942 - 0.00472/Pr
        # + 0.00832/Pr^2) — 1.410 at Pr=0.71 (finite-epsilon branch
        # points bend below it, so report, don't assert).
        slb = 1.0 / (0.69942 - 0.00472 / 0.71 + 0.00832 / 0.71 ** 2)
        print(f"branch fit: Nu-1 = {slope:.3e}*(Ra - {ra_c:.1f}); "
              f"Ra_c rel err {rel:.2e}; initial slope "
              f"dNu/d(Ra/Ra_c) = {slope * ra_c:.3f} (SLB theory "
              f"{slb:.3f})")
        rows.append(["branch_Ra_c", args.n, args.method, ra_c,
                     cv.RB_CRITICAL_RA, rel, slope * ra_c])
        if rel > args.tol:
            print(f"  FAIL: branch Ra_c rel err {rel:.4f} > {args.tol}",
                  file=sys.stderr)
            ok = False
    out = args.out or "artifacts/rb_branch.csv"
    with open(out, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["Ra", "n", "method", "nu_bottom_or_rac",
                    "nu_top_or_ref", "steps_or_rel", "wall_s_or_slope"])
        w.writerows(rows)
    print(f"wrote {out}")
    return ok


def run_nusselt(args, cv):
    rows = []
    ok = True
    for ra in args.ra:
        t0 = time.time()
        params, cfg = cv.rayleigh_benard_setup(ra, n=args.n)
        state = cv.seed_rb_perturbation(
            cv.allocate_thermal(params, cfg), params, cfg, amp=0.05)
        state, info = cv.solve_convection(params, cfg, state,
                                          pressure_method=args.method,
                                          steady_tol=args.steady_tol)
        nu_b = cv.nusselt_bottom(state.T, params)
        nu_t = cv.nusselt_top(state.T, params)
        ref = cv.OUERTATANI_RB_NU.get(ra)
        rel = abs(nu_b - ref) / ref if ref else float("nan")
        wall = time.time() - t0
        print(f"Ra={ra:g} n={args.n}: Nu_bottom={nu_b:.4f} "
              f"Nu_top={nu_t:.4f} ref={ref} rel_err={rel:.4f} "
              f"steps={info['steps']} steady={info['steady']} "
              f"[{wall:.0f}s]")
        rows.append([ra, args.n, args.method, nu_b, nu_t, ref, rel,
                     info["steps"], wall])
        if ref and rel > args.tol:
            print(f"  FAIL: rel err {rel:.4f} > tol {args.tol}",
                  file=sys.stderr)
            ok = False
        if abs(nu_b - nu_t) > 0.02 * max(abs(nu_b), 1.0):
            print(f"  FAIL: plate imbalance {nu_b:.4f} vs {nu_t:.4f}",
                  file=sys.stderr)
            ok = False
    out = args.out or "artifacts/rb_nusselt.csv"
    with open(out, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["Ra", "n", "method", "nu_bottom", "nu_top",
                    "nu_ouertatani", "rel_err", "steps", "wall_s"])
        w.writerows(rows)
    print(f"wrote {out}")
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="onset",
                    choices=["onset", "nusselt", "branch"])
    ap.add_argument("--ra", nargs="+", type=float, default=[1e4],
                    help="Rayleigh numbers for --mode nusselt")
    ap.add_argument("--onset-ra", nargs="+", type=float,
                    default=[1850.0, 2100.0])
    ap.add_argument("--branch-ra", nargs="+", type=float,
                    default=[1600.0, 1800.0, 1900.0, 2000.0, 2200.0])
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--method", default="mg",
                    choices=["fft", "mg", "rb_sor", "cg"])
    ap.add_argument("--transient", type=float, default=15.0)
    ap.add_argument("--measure", type=float, default=25.0)
    ap.add_argument("--steady-tol", type=float, default=1e-6)
    ap.add_argument("--platform", default="cpu")
    ap.add_argument("--tol", type=float, default=None,
                    help="asserted relative tolerance "
                         "(default: 0.02 onset, 0.10 nusselt)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.tol is None:
        args.tol = {"onset": 0.02, "branch": 0.03,
                    "nusselt": 0.10}[args.mode]

    import jax

    jax.config.update("jax_platforms", args.platform)
    jax.config.update("jax_enable_x64", True)

    from navierstokes_parallel_tpu.models import convection as cv

    os.makedirs("artifacts", exist_ok=True)
    if args.mode == "onset":
        ok = run_onset(args, cv)
    elif args.mode == "branch":
        ok = run_branch(args, cv)
    else:
        ok = run_nusselt(args, cv)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
