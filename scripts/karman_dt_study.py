"""Space-time refinement study for the Schäfer-Turek 2D-2 ladder.

The karman resolution ladder (scripts/karman_artifact.py) refines h at a
fixed CFL safety factor tau, so the adaptive dt shrinks proportionally to
h and the ladder measures a COMBINED space-time limit.  The momentum
integrator is explicit Euler — first order in dt — while the spatial
boundary treatment is second order, so once the O(dt) term dominates the
h-ladder's apparent order collapses toward 1 and the extrapolation
absorbs a temporal bias (measured at 20 cells/D: halving tau moves St by
+3.8% and cl_max by +1.8% — larger than the remaining band gaps).

This script runs each rung at several tau values, Richardson-extrapolates
tau -> 0 PER RUNG (first order in dt; with >= 3 tau points the temporal
order is fitted instead of assumed), then Richardson-extrapolates the
time-exact rungs h -> 0 with the spatial order.  Output:
artifacts/karman_dt_study.csv with one row per (n_per_d, tau), the
per-rung tau->0 limits, and the final space-time limits vs the published
bands (St 0.2950-0.3050, cd_max 3.22-3.24, cl_max 0.99-1.01,
dp 2.46-2.50).

Reference analogue: none — the reference fixes tau = 0.5 and never
separates the two error sources (SURVEY §6 benchmarks only time its
solver); the published 2D-2 numbers are implicit/higher-order-in-time
solutions, which is exactly why the tau -> 0 limit is the right thing to
compare against.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

QUANTS = ("st", "cd_max", "cl_max", "dp_mean", "cd_s_max", "cl_s_max")
BANDS = {"st": (0.2950, 0.3050), "cd_max": (3.22, 3.24),
         "cl_max": (0.99, 1.01), "dp_mean": (2.46, 2.50),
         "cd_s_max": (3.22, 3.24), "cl_s_max": (0.99, 1.01)}


def run_rung(n, tau, T, method, chunk, time_order=1):
    from navierstokes_parallel_tpu.models import karman as K

    params = K.schafer_turek(n_per_d=n, T=T, tau=tau)
    rec = K.surface_force_record_fn(params, 5, *K.probe_node(params))
    t0 = time.perf_counter()
    tr = K.shedding_signal(params, method=method, chunk=chunk,
                           record_fn=rec, time_order=time_order)
    wall = time.perf_counter() - t0
    st, _ = K.strouhal(tr.t, tr.v, skip_frac=0.7)
    co = K.coefficients(tr, params, skip_frac=0.7)
    row = dict(n=n, tau=tau, steps=int(tr.stats.steps),
               fails=int(tr.stats.sor_failures), wall=wall, st=st,
               cd_max=co["cd_max"], cl_max=co["cl_max"],
               dp_mean=co["dp_mean"], cd_s_max=co["cd_s_max"],
               cl_s_max=co["cl_s_max"])
    print("  " + " ".join(f"{k}={v:.4f}" if isinstance(v, float)
                          else f"{k}={v}" for k, v in row.items()),
          flush=True)
    return row


def tau_limit(rows):
    """tau -> 0 Richardson per quantity from this rung's tau ladder
    (finest two points, fitted temporal order from three when monotone;
    dt scales linearly with tau at fixed h)."""
    rows = sorted(rows, key=lambda r: -r["tau"])
    out = {}
    for q in QUANTS:
        v = [r[q] for r in rows]
        t = [r["tau"] for r in rows]
        p = 1.0
        if len(v) >= 3:
            num, den = v[-3] - v[-2], v[-2] - v[-1]
            if den != 0 and num / den > 0:
                # Solve ratio = (t1^p - t2^p)/(t2^p - t3^p) by bisection.
                def g(p):
                    return ((t[-3] ** p - t[-2] ** p)
                            / (t[-2] ** p - t[-1] ** p) - num / den)
                lo, hi = 0.2, 4.0
                if g(lo) * g(hi) < 0:
                    for _ in range(80):
                        mid = 0.5 * (lo + hi)
                        lo, hi = (lo, mid) if g(lo) * g(mid) <= 0 \
                            else (mid, hi)
                    p = max(0.5, 0.5 * (lo + hi))
        C = (v[-2] - v[-1]) / (t[-2] ** p - t[-1] ** p)
        out[q] = v[-1] - C * t[-1] ** p
        out[q + "_order"] = p
    return out


def h_limit(ns, limits, p_spatial=2.0):
    """h -> 0 Richardson on the per-rung tau->0 limits (fitted spatial
    order from the finest monotone triple, nominal fallback) WITH an
    extrapolation error bar.

    The error bar follows Roache's grid-convergence-index discipline
    (ASME V&V 20 practice): the uncertainty of a Richardson limit is a
    safety factor times the magnitude of the correction it applied,
    |f_limit - f_finest|.  Fs = 1.25 when the observed order was actually
    demonstrated by the fit; Fs = 3.0 when the triple was non-monotone /
    outside the fit window and the NOMINAL order had to be assumed — the
    honest admission that the rungs are not yet asymptotic (the round-4
    ladders' cd differences at 20/30/40 cells/D are nearly equal, so the
    fit fails and the 3x bar applies)."""
    out = {}
    h = [1.0 / n for n in ns]
    for q in QUANTS:
        v = [limits[n][q] for n in ns]
        p, fitted = p_spatial, False
        if len(v) >= 3:
            num, den = v[-3] - v[-2], v[-2] - v[-1]
            if den != 0 and num / den > 0:
                def g(p):
                    return ((h[-3] ** p - h[-2] ** p)
                            / (h[-2] ** p - h[-1] ** p) - num / den)
                lo, hi = 0.2, 5.0
                if g(lo) * g(hi) < 0:
                    for _ in range(80):
                        mid = 0.5 * (lo + hi)
                        lo, hi = (lo, mid) if g(lo) * g(mid) <= 0 \
                            else (mid, hi)
                    pf = 0.5 * (lo + hi)
                    if pf >= 0.5:
                        p, fitted = pf, True
        C = (v[-2] - v[-1]) / (h[-2] ** p - h[-1] ** p)
        out[q] = v[-1] - C * h[-1] ** p
        out[q + "_order"] = p
        out[q + "_fitted"] = fitted
        # Scatter floor: a near-zero finest correction can coexist with
        # visible rung-to-rung scatter (e.g. the AB2 St ladder: 0.3040 /
        # 0.3032 / 0.3031) — the bar must not report more certainty than
        # the rungs themselves show.
        floor = (max(v[-3:]) - min(v[-3:])) / 2 if len(v) >= 3 else 0.0
        out[q + "_err"] = max(
            (1.25 if fitted else 3.0) * abs(out[q] - v[-1]), floor)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--resolutions", default="20,30,40")
    ap.add_argument("--taus", default="0.5,0.25")
    ap.add_argument("--T", type=float, default=150.0)
    ap.add_argument("--method", default="mg")
    ap.add_argument("--time-order", type=int, default=1, choices=(1, 2),
                    help="2 = Adams-Bashforth-2 momentum stepping "
                         "(solver.step_ab2): the Euler O(dt) error is "
                         "gone, so the remaining tau-sensitivity "
                         "isolates the donor-cell gamma=tau dissipation "
                         "— an independent route to the same tau->0 "
                         "rung limits (cross-validation)")
    ap.add_argument("--chunk", type=int, default=128)
    ap.add_argument("--out", default="artifacts")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--cache-only", action="store_true",
                    help="recompute the tau->0 / h->0 / order summary rows "
                         "from the cells already in the CSV without running "
                         "anything: rungs keep whatever (possibly partial) "
                         "tau ladder they have, rungs with < 2 tau points "
                         "are skipped.  For regenerating summaries after a "
                         "truncated finer-rung attempt.")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    ns = [int(s) for s in args.resolutions.split(",")]
    taus = sorted((float(s) for s in args.taus.split(",")), reverse=True)
    os.makedirs(args.out, exist_ok=True)
    suffix = "_ab2" if args.time_order == 2 else ""
    csv = os.path.join(args.out, f"karman_dt_study{suffix}.csv")

    # Resume: measured (n, tau) cells already in the CSV are reused, so a
    # worker crash (or a ladder row measured by scripts/karman_artifact.py
    # with the identical protocol and hand-seeded here) never costs a rerun.
    rows = []
    if os.path.exists(csv):
        with open(csv) as f:
            header = f.readline().strip().split(",")
            for line in f:
                cells = line.strip().split(",")
                if len(cells) != len(header) or not cells[1][:1].isdigit():
                    continue    # tau->0 / h->0 / order summary rows
                r = dict(zip(header, cells))
                rows.append(dict(
                    n=int(r["n_per_d"]), tau=float(r["tau"]),
                    steps=int(r["steps"]), fails=int(r["fails"]),
                    wall=float(r["wall_seconds"]),
                    **{q: float(r[q]) for q in QUANTS}))
        if rows:
            print(f"resumed {len(rows)} measured cells from {csv}")
    limits = {}

    def write_csv():
        with open(csv, "w") as f:
            f.write("n_per_d,tau,steps,fails,wall_seconds,"
                    + ",".join(QUANTS) + "\n")
            for r in rows:
                f.write(f"{r['n']},{r['tau']},{r['steps']},{r['fails']},"
                        f"{r['wall']:.1f},"
                        + ",".join(f"{r[q]:.4f}" for q in QUANTS) + "\n")
            for n in sorted(limits):
                lim = limits[n]
                f.write(f"{n},tau->0,-,-,-,"
                        + ",".join(f"{lim[q]:.4f}" for q in QUANTS) + "\n")
            if len(limits) >= 2:
                fin = h_limit(sorted(limits), limits)
                f.write("h->0,tau->0,-,-,-,"
                        + ",".join(f"{fin[q]:.4f}" for q in QUANTS) + "\n")
                f.write("spatial_order,-,-,-,-,"
                        + ",".join(f"{fin[q + '_order']:.2f}"
                                   f"[{'fit' if fin[q + '_fitted'] else 'nom'}]"
                                   for q in QUANTS) + "\n")
                f.write("extrap_err,-,-,-,-,"
                        + ",".join(f"{fin[q + '_err']:.4f}"
                                   for q in QUANTS) + "\n")
                print("space-time limits vs bands (err = GCI bar, "
                      "Fs=1.25 fit / 3.0 nominal):")
                for q in QUANTS:
                    lo, hi = BANDS[q]
                    v, e = fin[q], fin[q + "_err"]
                    where = ("IN" if lo <= v <= hi else
                             "IN(+err)" if lo - e <= v <= hi + e else
                             f"{(v - hi) / hi * 100:+.1f}%" if v > hi else
                             f"{(v - lo) / lo * 100:+.1f}%")
                    print(f"  {q}: {v:.4f} +/- {e:.4f}  band [{lo}, {hi}]"
                          f"  {where}")

    if args.cache_only:
        ns = sorted({r["n"] for r in rows})
    for n in ns:
        per_rung = []
        # --cache-only promises "rungs keep whatever (possibly partial)
        # tau ladder they have": iterate the rung's CACHED taus, not the
        # CLI list — otherwise a default --taus silently drops cached
        # finer-tau cells (e.g. the 40-rung's 0.125 cell) and the
        # rewritten summary rows revert to less-converged limits.
        rung_taus = (sorted({r["tau"] for r in rows if r["n"] == n},
                            reverse=True)
                     if args.cache_only else taus)
        for tau in rung_taus:
            have = [r for r in rows if r["n"] == n and r["tau"] == tau]
            if have:
                print(f"n_per_d={n} tau={tau}: cached", flush=True)
                per_rung.append(have[0])
                continue
            if args.cache_only:
                continue
            print(f"n_per_d={n} tau={tau}:", flush=True)
            r = run_rung(n, tau, args.T, args.method, args.chunk,
                         args.time_order)
            per_rung.append(r)
            rows.append(r)
            write_csv()          # crash-proof: rewrite after every run
        if len(per_rung) < 2:
            print(f"n_per_d={n}: {len(per_rung)} tau point(s) — skipped "
                  "from the ladder", flush=True)
            continue
        limits[n] = tau_limit(per_rung)
        print(f"n_per_d={n} tau->0: " + " ".join(
            f"{q}={limits[n][q]:.4f}(p={limits[n][q + '_order']:.2f})"
            for q in QUANTS), flush=True)
        write_csv()
    print(f"wrote {csv}")


if __name__ == "__main__":
    main()
