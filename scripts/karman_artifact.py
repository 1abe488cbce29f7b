"""Kármán vortex street artifact: Schäfer-Turek 2D-2 resolution study.

Runs the circular-cylinder channel (models/karman.py) at a ladder of
resolutions, extracts the Strouhal number of the saturated limit cycle,
Richardson-extrapolates the staircase-cylinder sequence (1st order in
dx — the staircase boundary dominates), and writes:

  artifacts/karman_strouhal.csv   n_per_d, grid, steps, St, amplitude,
                                  wall seconds (+ an `extrapolated` row)
  artifacts/karman_street.png     spanwise-vorticity snapshot of the
                                  saturated street at the finest grid,
                                  cylinder mask overlaid

Published target: St in [0.2950, 0.3050] (Schäfer & Turek 1996, table 4).

Usage: python scripts/karman_artifact.py [--resolutions 10,20,30]
       [--T 150] [--method mg] [--out artifacts] [--cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--resolutions", default="10,20,30",
                    help="comma list of cells per diameter (multiples of 10)")
    ap.add_argument("--T", type=float, default=150.0)
    ap.add_argument("--method", default="mg", choices=["mg", "rb_sor"])
    ap.add_argument("--out", default="artifacts")
    ap.add_argument("--chunk", type=int, default=128,
                    help="steps per on-device scan dispatch")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--staircase", action="store_true",
                    help="first-order mirror BCs (sharp=False) for A/B "
                         "against the default second-order ghost-fluid "
                         "cylinder")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    from navierstokes_parallel_tpu.models import karman as K

    ns = [int(s) for s in args.resolutions.split(",")]
    os.makedirs(args.out, exist_ok=True)
    rows = []
    finest = None
    csv = os.path.join(args.out, "karman_strouhal.csv")
    for n in ns:
        params = K.schafer_turek(n_per_d=n, T=args.T,
                                 sharp=not args.staircase)
        if params.obstacle_surfaces:
            # Sharp mode also integrates the INDEPENDENT surface-traction
            # estimator on the analytic circle (cd_s/cl_s columns) — the
            # CV balance and the traction quadrature converge toward the
            # published bands from opposite sides.
            rec = K.surface_force_record_fn(params, 5,
                                            *K.probe_node(params))
        else:
            rec = K.force_record_fn(params, 5, *K.probe_node(params))
        t0 = time.perf_counter()
        trace = K.shedding_signal(params, method=args.method,
                                  chunk=args.chunk, record_fn=rec)
        wall = time.perf_counter() - t0
        st, amp = K.strouhal(trace.t, trace.v, skip_frac=0.7)
        co = K.coefficients(trace, params, skip_frac=0.7)
        rows.append((n, f"{params.i_max}x{params.j_max}",
                     trace.stats.steps, st, amp, co["cd_max"],
                     co["cl_max"], co["dp_mean"], wall,
                     co.get("cd_s_max"), co.get("cl_s_max")))
        finest = (params, trace)
        surf = (f" cd_s={co['cd_s_max']:.3f} cl_s={co['cl_s_max']:.3f}"
                if "cd_s_max" in co else "")
        print(f"n_per_d={n}: grid {params.i_max}x{params.j_max} "
              f"steps={trace.stats.steps} St={st:.4f} amp={amp:.3f} "
              f"cd_max={co['cd_max']:.3f} cl_max={co['cl_max']:.3f} "
              f"dp={co['dp_mean']:.3f}{surf} "
              f"fails={trace.stats.sor_failures} wall={wall:.0f}s",
              flush=True)
        # Rewrite the CSV after EVERY rung: a failure on a later (bigger)
        # rung must not lose the finished ladder below it.
        _write_csv(csv, rows, args.staircase)
    print(f"wrote {csv}")

    params, trace = finest
    _plot_street(params, trace, os.path.join(args.out, "karman_street.png"))


def _write_csv(csv, rows, staircase):
    surf = rows and rows[0][9] is not None
    with open(csv, "w") as f:
        f.write("n_per_d,grid,steps,strouhal,amplitude,cd_max,cl_max,"
                "dp_mean,wall_seconds" + (",cd_s_max,cl_s_max" if surf
                                          else "") + "\n")
        for r in rows:
            f.write(f"{r[0]},{r[1]},{r[2]},{r[3]:.4f},{r[4]:.4f},"
                    f"{r[5]:.4f},{r[6]:.4f},{r[7]:.4f},{r[8]:.1f}"
                    + (f",{r[9]:.4f},{r[10]:.4f}" if surf else "") + "\n")
        if len(rows) >= 2:
            # Richardson extrapolation with an OBSERVED-order estimate
            # when >= 3 rungs are available (fit q = q_inf + C h^p on the
            # finest three; round-3 verdict: assuming p=1 extrapolated
            # the staircase cd PAST the published band).  Falls back to
            # the nominal boundary order (2 sharp / 1 staircase) on two
            # rungs or a non-monotone triple.
            p_nom = 1.0 if staircase else 2.0
            ex, orders, srcs = [], [], []
            cols = (3, 5, 6, 7) + ((9, 10) if surf else ())
            for k in cols:
                q = [r[k] for r in rows[-3:]]
                h = [1.0 / r[0] for r in rows[-3:]]
                p, q_inf, fitted = _richardson(q, h, p_nom)
                orders.append(p)
                ex.append(q_inf)
                srcs.append("fit" if fitted else "nominal")
            tail = (f",{ex[4]:.4f},{ex[5]:.4f}" if surf else "")
            otail = (f",{orders[4]:.2f},{orders[5]:.2f}" if surf else "")
            stail = (f",{srcs[4]},{srcs[5]}" if surf else "")
            f.write(f"extrapolated,-,-,{ex[0]:.4f},-,{ex[1]:.4f},"
                    f"{ex[2]:.4f},{ex[3]:.4f},-{tail}\n")
            f.write(f"observed_order,-,-,{orders[0]:.2f},-,"
                    f"{orders[1]:.2f},{orders[2]:.2f},{orders[3]:.2f},-"
                    f"{otail}\n")
            # Which entries carry a genuinely FITTED 3-rung order vs the
            # nominal-order finest-pair fallback (non-monotone or
            # non-asymptotic triple) — without this row a fallback 2.00
            # is indistinguishable from a measured 2.00.
            f.write(f"order_source,-,-,{srcs[0]},-,{srcs[1]},{srcs[2]},"
                    f"{srcs[3]},-{stail}\n")
            surf_msg = (f", surface-traction cd_max={ex[4]:.4f} "
                        f"cl_max={ex[5]:.4f}" if surf else "")
            print(f"Richardson-extrapolated (orders "
                  f"{', '.join(f'{o:.2f}[{s}]' for o, s in zip(orders, srcs))}"
                  f"): St={ex[0]:.4f} (band 0.2950-0.3050), "
                  f"cd_max={ex[1]:.4f} (3.22-3.24), cl_max={ex[2]:.4f} "
                  f"(0.99-1.01), dp={ex[3]:.4f} (2.46-2.50){surf_msg}")


def _richardson(q, h, p_nominal):
    """(observed order p, extrapolated q_inf, fitted) from the finest-
    available rungs, coarse->fine ordering.  With three rungs, solve
    (q1-q2)/(q2-q3) = (h1^p - h2^p)/(h2^p - h3^p) for p by bisection; a
    non-monotone or non-asymptotic triple (ratio <= 0, no bracketing sign
    change, or fitted p < 1/2) falls back to p_nominal on the finest pair
    with fitted=False."""
    if len(q) >= 3:
        q1, q2, q3 = q[-3:]
        h1, h2, h3 = h[-3:]
        num, den = q1 - q2, q2 - q3
        if den != 0 and num / den > 0:
            def g(p):
                return ((h1 ** p - h2 ** p) / (h2 ** p - h3 ** p)
                        - num / den)

            lo, hi = 0.1, 5.0
            if g(lo) * g(hi) < 0:
                for _ in range(80):
                    mid = 0.5 * (lo + hi)
                    if g(lo) * g(mid) <= 0:
                        hi = mid
                    else:
                        lo = mid
                p = 0.5 * (lo + hi)
                # A fitted order below ~1/2 means the triple is not in
                # the asymptotic range (successive differences barely
                # shrink); the 1/(h2^p - h3^p) factor then amplifies the
                # rung noise into an absurd limit (observed: a monotone
                # cl ladder ending at 0.898 "extrapolating" to 1.57).
                # Fall back to the nominal boundary order on the finest
                # pair instead, like the non-monotone case below.
                if p >= 0.5:
                    C = (q2 - q3) / (h2 ** p - h3 ** p)
                    return p, q3 - C * h3 ** p, True
    q2, q3 = q[-2:]
    h2, h3 = h[-2:]
    p = p_nominal
    C = (q2 - q3) / (h2 ** p - h3 ** p)
    return p, q3 - C * h3 ** p, False


def _plot_street(params, trace, out_path):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from navierstokes_parallel_tpu.ops import obstacles as obs

    u = np.asarray(trace.state.u)
    v = np.asarray(trace.state.v)
    # Spanwise vorticity at cell corners (i dx, j dy): dv/dx - du/dy.
    om = ((v[1:, :-1] - v[:-1, :-1]) / params.dx
          - (u[:-1, 1:] - u[:-1, :-1]) / params.dy)
    x = np.arange(om.shape[0]) * params.dx
    y = np.arange(om.shape[1]) * params.dy
    fl = obs.masks(params).fluid[1:-1, 1:-1]
    lim = np.percentile(np.abs(om), 99)
    fig, ax = plt.subplots(figsize=(10, 10 * params.b / params.a + 0.8))
    ax.pcolormesh(x, y, om.T, cmap="RdBu_r", vmin=-lim, vmax=lim,
                  rasterized=True)
    ax.contourf(
        (np.arange(params.i_max) + 0.5) * params.dx,
        (np.arange(params.j_max) + 0.5) * params.dy,
        np.where(fl, np.nan, 1.0).T, levels=[0.5, 1.5], colors=["0.2"])
    ax.set_aspect("equal")
    ax.set_title(f"Kármán street, Schäfer-Turek 2D-2 (Re_D=100), "
                 f"{params.i_max}x{params.j_max}, t={float(trace.t[-1]):.0f}")
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
