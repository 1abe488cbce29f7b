"""Kármán vortex street — flow past a cylinder (problem 3 + flag-field
obstacle).  No reference analogue: the reference ships only the enclosed
cavity problems (main.c:95-108); this is the classic unsteady benchmark
the NaSt2D lineage (Griebel et al. 1998, sect. 9.5 "flow past an
obstacle") uses its obstacle machinery for.

Geometry: the Schäfer-Turek 2D-2 benchmark (Schäfer & Turek 1996,
"Benchmark computations of laminar flow around a cylinder"), scaled to
cylinder-diameter units: channel 22 x 4.1, cylinder of diameter 1
centered at (2.0, 2.0) — 0.05 BELOW the centerline, the deliberate
asymmetry that seeds the shedding instability.  Parabolic inflow
(problem-3 BCs, peak u = 1, mean 2/3), so the benchmark Reynolds number
Re_D = u_mean * D / nu = 100 maps to params.Re = 1/nu = 1.5 * Re_D.

The cylinder is rasterized onto the cell grid as a union of row
rectangles (`circle_rects`) compatible with `Params.obstacles`
(ops/obstacles.py): cell-center-inside sampling, then an iterative
erosion of any cell that would violate the >= 2-cell thin-wall rule, so
the staircase disk always passes the mask builder's geometry checks.

Measurement: `shedding_signal` runs chunked on-device lax.scan
dispatches recording per-step diagnostics — the cross-stream velocity at
a wake probe by default, or the control-volume force balance
(`force_record_fn`: surface momentum/stress integrals + CV momentum,
from which `coefficients` forms drag/lift/pressure-drop — exact for any
box around the body, sidestepping staircase-boundary stress
integration); `strouhal` extracts the shedding frequency from the zero
crossings of the saturated limit cycle (robust under the adaptive-dt
nonuniform sampling).  Benchmark
target: St = f * D / u_mean in [0.2950, 0.3050] (Schäfer-Turek table 4,
fine-grid band); the staircase cylinder converges into that band from
BELOW, first order in dx (the staircase enlarges the effective diameter
and thickens the boundary layer, slowing the shedding): measured
0.2616 / 0.2791 / 0.2861 / 0.2904 at 10/20/30/40 cells per diameter,
Richardson limit 0.3033 (artifacts/karman_strouhal.csv).
Validated in tests/test_karman.py (rasterizer geometry, synthetic-signal
frequency extraction, and an end-to-end square-cylinder shedding run);
the fine-grid circle numbers are recorded artifacts
(artifacts/karman_strouhal.csv, scripts/karman_artifact.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..config import Params
from ..grid import State, allocate_state
from .. import solver as _solver


def circle_cells(cx: float, cy: float, d: float, dx: float, dy: float,
                 i_max: int, j_max: int) -> np.ndarray:
    """Interior solid mask (i_max, j_max) of the rasterized disk: cell
    centers inside radius d/2, eroded to satisfy the obstacle geometry
    rules (no solid cell with fluid on both opposite sides — ops/
    obstacles.py::_check_geometry's thin-wall rule).  Erosion of an
    offending cell can expose a new one, so iterate to a fixed point;
    for a convex disk this only shaves the 1-cell-thin extreme rows and
    columns (a flat staircase cap, indistinguishable from any other
    staircase error at the same resolution)."""
    xi = (np.arange(1, i_max + 1) - 0.5) * dx
    yj = (np.arange(1, j_max + 1) - 0.5) * dy
    solid = ((xi[:, None] - cx) ** 2 + (yj[None, :] - cy) ** 2
             <= (0.5 * d) ** 2)
    while solid.any():
        pad = np.zeros((i_max + 2, j_max + 2), bool)
        pad[1:-1, 1:-1] = solid
        fl = ~pad
        thin_ew = solid & fl[2:, 1:-1] & fl[:-2, 1:-1]
        thin_ns = solid & fl[1:-1, 2:] & fl[1:-1, :-2]
        thin = thin_ew | thin_ns
        if not thin.any():
            return solid
        solid = solid & ~thin
    # Zero cells inside, or erosion shaved an under-resolved disk away.
    raise ValueError(f"cylinder d={d} rasterizes to zero cells at "
                     f"dx={dx}, dy={dy} — refine the grid")


def circle_rects(cx: float, cy: float, d: float, dx: float, dy: float,
                 i_max: int, j_max: int) -> Tuple[Tuple[int, int, int, int],
                                                  ...]:
    """`Params.obstacles` rectangles (1-based inclusive cell indices) for
    the rasterized disk: one rect per contiguous solid run per row."""
    solid = circle_cells(cx, cy, d, dx, dy, i_max, j_max)
    rects = []
    for j in range(j_max):
        row = solid[:, j]
        i = 0
        while i < i_max:
            if not row[i]:
                i += 1
                continue
            k = i
            while k < i_max and row[k]:
                k += 1
            rects.append((i + 1, k, j + 1, j + 1))
            i = k
    return tuple(rects)


def schafer_turek(n_per_d: int = 10, Re_D: float = 100.0, T: float = 50.0,
                  sharp: bool = True, **overrides) -> Params:
    """Schäfer-Turek 2D-2 in diameter units: 22 x 4.1 channel, unit
    cylinder at (2.0, 2.0).  `n_per_d` cells across the diameter must be
    a multiple of 10 so 4.1 * n_per_d is a whole cell count.

    `sharp=True` (default) registers the analytic circle as a
    `Params.obstacle_surfaces` level set, so the velocity BCs are the
    second-order ghost-fluid interpolation against the TRUE circle
    (ops/obstacles.py::ib_weights) instead of the first-order staircase
    mirror — the round-3 ladder showed the staircase leaves the
    Richardson-extrapolated cd_max/cl_max 2-5% below the published
    Schäfer-Turek bands.  `sharp=False` keeps the staircase for A/Bs."""
    if n_per_d % 10 != 0:
        raise ValueError(f"n_per_d must be a multiple of 10 (4.1 * n "
                         f"cells across the channel), got {n_per_d}")
    a, b, cx, cy, d = 22.0, 4.1, 2.0, 2.0, 1.0
    nx = int(round(a * n_per_d))
    ny = int(round(b * n_per_d))
    dx, dy = a / nx, b / ny
    rects = circle_rects(cx, cy, d, dx, dy, nx, ny)
    surfaces = (("circle", cx, cy, 0.5 * d),) if sharp else ()
    defaults = dict(problem=3, i_max=nx, j_max=ny, a=a, b=b, T=T,
                    Re=1.5 * Re_D, tau=0.5, omega=1.7, epsilon=1e-4,
                    max_it=20000, obstacles=rects,
                    obstacle_surfaces=surfaces)
    defaults.update(overrides)
    return Params(**defaults)


def square_cylinder(n_per_d: int = 8, Re_D: float = 100.0, T: float = 60.0,
                    a_over_d: float = 20.0, blockage: float = 8.0,
                    x_front: float = 5.0, offset_frac: float = 0.05,
                    **overrides) -> Params:
    """Confined square cylinder (Breuer et al. 2000 setup, diameter
    units): channel `a_over_d` x `blockage`, unit square with its front
    face at x = `x_front`, shifted `offset_frac` below the channel
    centerline WHERE THE GRID CAN REPRESENT IT — the shift rounds to
    whole cells, so it is exactly zero below n_per_d = 10 and the
    geometry is then Breuer's symmetric one; shedding onset is seeded by
    the `initial_state` kick either way (a symmetric impulsive start
    with perturb=0 still sheds, from grid-roundoff seeds, just much
    later).  Exactly resolvable at any grid (no staircase), so it is the
    cheap CPU-testable shedding workload; Breuer's blockage-1/8 St(Re_D =
    100) is ~0.135-0.14."""
    d_cells = n_per_d
    nx = int(round(a_over_d * n_per_d))
    ny = int(round(blockage * n_per_d))
    a, b = float(a_over_d), float(blockage)
    dy = b / ny
    i0 = int(round(x_front * n_per_d)) + 1
    cy = 0.5 * b - offset_frac
    j0 = int(round((cy - 0.5) / dy)) + 1
    rect = (i0, i0 + d_cells - 1, j0, j0 + d_cells - 1)
    defaults = dict(problem=3, i_max=nx, j_max=ny, a=a, b=b, T=T,
                    Re=1.5 * Re_D, tau=0.5, omega=1.7, epsilon=1e-4,
                    max_it=20000, obstacles=(rect,))
    defaults.update(overrides)
    return Params(**defaults)


def cylinder_extent(params: Params) -> Tuple[float, float, float, float]:
    """(x0, x1, y0, y1) bounding box of the obstacle cells, physical."""
    rs = np.array(params.obstacles)
    return (float((rs[:, 0].min() - 1) * params.dx),
            float(rs[:, 1].max() * params.dx),
            float((rs[:, 2].min() - 1) * params.dy),
            float(rs[:, 3].max() * params.dy))


def initial_state(params: Params, perturb: float = 0.3) -> State:
    """Impulsive start: the parabolic inflow profile filled across the
    whole channel (masked to fluid columns by the first BC pass), plus a
    one-sided cross-stream kick just behind the cylinder to cut the
    onset transient — the kick projects onto the shedding eigenmode, so
    the limit cycle saturates in ~1/3 the time the geometric asymmetry
    alone needs (the saturated cycle is identical; only onset changes)."""
    from ..ops.obstacles import inflow_profile

    state = allocate_state(params)
    prof = inflow_profile(params)
    u = np.zeros(params.shape, np.float64)
    u[:, 1:-1] = prof[None, :]
    v = np.zeros(params.shape, np.float64)
    if perturb and params.obstacles:
        x0, x1, y0, y1 = cylinder_extent(params)
        d = max(x1 - x0, y1 - y0)
        xi = (np.arange(params.i_max + 2) - 0.5) * params.dx
        yj = (np.arange(params.j_max + 2) - 0.5) * params.dy
        blob = (np.exp(-(((xi[:, None] - (x1 + d)) / d) ** 2
                         + ((yj[None, :] - 0.5 * (y0 + y1)) / d) ** 2))
                * perturb)
        v += blob
    return state._replace(u=state.u + jnp.asarray(u, state.u.dtype),
                          v=state.v + jnp.asarray(v, state.v.dtype))


class SheddingTrace(NamedTuple):
    t: np.ndarray        # sample times (end of each step; nonuniform dt)
    v: np.ndarray        # cross-stream velocity at the wake probe
    state: State         # final state
    stats: _solver.SolveStats
    rec: dict            # extra per-step records ({} unless record_fn)


def probe_node(params: Params, probe: Optional[Tuple[float, float]] = None
               ) -> Tuple[int, int]:
    """Padded v-node indices nearest the probe point (default: one
    diameter behind the cylinder's rear face, on its horizontal
    midline).  v node (i, j) lives at ((i - 1/2) dx, j dy)."""
    if probe is None:
        x0, x1, y0, y1 = cylinder_extent(params)
        probe = (x1 + max(x1 - x0, y1 - y0), 0.5 * (y0 + y1))
    pi = int(np.clip(round(probe[0] / params.dx + 0.5), 1, params.i_max))
    pj = int(np.clip(round(probe[1] / params.dy), 1, params.j_max - 1))
    return pi, pj


@functools.lru_cache(maxsize=16)
def _probe_record_fn(params: Params, pi: int, pj: int):
    """Default per-step record: v at the wake probe node."""
    def rec(state: State):
        return {"v": state.v[pi, pj]}
    return rec


@functools.lru_cache(maxsize=16)
def _make_chunk_fn(params: Params, method: str, chunk: int, record_fn,
                   time_order: int = 1):
    """`chunk` steps per dispatch, per-step diagnostics recorded ON
    DEVICE via lax.scan — one dispatch + one small-array fetch per chunk,
    instead of a scalar device-to-host fetch per step (which would
    dominate these small unsteady grids).  `record_fn(state)
    -> dict of scalars` runs inside the scan body; keep it cached /
    identity-stable or every call retraces.  `time_order=2` scans the
    Adams-Bashforth-2 stepper (solver.step_ab2); the AB2 tendency carry
    threads through the scan AND across chunk dispatches, so the chunked
    trajectory is identical to unchunked stepping."""
    import jax
    from jax import lax

    if time_order == 1:
        _step = lambda s: _solver.step(s, params, pressure_method=method)
        _base = lambda s: s
    elif time_order == 2:
        _step = lambda s: _solver.step_ab2(s, params,
                                           pressure_method=method)
        _base = lambda s: s.s
    else:
        raise ValueError(f"time_order must be 1 or 2, got {time_order}")

    @jax.jit
    def _chunk(carry):
        def body(s, _):
            s2, d = _step(s)
            b = _base(s2)
            return s2, (b.t, record_fn(b), d.sor_iterations,
                        (~d.sor_converged).astype(jnp.int32),
                        d.sor_res_norm)
        return lax.scan(body, carry, None, length=chunk)

    return _chunk


def shedding_signal(params: Params, state: Optional[State] = None, *,
                    method: str = "rb_sor", probe: Optional[Tuple[float,
                    float]] = None, perturb: float = 0.3,
                    chunk: int = 64, record_fn=None,
                    time_order: int = 1) -> SheddingTrace:
    """Integrate past params.T recording per-step wake diagnostics.

    Default record: v at the probe, one diameter behind the cylinder's
    rear face on its horizontal midline; pass `record_fn(state) -> dict`
    (e.g. `force_record_fn`) for more — a "v" key, if present, also
    populates trace.v.  Steps run in `chunk`-sized on-device lax.scan
    dispatches (see _make_chunk_fn), so the final state may overshoot T
    by up to chunk - 1 steps — irrelevant for spectral measurements, and
    the trace itself is returned untrimmed with its exact times.
    `time_order=2` uses the Adams-Bashforth-2 stepper (solver.step_ab2)
    — second order in dt, so the resolution ladder's temporal bias
    (scripts/karman_dt_study.py) vanishes at the native tau."""
    if state is None:
        state = initial_state(params, perturb=perturb)
    if record_fn is None:
        record_fn = _probe_record_fn(params, *probe_node(params, probe))
    fn = _make_chunk_fn(params, method, chunk, record_fn, time_order)
    carry = _solver.ab2_init(state) if time_order == 2 else state
    ts, recs = [], []
    steps = iters = fails = 0
    last = 0.0
    t_end = float(np.asarray(params.T, np.asarray(state.t).dtype))
    if float(state.t) >= t_end:
        # Chunked stepping overshoots T, so a completed trace's state is
        # naturally past T — fail loudly instead of returning an empty
        # trace (or crashing on recs[0]) when resumed without a larger T.
        raise ValueError(
            f"state.t = {float(state.t):g} already >= T = {t_end:g} — "
            f"raise params.T to continue this run")
    while float(state.t) < t_end:
        carry, (ct, crec, cit, cfl, cres) = fn(carry)
        state = carry.s if time_order == 2 else carry
        ts.append(np.asarray(ct))
        recs.append({k: np.asarray(a) for k, a in crec.items()})
        steps += chunk
        iters += int(np.sum(cit))
        fails += int(np.sum(cfl))
        last = float(np.asarray(cres)[-1])
    stats = _solver.SolveStats(steps=steps, total_sor_iterations=iters,
                               sor_failures=fails, last_res_norm=last)
    rec = {k: np.concatenate([r[k] for r in recs]) for k in recs[0]}
    v = rec.get("v", np.zeros(0))
    return SheddingTrace(t=np.concatenate(ts), v=v, state=state,
                         stats=stats, rec=rec)


def control_volume(params: Params, margin: int = 5
                   ) -> Tuple[int, int, int, int]:
    """(I0, I1, J0, J1) interior cell indices of a rectangular control
    volume: the obstacle bounding box padded by `margin` cells, clamped
    so every CV boundary face (and the stencils evaluated on it) stays
    strictly inside the domain."""
    rs = np.array(params.obstacles)
    I0 = max(int(rs[:, 0].min()) - margin, 2)
    I1 = min(int(rs[:, 1].max()) + margin, params.i_max - 1)
    J0 = max(int(rs[:, 2].min()) - margin, 2)
    J1 = min(int(rs[:, 3].max()) + margin, params.j_max - 2)
    return I0, I1, J0, J1


@functools.lru_cache(maxsize=16)
def force_record_fn(params: Params, margin: int = 5,
                    pi: int = 0, pj: int = 0):
    """Per-step record for force coefficients: the control-volume
    momentum balance

        F_body(t) = oint_dCV [ -u (u.n) - p n + nu (grad u + grad u^T) n ] dS
                    - d/dt int_CV u dV

    evaluated as staggered-grid slice reductions — the surface integral
    S = (sx, sy) and the CV fluid momentum M = (mx, my) are recorded on
    device each step; `coefficients` differentiates M in time on the
    host and forms F = S - dM/dt.  This is exact for ANY control volume
    enclosing the body, so it sidesteps integrating pressure + shear
    over the staircase boundary (where the cell-by-cell normals are
    noise).  Also records the Schäfer-Turek front/back pressure
    difference `dp` (cylinder midline poles) and the wake probe `v`
    (node (pi, pj), 0 = skip)."""
    I0, I1, J0, J1 = control_volume(params, margin)
    dx, dy, nu = params.dx, params.dy, 1.0 / params.Re
    from ..ops.obstacles import fluid_mask
    fl = jnp.asarray(fluid_mask(params)[I0:I1 + 1, J0:J1 + 1])
    # Schäfer-Turek pressure poles: cell just west of the obstacle bbox
    # front face / just east of its rear face, midline cells straddling
    # the obstacle's vertical center.
    rs = np.array(params.obstacles)
    i_f, i_b = int(rs[:, 0].min()) - 1, int(rs[:, 1].max()) + 1
    jc = int(round(0.5 * (rs[:, 2].min() - 1 + rs[:, 3].max())))

    def rec(state: State):
        u, v, p = state.u, state.v, state.p
        js = slice(J0, J1 + 1)          # cell rows J0..J1
        ii = slice(I0, I1 + 1)          # cell cols I0..I1
        # --- x-momentum, east/west faces (u-edges I1 / I0-1) ---
        def fx_vert(I, sign):
            uf = u[I, js]
            pf = 0.5 * (p[I, js] + p[I + 1, js])
            dudx = (u[I + 1, js] - u[I - 1, js]) / (2 * dx)
            return sign * jnp.sum(-uf * uf - pf + 2 * nu * dudx) * dy
        # --- x-momentum, north/south faces (v-edges J1 / J0-1) ---
        def fx_horiz(J, sign):
            vf = v[ii, J]
            uc = 0.25 * (u[I0 - 1:I1, J] + u[ii, J]
                         + u[I0 - 1:I1, J + 1] + u[ii, J + 1])
            dudy = (0.5 * (u[I0 - 1:I1, J + 1] + u[ii, J + 1])
                    - 0.5 * (u[I0 - 1:I1, J] + u[ii, J])) / dy
            dvdx = (v[I0 + 1:I1 + 2, J] - v[I0 - 1:I1, J]) / (2 * dx)
            return sign * jnp.sum(-uc * vf + nu * (dudy + dvdx)) * dx
        # --- y-momentum, east/west faces ---
        def fy_vert(I, sign):
            uf = u[I, js]
            vc = 0.25 * (v[I, J0 - 1:J1] + v[I, js]
                         + v[I + 1, J0 - 1:J1] + v[I + 1, js])
            dvdx = (0.5 * (v[I + 1, js] + v[I + 1, J0 - 1:J1])
                    - 0.5 * (v[I, js] + v[I, J0 - 1:J1])) / dx
            dudy = (u[I, J0 + 1:J1 + 2] - u[I, J0 - 1:J1]) / (2 * dy)
            return sign * jnp.sum(-uf * vc + nu * (dvdx + dudy)) * dy
        # --- y-momentum, north/south faces ---
        def fy_horiz(J, sign):
            vf = v[ii, J]
            pf = 0.5 * (p[ii, J] + p[ii, J + 1])
            dvdy = (v[ii, J + 1] - v[ii, J - 1]) / (2 * dy)
            return sign * jnp.sum(-vf * vf - pf + 2 * nu * dvdy) * dx
        sx = (fx_vert(I1, +1.0) + fx_vert(I0 - 1, -1.0)
              + fx_horiz(J1, +1.0) + fx_horiz(J0 - 1, -1.0))
        sy = (fy_vert(I1, +1.0) + fy_vert(I0 - 1, -1.0)
              + fy_horiz(J1, +1.0) + fy_horiz(J0 - 1, -1.0))
        # CV fluid momentum (cell-centered averages; solid cells hold
        # reflection ghosts, so mask them out).
        uc = 0.5 * (u[I0 - 1:I1, js] + u[ii, js])
        vc = 0.5 * (v[ii, J0 - 1:J1] + v[ii, js])
        mx = jnp.sum(jnp.where(fl, uc, 0.0)) * dx * dy
        my = jnp.sum(jnp.where(fl, vc, 0.0)) * dx * dy
        dp = (0.5 * (p[i_f, jc] + p[i_f, jc + 1])
              - 0.5 * (p[i_b, jc] + p[i_b, jc + 1]))
        out = {"sx": sx, "sy": sy, "mx": mx, "my": my, "dp": dp}
        if pi:
            out["v"] = v[pi, pj]
        return out
    return rec


@functools.lru_cache(maxsize=16)
def surface_force_record_fn(params: Params, margin: int = 5,
                            pi: int = 0, pj: int = 0):
    """`force_record_fn` plus the direct surface-traction force (fsx, fsy)
    integrated on the analytic cylinder (ops/obstacles.py::surface_force)
    — two INDEPENDENT estimators of the same body force in one trace:
    the CV balance never touches the boundary, the traction quadrature
    never leaves it.  Requires `params.obstacle_surfaces` with a single
    circle."""
    from ..ops.obstacles import surface_force, surface_quadrature

    quad = surface_quadrature(params)
    base = force_record_fn(params, margin, pi, pj)

    def rec(state: State):
        out = dict(base(state))
        fsx, fsy = surface_force(state.u, state.v, state.p, params, quad)
        out["fsx"] = fsx
        out["fsy"] = fsy
        return out
    return rec


def coefficients(trace: SheddingTrace, params: Params, *,
                 d: float = 1.0, u_mean: float = 2.0 / 3.0,
                 skip_frac: float = 0.5) -> dict:
    """Force coefficients of the saturated cycle from a force trace:
    cD(t), cL(t) = 2 (S - dM/dt) / (u_mean^2 d), with dM/dt a centered
    finite difference on the nonuniform sample times.  Returns mean/max
    statistics over the tail plus the Schäfer-Turek normalized pressure
    difference dp / u_mean^2.  Published 2D-2 targets: cD_max 3.22-3.24,
    cL_max 0.99-1.01, dp 2.46-2.50."""
    t = trace.t
    scale = 2.0 / (u_mean * u_mean * d)
    out = {}
    for comp, name in (("x", "cd"), ("y", "cl")):
        S = trace.rec["s" + comp]
        M = trace.rec["m" + comp]
        dMdt = np.gradient(M, t)
        c = scale * (S - dMdt)
        cc = c[int(len(c) * skip_frac):]
        out[name + "_mean"] = float(np.mean(cc))
        out[name + "_max"] = float(np.max(cc))
        out[name + "_amp"] = float(0.5 * (np.max(cc) - np.min(cc)))
    if "fsx" in trace.rec:
        # Surface-traction estimator (surface_force_record_fn): direct
        # coefficients, no dM/dt term.
        for comp, name in (("x", "cd_s"), ("y", "cl_s")):
            c = scale * trace.rec["fs" + comp]
            cc = c[int(len(c) * skip_frac):]
            out[name + "_mean"] = float(np.mean(cc))
            out[name + "_max"] = float(np.max(cc))
            out[name + "_amp"] = float(0.5 * (np.max(cc) - np.min(cc)))
    dp = trace.rec["dp"][int(len(t) * skip_frac):] / (u_mean * u_mean)
    out["dp_mean"] = float(np.mean(dp))
    out["dp_max"] = float(np.max(dp))
    return out


def strouhal(t: np.ndarray, signal: np.ndarray, *, d: float = 1.0,
             u_mean: float = 2.0 / 3.0, skip_frac: float = 0.5,
             min_crossings: int = 5) -> Tuple[float, float]:
    """(St, amplitude) of the saturated limit cycle.

    Uses the tail `1 - skip_frac` of the record: mean-removed zero
    crossings, linearly interpolated in time (exact under nonuniform
    adaptive-dt sampling, unlike an FFT), averaged over all full periods
    = (n_crossings - 1) half-periods.  Amplitude is half the tail's
    peak-to-peak — 0 for a dead (non-shedding) wake."""
    i0 = int(len(t) * skip_frac)
    tt, ss = np.asarray(t[i0:], float), np.asarray(signal[i0:], float)
    if len(tt) < 4:
        raise ValueError("signal too short")
    ss = ss - np.mean(ss)
    amp = 0.5 * (np.max(ss) - np.min(ss))
    idx = np.flatnonzero(np.diff(np.sign(ss)) != 0)
    if len(idx) < min_crossings:
        return 0.0, amp
    cross = tt[idx] - ss[idx] * (tt[idx + 1] - tt[idx]) / (ss[idx + 1]
                                                           - ss[idx])
    period = 2.0 * (cross[-1] - cross[0]) / (len(cross) - 1)
    return d / (u_mean * period), amp
