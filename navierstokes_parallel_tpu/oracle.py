"""NumPy serial oracle — the framework's ground truth.

The reference uses its serial C build as the oracle for the CUDA path
(colab-runner.ipynb runs both and compares within 1e-4).  We keep that
pattern: this module is a float64 NumPy re-implementation of the *serial*
semantics (src/serial/ — lexicographic in-place Gauss-Seidel SOR, exact
ghost-fill ordering, the signed-max quirk of max_mat), used by the test suite
to validate the accelerated paths (pure-jnp, CUDA kernel, sharded) within
the reference's 1e-4 tolerance contract.

Deliberately unoptimized; only run on small grids in tests.  A native C
version of this oracle (csrc/) provides the fast serial baseline for
benchmarks.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

from .config import Params


class OracleResult(NamedTuple):
    u: np.ndarray
    v: np.ndarray
    p: np.ndarray
    t: float
    steps: int
    total_sor_iterations: int


def _max_mat(x: np.ndarray, i_max: int, j_max: int) -> float:
    """Signed interior max seeded with x[0,0] (reference io.c:122-139)."""
    return max(x[0, 0], float(np.max(x[1 : i_max + 1, 1 : j_max + 1])))


def _apply_bcs(u, v, i_max, j_max, lid_u):
    """Serial BC semantics (boundaries.c:7-39), driver order (main.c:95-104)."""
    # LEFT (no-slip)
    u[0, 1 : j_max + 1] = 0.0
    v[0, 1 : j_max + 1] = -v[1, 1 : j_max + 1]
    # RIGHT (no-slip)
    u[i_max, 1 : j_max + 1] = 0.0
    v[i_max + 1, 1 : j_max + 1] = -v[i_max, 1 : j_max + 1]
    # BOTTOM (no-slip)
    v[1 : i_max + 1, 0] = 0.0
    u[1 : i_max + 1, 0] = -u[1 : i_max + 1, 1]
    # TOP (moving lid)
    v[1 : i_max + 1, j_max] = 0.0
    u[1 : i_max + 1, j_max + 1] = 2.0 * lid_u - u[1 : i_max + 1, j_max]


def _apply_freeslip_bcs(u, v, i_max, j_max):
    """Free-slip box (problem 4, beyond-reference — ops/boundary.py
    apply_freeslip_box): zero normal velocity, zero-gradient tangential
    ghost on all four walls.  Writes commute (see apply_freeslip_box)."""
    # LEFT
    u[0, 1 : j_max + 1] = 0.0
    v[0, 1 : j_max + 1] = v[1, 1 : j_max + 1]
    # RIGHT
    u[i_max, 1 : j_max + 1] = 0.0
    v[i_max + 1, 1 : j_max + 1] = v[i_max, 1 : j_max + 1]
    # BOTTOM
    v[1 : i_max + 1, 0] = 0.0
    u[1 : i_max + 1, 0] = u[1 : i_max + 1, 1]
    # TOP
    v[1 : i_max + 1, j_max] = 0.0
    u[1 : i_max + 1, j_max + 1] = u[1 : i_max + 1, j_max]


def _apply_channel_bcs(u, v, i_max, j_max, prm: Params):
    """Channel BCs (problem 3, beyond-reference — ops/boundary.py
    apply_channel_bcs): parabolic inflow left, flux-balanced zero-gradient
    outflow right, no-slip walls.  Same driver order."""
    y = (np.arange(1, j_max + 1) - 0.5) * prm.dy
    profile = 4.0 * y * (prm.b - y) / (prm.b * prm.b)
    # LEFT (inflow)
    u[0, 1 : j_max + 1] = profile
    v[0, 1 : j_max + 1] = -v[1, 1 : j_max + 1]
    # RIGHT (outflow + global mass balance)
    u[i_max, 1 : j_max + 1] = u[i_max - 1, 1 : j_max + 1]
    v[i_max + 1, 1 : j_max + 1] = v[i_max, 1 : j_max + 1]
    u[i_max, 1 : j_max + 1] += (
        u[0, 1 : j_max + 1].sum() - u[i_max, 1 : j_max + 1].sum()
    ) / j_max
    # BOTTOM (no-slip)
    v[1 : i_max + 1, 0] = 0.0
    u[1 : i_max + 1, 0] = -u[1 : i_max + 1, 1]
    # TOP (no-slip)
    v[1 : i_max + 1, j_max] = 0.0
    u[1 : i_max + 1, j_max + 1] = -u[1 : i_max + 1, j_max]


def _compute_fg(u, v, dt, gamma, prm: Params):
    """Vectorized but mathematically identical to integration.c:73-96.

    F/G boundary entries stay zero exactly like the reference's calloc'd
    grids that FG never writes.
    """
    dx, dy, Re = prm.dx, prm.dy, prm.Re
    i_max, j_max = prm.i_max, prm.j_max
    F = np.zeros_like(u)
    G = np.zeros_like(v)

    # F region: i in [1, i_max-1], j in [1, j_max]
    I = np.arange(1, i_max)[:, None]
    J = np.arange(1, j_max + 1)[None, :]
    uc, ue, uw = u[I, J], u[I + 1, J], u[I - 1, J]
    un, us = u[I, J + 1], u[I, J - 1]
    vc, ve, vs, vse = v[I, J], v[I + 1, J], v[I, J - 1], v[I + 1, J - 1]

    s1 = 0.5 * (uc + ue)
    s2 = 0.5 * (uw + uc)
    du2dx = (s1 * s1 - s2 * s2) / dx + gamma / dx * (
        np.abs(s1) * 0.5 * (uc - ue) - np.abs(s2) * 0.5 * (uw - uc)
    )
    vn_avg = 0.5 * (vc + ve)
    vs_avg = 0.5 * (vs + vse)
    duvdy = (vn_avg * 0.5 * (uc + un) - vs_avg * 0.5 * (us + uc)) / dy + (
        gamma / dy
    ) * (np.abs(vn_avg) * 0.5 * (uc - un) - np.abs(vs_avg) * 0.5 * (us - uc))
    lap_u = (ue - 2 * uc + uw) / dx**2 + (un - 2 * uc + us) / dy**2
    F[I, J] = uc + dt * (lap_u / Re - du2dx - duvdy + prm.g_x)

    # G region: i in [1, i_max], j in [1, j_max-1]
    I = np.arange(1, i_max + 1)[:, None]
    J = np.arange(1, j_max)[None, :]
    vc, vn, vs = v[I, J], v[I, J + 1], v[I, J - 1]
    ve, vw = v[I + 1, J], v[I - 1, J]
    uc, un, uw, unw = u[I, J], u[I, J + 1], u[I - 1, J], u[I - 1, J + 1]

    s1 = 0.5 * (vc + vn)
    s2 = 0.5 * (vs + vc)
    dv2dy = (s1 * s1 - s2 * s2) / dy + gamma / dy * (
        np.abs(s1) * 0.5 * (vc - vn) - np.abs(s2) * 0.5 * (vs - vc)
    )
    ue_avg = 0.5 * (uc + un)
    uw_avg = 0.5 * (uw + unw)
    duvdx = (ue_avg * 0.5 * (vc + ve) - uw_avg * 0.5 * (vw + vc)) / dx + (
        gamma / dx
    ) * (np.abs(ue_avg) * 0.5 * (vc - ve) - np.abs(uw_avg) * 0.5 * (vw - vc))
    lap_v = (ve - 2 * vc + vw) / dx**2 + (vn - 2 * vc + vs) / dy**2
    G[I, J] = vc + dt * (lap_v / Re - duvdx - dv2dy + prm.g_y)

    return F, G


def sor_serial(p, rhs, prm: Params) -> Tuple[int, float]:
    """Lexicographic in-place Gauss-Seidel SOR (integration.c:129-173).

    Mutates `p`; returns (iterations, final residual norm).
    """
    i_max, j_max = prm.i_max, prm.j_max
    dx2, dy2 = prm.dx**2, prm.dy**2
    omega, eps = prm.omega, prm.epsilon
    coef = omega / (2.0 * (1.0 / dx2 + 1.0 / dy2))

    norm_p = np.sqrt(
        np.sum(p[1 : i_max + 1, 1 : j_max + 1] ** 2) / (i_max * j_max)
    )
    res_norm = np.inf
    for it in range(1, prm.max_it + 1):
        # Neumann ghost fill (sides only)
        p[0, 1 : j_max + 1] = p[1, 1 : j_max + 1]
        p[i_max + 1, 1 : j_max + 1] = p[i_max, 1 : j_max + 1]
        p[1 : i_max + 1, 0] = p[1 : i_max + 1, 1]
        p[1 : i_max + 1, j_max + 1] = p[1 : i_max + 1, j_max]

        # In-place lexicographic sweep — inherently sequential.
        for i in range(1, i_max + 1):
            for j in range(1, j_max + 1):
                p[i, j] = (1.0 - omega) * p[i, j] + coef * (
                    (p[i + 1, j] + p[i - 1, j]) / dx2
                    + (p[i, j + 1] + p[i, j - 1]) / dy2
                    - rhs[i, j]
                )

        res = (
            (p[2:, 1:-1] - 2 * p[1:-1, 1:-1] + p[:-2, 1:-1]) / dx2
            + (p[1:-1, 2:] - 2 * p[1:-1, 1:-1] + p[1:-1, :-2]) / dy2
            - rhs[1:-1, 1:-1]
        )
        res_norm = np.sqrt(np.sum(res**2) / (i_max * j_max))
        if res_norm <= eps * (norm_p + 1.5):
            return it, res_norm
    return prm.max_it, res_norm


def oracle_step(u, v, p, t, prm: Params) -> Tuple[float, int]:
    """One serial time step in place; returns (dt, sor_iterations)."""
    i_max, j_max = prm.i_max, prm.j_max
    dx, dy = prm.dx, prm.dy

    u_max = _max_mat(u, i_max, j_max)
    v_max = _max_mat(v, i_max, j_max)
    with np.errstate(divide="ignore"):
        dt = prm.tau * min(
            prm.Re / 2.0 / (1.0 / dx**2 + 1.0 / dy**2),
            dx / abs(u_max) if u_max != 0 else np.inf,
            dy / abs(v_max) if v_max != 0 else np.inf,
        )
    if prm.gamma_fixed is not None:
        gamma = prm.gamma_fixed  # fixed upwind weight (config.py)
    else:
        gamma = max(u_max * dt / dx, v_max * dt / dy)

    if prm.obstacles:
        raise ValueError("the serial oracle has no flag-field support — "
                         "obstacle runs validate by domain equivalence "
                         "instead (tests/test_obstacles.py)")
    if prm.problem == 3:
        _apply_channel_bcs(u, v, i_max, j_max, prm)
    elif prm.problem == 4:
        _apply_freeslip_bcs(u, v, i_max, j_max)
    else:
        lid_u = 1.0 if prm.problem == 1 else np.sin(prm.f * t)
        _apply_bcs(u, v, i_max, j_max, lid_u)

    F, G = _compute_fg(u, v, dt, gamma, prm)
    if prm.problem == 3:
        # Nonzero wall-normal flux through the inflow/outflow planes: pin
        # F = u there (momentum.compute_fg does this for every problem; the
        # cavity oracle's calloc-zero edges coincide only because its wall
        # normal velocities vanish).
        F[0, 1 : j_max + 1] = u[0, 1 : j_max + 1]
        F[i_max, 1 : j_max + 1] = u[i_max, 1 : j_max + 1]
    rhs = np.zeros_like(p)
    rhs[1:-1, 1:-1] = (
        (F[1:-1, 1:-1] - F[:-2, 1:-1]) / dx + (G[1:-1, 1:-1] - G[1:-1, :-2]) / dy
    ) / dt

    if prm.problem == 3:
        # Same constant-mode deflation as ops/sor.py::solve_pressure (the
        # outflow flux balance is exact only to storage roundoff).
        rhs[1:-1, 1:-1] -= rhs[1:-1, 1:-1].mean()

    iters, _ = sor_serial(p, rhs, prm)

    # Projection (main.c:131-136): u for i <= i_max-1, v for j <= j_max-1.
    u[1:i_max, 1:-1] = F[1:i_max, 1:-1] - dt * (p[2 : i_max + 1, 1:-1] - p[1:i_max, 1:-1]) / dx
    v[1:-1, 1:j_max] = G[1:-1, 1:j_max] - dt * (p[1:-1, 2 : j_max + 1] - p[1:-1, 1:j_max]) / dy
    return dt, iters


def oracle_solve(prm: Params, max_steps: int = 10**9,
                 initial=None) -> OracleResult:
    """Full serial integration `while t < T` (main.c:86-147), float64.
    `initial` optionally seeds (u, v[, p]) — nonzero-initial-condition
    model families (e.g. the Taylor-Green box) pass their staggered
    samples; the reference always starts from calloc zeros."""
    shape = (prm.i_max + 2, prm.j_max + 2)
    u = np.zeros(shape)
    v = np.zeros(shape)
    p = np.zeros(shape)
    if initial is not None:
        u[:] = np.asarray(initial[0], np.float64)
        v[:] = np.asarray(initial[1], np.float64)
        if len(initial) > 2:
            p[:] = np.asarray(initial[2], np.float64)
    t, steps, total_iters = 0.0, 0, 0
    while t < prm.T and steps < max_steps:
        dt, iters = oracle_step(u, v, p, t, prm)
        t += dt
        steps += 1
        total_iters += iters
    return OracleResult(u=u, v=v, p=p, t=t, steps=steps,
                        total_sor_iterations=total_iters)
