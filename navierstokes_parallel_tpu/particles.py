"""Marker-particle tracing: pathlines and streaklines.

The serial lineage this framework re-implements (Griebel et al. 1998,
sect. 3.4 "visualization": particle tracing, eq. 4.1-4.3) carries marker
particles through the evolving velocity field; the reference repo dropped
the capability entirely (its post-processing is field plots only,
src/plot_field.py).  This module restores it in a vectorized formulation:

  * A particle set is a fixed-capacity pytree of coordinate vectors — no
    Python lists of structs, no dynamic allocation.  Everything jits;
    injection is a ring buffer over the static capacity, so streakline
    sources run inside `lax.while_loop` with static shapes.
  * Staggered bilinear interpolation (Griebel eq. 4.2/4.3) is a batch of
    four flat gathers (`jnp.take`) per field — one vectorized op over ALL
    particles, not a per-particle scalar loop.  Ghost layers already hold
    the wall reflections (ops/boundary.py), so interpolation within half a
    cell of a wall sees the physical wall velocity for free — the exact
    trick the serial staggered-grid codes rely on.
  * Time integration of dx/dt = u(x, t) is explicit Euler (the serial
    scheme, eq. 4.1) or Heun/RK2 (default — one extra interpolation per
    step buys second order, negligible next to the flow solve).
  * Particles that leave the domain or enter an obstacle cell deactivate
    and freeze (the flag-field analogue of the serial codes deleting them
    from the linked list — deletion is a mask here, shapes never change).

Drivers: `advect` is one particle step; `solve_with_particles` co-integrates
particles with the flow entirely on device (one XLA program, no per-step
D2H); `trace_particles` is the host-loop twin that records the trajectory
history for plotting (utils/plotting.py::plot_particle_paths).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .config import Params
from .grid import State, allocate_state
from . import solver as _solver


class ParticleSet(NamedTuple):
    """Fixed-capacity particle state. All fields are (capacity,) arrays."""

    x: jax.Array       # x position (frozen at last value once inactive)
    y: jax.Array
    active: jax.Array  # bool: advected & plotted iff True


def init_particles(points, capacity: Optional[int] = None,
                   dtype=jnp.float32) -> ParticleSet:
    """Particle set from an (N, 2) array of seed positions.  `capacity`
    (>= N) reserves extra inactive slots for later `inject` calls."""
    pts = np.asarray(points, dtype=np.float64).reshape(-1, 2)
    n = pts.shape[0]
    cap = int(capacity) if capacity is not None else n
    if cap < n:
        raise ValueError(f"capacity {cap} < {n} seed particles")
    x = np.zeros(cap)
    y = np.zeros(cap)
    active = np.zeros(cap, bool)
    x[:n], y[:n] = pts[:, 0], pts[:, 1]
    active[:n] = True
    return ParticleSet(x=jnp.asarray(x, dtype), y=jnp.asarray(y, dtype),
                       active=jnp.asarray(active))


def grid_of_particles(params: Params, nx: int, ny: int,
                      capacity: Optional[int] = None) -> ParticleSet:
    """nx x ny uniform seed lattice over the interior (cell-center aligned
    when nx == i_max), the usual pathline initialization."""
    xs = (np.arange(nx) + 0.5) * (params.a / nx)
    ys = (np.arange(ny) + 0.5) * (params.b / ny)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    return init_particles(np.stack([gx.ravel(), gy.ravel()], -1), capacity)


def _gather(field: jax.Array, i, j) -> jax.Array:
    """field[i, j] for vector index arrays, as one flat gather."""
    ncols = field.shape[1]
    return jnp.take(field.reshape(-1), i * ncols + j)


def _bilinear(field, gx, gy, i_hi: int, j_hi: int):
    """Bilinear interpolation at grid coordinates (gx, gy) of a node family
    whose nodes sit at integer grid coordinates; node indices are clamped to
    [0, i_hi] x [0, j_hi] (so evaluation clamps to the covered strip — with
    ghost nodes included that strip extends half a cell beyond each wall)."""
    i = jnp.clip(jnp.floor(gx).astype(jnp.int32), 0, i_hi - 1)
    j = jnp.clip(jnp.floor(gy).astype(jnp.int32), 0, j_hi - 1)
    tx = jnp.clip(gx - i, 0.0, 1.0)
    ty = jnp.clip(gy - j, 0.0, 1.0)
    f00 = _gather(field, i, j)
    f10 = _gather(field, i + 1, j)
    f01 = _gather(field, i, j + 1)
    f11 = _gather(field, i + 1, j + 1)
    return ((1 - tx) * ((1 - ty) * f00 + ty * f01)
            + tx * ((1 - ty) * f10 + ty * f11))


def interp_uv(x: jax.Array, y: jax.Array, u: jax.Array, v: jax.Array,
              params: Params) -> Tuple[jax.Array, jax.Array]:
    """Velocity at arbitrary points, staggered-aware (Griebel eq. 4.2/4.3).

    u[i, j] sits at (i*dx, (j-0.5)*dy) for i = 0..i_max, j = 0..j_max+1
    (ghost rows included — they carry the wall reflections); v[i, j] at
    ((i-0.5)*dx, j*dy).  Each interpolation is 4 vectorized gathers.
    """
    dx, dy = params.dx, params.dy
    # u nodes: grid coords (i, j) = (x/dx, y/dy + 1/2); usable node columns
    # i = 0..i_max, rows j = 0..j_max+1.
    up = _bilinear(u, x / dx, y / dy + 0.5, params.i_max, params.j_max + 1)
    vp = _bilinear(v, x / dx + 0.5, y / dy, params.i_max + 1, params.j_max)
    return up, vp


@functools.lru_cache(maxsize=32)
def _fluid_mask_const(params: Params) -> np.ndarray:
    if not params.obstacles:
        return None
    from .ops import obstacles as obs

    return obs.fluid_mask(params)


def _in_domain(x, y, params: Params):
    """True strictly inside the domain and (if obstacles) in a fluid cell."""
    eps = 0.0
    ok = (x > eps) & (x < params.a - eps) & (y > eps) & (y < params.b - eps)
    fl = _fluid_mask_const(params)
    if fl is not None:
        ci = jnp.clip(jnp.floor(x / params.dx).astype(jnp.int32) + 1,
                      1, params.i_max)
        cj = jnp.clip(jnp.floor(y / params.dy).astype(jnp.int32) + 1,
                      1, params.j_max)
        ok = ok & _gather(jnp.asarray(fl), ci, cj)
    return ok


def advect(pset: ParticleSet, u: jax.Array, v: jax.Array, dt,
           params: Params, *, method: str = "heun") -> ParticleSet:
    """One advection step of every active particle through (u, v).

    `method`: "euler" is the serial scheme (Griebel eq. 4.1); "heun"
    (default) adds one predictor interpolation for second order — for the
    cost of 8 extra gathers, rotation tests hold radius to O(dt^2).
    Inactive particles are frozen; particles that step out of the domain or
    into an obstacle cell deactivate at their pre-step position (the serial
    codes delete them; a mask keeps shapes static)."""
    if method not in ("euler", "heun"):
        raise ValueError(f"unknown particle integrator {method!r}")
    x, y = pset.x, pset.y
    k1u, k1v = interp_uv(x, y, u, v, params)
    if method == "euler":
        xn = x + dt * k1u
        yn = y + dt * k1v
    else:
        xm = x + dt * k1u
        ym = y + dt * k1v
        k2u, k2v = interp_uv(xm, ym, u, v, params)
        xn = x + dt * 0.5 * (k1u + k2u)
        yn = y + dt * 0.5 * (k1v + k2v)
    ok = _in_domain(xn, yn, params)
    live = pset.active & ok
    xn = jnp.where(live, xn, x)
    yn = jnp.where(live, yn, y)
    return ParticleSet(x=xn.astype(pset.x.dtype), y=yn.astype(pset.y.dtype),
                       active=live)


def inject(pset: ParticleSet, points: jax.Array, cursor) -> Tuple[
        ParticleSet, jax.Array]:
    """Write len(points) new active particles into the ring buffer at
    `cursor` (traced int32 scalar), overwriting the oldest slots; returns
    (new set, cursor + K).  This is the streakline source (Griebel
    sect. 3.4.2: inject at fixed points every delt_inject) with static
    shapes: capacity bounds the streak length instead of a linked list."""
    pts = jnp.asarray(points, pset.x.dtype).reshape(-1, 2)
    k = pts.shape[0]
    cap = pset.x.shape[0]
    idx = (jnp.asarray(cursor, jnp.int32) + jnp.arange(k, dtype=jnp.int32)) % cap
    return ParticleSet(
        x=pset.x.at[idx].set(pts[:, 0]),
        y=pset.y.at[idx].set(pts[:, 1]),
        active=pset.active.at[idx].set(True),
    ), jnp.asarray(cursor, jnp.int32) + k


class _Carry(NamedTuple):
    state: State
    stats: _solver.SolveStats
    pset: ParticleSet
    cursor: jax.Array   # ring-buffer write head
    nstep: jax.Array    # steps taken (injection cadence)


@functools.partial(jax.jit, static_argnums=(0, 3, 4, 6))
def _solve_with_particles(params: Params, state: State, pset: ParticleSet,
                          pressure_method: str, method: str,
                          inject_points, inject_every: int):
    T = jnp.asarray(params.T, state.t.dtype)

    def cond(c: _Carry):
        return c.state.t < T

    def body(c: _Carry):
        state, diag = _solver.step(c.state, params,
                                   pressure_method=pressure_method)
        # Advect through the END-of-step field with the step's dt — the
        # field the projection just made divergence-free (eq. 4.1 uses the
        # current field; end-of-step is the one consistent with t+dt).
        pset = advect(c.pset, state.u, state.v, diag.dt, params,
                      method=method)
        cursor = c.cursor
        if inject_points is not None:
            due = (c.nstep + 1) % inject_every == 0
            inj, moved = inject(pset, inject_points, cursor)
            pset = jax.tree_util.tree_map(
                lambda a, b: jnp.where(due, a, b), inj, pset)
            cursor = jnp.where(due, moved, cursor)
        stats = _solver.SolveStats(
            steps=c.stats.steps + 1,
            total_sor_iterations=(c.stats.total_sor_iterations
                                  + diag.sor_iterations),
            sor_failures=c.stats.sor_failures
            + jnp.where(diag.sor_converged, 0, 1).astype(jnp.int32),
            last_res_norm=diag.sor_res_norm,
        )
        return _Carry(state, stats, pset, cursor, c.nstep + 1)

    zero = jnp.zeros((), jnp.int32)
    init = _Carry(
        state=state,
        stats=_solver.SolveStats(steps=zero, total_sor_iterations=zero,
                                 sor_failures=zero,
                                 last_res_norm=jnp.zeros((), state.t.dtype)),
        pset=pset,
        cursor=zero,
        nstep=zero,
    )
    out = lax.while_loop(cond, body, init)
    return out.state, out.stats, out.pset


def solve_with_particles(
    params: Params,
    pset: ParticleSet,
    state: Optional[State] = None,
    *,
    pressure_method: str = "rb_sor",
    method: str = "heun",
    inject_points=None,
    inject_every: int = 0,
) -> Tuple[State, _solver.SolveStats, ParticleSet]:
    """Integrate flow + particles to t >= T in ONE on-device while_loop.

    Numerically identical flow to solver.solve() (same step fn); particles
    ride the same XLA program, so tracing N markers costs ~12 gathers per
    step and zero extra dispatches.  `inject_points` (K, 2) + `inject_every`
    n turn the set into streaklines: K particles are (re-)injected every
    n-th step into the ring buffer (capacity caps streak length).
    """
    if state is None:
        state = allocate_state(params)
    if inject_points is not None:
        if inject_every < 1:
            raise ValueError("inject_every must be >= 1 with inject_points")
        inject_points = tuple(map(tuple, np.asarray(inject_points,
                                                    np.float64).reshape(-1, 2)))
        pts = jnp.asarray(inject_points, pset.x.dtype)
    else:
        pts = None
    return _solve_with_particles(params, state, pset,
                                 pressure_method, method, pts,
                                 inject_every if inject_points is not None
                                 else 0)


def trace_particles(
    params: Params,
    pset: ParticleSet,
    state: Optional[State] = None,
    *,
    pressure_method: str = "rb_sor",
    method: str = "heun",
    inject_points=None,
    inject_every: int = 0,
    record_every: int = 1,
):
    """Host-loop twin of solve_with_particles that records the trajectory
    history: returns (state, stats, pset, history) where history is a
    (frames, capacity, 3) float array of (x, y, active) snapshots (frame 0
    is the initial set).  Bitwise-identical particle math to the on-device
    loop (same jitted ops in the same order); costs one D2H fetch per step
    like solver.solve_stepwise — use for plotting, not benchmarks."""
    if state is None:
        state = allocate_state(params)
    step_fn = _solver.make_step_fn(params, pressure_method)
    adv = jax.jit(functools.partial(advect, params=params, method=method))
    if inject_points is not None:
        if inject_every < 1:
            raise ValueError("inject_every must be >= 1 with inject_points")
        pts = jnp.asarray(np.asarray(inject_points, np.float64).reshape(-1, 2),
                          pset.x.dtype)
    cursor = jnp.zeros((), jnp.int32)
    frames = [_snapshot(pset)]
    steps = iters = fails = 0
    last = 0.0
    T = float(jnp.asarray(params.T, state.t.dtype))
    while float(state.t) < T:
        state, diag = step_fn(state)
        pset = adv(pset, state.u, state.v, diag.dt)
        steps += 1
        if inject_points is not None and steps % inject_every == 0:
            pset, cursor = inject(pset, pts, cursor)
        if steps % record_every == 0:
            frames.append(_snapshot(pset))
        iters += int(diag.sor_iterations)
        fails += 0 if bool(diag.sor_converged) else 1
        last = float(diag.sor_res_norm)
    stats = _solver.SolveStats(
        steps=jnp.asarray(steps, jnp.int32),
        total_sor_iterations=jnp.asarray(iters, jnp.int32),
        sor_failures=jnp.asarray(fails, jnp.int32),
        last_res_norm=jnp.asarray(last, state.t.dtype),
    )
    return state, stats, pset, np.stack(frames)


def _snapshot(pset: ParticleSet) -> np.ndarray:
    return np.stack([np.asarray(pset.x), np.asarray(pset.y),
                     np.asarray(pset.active, np.float32)], -1)
