"""Natural convection (Boussinesq) — differentially heated square cavity.

Beyond-reference model family: the reference solves only isothermal
cavities; this couples the energy equation of Griebel et al. 1998 ch. 9
(ops/energy.py) to the same staggered momentum/pressure core and
validates against the de Vahl Davis (1983) benchmark — THE standard
natural-convection test.

Scaling: velocity scale U = sqrt(g beta dT L) (the "convective" scale),
so the dimensionless system is exactly the isothermal one plus

    momentum:  ... + T j_hat        (buoyancy coefficient 1)
    energy:    T_t + (uT)_x + (vT)_y = lap(T) / sqrt(Ra Pr)

with Re = sqrt(Ra/Pr) and alpha = 1/(Re Pr) = 1/sqrt(Ra Pr).  Hot wall
T=+1/2 on the left, cold T=-1/2 on the right, adiabatic top/bottom,
no-slip everywhere.  The mean hot-wall Nusselt number must land on de
Vahl Davis's values (1.118 / 2.243 / 4.519 / 8.8 for Ra=1e3..1e6).

Steady state is detected on device (max |dT| per step under a
threshold); the integration runs as jitted chunks so the host sees one
scalar per chunk.  Everything is pure jnp — the family is
differentiable end to end with diff.py's pressure wrapper if needed.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..config import Params
from ..grid import allocate_state
from ..ops import boundary, energy, momentum, sor
from ..ops import stencils as st


class ThermalConfig(NamedTuple):
    """Dimensionless thermal coupling constants (see module docstring)."""
    alpha: float          # thermal diffusivity = 1/(Re*Pr)
    beta_gx: float        # buoyancy coefficient on F (usually 0)
    beta_gy: float        # buoyancy coefficient on G (-1: hot rises)
    t_left: float = 0.5   # hot wall
    t_right: float = -0.5  # cold wall
    # Temperature of interior obstacle cells (params.obstacles):
    # None = adiabatic blocks, a float = isothermal blocks at that value
    # (ops/energy.py::apply_obstacle_temperature_bcs).  Ignored without
    # obstacles.
    t_obstacle: Optional[float] = None
    # Which pair of walls carries the Dirichlet temperatures:
    #   "side"  — left=t_left / right=t_right, adiabatic top/bottom
    #             (de Vahl Davis; the original family member)
    #   "below" — BOTTOM=t_left / TOP=t_right, adiabatic sidewalls
    #             (Rayleigh-Benard; t_left/t_right keep their role as
    #             hot/cold Dirichlet values, only the walls rotate)
    heating: str = "side"
    # Sidewall velocity condition: "noslip" (cavity default) or
    # "freeslip" (shear-free impermeable — a free-slip sidewall is
    # exactly a convection-roll symmetry plane, which lets a finite box
    # host the infinite-layer Rayleigh-Benard eigenmode; see
    # rb_growth_rate).  Top/bottom plates stay rigid no-slip either way.
    sidewalls: str = "noslip"
    # Lid (top-wall) tangential velocity — nonzero turns any member into
    # MIXED convection (forced + natural, Richardson number
    # Ri = 1/lid_u^2 in the convective scaling since the buoyancy
    # coefficient is 1).  Only meaningful with sidewalls="noslip".
    lid_u: float = 0.0


class ThermalState(NamedTuple):
    u: jax.Array
    v: jax.Array
    p: jax.Array
    T: jax.Array
    t: jax.Array
    n: jax.Array


def convection_setup(Ra: float, Pr: float = 0.71, n: int = 64,
                     tau: float = 0.5, epsilon: float = 1e-4,
                     dtype: str = "float32",
                     max_it: int = 20000) -> Tuple[Params, ThermalConfig]:
    """Params + ThermalConfig for the de Vahl Davis cavity at Rayleigh
    number Ra (square, unit walls, convective velocity scale)."""
    Re = float(jnp.sqrt(Ra / Pr))
    params = Params(problem=1, i_max=n, j_max=n, a=1.0, b=1.0, T=1e9,
                    Re=Re, tau=tau, omega=1.7, epsilon=epsilon,
                    max_it=max_it, dtype=dtype)
    cfg = ThermalConfig(alpha=1.0 / (Re * Pr), beta_gx=0.0, beta_gy=-1.0)
    return params, cfg


def _apply_t_bcs(T, params: Params, cfg: ThermalConfig):
    """Dirichlet/adiabatic wall pattern per cfg.heating (see ThermalConfig)."""
    if cfg.heating == "below":
        return energy.apply_temperature_bcs_rb(T, params, cfg.t_left,
                                               cfg.t_right)
    if cfg.heating != "side":
        raise ValueError(f"unknown heating mode {cfg.heating!r}")
    return energy.apply_temperature_bcs(T, params, cfg.t_left, cfg.t_right)


def _apply_vel_bcs(u, v, cfg: ThermalConfig):
    """Rigid no-slip plates; sidewalls per cfg.sidewalls.  Side order
    follows the cavity (sides before TOP — boundary.apply_cavity_bcs
    documents why it is load-bearing)."""
    if cfg.sidewalls == "freeslip":
        # lid_u must be STATICALLY zero here (an np scalar or tracer
        # would be silently dropped by the free-slip walls below) —
        # mirror energy.buoyant_fg's _static_zero convention.
        if not (isinstance(cfg.lid_u, (int, float)) and cfg.lid_u == 0.0):
            raise ValueError("lid_u requires sidewalls='noslip' "
                             "(free-slip sidewalls have no moving lid)")
        u, v = boundary.set_freeslip(u, v, boundary.Side.LEFT)
        u, v = boundary.set_freeslip(u, v, boundary.Side.RIGHT)
        u, v = boundary.set_noslip(u, v, boundary.Side.BOTTOM)
        u, v = boundary.set_noslip(u, v, boundary.Side.TOP)
        return u, v
    if cfg.sidewalls != "noslip":
        raise ValueError(f"unknown sidewall mode {cfg.sidewalls!r}")
    return boundary.apply_cavity_bcs(u, v,
                                     jnp.asarray(cfg.lid_u, u.dtype))


def rayleigh_benard_setup(Ra: float, Pr: float = 0.71, n: int = 64,
                          aspect: float = 1.0, sidewalls: str = "noslip",
                          tau: float = 0.5, epsilon: float = 1e-4,
                          dtype: str = "float32",
                          max_it: int = 20000) -> Tuple[Params,
                                                        ThermalConfig]:
    """Params + ThermalConfig for Rayleigh-Benard convection: hot bottom
    plate T=+1/2, cold top plate T=-1/2, adiabatic sidewalls, rigid
    no-slip plates.  `aspect` = width/height (plate spacing = the unit
    height = the Ra length scale); `n` = vertical resolution, the
    horizontal count scales with aspect.  Same convective velocity scale
    as convection_setup, so Re = sqrt(Ra/Pr) and buoyancy coefficient 1.

    Beyond-reference family member (reference: isothermal cavities only,
    SURVEY.md §intro); couples ops/energy.py exactly like the de Vahl
    Davis member, rotated 90°."""
    Re = float(jnp.sqrt(Ra / Pr))
    i_max = max(4, int(round(aspect * n)))
    params = Params(problem=1, i_max=i_max, j_max=n, a=float(aspect),
                    b=1.0, T=1e9, Re=Re, tau=tau, omega=1.7,
                    epsilon=epsilon, max_it=max_it, dtype=dtype)
    cfg = ThermalConfig(alpha=1.0 / (Re * Pr), beta_gx=0.0, beta_gy=-1.0,
                        heating="below", sidewalls=sidewalls)
    return params, cfg


def mixed_convection_setup(Re_lid: float, Gr: float, Pr: float = 0.71,
                           n: int = 64, tau: float = 0.5,
                           epsilon: float = 1e-4, dtype: str = "float32",
                           max_it: int = 20000) -> Tuple[Params,
                                                         ThermalConfig]:
    """Mixed (forced + natural) convection in the Iwatsu-Hyun-Kuwahara
    (1993) configuration: square cavity, HOT MOVING TOP LID T=+1/2, cold
    bottom plate T=-1/2 (stable stratification), adiabatic no-slip
    sidewalls.  Richardson number Ri = Gr/Re_lid² controls the regime:
    Ri >> 1 confines the shear-driven flow under the lid, Ri << 1 is the
    isothermal cavity with a passive scalar.

    Keeps the family's convective velocity scale sqrt(g beta dT L), so
    params.Re = sqrt(Gr) and the dimensionless lid speed is
    Re_lid/sqrt(Gr) = 1/sqrt(Ri) (lid Reynolds = lid_u * params.Re =
    Re_lid exactly).  With beta_gy = 0 and Pr = 1 the u/v trajectory is
    bit-identical to the isothermal solver.step cavity — the exact
    composition check in tests/test_convection.py."""
    Ra = Gr * Pr
    params, cfg = rayleigh_benard_setup(Ra, Pr=Pr, n=n, tau=tau,
                                        epsilon=epsilon, dtype=dtype,
                                        max_it=max_it)
    lid = float(Re_lid) / float(jnp.sqrt(Gr))
    return params, cfg._replace(t_left=-0.5, t_right=0.5, lid_u=lid)


def heated_block_setup(Ra: float, Pr: float = 0.71, n: int = 64,
                       block_frac: float = 0.4, t_walls: float = -0.5,
                       t_block: float = 0.5, tau: float = 0.5,
                       epsilon: float = 1e-4, dtype: str = "float32",
                       max_it: int = 20000
                       ) -> Tuple[Params, ThermalConfig]:
    """Isothermal hot square block centered in a cavity with cooled side
    walls and adiabatic top/bottom (the House/Ha 'enclosure with a heated
    inner body' configuration) — the obstacle-composed member of the
    Boussinesq family: flag-field no-slip on the block, Dirichlet block
    temperature via the solid-ghost reflection
    (ops/energy.py::apply_obstacle_temperature_bcs), masked pressure
    solve.  Validated by exact domain equivalence (a full-height
    isothermal strip flush against a wall reproduces the narrower plain
    cavity) and by the steady-state heat balance block flux == wall flux
    (tests/test_convection.py)."""
    Re = float(jnp.sqrt(Ra / Pr))
    half = max(1, int(round(0.5 * block_frac * n)))
    c0 = n // 2 - half + 1
    c1 = n // 2 + half
    params = Params(problem=1, i_max=n, j_max=n, a=1.0, b=1.0, T=1e9,
                    Re=Re, tau=tau, omega=1.7, epsilon=epsilon,
                    max_it=max_it, dtype=dtype,
                    obstacles=((c0, c1, c0, c1),))
    cfg = ThermalConfig(alpha=1.0 / (Re * Pr), beta_gx=0.0, beta_gy=-1.0,
                        t_left=t_walls, t_right=t_walls,
                        t_obstacle=t_block)
    return params, cfg


def block_heat_flux(T, params: Params, t_block: float) -> float:
    """Total heat flux leaving the obstacle block through its boundary
    faces, sum over fluid cells adjacent to solid of the one-sided
    Dirichlet gradient 2 (t_block - T_fluid)/d * face length (the exact
    discrete flux the solid-ghost reflection encodes).  At steady state
    with adiabatic top/bottom this must balance the flux out through the
    cooled side walls: (Nu_left + Nu_right) * b * dT_wall-scale."""
    import numpy as np
    from ..ops.obstacles import fluid_mask

    fl = fluid_mask(params)
    interior = np.zeros_like(fl)
    interior[1:-1, 1:-1] = True
    solid = interior & ~fl
    Tn = np.asarray(T)
    # One face term per (fluid cell, solid-neighbor direction): gradient
    # 2 (t_block - T)/d across the half-cell to the face, times the face
    # length.  Directions summed separately so a 1-wide fluid channel
    # between two blocks counts both its faces.
    flux = 0.0
    for shift_ax, d, face in ((0, params.dx, params.dy),
                              (1, params.dy, params.dx)):
        for sgn in (-1, 1):
            adj = fl & np.roll(solid, sgn, shift_ax)
            flux += np.sum(2.0 * (t_block - Tn[adj])) / d * face
    return float(flux)


def allocate_thermal(params: Params, cfg: ThermalConfig) -> ThermalState:
    """From-rest state with the conduction (linear) temperature profile —
    a much better starting point than isothermal (the linear profile is
    the exact zero-velocity solution, so early steps measure buoyancy,
    not a thermal shock)."""
    base = allocate_state(params)
    if cfg.heating == "below":
        y = (jnp.arange(params.j_max + 2) - 0.5) / params.j_max
        T0 = cfg.t_left + (cfg.t_right - cfg.t_left) * y
        T = jnp.broadcast_to(T0[None, :], params.shape)
    else:
        x = (jnp.arange(params.i_max + 2) - 0.5) / params.i_max
        T0 = cfg.t_left + (cfg.t_right - cfg.t_left) * x
        T = jnp.broadcast_to(T0[:, None], params.shape)
    T = _apply_t_bcs(T.astype(base.p.dtype), params, cfg)
    return ThermalState(u=base.u, v=base.v, p=base.p, T=T, t=base.t,
                        n=base.n)


def thermal_step(ts: ThermalState, params: Params, cfg: ThermalConfig,
                 pressure_method: str = "mg"):
    """One Boussinesq time step (Griebel ch. 9 ordering: T first with the
    old velocities, then momentum with the NEW temperature).  Returns
    (new_state, (dt, max_dT, sor_result))."""
    u, v, p, T, t, n = ts

    # CFL dt with the additional explicit-diffusion bound for T.
    dx, dy = params.dx, params.dy
    u_max = st.max_interior(u)
    v_max = st.max_interior(v)
    visc = params.Re / 2.0 / (1.0 / (dx * dx) + 1.0 / (dy * dy))
    dt = params.tau * jnp.minimum(
        jnp.minimum(visc, energy.thermal_dt_limit(params, cfg.alpha)),
        jnp.minimum(dx / jnp.abs(u_max), dy / jnp.abs(v_max)))
    if params.gamma_fixed is not None:
        # Fixed upwind weight (config.py::gamma_fixed) — must match the
        # diff/sharded thermal twins or the 1e-4 parity contract breaks.
        gamma = jnp.asarray(params.gamma_fixed, dt.dtype)
    else:
        gamma = jnp.maximum(u_max * dt / dx, v_max * dt / dy)

    u, v = _apply_vel_bcs(u, v, cfg)
    if params.obstacles:
        from ..ops import obstacles as obs

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
    result = sor.solve_pressure(p, rhs, params, method=pressure_method)
    u, v = momentum.project_velocities(u, v, F, G, result.p, dt, params)
    if params.obstacles:
        # The projection slice sweeps obstacle faces too — restore
        # no-slip so the state stays consistent (solver.step does the
        # same).
        u, v = obs.apply_obstacle_bcs(u, v, params)

    max_dT = jnp.max(jnp.abs(T_new[1:-1, 1:-1] - T[1:-1, 1:-1]))
    new = ThermalState(u=u, v=v, p=result.p, T=T_new, t=t + dt, n=n + 1)
    return new, (dt, max_dT, result)


class ThermalAB2State(NamedTuple):
    """AB2 carry for the Boussinesq system: the state plus the previous
    step's momentum AND energy tendencies (solver.AB2State grows rT)."""
    ts: ThermalState
    ru: jax.Array
    rv: jax.Array
    rT: jax.Array
    dt_prev: jax.Array


def thermal_ab2_init(ts: ThermalState) -> ThermalAB2State:
    """Euler-bootstrap carry (dt_prev = 0 -> w = 0 on the first step)."""
    return ThermalAB2State(ts=ts, ru=jnp.zeros_like(ts.u),
                           rv=jnp.zeros_like(ts.v),
                           rT=jnp.zeros_like(ts.T),
                           dt_prev=jnp.zeros((), ts.t.dtype))


def thermal_step_ab2(ab2: ThermalAB2State, params: Params,
                     cfg: ThermalConfig, pressure_method: str = "mg"):
    """Second-order (variable-step Adams-Bashforth 2) Boussinesq step —
    the problem-5 twin of solver.step_ab2 (round-4 verdict item 3).

    Both tendencies extrapolate through the previous step:

        T_{n+1} = T_n + dt [(1 + w) S_n - w S_{n-1}],
        u*      = u_n + dt [(1 + w) R_n - w R_{n-1}],   w = dt / (2 dt_{n-1}),

    with S from ops/energy.py::advance_temperature and R from the Euler
    tentative fields (compute_fg + buoyancy).  One deliberate difference
    from thermal_step's Griebel ch.9 ordering: the buoyant term in R_n is
    evaluated at T_n, NOT the freshly advanced T_{n+1} — R_n must be the
    true time-t_n tendency or the extrapolation carries an O(dt)
    perturbation (beta * S_n * dt) that caps the observed order at one.
    The two orderings differ by O(dt^2) per step and share the continuum
    limit; tests/test_ab2.py asserts the observed order ~2 of this form
    (with gamma_fixed, same fine print as the isothermal step).  The
    pressure projection is order-agnostic (enforces div u = 0 at t_{n+1})
    and the explicit stability interval halves exactly like the
    isothermal AB2 (tau <= 0.5)."""
    u, v, p, T, t, n = ab2.ts

    dx, dy = params.dx, params.dy
    u_max = st.max_interior(u)
    v_max = st.max_interior(v)
    visc = params.Re / 2.0 / (1.0 / (dx * dx) + 1.0 / (dy * dy))
    dt = params.tau * jnp.minimum(
        jnp.minimum(visc, energy.thermal_dt_limit(params, cfg.alpha)),
        jnp.minimum(dx / jnp.abs(u_max), dy / jnp.abs(v_max)))
    if params.gamma_fixed is not None:
        gamma = jnp.asarray(params.gamma_fixed, dt.dtype)
    else:
        gamma = jnp.maximum(u_max * dt / dx, v_max * dt / dy)
    w = jnp.where(ab2.dt_prev > 0, dt / (2.0 * ab2.dt_prev), 0.0)

    u, v = _apply_vel_bcs(u, v, cfg)
    if params.obstacles:
        from ..ops import obstacles as obs

        u, v = obs.apply_obstacle_bcs(u, v, params)
    T = _apply_t_bcs(T, params, cfg)
    T = energy.apply_obstacle_temperature_bcs(T, params, cfg.t_obstacle)
    # Energy tendency at t_n (advance_temperature is one explicit Euler
    # update, so (T' - T)/dt IS the semi-discrete dT/dt).
    S = (energy.advance_temperature(T, u, v, dt, gamma, params, cfg.alpha)
         - T) / dt
    T_new = T + dt * (S + w * (S - ab2.rT))
    T_new = _apply_t_bcs(T_new, params, cfg)
    T_new = energy.apply_obstacle_temperature_bcs(T_new, params,
                                                  cfg.t_obstacle)

    F, G = momentum.compute_fg(u, v, dt, gamma, params)
    F, G = energy.buoyant_fg(F, G, T, dt, cfg.beta_gx, cfg.beta_gy)
    ru = (F - u) / dt
    rv = (G - v) / dt
    F = F + (dt * w) * (ru - ab2.ru)
    G = G + (dt * w) * (rv - ab2.rv)
    if params.obstacles:
        from ..ops import obstacles as obs

        F, G = obs.pin_fg(F, G, u, v, params)
        rhs = obs.poisson_rhs(F, G, dt, params)
    else:
        rhs = momentum.compute_rhs(F, G, dt, params)
    result = sor.solve_pressure(p, rhs, params, method=pressure_method)
    u, v = momentum.project_velocities(u, v, F, G, result.p, dt, params)
    if params.obstacles:
        from ..ops import obstacles as obs

        u, v = obs.apply_obstacle_bcs(u, v, params)

    max_dT = jnp.max(jnp.abs(T_new[1:-1, 1:-1] - T[1:-1, 1:-1]))
    new = ThermalState(u=u, v=v, p=result.p, T=T_new, t=t + dt, n=n + 1)
    return (ThermalAB2State(ts=new, ru=ru, rv=rv, rT=S, dt_prev=dt),
            (dt, max_dT, result))


@functools.lru_cache(maxsize=32)
def make_thermal_step_ab2_fn(params: Params, cfg: ThermalConfig,
                             pressure_method: str = "mg"):
    """Jitted AB2 thermal step for host-driven loops (the --time-order 2
    problem-5 CLI path; twin of make_thermal_step_fn)."""
    from ..solver import StepDiagnostics

    @jax.jit
    def _step(ab2: ThermalAB2State):
        new, (dt, _, res) = thermal_step_ab2(ab2, params, cfg,
                                             pressure_method=pressure_method)
        return new, StepDiagnostics(dt=dt, sor_iterations=res.iterations,
                                    sor_res_norm=res.res_norm,
                                    sor_converged=res.converged)

    return _step


@functools.partial(jax.jit, static_argnums=(0, 1, 3))
def _thermal_solve_ab2_on_device(params: Params, cfg: ThermalConfig,
                                 ab2: ThermalAB2State,
                                 pressure_method: str):
    from ..solver import SolveStats

    T_end = jnp.asarray(params.T, ab2.ts.t.dtype)

    def cond(carry):
        return carry[0].ts.t < T_end

    def body(carry):
        ab2, stats = carry
        ab2, (dt, _, res) = thermal_step_ab2(ab2, params, cfg,
                                             pressure_method=pressure_method)
        stats = SolveStats(
            steps=stats.steps + 1,
            total_sor_iterations=stats.total_sor_iterations + res.iterations,
            sor_failures=stats.sor_failures
            + jnp.where(res.converged, 0, 1).astype(jnp.int32),
            last_res_norm=res.res_norm,
        )
        return ab2, stats

    zero = jnp.zeros((), jnp.int32)
    init = SolveStats(steps=zero, total_sor_iterations=zero,
                      sor_failures=zero,
                      last_res_norm=jnp.zeros((), ab2.ts.t.dtype))
    return lax.while_loop(cond, body, (ab2, init))


def thermal_solve_ab2(params: Params, cfg: ThermalConfig,
                      state: Optional[ThermalState] = None, *,
                      pressure_method: str = "mg"):
    """Second-order fixed-horizon Boussinesq integration (single chip) —
    thermal_solve's --time-order 2 twin.  Returns (ThermalState,
    SolveStats)."""
    if state is None:
        state = allocate_thermal(params, cfg)
    ab2, stats = _thermal_solve_ab2_on_device(
        params, cfg, thermal_ab2_init(state), pressure_method)
    return ab2.ts, stats


def config_from_params(params: Params) -> ThermalConfig:
    """ThermalConfig for a problem-5 `Params` (the reference-protocol
    surface: CLI / ``.in`` files — config.py lines 16/17 carry Ra/Pr).
    De Vahl Davis orientation: hot left wall `params.t_hot`, cold right
    wall `params.t_cold`, adiabatic top/bottom, no-slip walls, buoyancy
    coefficient 1 in the convective velocity scale (module docstring);
    obstacle cells (``--obstacle``) default to adiabatic blocks."""
    if params.problem != 5:
        raise ValueError(
            f"config_from_params expects problem=5, got {params.problem}")
    return ThermalConfig(alpha=1.0 / (params.Re * params.Pr),
                         beta_gx=0.0, beta_gy=-1.0,
                         t_left=params.t_hot, t_right=params.t_cold)


@functools.lru_cache(maxsize=32)
def make_thermal_step_fn(params: Params, cfg: ThermalConfig,
                         pressure_method: str = "mg"):
    """Jitted thermal step for host-driven loops (cli.py output/checkpoint
    paths) — the Boussinesq twin of solver.make_step_fn, returning the
    isothermal `StepDiagnostics` tuple so the host loop is state-family
    agnostic."""
    from ..solver import StepDiagnostics

    @jax.jit
    def _step(ts: ThermalState):
        new, (dt, _, res) = thermal_step(ts, params, cfg,
                                         pressure_method=pressure_method)
        return new, StepDiagnostics(dt=dt, sor_iterations=res.iterations,
                                    sor_res_norm=res.res_norm,
                                    sor_converged=res.converged)

    return _step


def _thermal_loop(params: Params, cfg: ThermalConfig,
                  ts: ThermalState, pressure_method: str):
    """Unjitted `while t < T` Boussinesq integration — traced directly by
    the single-chip jit below AND inside the padded GSPMD jit (where an
    extra jit boundary would block the partitioner's sharding view)."""
    from ..solver import SolveStats

    T_end = jnp.asarray(params.T, ts.t.dtype)

    def cond(carry):
        ts, _ = carry
        return ts.t < T_end

    def body(carry):
        ts, stats = carry
        ts, (dt, _, res) = thermal_step(ts, params, cfg,
                                        pressure_method=pressure_method)
        stats = SolveStats(
            steps=stats.steps + 1,
            total_sor_iterations=stats.total_sor_iterations + res.iterations,
            sor_failures=stats.sor_failures
            + jnp.where(res.converged, 0, 1).astype(jnp.int32),
            last_res_norm=res.res_norm,
        )
        return ts, stats

    zero = jnp.zeros((), jnp.int32)
    init = SolveStats(steps=zero, total_sor_iterations=zero,
                      sor_failures=zero,
                      last_res_norm=jnp.zeros((), ts.t.dtype))
    return lax.while_loop(cond, body, (ts, init))


_thermal_solve_on_device = functools.partial(jax.jit,
                                             static_argnums=(0, 1, 3))(
    _thermal_loop)


def thermal_solve(params: Params, cfg: ThermalConfig,
                  state: Optional[ThermalState] = None, *,
                  pressure_method: str = "mg", mesh=None):
    """Integrate the Boussinesq system to t >= params.T entirely on device
    (the solver.solve twin for problem 5 — fixed-horizon reference
    protocol, vs solve_convection's steady-state detection).  Returns
    (ThermalState, SolveStats).

    With `mesh` (a 2D jax.sharding.Mesh) the whole integration runs
    multi-chip via the GSPMD recipe — the four grid fields (u, v, p, T)
    boundary-padded and block-sharded, XLA's partitioner inserting the
    collectives for momentum, pressure, AND the energy equation alike
    (no thermal-specific communication code, same as solve_convection's
    mesh arm)."""
    if state is None:
        state = allocate_thermal(params, cfg)
    if mesh is not None:
        fn = _make_thermal_gspmd(params, cfg, mesh, pressure_method,
                                 whole_solve=True)
        out, stats = fn(place_thermal(state, params, mesh))
        return fetch_thermal(out, params), stats
    return _thermal_solve_on_device(params, cfg, state, pressure_method)


# ---------------------------------------------------------------------------
# Multi-chip fixed-horizon thermal runs (GSPMD recipe) — the problem-5
# CLI's `--backend gspmd` path.  solve_convection(mesh=...) above is the
# steady-state twin; this one carries the reference protocol (while t < T,
# SolveStats, host-loop stepper for output/checkpointing).
# ---------------------------------------------------------------------------


def place_thermal(ts: ThermalState, params: Params, mesh) -> ThermalState:
    """Device-place a ThermalState for a GSPMD run: all four grid fields
    boundary-padded to mesh multiples + block-sharded (parallel/gspmd.py
    semantics — on-device pad single-process, per-shard scatter
    multi-process), scalars replicated."""
    import numpy as np

    from ..parallel import gspmd

    grid, rep = gspmd._shardings(mesh)
    pi, pj = gspmd._padded_shape(mesh, ts.u.shape)

    def pad(arr):
        ni, nj = arr.shape
        if gspmd._all_local(grid):
            padded = jnp.zeros((pi, pj), arr.dtype).at[:ni, :nj].set(
                jnp.asarray(arr))
            return jax.device_put(padded, grid)
        host = np.zeros((pi, pj), arr.dtype)
        host[:ni, :nj] = np.asarray(arr)
        return gspmd._put(host, grid)

    return ThermalState(u=pad(ts.u), v=pad(ts.v), p=pad(ts.p), T=pad(ts.T),
                        t=gspmd._put(np.asarray(ts.t), rep),
                        n=gspmd._put(np.asarray(ts.n), rep))


def fetch_thermal(ts: ThermalState, params: Params) -> ThermalState:
    """Reference-layout ThermalState from a (padded, sharded) output —
    single-process: a device-resident sliced view; multi-process:
    allgathered (parallel/gspmd.py::fetch_state semantics)."""
    from ..parallel import gspmd

    ni, nj = params.shape
    s = ThermalState(u=ts.u[:ni, :nj], v=ts.v[:ni, :nj],
                     p=ts.p[:ni, :nj], T=ts.T[:ni, :nj], t=ts.t, n=ts.n)
    if gspmd._all_local(ts.u):
        return s
    return ThermalState(u=jnp.asarray(gspmd._fetch(s.u)),
                        v=jnp.asarray(gspmd._fetch(s.v)),
                        p=jnp.asarray(gspmd._fetch(s.p)),
                        T=jnp.asarray(gspmd._fetch(s.T)),
                        t=s.t, n=s.n)


@functools.lru_cache(maxsize=32)
def _make_thermal_gspmd(params: Params, cfg: ThermalConfig, mesh,
                        pressure_method: str, whole_solve: bool):
    from ..parallel import gspmd
    from ..solver import SolveStats, StepDiagnostics

    gspmd._check_mesh(mesh)
    gspmd._check_method(pressure_method)
    params = params.replace(disable_pallas=True)
    grid, rep = gspmd._shardings(mesh)
    ni, nj = params.shape
    pi, pj = gspmd._padded_shape(mesh, (ni, nj))
    out_ts = ThermalState(u=grid, v=grid, p=grid, T=grid, t=rep, n=rep)
    aux = (SolveStats(rep, rep, rep, rep) if whole_solve
           else StepDiagnostics(rep, rep, rep, rep))

    def fn(padded: ThermalState):
        ts = ThermalState(u=padded.u[:ni, :nj], v=padded.v[:ni, :nj],
                          p=padded.p[:ni, :nj], T=padded.T[:ni, :nj],
                          t=padded.t, n=padded.n)
        if whole_solve:
            out, aux_val = _thermal_loop(params, cfg, ts, pressure_method)
        else:
            out, (dt, _, res) = thermal_step(
                ts, params, cfg, pressure_method=pressure_method)
            aux_val = StepDiagnostics(dt=dt, sor_iterations=res.iterations,
                                      sor_res_norm=res.res_norm,
                                      sor_converged=res.converged)

        def repad(a):
            return jnp.zeros((pi, pj), a.dtype).at[:ni, :nj].set(a)

        return (ThermalState(u=repad(out.u), v=repad(out.v),
                             p=repad(out.p), T=repad(out.T),
                             t=out.t, n=out.n), aux_val)

    return jax.jit(fn, out_shardings=(out_ts, aux))


class ThermalGspmdStepper:
    """Host-loop adapter for multi-chip problem-5 runs (periodic output /
    checkpoint / history through cli._run_host_loop) — the thermal twin
    of parallel/gspmd.py::GspmdStepper."""

    def __init__(self, params: Params, cfg: ThermalConfig,
                 state: ThermalState, mesh=None,
                 pressure_method: str = "mg"):
        from ..parallel import gspmd

        if mesh is None:
            mesh = gspmd._default_mesh()
        self.params = params
        self._fn = _make_thermal_gspmd(params, cfg, mesh, pressure_method,
                                       whole_solve=False)
        self._state = place_thermal(state, params, mesh)

    @property
    def t(self) -> float:
        return float(self._state.t)

    @property
    def n(self) -> int:
        return int(self._state.n)

    def warm(self) -> None:
        self._fn = self._fn.lower(self._state).compile()

    def step(self):
        self._state, diag = self._fn(self._state)
        return diag

    def state(self) -> ThermalState:
        return fetch_thermal(self._state, self.params)


def solve_convection(params: Params, cfg: ThermalConfig,
                     state: Optional[ThermalState] = None, *,
                     pressure_method: str = "mg",
                     steady_tol: float = 1e-6,
                     max_steps: int = 200_000,
                     chunk: int = 200,
                     mesh=None):
    """Integrate to steady state: stop when max|dT|/dt of a step falls
    under steady_tol (or max_steps).  Jitted chunks; one scalar fetch
    per chunk.  Returns (state, info dict).

    `mesh`: a 2D jax.sharding.Mesh makes the family multi-chip via the
    GSPMD recipe (parallel/gspmd.py): the four grid fields are
    boundary-padded and block-sharded, the UNMODIFIED thermal step is
    jitted under those shardings, and XLA's partitioner inserts the
    collectives — no thermal-specific communication code."""
    if mesh is not None:
        return _solve_convection_gspmd(
            params, cfg, state, pressure_method=pressure_method,
            steady_tol=steady_tol, max_steps=max_steps, chunk=chunk,
            mesh=mesh)
    if state is None:
        state = allocate_thermal(params, cfg)

    @jax.jit
    def run_chunk(ts):
        def body(carry, _):
            ts, _, failed = carry
            new, (dt, max_dT, res) = thermal_step(
                ts, params, cfg, pressure_method=pressure_method)
            return (new, max_dT / dt,
                    failed + (~res.converged).astype(jnp.int32)), None

        init = (ts, jnp.asarray(jnp.inf, ts.T.dtype),
                jnp.zeros((), jnp.int32))
        (ts, rate, failed), _ = lax.scan(body, init, None, length=chunk)
        return ts, rate, failed

    steps = 0
    failures = 0
    rate = float("inf")
    while steps < max_steps:
        state, rate_dev, failed = run_chunk(state)
        rate = float(rate_dev)
        failures += int(failed)
        steps += chunk
        if rate < steady_tol:
            break
    return state, {"steps": steps, "dT_rate": rate,
                   "sor_failures": failures,
                   "steady": rate < steady_tol}


def _solve_convection_gspmd(params: Params, cfg: ThermalConfig, state, *,
                            pressure_method, steady_tol, max_steps, chunk,
                            mesh):
    """GSPMD multi-chip arm of solve_convection (see its docstring)."""
    from ..parallel import gspmd

    gspmd._check_mesh(mesh)
    if pressure_method == "pallas_sor":
        raise ValueError("gspmd convection cannot run pallas_sor "
                         "(opaque to the SPMD partitioner)")
    # Pin the jnp formulations + the matmul DCT route (the partitioner
    # cannot shard Pallas calls; jnp.fft gathers).
    params = params.replace(disable_pallas=True)
    if state is None:
        state = allocate_thermal(params, cfg)

    grid, rep = gspmd._shardings(mesh)
    ni, nj = params.shape
    pi, pj = gspmd._padded_shape(mesh, (ni, nj))
    placed = place_thermal(state, params, mesh)

    out_shardings = (ThermalState(u=grid, v=grid, p=grid, T=grid,
                                  t=rep, n=rep), rep, rep)

    @functools.partial(jax.jit, out_shardings=out_shardings)
    def run_chunk(padded):
        ts = ThermalState(u=padded.u[:ni, :nj], v=padded.v[:ni, :nj],
                          p=padded.p[:ni, :nj], T=padded.T[:ni, :nj],
                          t=padded.t, n=padded.n)

        def body(carry, _):
            ts, _, failed = carry
            new, (dt, max_dT, res) = thermal_step(
                ts, params, cfg, pressure_method=pressure_method)
            return (new, max_dT / dt,
                    failed + (~res.converged).astype(jnp.int32)), None

        init = (ts, jnp.asarray(jnp.inf, ts.T.dtype),
                jnp.zeros((), jnp.int32))
        (ts, rate, failed), _ = lax.scan(body, init, None, length=chunk)

        def repad(a):
            return jnp.zeros((pi, pj), a.dtype).at[:ni, :nj].set(a)

        return (ThermalState(u=repad(ts.u), v=repad(ts.v), p=repad(ts.p),
                             T=repad(ts.T), t=ts.t, n=ts.n), rate, failed)

    steps = 0
    failures = 0
    rate = float("inf")
    while steps < max_steps:
        placed, rate_dev, failed = run_chunk(placed)
        rate = float(rate_dev)
        failures += int(failed)
        steps += chunk
        if rate < steady_tol:
            break
    final = fetch_thermal(placed, params)
    return final, {"steps": steps, "dT_rate": rate,
                   "sor_failures": failures,
                   "steady": rate < steady_tol}


def nusselt_hot_wall(T: jax.Array, params: Params,
                     t_left: float = 0.5) -> float:
    """Mean Nusselt number at the hot (left) wall: -dT/dx integrated over
    the wall (dT=1, L=1 => conduction gives exactly 1).  The Dirichlet
    ghost reflection makes the one-sided wall gradient
    2 (T[1,j] - t_left)/dx."""
    g = -2.0 * (jnp.asarray(T)[1, 1:-1] - t_left) * params.i_max
    return float(jnp.mean(g))


def nusselt_cold_wall(T: jax.Array, params: Params,
                      t_right: float = -0.5) -> float:
    g = -2.0 * (t_right - jnp.asarray(T)[-2, 1:-1]) * params.i_max
    return float(jnp.mean(g))


# de Vahl Davis (1983) benchmark mean hot-wall Nusselt numbers.
DE_VAHL_DAVIS_NU = {1e3: 1.118, 1e4: 2.243, 1e5: 4.519, 1e6: 8.800}


# ---------------------------------------------------------------------------
# Rayleigh-Benard (heated from below)

# Linear-stability constants for a layer between rigid (no-slip)
# conducting plates (Chandrasekhar 1961, ch. II): onset at
# Ra_c = 1707.762 with horizontal wavenumber a_c = 3.117.  A free-slip
# sidewall is a roll symmetry plane, so a box of width pi/a_c (one roll
# = half the critical wavelength 2*pi/a_c) hosts the infinite-layer
# critical eigenmode EXACTLY — finite-box validation against closed-form
# theory with no fitted constants.
RB_CRITICAL_RA = 1707.762
RB_CRITICAL_WAVENUMBER = 3.117
RB_CRITICAL_ASPECT = float(jnp.pi) / RB_CRITICAL_WAVENUMBER


def nusselt_bottom(T: jax.Array, params: Params,
                   t_bottom: float = 0.5) -> float:
    """Mean Nusselt number at the hot bottom plate: -dT/dy (times
    b/dT = 1 in the unit scaling) averaged over the plate; Dirichlet
    ghost reflection makes the one-sided gradient 2 (T[i,1]-t_b)/dy."""
    g = -2.0 * (jnp.asarray(T)[1:-1, 1] - t_bottom) * params.j_max / params.b
    return float(jnp.mean(g))


def nusselt_top(T: jax.Array, params: Params,
                t_top: float = -0.5) -> float:
    """Mean Nusselt number at the cold top plate (must equal
    nusselt_bottom at steady state — discrete heat balance with
    adiabatic sidewalls)."""
    g = -2.0 * (t_top - jnp.asarray(T)[1:-1, -2]) * params.j_max / params.b
    return float(jnp.mean(g))


def seed_rb_perturbation(ts: ThermalState, params: Params,
                         cfg: ThermalConfig, amp: float = 1e-3,
                         mode: int = 1) -> ThermalState:
    """Add the m-roll thermal eigenmode shape amp*cos(m pi x/a)*sin(pi y/b)
    to T (cell centers).  cos in x has zero normal gradient at the
    adiabatic sidewalls; sin in y vanishes at the conducting plates —
    compatible with every RB boundary condition, and for the critical
    box it IS the horizontal structure of the unstable mode."""
    x = (jnp.arange(params.i_max + 2, dtype=ts.T.dtype) - 0.5) * params.dx
    y = (jnp.arange(params.j_max + 2, dtype=ts.T.dtype) - 0.5) * params.dy
    pert = (amp * jnp.cos(mode * jnp.pi * x[:, None] / params.a)
            * jnp.sin(jnp.pi * y[None, :] / params.b))
    T = _apply_t_bcs(ts.T + pert, params, cfg)
    return ts._replace(T=T)


def kinetic_energy(ts: ThermalState) -> jax.Array:
    """Interior sum of u^2 + v^2 — the (unnormalized) perturbation
    energy whose exponential trend rb_growth_rate fits."""
    return (jnp.sum(ts.u[1:-1, 1:-1] ** 2)
            + jnp.sum(ts.v[1:-1, 1:-1] ** 2))


def rb_growth_rate(Ra: float, *, Pr: float = 0.71, n: int = 32,
                   aspect: Optional[float] = None,
                   amp: Optional[float] = None,
                   t_transient: float = 10.0, t_measure: float = 20.0,
                   pressure_method: str = "mg", dtype: str = "float32",
                   chunk: int = 200) -> dict:
    """Measure the linear growth rate sigma of the single-roll RB mode:
    integrate the perturbed conduction state in the critical free-slip
    box, then fit E(t) ~ exp(2 sigma t) between the end of the transient
    window and the end of the run.  sigma crosses zero at Ra_c — the
    sign test and the linear-in-Ra extrapolation to sigma=0 are the
    validation hooks (scripts/validate_rb.py, tests/test_convection.py).

    Times are in convective units (the diffusive time is sqrt(Ra*Pr) of
    them, so defaults cover ~0.8 diffusive times at Ra~2000).  Returns
    {sigma, E0, E1, t0, t1, Ra}.

    `amp` is resolution-dependent, squeezed from both sides (both limits
    MEASURED, round 3/4): it must stay above the f32 storage +
    pressure-tolerance noise floor — 1e-4 flatlines a near-critical slow
    mode at 64² (sigma +0.0002 instead of +0.026) while 1e-3
    recovers it — yet small enough that the E1 window is still linear:
    at 32² over the default 35-unit horizon, 1e-3 saturates enough to
    bias the extrapolated Ra_c 2% low (1673 vs 1707.76) where 1e-4 gives
    0.002%.  The default (amp=None) picks 1e-4 for n<=32 and 1e-3
    above; pass amp explicitly to override."""
    if amp is None:
        amp = 1e-4 if n <= 32 else 1e-3
    if aspect is None:
        aspect = RB_CRITICAL_ASPECT
    params, cfg = rayleigh_benard_setup(
        Ra, Pr=Pr, n=n, aspect=aspect, sidewalls="freeslip",
        epsilon=1e-6, dtype=dtype)
    ts = seed_rb_perturbation(allocate_thermal(params, cfg), params, cfg,
                              amp=amp)

    @jax.jit
    def run_chunk(ts):
        def body(ts, _):
            new, _aux = thermal_step(ts, params, cfg,
                                     pressure_method=pressure_method)
            return new, None

        ts, _ = lax.scan(body, ts, None, length=chunk)
        return ts, kinetic_energy(ts), ts.t

    def run_until(ts, t_target):
        E, t = kinetic_energy(ts), float(ts.t)
        while t < t_target:
            ts, E, t_dev = run_chunk(ts)
            t = float(t_dev)
        return ts, float(E), t

    ts, E0, t0 = run_until(ts, t_transient)
    ts, E1, t1 = run_until(ts, t_transient + t_measure)
    sigma = float(jnp.log(E1 / E0) / (2.0 * (t1 - t0)))
    return {"sigma": sigma, "E0": E0, "E1": E1, "t0": t0, "t1": t1,
            "Ra": Ra}


# Published mean-Nusselt benchmarks for the SQUARE Rayleigh-Benard
# cavity (aspect 1, air Pr=0.71, rigid no-slip walls, adiabatic
# sidewalls, single-roll steady state): Ouertatani, Ben Cheikh, Ben
# Beya & Lili, C. R. Mecanique 336 (2008) 464-470.
OUERTATANI_RB_NU = {1e4: 2.154, 1e5: 3.907, 1e6: 6.363}
