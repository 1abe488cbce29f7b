"""Time-integration driver.

Accelerator redesign of the reference drivers (src/serial/main.c:31-158,
src/parallel/main.cu:954-1129).  One time step =

    adaptive CFL dt  ->  velocity BCs  ->  tentative F/G  ->  Poisson RHS
    ->  red-black SOR pressure solve  ->  velocity projection

exactly the reference's flow, but expressed as a pure function
`step : State -> State` that jits into a single XLA computation.  The full
integration `while t < T` is available in two forms:

  * `solve()` — the whole time loop is a `lax.while_loop` **on device**; the
    host is not involved between t=0 and t=T (no per-step D2H transfers at
    all, vs. the reference's 2 memcpys per step for dt + 1 per SOR iteration,
    main.cu:825/710).
  * `run()` (in cli.py) — host loop over the jitted `step` for when periodic
    field output / checkpointing is requested (n_print), the working version
    of the reference's commented-out output path (main.c:138-143).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from .config import Params
from .grid import State, allocate_state
from .ops import boundary, momentum, sor


class StepDiagnostics(NamedTuple):
    dt: jax.Array              # time step taken
    sor_iterations: jax.Array  # SOR sweeps in this step
    sor_res_norm: jax.Array    # final SOR residual norm
    sor_converged: jax.Array   # bool: SOR met tolerance (reference silently
                               # ignores non-convergence, main.c:123; we track)


class SolveStats(NamedTuple):
    steps: jax.Array               # total time steps
    total_sor_iterations: jax.Array
    sor_failures: jax.Array        # steps where SOR hit max_it
    last_res_norm: jax.Array


def step(
    state: State,
    params: Params,
    *,
    pressure_method: str = "rb_sor",
) -> Tuple[State, StepDiagnostics]:
    """One time step (reference main.c:86-146). Pure; jit over `state`."""
    u, v, p, t, n = state

    dt, gamma = momentum.adaptive_dt_gamma(u, v, params)
    if params.problem == 3:
        u, v = boundary.apply_channel_bcs(u, v, params)
    elif params.problem == 4:
        u, v = boundary.apply_freeslip_box(u, v)
    else:
        lid = boundary.lid_velocity(params.problem, params.f, t)
        u, v = boundary.apply_cavity_bcs(u, v, lid)
    if params.obstacles:
        from .ops import obstacles as obs

        u, v = obs.apply_obstacle_bcs(u, v, params)
    F, G = momentum.compute_fg(u, v, dt, gamma, params)
    if params.obstacles:
        # F = u on obstacle faces BEFORE the divergence, then no
        # equation on solid cells; with the cut-cell closure the
        # divergence is aperture-weighted (obstacles.poisson_rhs).
        F, G = obs.pin_fg(F, G, u, v, params)
        rhs = obs.poisson_rhs(F, G, dt, params)
    else:
        rhs = momentum.compute_rhs(F, G, dt, params)
    return _advance(u, v, p, t, n, F, G, rhs, dt, params, pressure_method)


def _advance(u, v, p, t, n, F, G, rhs, dt, params: Params,
             pressure_method: str) -> Tuple[State, StepDiagnostics]:
    """Pressure solve + projection tail shared by `step` and `step_ab2`."""
    result = sor.solve_pressure(p, rhs, params, method=pressure_method)
    u, v = momentum.project_velocities(u, v, F, G, result.p, dt, params)
    if params.obstacles:
        from .ops import obstacles as obs

        # The projection slice sweeps obstacle faces too (unlike the outer
        # walls, which it excludes by construction) — restore no-slip so
        # the state is always consistent between steps.
        u, v = obs.apply_obstacle_bcs(u, v, params)

    new_state = State(u=u, v=v, p=result.p, t=t + dt, n=n + 1)
    diag = StepDiagnostics(
        dt=dt,
        sor_iterations=result.iterations,
        sor_res_norm=result.res_norm,
        sor_converged=result.converged,
    )
    return new_state, diag


@functools.lru_cache(maxsize=32)
def make_step_fn(params: Params, pressure_method: str = "rb_sor"):
    """Jitted step closure for host-driven loops (output/checkpoint paths).
    Cached so repeated host loops on the same config reuse the jit cache
    (a fresh wrapper would re-trace — minutes at 4096^2)."""
    @jax.jit
    def _step(state: State) -> Tuple[State, StepDiagnostics]:
        return step(state, params, pressure_method=pressure_method)

    return _step


@functools.lru_cache(maxsize=32)
def make_ab2_step_fn(params: Params, pressure_method: str = "rb_sor"):
    """Jitted step_ab2 closure for host-driven loops (same caching
    rationale as make_step_fn)."""
    @jax.jit
    def _step(ab2: "AB2State") -> Tuple["AB2State", StepDiagnostics]:
        return step_ab2(ab2, params, pressure_method=pressure_method)

    return _step


class AB2State(NamedTuple):
    """Carry for the second-order (Adams-Bashforth 2) time integrator:
    the base State plus the previous step's explicit spatial tendency
    (advection + diffusion + body force, on the F/G face layouts) and the
    previous dt for the variable-step AB2 weights.  `dt_prev == 0` marks
    the bootstrap — the first step is plain explicit Euler."""

    s: State
    ru: jax.Array       # dU/dt at the previous step, F layout
    rv: jax.Array       # dV/dt at the previous step, G layout
    dt_prev: jax.Array  # previous dt (scalar; 0.0 = bootstrap)


def ab2_init(state: State) -> AB2State:
    return AB2State(s=state, ru=jnp.zeros_like(state.u),
                    rv=jnp.zeros_like(state.v),
                    dt_prev=jnp.zeros((), state.t.dtype))


def step_ab2(
    ab2: AB2State,
    params: Params,
    *,
    pressure_method: str = "rb_sor",
) -> Tuple[AB2State, StepDiagnostics]:
    """One second-order (variable-step Adams-Bashforth 2) time step.

    The reference integrates the momentum equations with explicit Euler
    (integration.c:73-96 — F = u + dt*(...)), first order in dt; the
    Kármán space-time study (scripts/karman_dt_study.py) measured that
    temporal bias at 2-4% on the Schäfer-Turek force coefficients, larger
    than the spatial error at 20+ cells/diameter.  AB2 extrapolates the
    explicit tendency through the previous step,

        u* = u + dt*[(1 + w) R_n - w R_{n-1}],   w = dt / (2 dt_{n-1}),

    the variable-step form needed under the adaptive CFL dt; the pressure
    projection is unchanged (it enforces the divergence constraint at
    t_{n+1} regardless of the tentative scheme's order).  The first step
    bootstraps with Euler (w = 0).  Stability: AB2's real-axis interval is
    (-1, 0) vs Euler's (-2, 0), so the viscous-limited dt must satisfy
    tau <= 0.5 — exactly the reference's default; donor-cell upwinding
    keeps the advective eigenvalues off the imaginary axis.

    The extra state is two face arrays + one scalar.

    Accuracy fine print (all measured, tests/test_ab2.py): interior AND
    first-ring velocities are clean order 2 — but only with a
    dt-decoupled donor-cell weight (config.py::gamma_fixed; under the
    reference's adaptive gamma the upwind dissipation itself is O(dt)
    and dominates).  Ghost cells are refreshed at the START of the next
    step, so a final state's ghosts lag one step (O(dt) staleness, not a
    trajectory error).  The returned pressure is the AB2 tendency's
    midpoint pressure — a uniform half-step time offset, O(dt^2) beyond
    the shift; cycle maxima/means of recorded signals (the Kármán
    cd/cl/dp protocol) are shift-invariant.
    """
    u, v, p, t, n = ab2.s

    dt, gamma = momentum.adaptive_dt_gamma(u, v, params)
    if params.problem == 3:
        u, v = boundary.apply_channel_bcs(u, v, params)
    elif params.problem == 4:
        u, v = boundary.apply_freeslip_box(u, v)
    else:
        lid = boundary.lid_velocity(params.problem, params.f, t)
        u, v = boundary.apply_cavity_bcs(u, v, lid)
    if params.obstacles:
        from .ops import obstacles as obs

        u, v = obs.apply_obstacle_bcs(u, v, params)
    F, G = momentum.compute_fg(u, v, dt, gamma, params)
    # Tendencies from the Euler tentative fields: R = (F - u)/dt.  Exact
    # zeros on the wall faces (compute_fg sets F = u there); the ghost
    # rows/columns hold junk that no downstream read touches (the RHS
    # divergence and the projection only read interior + wall faces).
    ru = (F - u) / dt
    rv = (G - v) / dt
    w = jnp.where(ab2.dt_prev > 0, dt / (2.0 * ab2.dt_prev), 0.0)
    F = F + (dt * w) * (ru - ab2.ru)
    G = G + (dt * w) * (rv - ab2.rv)
    if params.obstacles:
        F, G = obs.pin_fg(F, G, u, v, params)
        rhs = obs.poisson_rhs(F, G, dt, params)
    else:
        rhs = momentum.compute_rhs(F, G, dt, params)
    state, diag = _advance(u, v, p, t, n, F, G, rhs, dt, params,
                           pressure_method)
    return AB2State(s=state, ru=ru, rv=rv, dt_prev=dt), diag


@functools.partial(jax.jit, static_argnums=(0, 2))
def _solve_ab2_on_device(
    params: Params,
    ab2: AB2State,
    pressure_method: str = "rb_sor",
) -> Tuple[AB2State, SolveStats]:
    T = jnp.asarray(params.T, ab2.s.t.dtype)

    def cond(carry):
        ab2, _ = carry
        return ab2.s.t < T

    def body(carry):
        ab2, stats = carry
        ab2, diag = step_ab2(ab2, params, pressure_method=pressure_method)
        stats = SolveStats(
            steps=stats.steps + 1,
            total_sor_iterations=stats.total_sor_iterations
            + diag.sor_iterations,
            sor_failures=stats.sor_failures
            + jnp.where(diag.sor_converged, 0, 1).astype(jnp.int32),
            last_res_norm=diag.sor_res_norm,
        )
        return ab2, stats

    zero = jnp.zeros((), jnp.int32)
    init_stats = SolveStats(
        steps=zero,
        total_sor_iterations=zero,
        sor_failures=zero,
        last_res_norm=jnp.zeros((), ab2.s.t.dtype),
    )
    return lax.while_loop(cond, body, (ab2, init_stats))


def solve_ab2(
    params: Params,
    state: Optional[State] = None,
    *,
    pressure_method: str = "rb_sor",
) -> Tuple[State, SolveStats]:
    """Integrate to t >= T on device with second-order time stepping."""
    if state is None:
        state = allocate_state(params)
    ab2, stats = _solve_ab2_on_device(params, ab2_init(state),
                                      pressure_method)
    return ab2.s, stats


def solve_stepwise(
    params: Params,
    state: Optional[State] = None,
    *,
    pressure_method: str = "rb_sor",
) -> Tuple[State, SolveStats]:
    """Host-driven per-STEP dispatches: numerically identical to solve(),
    but no on-device multi-step while_loop: each step is one dispatch,
    and the host reads the step's diagnostics before the next.  Costs
    one small device-to-host fetch per step."""
    if state is None:
        state = allocate_state(params)
    fn = make_step_fn(params, pressure_method)
    steps = 0
    iters = 0
    fails = 0
    last = 0.0
    # Compare against T in the state's dtype, exactly as the on-device
    # while_loops do (_solve_on_device:137): with f32 time, float(f32(T))
    # can differ from the python T by one ulp, which would make this loop
    # take one step more/less than solve() on the same workload.
    T = float(jnp.asarray(params.T, state.t.dtype))
    while float(state.t) < T:
        state, diag = fn(state)
        steps += 1
        iters += int(diag.sor_iterations)
        fails += 0 if bool(diag.sor_converged) else 1
        last = float(diag.sor_res_norm)
    return state, SolveStats(
        steps=jnp.asarray(steps, jnp.int32),
        total_sor_iterations=jnp.asarray(iters, jnp.int32),
        sor_failures=jnp.asarray(fails, jnp.int32),
        last_res_norm=jnp.asarray(last, state.t.dtype),
    )


@functools.partial(jax.jit, static_argnums=(0, 2))
def _solve_on_device(
    params: Params,
    state: State,
    pressure_method: str = "rb_sor",
) -> Tuple[State, SolveStats]:
    T = jnp.asarray(params.T, state.t.dtype)

    def cond(carry):
        state, _ = carry
        return state.t < T

    def body(carry):
        state, stats = carry
        state, diag = step(state, params, pressure_method=pressure_method)
        stats = SolveStats(
            steps=stats.steps + 1,
            total_sor_iterations=stats.total_sor_iterations + diag.sor_iterations,
            sor_failures=stats.sor_failures
            + jnp.where(diag.sor_converged, 0, 1).astype(jnp.int32),
            last_res_norm=diag.sor_res_norm,
        )
        return state, stats

    zero = jnp.zeros((), jnp.int32)
    init_stats = SolveStats(
        steps=zero,
        total_sor_iterations=zero,
        sor_failures=zero,
        last_res_norm=jnp.zeros((), state.t.dtype),
    )
    return lax.while_loop(cond, body, (state, init_stats))


def solve(
    params: Params,
    state: Optional[State] = None,
    *,
    pressure_method: str = "rb_sor",
) -> Tuple[State, SolveStats]:
    """Integrate from `state` (or zeros) to t >= T entirely on device."""
    if state is None:
        state = allocate_state(params)
    return _solve_on_device(params, state, pressure_method)


@functools.partial(jax.jit, static_argnums=(0, 4))
def _solve_capped(
    params: Params,
    state: State,
    stats: SolveStats,
    max_steps,
    pressure_method: str = "rb_sor",
) -> Tuple[State, SolveStats]:
    """Like _solve_on_device but stops after `max_steps` additional steps,
    resuming from carried stats."""
    T = jnp.asarray(params.T, state.t.dtype)
    stop_at = stats.steps + jnp.asarray(max_steps, jnp.int32)

    def cond(carry):
        state, stats = carry
        return jnp.logical_and(state.t < T, stats.steps < stop_at)

    def body(carry):
        state, stats = carry
        state, diag = step(state, params, pressure_method=pressure_method)
        stats = SolveStats(
            steps=stats.steps + 1,
            total_sor_iterations=stats.total_sor_iterations + diag.sor_iterations,
            sor_failures=stats.sor_failures
            + jnp.where(diag.sor_converged, 0, 1).astype(jnp.int32),
            last_res_norm=diag.sor_res_norm,
        )
        return state, stats

    return lax.while_loop(cond, body, (state, stats))


def solve_segmented(
    params: Params,
    state: Optional[State] = None,
    *,
    pressure_method: str = "rb_sor",
    steps_per_dispatch: int = 16,
) -> Tuple[State, SolveStats]:
    """Integrate to T in host-bounded dispatches of `steps_per_dispatch`
    steps each.  Numerically identical to solve(); use for very large grids
    or fragile remote platforms where a single multi-minute dispatch is
    risky (each segment boundary is a natural checkpoint opportunity)."""
    if state is None:
        state = allocate_state(params)
    zero = jnp.zeros((), jnp.int32)
    stats = SolveStats(steps=zero, total_sor_iterations=zero,
                       sor_failures=zero,
                       last_res_norm=jnp.zeros((), state.t.dtype))
    # T in the state's dtype, like _solve_capped's on-device cond: if the
    # python T rounds DOWN in f32 and the accumulated t lands exactly on
    # f32(T), a full-precision comparison here would stay true while the
    # capped dispatch advances zero steps — an infinite no-op loop.
    T = float(jnp.asarray(params.T, state.t.dtype))
    while float(state.t) < T:  # the float() fetch fences each segment
        state, stats = _solve_capped(params, state, stats,
                                     steps_per_dispatch, pressure_method)
    return state, stats


def stack_states(states) -> State:
    """Stack per-member States into one batched State (leading batch dim)."""
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)


@functools.partial(jax.jit, static_argnums=(0, 2))
def _solve_ensemble(params: Params, states: State,
                    pressure_method: str = "rb_sor"):
    return jax.vmap(
        lambda s: _solve_on_device(params, s, pressure_method)
    )(states)


def solve_ensemble(
    params: Params,
    states: State,
    *,
    pressure_method: str = "rb_sor",
    mesh=None,
) -> Tuple[State, SolveStats]:
    """Batched ensemble solve: integrate a whole batch of initial states
    (e.g. perturbed initial conditions for uncertainty quantification, or a
    restart ensemble) to t >= T in ONE compiled program via `vmap`.

    Batching with no reference analogue (the reference would run N
    separate processes): every stencil, sweep, and reduction gains a
    leading batch dimension and runs as the same fused ops; the nested
    adaptive-dt time loop and SOR convergence loop are batched by JAX's
    while_loop rules — the fused loop runs until every member finishes,
    with finished members' carries held fixed — so per-member stopping
    behavior (and the reference convergence contract) is preserved exactly.

    `states` is a stacked State with a leading batch dim (see
    `stack_states`); returns the batched final State and per-member
    SolveStats.  Single-chip; shard the batch dim with the gspmd backend's
    mesh for multi-chip ensembles.

    The ensemble routes through the jnp formulations (disable_pallas): the
    CUDA SOR kernel has no batching rule, and the batch dimension already
    provides the parallelism the kernel exists to extract.

    Pass `mesh` (a 1D jax.sharding.Mesh whose single axis divides the batch
    size) for the data-parallel multi-chip ensemble: members are sharded
    over the axis and solved with ZERO communication (each member is
    independent; the only collective is none at all — the embarrassingly
    parallel axis the reference has no analogue of, SURVEY.md §2.4)."""
    if pressure_method == "pallas_sor":
        raise ValueError(
            "solve_ensemble cannot batch the CUDA SOR kernel; use rb_sor "
            "(same algorithm, jnp formulation) or mg/cg/fft"
        )
    params = params.replace(disable_pallas=True)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        if len(mesh.axis_names) != 1:
            raise ValueError(
                f"ensemble mesh must be 1D (batch axis); got {mesh.axis_names}"
            )
        axis = mesh.axis_names[0]
        if states.u.shape[0] % mesh.devices.size != 0:
            raise ValueError(
                f"batch size {states.u.shape[0]} must be a multiple of the "
                f"{mesh.devices.size}-device ensemble mesh"
            )
        grid = NamedSharding(mesh, P(axis, None, None))
        vec = NamedSharding(mesh, P(axis))
        states = State(
            u=jax.device_put(states.u, grid),
            v=jax.device_put(states.v, grid),
            p=jax.device_put(states.p, grid),
            t=jax.device_put(states.t, vec),
            n=jax.device_put(states.n, vec),
        )
    return _solve_ensemble(params, states, pressure_method)


def center_values(state: State, params: Params) -> Tuple[float, float]:
    """The reference's reduced observable: cavity-center velocities
    (main.c:148-149 prints u[i_max/2][j_max/2], v[i_max/2][j_max/2])."""
    i_c, j_c = params.i_max // 2, params.j_max // 2
    return float(state.u[i_c, j_c]), float(state.v[i_c, j_c])
