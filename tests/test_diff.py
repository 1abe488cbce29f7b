"""Differentiable-path tests: adjoint (IFT) pressure solve + remat scan.

Every gradient is validated against central finite differences of the
SAME float64 forward computation — the strictest check available for an
adjoint implementation (reference has no analogue; diff.py is a
beyond-reference capability).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from navierstokes_parallel_tpu.config import Params
from navierstokes_parallel_tpu.grid import allocate_state
from navierstokes_parallel_tpu import diff


def _params(**kw):
    defaults = dict(problem=1, i_max=16, j_max=16, a=1.0, b=1.0, T=1.0,
                    Re=100.0, tau=0.5, omega=1.7, epsilon=1e-9,
                    max_it=20000, dtype="float64")
    defaults.update(kw)
    return Params(**defaults)


def _loss_fn(params, n_steps=3, method="mg"):
    """Scalar kinetic-energy-style loss after n differentiable steps, as a
    function of (initial state, controls)."""

    def loss(state, controls):
        final, _ = diff.solve_n_steps(params, state, n_steps,
                                      controls=controls,
                                      pressure_method=method)
        return jnp.sum(final.u[1:-1, 1:-1] ** 2) + \
            jnp.sum(final.v[1:-1, 1:-1] ** 2)

    return loss


def test_grad_matches_fd_lid_scale_and_gx():
    """d(loss)/d(lid_scale) vs central differences; d(loss)/d(g_x) must be
    ~zero on the enclosed cavity (a uniform body force is absorbed
    hydrostatically by the Neumann pressure — the velocity barely feels
    it, so FD cannot resolve it; the channel test below validates g_x
    where it has O(1) effect)."""
    params = _params()
    state = allocate_state(params)
    loss = _loss_fn(params)

    def f(ls, gx):
        c = diff.default_controls(params)._replace(
            lid_scale=jnp.asarray(ls, jnp.float64),
            g_x=jnp.asarray(gx, jnp.float64))
        return loss(state, c)

    g_ls, g_gx = jax.grad(f, argnums=(0, 1))(1.0, 0.0)
    h = 1e-5
    fd_ls = (float(f(1.0 + h, 0.0)) - float(f(1.0 - h, 0.0))) / (2 * h)
    assert float(g_ls) == pytest.approx(fd_ls, rel=1e-5)
    # The lid drives the flow: the gradient must be decidedly nonzero.
    assert abs(float(g_ls)) > 1e-6
    assert abs(float(g_gx)) < 1e-6


def test_grad_matches_fd_initial_state():
    """Directional derivative w.r.t. the initial velocity field vs FD.

    The base state is symmetry-BROKEN first: the from-rest cavity is
    exactly mirror-symmetric, which parks entire grid lines on the
    donor-cell |u| kinks (u = 0 on the centerline) where AD returns the
    sign(0) = 0 subgradient while central FD straddles the kink — a
    measure-zero manifold, documented in diff.py.  At any generic state
    the gradient is exact."""
    params = _params()
    base = allocate_state(params)
    rng = np.random.default_rng(42)
    bump = np.zeros(params.shape)
    bump[1:-1, 1:-1] = 0.05 * rng.standard_normal((params.i_max,
                                                   params.j_max))
    state = base._replace(u=base.u + jnp.asarray(bump))
    loss = _loss_fn(params)
    controls = diff.default_controls(params)

    rng = np.random.default_rng(7)
    direction = np.zeros(params.shape)
    direction[1:-1, 1:-1] = rng.standard_normal((params.i_max,
                                                 params.j_max))
    d = jnp.asarray(direction)

    def f_along(eps):
        s = state._replace(u=state.u + eps * d)
        return loss(s, controls)

    g_u = jax.grad(
        lambda u0: loss(state._replace(u=u0), controls))(state.u)
    directional = float(jnp.sum(g_u * d))
    h = 1e-6
    fd = (float(f_along(h)) - float(f_along(-h))) / (2 * h)
    assert directional == pytest.approx(fd, rel=1e-4)


def test_grad_channel_initial_state():
    """The adjoint path covers problem 3 (deflated Neumann solve in both
    directions): directional derivative w.r.t. the initial state on the
    channel vs FD.  (A uniform g_x is NOT a usable probe here: with the
    flux-balanced in/outflow BCs pinning the throughput, the pressure
    absorbs it hydrostatically — measured df/dg_x ~ 1e-10.)"""
    from navierstokes_parallel_tpu.models import channel

    params = channel.plane_channel(Re=10.0, nx=16, ny=8, T=1.0,
                                   dtype="float64", epsilon=1e-9)
    state = channel.developed_state(params)
    # Break the v = 0 kink manifold (|v| donor-cell subgradients at the
    # exact fixed point — see diff.py docstring / the cavity test).
    rng = np.random.default_rng(5)
    bump = np.zeros(params.shape)
    bump[1:-1, 1:-1] = 0.02 * rng.standard_normal((params.i_max,
                                                   params.j_max))
    state = state._replace(v=state.v + jnp.asarray(bump))
    loss = _loss_fn(params, n_steps=2)
    controls = diff.default_controls(params)

    direction = np.zeros(params.shape)
    direction[1:-1, 1:-1] = rng.standard_normal((params.i_max,
                                                 params.j_max))
    d = jnp.asarray(direction)
    g_u = jax.grad(
        lambda u0: loss(state._replace(u=u0), controls))(state.u)
    directional = float(jnp.sum(g_u * d))
    h = 1e-6
    fd = (float(loss(state._replace(u=state.u + h * d), controls))
          - float(loss(state._replace(u=state.u - h * d), controls))) \
        / (2 * h)
    assert directional == pytest.approx(fd, rel=1e-4)
    assert abs(directional) > 1e-3


def test_remat_matches_no_remat():
    """jax.checkpoint changes memory, not values: gradients identical."""
    params = _params()
    state = allocate_state(params)

    def grad_of(remat):
        def f(ls):
            c = diff.default_controls(params)._replace(
                lid_scale=jnp.asarray(ls, jnp.float64))
            final, _ = diff.solve_n_steps(params, state, 2, controls=c,
                                          remat=remat)
            return jnp.sum(final.u[1:-1, 1:-1] ** 2)

        return float(jax.grad(f)(1.0))

    assert grad_of(True) == pytest.approx(grad_of(False), rel=1e-12)


def test_diff_step_matches_solver_step():
    """The differentiable forward IS the production step (same math, jnp
    formulation): one step must match solver.step to solver tolerance."""
    from navierstokes_parallel_tpu import solver

    params = _params()
    state = allocate_state(params)
    ref_state, _ = solver.step(state, params, pressure_method="mg")
    d_state, dt = diff.diff_step(state, params, pressure_method="mg")
    np.testing.assert_allclose(np.asarray(d_state.u), np.asarray(ref_state.u),
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(d_state.v), np.asarray(ref_state.v),
                               atol=1e-10)
    assert float(d_state.t) == pytest.approx(float(ref_state.t), rel=1e-12)


def test_grad_obstacle_initial_state():
    """Obstacle-domain adjoint (masked neighbor-weight operator,
    _ift_bwd_masked): directional derivative w.r.t. the initial state on
    a small backward-facing step vs FD."""
    from navierstokes_parallel_tpu.models import step as bfs

    params = bfs.backward_facing_step(Re=50.0, nx=16, ny=8, T=1.0,
                                      dtype="float64", epsilon=1e-9)
    state = allocate_state(params)
    rng = np.random.default_rng(11)
    bump = np.zeros(params.shape)
    bump[1:-1, 1:-1] = 0.02 * rng.standard_normal((params.i_max,
                                                   params.j_max))
    state = state._replace(u=state.u + jnp.asarray(bump),
                           v=state.v + jnp.asarray(bump))
    loss = _loss_fn(params, n_steps=2)
    controls = diff.default_controls(params)

    direction = np.zeros(params.shape)
    direction[1:-1, 1:-1] = rng.standard_normal((params.i_max,
                                                 params.j_max))
    d = jnp.asarray(direction)
    g_u = jax.grad(
        lambda u0: loss(state._replace(u=u0), controls))(state.u)
    directional = float(jnp.sum(g_u * d))
    h = 1e-6
    fd = (float(loss(state._replace(u=state.u + h * d), controls))
          - float(loss(state._replace(u=state.u - h * d), controls))) \
        / (2 * h)
    assert directional == pytest.approx(fd, rel=1e-4)
    assert abs(directional) > 1e-4


def test_grad_thermal_wall_temperature():
    """Differentiable Boussinesq path: d(loss)/d(t_left) through coupled
    energy + momentum + adjoint pressure solves vs FD (the hot-wall
    temperature drives the whole flow — real O(1) sensitivity)."""
    from navierstokes_parallel_tpu import diff
    from navierstokes_parallel_tpu.models import convection as cv

    params, cfg = cv.convection_setup(1e4, n=12, dtype="float64",
                                      epsilon=1e-9)
    ts = cv.allocate_thermal(params, cfg)
    # Break |u|/|v| kink manifolds (from-rest state) — see diff.py.
    rng = np.random.default_rng(3)
    bump_u = np.zeros(params.shape)
    bump_u[1:-1, 1:-1] = 0.02 * rng.standard_normal((params.i_max,
                                                     params.j_max))
    bump_v = np.zeros(params.shape)
    bump_v[1:-1, 1:-1] = 0.02 * rng.standard_normal((params.i_max,
                                                     params.j_max))
    ts = ts._replace(u=ts.u + jnp.asarray(bump_u),
                     v=ts.v + jnp.asarray(bump_v))

    def f(t_left):
        c = cfg._replace(t_left=t_left)
        final, _ = diff.solve_thermal_n_steps(params, ts, 3, c)
        return jnp.sum(final.u[1:-1, 1:-1] ** 2) + \
            jnp.sum(final.T[1:-1, 1:-1] ** 2)

    g = float(jax.grad(f)(0.5))
    h = 1e-5
    fd = (float(f(0.5 + h)) - float(f(0.5 - h))) / (2 * h)
    assert g == pytest.approx(fd, rel=1e-4)
    assert abs(g) > 1e-3


def test_grad_thermal_buoyancy_coefficient():
    """d(loss)/d(beta_gy) — the coupling strength — vs FD."""
    from navierstokes_parallel_tpu import diff
    from navierstokes_parallel_tpu.models import convection as cv

    params, cfg = cv.convection_setup(1e4, n=12, dtype="float64",
                                      epsilon=1e-9)
    ts = cv.allocate_thermal(params, cfg)
    rng = np.random.default_rng(9)
    bump = np.zeros(params.shape)
    bump[1:-1, 1:-1] = 0.02 * rng.standard_normal((params.i_max,
                                                   params.j_max))
    ts = ts._replace(u=ts.u + jnp.asarray(bump),
                     v=ts.v + jnp.asarray(bump))

    def f(bgy):
        c = cfg._replace(beta_gy=bgy)
        final, _ = diff.solve_thermal_n_steps(params, ts, 3, c)
        return jnp.sum(final.v[1:-1, 1:-1] ** 2)

    g = float(jax.grad(f)(-1.0))
    h = 1e-5
    fd = (float(f(-1.0 + h)) - float(f(-1.0 - h))) / (2 * h)
    assert g == pytest.approx(fd, rel=1e-4)
    assert abs(g) > 1e-4


@pytest.mark.parametrize("variant", ["devahl", "rb", "rb_freeslip",
                                     "mixed", "heated_block"])
def test_grad_thermal_all_config_variants(variant):
    """Every public ThermalConfig family member must be differentiable
    end to end (round-3 regression: string dispatch fields leaked into
    the traced pytree and crashed jax.checkpoint; the diff step also
    silently ignored heating/sidewalls/lid_u — ADVICE r3).  Checks the
    gradient is finite AND matches central FD of the same forward."""
    from navierstokes_parallel_tpu.models import convection as cv

    if variant == "devahl":
        params, cfg = cv.convection_setup(1e4, n=10, dtype="float64",
                                          epsilon=1e-9)
    elif variant == "rb":
        params, cfg = cv.rayleigh_benard_setup(5e3, n=10, dtype="float64",
                                               epsilon=1e-9)
    elif variant == "rb_freeslip":
        params, cfg = cv.rayleigh_benard_setup(5e3, n=10,
                                               sidewalls="freeslip",
                                               dtype="float64",
                                               epsilon=1e-9)
    elif variant == "mixed":
        params, cfg = cv.mixed_convection_setup(100.0, 1e4, n=10,
                                                dtype="float64",
                                                epsilon=1e-9)
    else:
        params, cfg = cv.heated_block_setup(1e4, n=10, block_frac=0.3,
                                            dtype="float64", epsilon=1e-9)

    ts = cv.allocate_thermal(params, cfg)
    rng = np.random.default_rng(17)
    bump_u = np.zeros(params.shape)
    bump_u[1:-1, 1:-1] = 0.02 * rng.standard_normal((params.i_max,
                                                     params.j_max))
    bump_v = np.zeros(params.shape)
    bump_v[1:-1, 1:-1] = 0.02 * rng.standard_normal((params.i_max,
                                                     params.j_max))
    ts = ts._replace(u=ts.u + jnp.asarray(bump_u),
                     v=ts.v + jnp.asarray(bump_v))

    def f(t_hot):
        c = cfg._replace(t_left=t_hot)
        final, _ = diff.solve_thermal_n_steps(params, ts, 2, c)
        return (jnp.sum(final.u[1:-1, 1:-1] ** 2)
                + jnp.sum(final.T[1:-1, 1:-1] ** 2))

    x0 = float(cfg.t_left)
    g = float(jax.grad(f)(x0))
    assert np.isfinite(g)
    h = 1e-5
    fd = (float(f(x0 + h)) - float(f(x0 - h))) / (2 * h)
    assert g == pytest.approx(fd, rel=1e-4)


def test_diff_thermal_step_matches_primal_forward():
    """The forward values of diff_thermal_step must track the primal
    thermal_step on the dispatch-heavy variants (mixed convection with a
    moving lid + a heated obstacle block) — guards the ADVICE-r3 silent
    wrong-physics bug where the diff step hardcoded side heating and a
    zero lid."""
    from navierstokes_parallel_tpu.models import convection as cv

    for setup in (
        lambda: cv.mixed_convection_setup(100.0, 1e4, n=10,
                                          dtype="float64", epsilon=1e-10),
        lambda: cv.heated_block_setup(1e4, n=10, block_frac=0.3,
                                      dtype="float64", epsilon=1e-10),
        lambda: cv.rayleigh_benard_setup(5e3, n=10, sidewalls="freeslip",
                                         dtype="float64", epsilon=1e-10),
    ):
        params, cfg = setup()
        ts = cv.allocate_thermal(params, cfg)
        ts = cv.seed_rb_perturbation(ts, params, cfg, amp=0.01)
        a, b = ts, ts
        for _ in range(3):
            a, _ = cv.thermal_step(a, params, cfg, pressure_method="mg")
            b, _ = diff.diff_thermal_step(b, params, cfg,
                                          pressure_method="mg")
        # Identical math up to the two CFL formulations' AD-safe floor
        # (exact at any nonzero velocity) and solver tolerance.
        np.testing.assert_allclose(np.asarray(a.T), np.asarray(b.T),
                                   atol=1e-8)
        np.testing.assert_allclose(np.asarray(a.u), np.asarray(b.u),
                                   atol=1e-8)
