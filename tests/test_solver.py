"""End-to-end solver tests: device path vs the float64 serial oracle, under the
reference's serial-as-oracle pattern and 1e-4 tolerance contract
(colab-runner.ipynb; SURVEY.md §3.3/§4)."""

import numpy as np
import jax.numpy as jnp
import pytest

from navierstokes_parallel_tpu import solve, center_values, allocate_state
from navierstokes_parallel_tpu.config import Params
from navierstokes_parallel_tpu.solver import make_step_fn
from navierstokes_parallel_tpu import oracle

from conftest import assert_close_reference_contract


def test_single_step_matches_oracle(small_params):
    prm = small_params
    # One oracle step.
    shape = (prm.i_max + 2, prm.j_max + 2)
    uo = np.zeros(shape)
    vo = np.zeros(shape)
    po = np.zeros(shape)
    dt_o, iters_o = oracle.oracle_step(uo, vo, po, 0.0, prm)

    # One jnp step.
    step_fn = make_step_fn(prm)
    state, diag = step_fn(allocate_state(prm))

    np.testing.assert_allclose(float(diag.dt), dt_o, rtol=1e-12)
    # Velocities agree within solver-tolerance-level differences (red-black
    # vs lexicographic SOR orderings).
    assert_close_reference_contract(np.asarray(state.u), uo, tol=1e-4)
    assert_close_reference_contract(np.asarray(state.v), vo, tol=1e-4)


def test_multi_step_matches_oracle(small_params):
    prm = small_params
    res_o = oracle.oracle_solve(prm)

    state, stats = solve(prm)
    assert int(stats.steps) == res_o.steps
    assert_close_reference_contract(np.asarray(state.u), res_o.u, tol=1e-4)
    assert_close_reference_contract(np.asarray(state.v), res_o.v, tol=1e-4)
    np.testing.assert_allclose(float(state.t), res_o.t, rtol=1e-10)


def test_center_values(small_params):
    prm = small_params
    state, _ = solve(prm)
    uc, vc = center_values(state, prm)
    res_o = oracle.oracle_solve(prm)
    i_c, j_c = prm.i_max // 2, prm.j_max // 2
    np.testing.assert_allclose(uc, res_o.u[i_c, j_c], atol=1e-4)
    np.testing.assert_allclose(vc, res_o.v[i_c, j_c], atol=1e-4)


def test_oscillating_lid_problem():
    prm = Params(problem=2, f=10.0, i_max=16, j_max=16, T=0.05, Re=100.0,
                 tau=0.5, epsilon=1e-4, max_it=500, dtype="float64")
    res_o = oracle.oracle_solve(prm)
    state, stats = solve(prm)
    assert int(stats.steps) == res_o.steps
    assert_close_reference_contract(np.asarray(state.u), res_o.u, tol=1e-4)
    assert_close_reference_contract(np.asarray(state.v), res_o.v, tol=1e-4)


def test_float32_close_to_float64(small_params):
    """The default float32 dtype must stay within the tolerance contract of the
    float64 path on short runs (SURVEY.md §7 'hard parts': f32 plan)."""
    prm64 = small_params
    prm32 = prm64.replace(dtype="float32")
    s64, _ = solve(prm64)
    s32, _ = solve(prm32)
    assert_close_reference_contract(
        np.asarray(s32.u, dtype=np.float64), np.asarray(s64.u), tol=1e-4
    )


def test_rectangular_grid():
    """Non-square grids (a != b, i_max != j_max) integrate and stay finite."""
    prm = Params(i_max=24, j_max=12, a=2.0, b=1.0, T=0.02, Re=100.0,
                 tau=0.5, epsilon=1e-4, max_it=500, dtype="float64")
    res_o = oracle.oracle_solve(prm)
    state, stats = solve(prm)
    assert int(stats.steps) == res_o.steps
    assert_close_reference_contract(np.asarray(state.u), res_o.u, tol=1e-4)
    assert np.all(np.isfinite(np.asarray(state.p)))


def test_gravity_body_force():
    prm = Params(i_max=12, j_max=12, T=0.01, Re=100.0, g_x=0.5, g_y=-1.0,
                 tau=0.5, epsilon=1e-4, max_it=500, dtype="float64")
    res_o = oracle.oracle_solve(prm)
    state, _ = solve(prm)
    assert_close_reference_contract(np.asarray(state.u), res_o.u, tol=1e-4)
    assert_close_reference_contract(np.asarray(state.v), res_o.v, tol=1e-4)


def test_segmented_solve_matches_monolithic(small_params):
    from navierstokes_parallel_tpu.solver import solve_segmented

    prm = small_params
    s1, st1 = solve(prm)
    s2, st2 = solve_segmented(prm, steps_per_dispatch=2)
    assert int(st2.steps) == int(st1.steps)
    assert int(st2.total_sor_iterations) == int(st1.total_sor_iterations)
    np.testing.assert_allclose(np.asarray(s2.u), np.asarray(s1.u), atol=1e-14)
    np.testing.assert_allclose(np.asarray(s2.p), np.asarray(s1.p), atol=1e-12)


def test_projection_enforces_incompressibility(small_params):
    """After each step, div(u, v) must be near zero — bounded by the SOR
    tolerance times 1/dt (the projection's entire purpose)."""
    from navierstokes_parallel_tpu.utils.checks import divergence_norm

    prm = small_params
    state, stats = solve(prm)
    div = divergence_norm(state.u, state.v, prm)
    # SOR residual <= eps*(||p||+1.5); divergence of the projected field is
    # dt * residual-of-the-Poisson-solve in this scheme.
    assert div < 10 * prm.epsilon * 2.0, f"divergence {div} too large"

    # mg path enforces it at least as well
    state2, _ = solve(prm.replace(dtype="float32"), pressure_method="mg")
    div2 = divergence_norm(state2.u, state2.v, prm)
    assert div2 < 10 * prm.epsilon * 2.0


def test_solve_stepwise_matches_solve(small_params):
    """Per-step host dispatches (the fragile-platform route bench.py uses
    at 4096^2) must be numerically identical to the on-device while_loop."""
    from navierstokes_parallel_tpu.solver import solve, solve_stepwise

    want, wstats = solve(small_params)
    got, gstats = solve_stepwise(small_params)
    np.testing.assert_allclose(np.asarray(got.u), np.asarray(want.u),
                               rtol=0, atol=0)
    np.testing.assert_allclose(np.asarray(got.p), np.asarray(want.p),
                               rtol=0, atol=0)
    assert int(gstats.steps) == int(wstats.steps)
    assert int(gstats.total_sor_iterations) == int(wstats.total_sor_iterations)
