"""Batched ensemble solving (solver.py::solve_ensemble): a vmapped batch of
initial states must reproduce each member's individual solve exactly —
including per-member adaptive dt trajectories, step counts, and SOR
iteration counts (JAX's batched while_loop holds finished members fixed)."""

import jax.numpy as jnp
import numpy as np
import pytest

from navierstokes_parallel_tpu.config import Params
from navierstokes_parallel_tpu.grid import State, allocate_state
from navierstokes_parallel_tpu.solver import solve, solve_ensemble, stack_states

from conftest import assert_close_reference_contract


@pytest.fixture
def params():
    return Params(problem=1, i_max=16, j_max=16, T=0.05, Re=100.0, tau=0.5,
                  omega=1.7, epsilon=1e-4, max_it=500, dtype="float64")


def _members(params, n=3):
    """Distinctly perturbed initial velocity fields (UQ-style ensemble)."""
    rng = np.random.default_rng(5)
    members = []
    for k in range(n):
        s = allocate_state(params)
        du = np.zeros(params.shape)
        du[1:-1, 1:-1] = 0.01 * k * rng.standard_normal(
            (params.i_max, params.j_max))
        members.append(s._replace(u=s.u + jnp.asarray(du, s.u.dtype)))
    return members


def test_ensemble_matches_individual_solves(params):
    members = _members(params, 3)
    batched_out, batched_stats = solve_ensemble(params, stack_states(members))
    assert batched_out.u.shape[0] == 3

    for k, member in enumerate(members):
        single_out, single_stats = solve(params, member)
        # Per-member trajectory metadata must match exactly: different
        # perturbations take different dt sequences and step counts.
        assert int(batched_stats.steps[k]) == int(single_stats.steps)
        assert int(batched_stats.total_sor_iterations[k]) == int(
            single_stats.total_sor_iterations)
        np.testing.assert_allclose(float(batched_out.t[k]),
                                   float(single_out.t), rtol=1e-12)
        for name in ("u", "v", "p"):
            assert_close_reference_contract(
                np.asarray(getattr(single_out, name)),
                np.asarray(getattr(batched_out, name))[k],
            )


def test_ensemble_members_actually_differ(params):
    """Guard against the batch collapsing to one member (a broadcasting bug
    would make this silently pass the parity test above for member 0)."""
    members = _members(params, 3)
    out, _ = solve_ensemble(params, stack_states(members))
    u = np.asarray(out.u)
    assert np.abs(u[0] - u[1]).max() > 1e-6
    assert np.abs(u[1] - u[2]).max() > 1e-6


def test_ensemble_rejects_pallas_method(params):
    members = _members(params, 2)
    with pytest.raises(ValueError, match="cannot batch the CUDA SOR kernel"):
        solve_ensemble(params, stack_states(members),
                       pressure_method="pallas_sor")


def test_ensemble_mg(params):
    """A second method family through the batched path (the vmapped
    V-cycle: reduce_window restriction + matmul prolongation batch too)."""
    members = _members(params.replace(dtype="float32"), 2)
    out, stats = solve_ensemble(params.replace(dtype="float32"),
                                stack_states(members), pressure_method="mg")
    assert int(stats.sor_failures[0]) == 0
    assert np.isfinite(np.asarray(out.u)).all()


def test_ensemble_fft(params):
    """The spectral direct solve batches too (vmapped transform + divide);
    each member must match its own solo fft solve exactly."""
    from navierstokes_parallel_tpu.solver import solve

    prm = params.replace(dtype="float32")
    members = _members(prm, 2)
    out, stats = solve_ensemble(prm, stack_states(members),
                                pressure_method="fft")
    assert int(stats.sor_failures[0]) == 0
    solo, _ = solve(prm.replace(disable_pallas=True), members[0],
                    pressure_method="fft")
    np.testing.assert_allclose(np.asarray(out.u[0]), np.asarray(solo.u),
                               atol=1e-6)


def test_ensemble_data_parallel_mesh(params):
    """Data-parallel ensemble: 8 members sharded over the 8-device mesh,
    results identical to the unsharded batch and per-member stats intact."""
    import jax
    from jax.sharding import Mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    mesh = Mesh(np.array(jax.devices()[:8]), ("b",))
    members = _members(params, 8)
    ref_out, ref_stats = solve_ensemble(params, stack_states(members))
    dp_out, dp_stats = solve_ensemble(params, stack_states(members),
                                      mesh=mesh)
    assert len(dp_out.u.sharding.device_set) == 8
    np.testing.assert_array_equal(np.asarray(dp_stats.steps),
                                  np.asarray(ref_stats.steps))
    for name in ("u", "v", "p"):
        np.testing.assert_allclose(
            np.asarray(getattr(dp_out, name)),
            np.asarray(getattr(ref_out, name)), atol=1e-12)


def test_ensemble_mesh_validation(params):
    import jax
    from jax.sharding import Mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    members = _members(params, 3)  # 3 does not divide 8
    mesh = Mesh(np.array(jax.devices()[:8]), ("b",))
    with pytest.raises(ValueError, match="must be a multiple"):
        solve_ensemble(params, stack_states(members), mesh=mesh)
