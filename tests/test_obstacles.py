"""Flag-field obstacle domains: masked solvers, BC masks, models/step.py.

The load-bearing validation is DOMAIN EQUIVALENCE: a cavity whose bottom
half is one big obstacle must reproduce the (independently validated)
half-height cavity — same BC semantics, same operator, same stopping
contract — through the entirely different masked code path.  Measured
agreement is ~1e-11 in f64; the tests assert 1e-9.
"""

import numpy as np
import pytest

from navierstokes_parallel_tpu.config import Params
from navierstokes_parallel_tpu import solver
from navierstokes_parallel_tpu.models import step as step_model
from navierstokes_parallel_tpu.ops import obstacles as obs


_COMMON = dict(Re=100.0, T=0.1, tau=0.5, omega=1.7, epsilon=1e-8,
               max_it=20000, dtype="float64")


def _blocked_and_half(n=32):
    full = Params(problem=1, i_max=n, j_max=n, a=1.0, b=1.0,
                  obstacles=((1, n, 1, n // 2),), **_COMMON)
    half = Params(problem=1, i_max=n, j_max=n // 2, a=1.0, b=0.5, **_COMMON)
    return full, half


@pytest.mark.parametrize("method", ["rb_sor", "mg"])
def test_half_blocked_cavity_equals_half_cavity(method):
    n = 32
    full, half = _blocked_and_half(n)
    stf, sf = solver.solve(full, pressure_method=method)
    sth, sh = solver.solve(half, pressure_method="rb_sor")
    assert int(sf.sor_failures) == 0 and int(sh.sor_failures) == 0
    assert int(sf.steps) == int(sh.steps)
    # fluid region j = n//2+1..n of the full grid == j = 1..n//2 of the half
    uf = np.asarray(stf.u)[:, n // 2 + 1 : n + 1]
    uh = np.asarray(sth.u)[:, 1 : n // 2 + 1]
    vf = np.asarray(stf.v)[:, n // 2 + 1 : n + 1]
    vh = np.asarray(sth.v)[:, 1 : n // 2 + 1]
    np.testing.assert_allclose(uf, uh, atol=1e-9)
    np.testing.assert_allclose(vf, vh, atol=1e-9)


def test_masked_mg_converges_fast():
    """The masked V(2,2) must keep multigrid iteration counts (O(5)/solve),
    not degenerate into smoothing."""
    full, _ = _blocked_and_half(32)
    _, s_mg = solver.solve(full, pressure_method="mg")
    _, s_rb = solver.solve(full, pressure_method="rb_sor")
    assert int(s_mg.sor_failures) == 0
    assert int(s_mg.total_sor_iterations) * 20 < int(
        s_rb.total_sor_iterations)


def _bfs(Re=100.0, T=8.0):
    return step_model.backward_facing_step(Re=Re, nx=64, ny=16, T=T,
                                           dtype="float32")


def test_backward_facing_step_physics():
    prm = _bfs()
    st, stats = solver.solve(prm, pressure_method="mg")
    assert int(stats.sor_failures) == 0
    u = np.asarray(st.u, np.float64)

    # Inflow: parabola over the open upper half, zero on the step face.
    prof = np.asarray(u[0, 1:-1])
    assert np.all(prof[: prm.j_max // 2] == 0.0)
    assert prof[prm.j_max // 2 :].max() == pytest.approx(1.0, abs=0.05)

    # Incompressibility: the fluid-edge flux through EVERY cross-section
    # equals the inflow flux to solver tolerance.
    fl = obs.fluid_mask(prm)
    carry = np.zeros_like(u, bool)
    carry[1:-2, 1:-1] = fl[1:-2, 1:-1] & fl[2:-1, 1:-1]
    carry[0, 1:-1] = True
    carry[-2, 1:-1] = fl[-2, 1:-1]
    flux = np.where(carry, u, 0.0)[:-1, 1:-1].sum(axis=1) * prm.dy
    np.testing.assert_allclose(flux, flux[0], rtol=1e-4)

    # Recirculation bubble: backflow right after the step, reattachment
    # strictly before the outflow.
    xr = step_model.reattachment_length(st.u, prm)
    i_step = prm.obstacles[0][1]
    assert 0.5 < xr < (prm.i_max - i_step) * prm.dx / (0.5 * prm.b)
    assert np.any(u[i_step + 2 : i_step + 8, 1] < 0.0)


def test_reattachment_grows_with_re():
    x = {}
    for Re in (50.0, 150.0):
        st, stats = solver.solve(_bfs(Re=Re, T=10.0), pressure_method="mg")
        assert int(stats.sor_failures) == 0
        x[Re] = step_model.reattachment_length(st.u, _bfs(Re=Re))
    assert x[150.0] > x[50.0] * 1.3


def test_geometry_validation():
    ok = dict(problem=1, i_max=16, j_max=16)
    with pytest.raises(ValueError, match="outside the interior"):
        Params(obstacles=((0, 4, 1, 4),), **ok)
    with pytest.raises(ValueError, match="1 cell thin"):
        Params(obstacles=((8, 8, 1, 16),), **ok).shape and obs.masks(
            Params(obstacles=((8, 8, 1, 16),), **ok))
    with pytest.raises(ValueError, match="fully enclosed"):
        # a 5x5 solid block with a one-cell hole at its center
        obs.masks(Params(obstacles=((4, 8, 4, 5), (4, 8, 7, 8),
                                    (4, 5, 6, 6), (7, 8, 6, 6)), **ok))
    with pytest.raises(ValueError, match="disconnected"):
        obs.masks(Params(obstacles=((8, 9, 1, 16),), **ok))
    with pytest.raises(ValueError, match="must be"):
        Params(obstacles=((1, 2, 3),), **ok)


def test_method_and_backend_gating():
    from navierstokes_parallel_tpu.ops import sor
    from navierstokes_parallel_tpu.parallel import sharded
    from navierstokes_parallel_tpu.parallel.topology import make_grid_mesh
    import jax.numpy as jnp

    prm = Params(problem=1, i_max=16, j_max=16,
                 obstacles=((4, 8, 4, 8),), dtype="float32")
    z = jnp.zeros(prm.shape, jnp.float32)
    for bad in ("fft", "cg", "pallas_sor"):
        with pytest.raises(ValueError, match="obstacle|does not support"):
            sor.solve_pressure(z, z, prm, method=bad)
    assert sor.default_method(prm) == "rb_sor"
    # Round 4: the shard_map backend RUNS obstacle domains via the masked
    # deep-halo rb_sor inner (tests/test_sharded_obstacles.py); only the
    # unmasked operators still reject.
    mesh = make_grid_mesh(8, prm.i_max, prm.j_max)
    for bad in ("mg", "fft", "cg"):
        with pytest.raises(ValueError, match="masked deep-halo"):
            sharded._check_method(prm, mesh, bad)
    with pytest.raises(ValueError, match="oracle"):
        from navierstokes_parallel_tpu import oracle
        oracle.oracle_solve(prm.replace(dtype="float64"))


def test_gspmd_runs_obstacles():
    from navierstokes_parallel_tpu.parallel import gspmd
    from navierstokes_parallel_tpu.parallel.topology import make_grid_mesh

    prm = Params(problem=1, i_max=16, j_max=16, T=0.05, Re=100.0,
                 epsilon=1e-4, max_it=2000, dtype="float32",
                 obstacles=((4, 8, 4, 8),))
    mesh = make_grid_mesh(8, prm.i_max, prm.j_max)
    g_state, g_stats = gspmd.solve_gspmd(prm, mesh=mesh)
    s_state, s_stats = solver.solve(prm.replace(disable_pallas=True))
    assert int(g_stats.steps) == int(s_stats.steps)
    np.testing.assert_allclose(np.asarray(g_state.u),
                               np.asarray(s_state.u), atol=1e-5)
