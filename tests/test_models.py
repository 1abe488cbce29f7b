"""Model-family and Ghia-validation-machinery tests."""

import numpy as np
import pytest

from navierstokes_parallel_tpu.models import cavity
from navierstokes_parallel_tpu.config import Params


def test_factories():
    p = cavity.lid_driven_cavity(Re=400.0, n=64, T=2.0)
    assert p.problem == 1 and p.Re == 400.0 and p.i_max == 64
    q = cavity.oscillating_lid(f=5.0, n=32)
    assert q.problem == 2 and q.f == 5.0


def test_ghia_tables_shape():
    for Re in (100, 400, 1000, 10000):
        assert cavity.GHIA_U[Re].shape == cavity.GHIA_Y.shape
        assert cavity.GHIA_V[Re].shape == cavity.GHIA_X.shape
        # lid-driven endpoints: u=1 at the lid, 0 at the floor; v=0 at walls
        assert cavity.GHIA_U[Re][0] == 1.0 and cavity.GHIA_U[Re][-1] == 0.0
        assert cavity.GHIA_V[Re][0] == 0.0 and cavity.GHIA_V[Re][-1] == 0.0


def test_centerline_extraction():
    prm = Params(i_max=8, j_max=8)
    shape = prm.shape
    u = np.zeros(shape)
    v = np.zeros(shape)
    # u varies only with y: u = y at sample points y=(j-0.5)*dy
    dy = prm.dy
    for j in range(shape[1]):
        u[:, j] = (j - 0.5) * dy
    y, u_prof, x, v_prof = cavity.centerline_profiles(u, v, prm)
    np.testing.assert_allclose(u_prof, y, rtol=1e-12)
    assert y[0] == pytest.approx(0.5 * dy)
    assert y[-1] == pytest.approx(1.0 - 0.5 * dy)


def test_ghia_errors_selfconsistent():
    """Profiles synthesized by interpolating the Ghia table itself must
    score ~zero error."""
    prm = Params(i_max=512, j_max=512)
    shape = prm.shape
    u = np.zeros(shape)
    v = np.zeros(shape)
    dy, dx = prm.dy, prm.dx
    ys = (np.arange(shape[1]) - 0.5) * dy
    # np.interp needs ascending x: Ghia tables are descending
    u_interp = np.interp(ys, cavity.GHIA_Y[::-1], cavity.GHIA_U[100][::-1])
    for j in range(shape[1]):
        u[:, j] = u_interp[j]
    xs = (np.arange(shape[0]) - 0.5) * dx
    v_interp = np.interp(xs, cavity.GHIA_X[::-1], cavity.GHIA_V[100][::-1])
    for i in range(shape[0]):
        v[i, :] = v_interp[i]
    errs = cavity.ghia_errors(u, v, prm, 100)
    # Double piecewise-linear interpolation on the nonuniform table leaves
    # O(h * slope-change) error; at 512^2 any indexing/orientation bug would
    # show up as O(0.1).
    assert errs.max_u_err < 2e-3
    assert errs.max_v_err < 2e-3


def test_ghia_errors_unknown_re():
    prm = Params(i_max=8, j_max=8)
    with pytest.raises(ValueError):
        cavity.ghia_errors(np.zeros(prm.shape), np.zeros(prm.shape), prm, 777)


# ---------------------------------------------------------------------------
# Plane channel (problem 3, beyond-reference model family)
# ---------------------------------------------------------------------------


def _channel(ny, **kw):
    from navierstokes_parallel_tpu.models import channel

    defaults = dict(Re=10.0, nx=2 * ny, ny=ny, a=2.0, b=1.0, T=0.5,
                    dtype="float32")
    defaults.update(kw)
    return channel.plane_channel(**defaults)


def test_channel_factory_and_config():
    from navierstokes_parallel_tpu.models import channel

    p = _channel(8)
    assert p.problem == 3 and p.a == 2.0
    # analytic profile peaks at the center, vanishes into the walls
    prof = channel.analytic_u(p)
    assert prof.max() == pytest.approx(4 * (0.5 - p.dy / 2) * (0.5 + p.dy / 2))
    assert np.all(prof > 0)
    with pytest.raises(ValueError, match="problem type"):
        Params(problem=7, i_max=8, j_max=8)  # 6 = free surface is valid now


def test_channel_steady_state_grid_convergence():
    """Integrating FROM the analytic fixed point must stay on the discrete
    steady state, whose distance to the parabola is the O(dy^2) ghost-cell
    wall closure — assert the error halves-ish per refinement (measured
    9.9e-3 / 3.2e-3 / 8.8e-4 at ny=8/16/32) and every solve converges."""
    from navierstokes_parallel_tpu import solver
    from navierstokes_parallel_tpu.models import channel

    errs = {}
    for ny in (8, 16):
        prm = _channel(ny)
        st, stats = solver.solve(prm, channel.developed_state(prm))
        assert int(stats.sor_failures) == 0
        err_out, err_mid = channel.profile_errors(st.u, prm)
        errs[ny] = err_mid
        # v stays near zero (pure shear flow)
        assert float(np.max(np.abs(np.asarray(st.v)))) < 5e-3 * (8 / ny)
    assert errs[8] < 2e-2
    assert errs[16] < errs[8] / 2.5  # ~2nd order (measured ratio 3.1)


def test_channel_methods_agree_and_from_rest_develops():
    """mg and fft reach the same steady state as rb_sor, and the from-rest
    transient (exercising the outflow mass-balance path) lands on the same
    state as starting from the analytic profile."""
    from navierstokes_parallel_tpu import solver
    from navierstokes_parallel_tpu.models import channel

    prm = _channel(16)
    ref, stats = solver.solve(prm, channel.developed_state(prm))
    assert int(stats.sor_failures) == 0
    for method in ("mg", "fft"):
        st, stats = solver.solve(prm, channel.developed_state(prm),
                                 pressure_method=method)
        assert int(stats.sor_failures) == 0
        np.testing.assert_allclose(np.asarray(st.u), np.asarray(ref.u),
                                   atol=2e-5)
        np.testing.assert_allclose(np.asarray(st.v), np.asarray(ref.v),
                                   atol=2e-5)
    st, stats = solver.solve(prm.replace(T=3.0), None,
                             pressure_method="mg")
    assert int(stats.sor_failures) == 0
    # physical u entries only (i = 0..i_max, j = 1..j_max): developed_state
    # also fills the never-read u ghost column i_max+1, from-rest leaves it
    # zero — dead cells by the grid convention (grid.py docstring)
    np.testing.assert_allclose(np.asarray(st.u)[:-1, 1:-1],
                               np.asarray(ref.u)[:-1, 1:-1], atol=5e-4)


def test_channel_oracle_contract():
    """The 1e-4 comparator contract (reference notebook) holds on the
    channel step too: float32 device-path solve vs the float64 NumPy oracle."""
    from navierstokes_parallel_tpu import oracle, solve

    prm = _channel(8, T=0.05, max_it=2000, dtype="float64")
    res_o = oracle.oracle_solve(prm)
    state, stats = solve(prm.replace(dtype="float32"))
    assert int(stats.steps) == res_o.steps
    np.testing.assert_allclose(np.asarray(state.u, dtype=np.float64),
                               res_o.u, atol=1e-4)
    np.testing.assert_allclose(np.asarray(state.v, dtype=np.float64),
                               res_o.v, atol=1e-4)


def test_channel_sharded_and_gspmd_match_single_chip():
    """Both multi-chip backends run problem 3: the shard_map BC twin
    (psum'd flux balance + global-mean defect deflation,
    parallel/sharded.py::_apply_channel_bcs_sharded) and the GSPMD backend
    (which reuses solver.step unmodified) must match the single-chip
    solve."""
    from navierstokes_parallel_tpu import solver
    from navierstokes_parallel_tpu.parallel import gspmd, sharded
    from navierstokes_parallel_tpu.parallel.topology import make_grid_mesh

    prm = _channel(8, T=0.1)
    mesh = make_grid_mesh(8, prm.i_max, prm.j_max)
    s_state, s_stats = solver.solve(prm.replace(disable_pallas=True))
    sh_state, sh_stats = sharded.solve_sharded(prm, mesh=mesh)
    assert int(sh_stats.steps) == int(s_stats.steps)
    assert int(sh_stats.sor_failures) == 0
    np.testing.assert_allclose(np.asarray(sh_state.u[1:-1, 1:-1]),
                               np.asarray(s_state.u[1:-1, 1:-1]), atol=1e-5)
    np.testing.assert_allclose(np.asarray(sh_state.v[1:-1, 1:-1]),
                               np.asarray(s_state.v[1:-1, 1:-1]), atol=1e-5)
    g_state, g_stats = gspmd.solve_gspmd(prm, mesh=mesh)
    assert int(g_stats.sor_failures) == int(s_stats.sor_failures)
    np.testing.assert_allclose(np.asarray(g_state.u), np.asarray(s_state.u),
                               atol=1e-5)


def test_channel_sharded_oracle_contract():
    """The 1e-4 reference-comparator contract holds for the shard_map
    channel end to end (vs the float64 NumPy oracle)."""
    from navierstokes_parallel_tpu import oracle
    from navierstokes_parallel_tpu.parallel import sharded
    from navierstokes_parallel_tpu.parallel.topology import make_grid_mesh

    prm = _channel(8, T=0.05, max_it=2000)
    mesh = make_grid_mesh(8, prm.i_max, prm.j_max)
    res_o = oracle.oracle_solve(prm.replace(dtype="float64"))
    sh_state, sh_stats = sharded.solve_sharded(prm, mesh=mesh)
    assert int(sh_stats.steps) == res_o.steps
    np.testing.assert_allclose(
        np.asarray(sh_state.u[1:-1, 1:-1], dtype=np.float64),
        res_o.u[1:-1, 1:-1], atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(sh_state.v[1:-1, 1:-1], dtype=np.float64),
        res_o.v[1:-1, 1:-1], atol=1e-4)


@pytest.mark.parametrize("method", ["mg", "fft"])
def test_channel_sharded_mg_fft(method):
    """The sharded multigrid and pencil-spectral inners converge on the
    channel too (the outflow constant mode is deflated with the psum'd
    global mean each outer pass)."""
    from navierstokes_parallel_tpu import solver
    from navierstokes_parallel_tpu.parallel import sharded
    from navierstokes_parallel_tpu.parallel.topology import make_grid_mesh

    prm = _channel(8, T=0.1)
    mesh = make_grid_mesh(8, prm.i_max, prm.j_max)
    s_state, s_stats = solver.solve(prm.replace(disable_pallas=True),
                                    pressure_method=method)
    sh_state, sh_stats = sharded.solve_sharded(prm, mesh=mesh,
                                               pressure_method=method)
    assert int(sh_stats.steps) == int(s_stats.steps)
    assert int(sh_stats.sor_failures) == 0
    np.testing.assert_allclose(np.asarray(sh_state.u[1:-1, 1:-1]),
                               np.asarray(s_state.u[1:-1, 1:-1]), atol=1e-5)
    np.testing.assert_allclose(np.asarray(sh_state.v[1:-1, 1:-1]),
                               np.asarray(s_state.v[1:-1, 1:-1]), atol=1e-5)


def test_channel_sharded_padded_grid():
    """Pad-to-divisible sharding on the channel: a 14x7 grid over an
    (4, 2) mesh pads both axes; the flux-balance psums and the masked
    deflation must ignore pad cells (results bit-independent of the pad)."""
    from navierstokes_parallel_tpu import solver
    from navierstokes_parallel_tpu.parallel import sharded
    from navierstokes_parallel_tpu.parallel.topology import make_grid_mesh

    prm = _channel(7, T=0.1)
    assert prm.i_max == 14 and prm.j_max == 7
    mesh = make_grid_mesh(8, prm.i_max, prm.j_max)
    s_state, s_stats = solver.solve(prm.replace(disable_pallas=True))
    sh_state, sh_stats = sharded.solve_sharded(prm, mesh=mesh)
    assert int(sh_stats.steps) == int(s_stats.steps)
    np.testing.assert_allclose(np.asarray(sh_state.u[1:-1, 1:-1]),
                               np.asarray(s_state.u[1:-1, 1:-1]), atol=1e-5)
    np.testing.assert_allclose(np.asarray(sh_state.v[1:-1, 1:-1]),
                               np.asarray(s_state.v[1:-1, 1:-1]), atol=1e-5)
