"""Pressure-Poisson solver tests.

The red-black solve must (a) actually satisfy the discrete Poisson equation
(residual below the serial stopping rule, integration.c:164), (b) agree with
the lexicographic serial oracle at the level the reference's notebook
comparator demands, and (c) honor max_it.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from navierstokes_parallel_tpu.config import Params
from navierstokes_parallel_tpu.ops import sor
from navierstokes_parallel_tpu import oracle


def _params(n=32, **kw):
    defaults = dict(i_max=n, j_max=n, a=1.0, b=1.0, epsilon=1e-6,
                    max_it=20000, omega=1.7, dtype="float64")
    defaults.update(kw)
    return Params(**defaults)


def _manufactured(n, seed=0):
    """Random smooth-ish RHS with zero mean (a Neumann-compatible source)."""
    rng = np.random.default_rng(seed)
    rhs = np.zeros((n + 2, n + 2))
    interior = rng.standard_normal((n, n))
    interior -= interior.mean()
    rhs[1:-1, 1:-1] = interior
    return rhs


def test_rb_sor_converges_and_satisfies_poisson():
    prm = _params(32)
    rhs = _manufactured(32)
    p0 = jnp.zeros((34, 34), dtype=jnp.float64)
    result = sor.solve_pressure(p0, jnp.asarray(rhs), prm)
    assert bool(result.converged)
    assert int(result.iterations) < prm.max_it
    # Recompute the residual independently.
    p = np.asarray(result.p)
    dx2 = prm.dx ** 2
    res = (
        (p[2:, 1:-1] - 2 * p[1:-1, 1:-1] + p[:-2, 1:-1]) / dx2
        + (p[1:-1, 2:] - 2 * p[1:-1, 1:-1] + p[1:-1, :-2]) / dx2
        - rhs[1:-1, 1:-1]
    )
    norm = np.sqrt(np.sum(res ** 2) / (32 * 32))
    assert norm <= prm.epsilon * (0.0 + sor.NORM_OFFSET) * 1.0000001


def test_rb_sor_matches_serial_oracle_gradients():
    """Red-black and lexicographic orderings must land on solutions whose
    *gradients* agree (the Neumann nullspace constant may differ); gradients
    are what the projection step consumes."""
    n = 24
    prm = _params(n, epsilon=1e-8)
    rhs = _manufactured(n, seed=3)

    p_serial = np.zeros((n + 2, n + 2))
    oracle.sor_serial(p_serial, rhs, prm)

    result = sor.solve_pressure(
        jnp.zeros((n + 2, n + 2), dtype=jnp.float64), jnp.asarray(rhs), prm
    )
    p_rb = np.asarray(result.p)

    gx_s = np.diff(p_serial[1:-1, 1:-1], axis=0)
    gx_rb = np.diff(p_rb[1:-1, 1:-1], axis=0)
    gy_s = np.diff(p_serial[1:-1, 1:-1], axis=1)
    gy_rb = np.diff(p_rb[1:-1, 1:-1], axis=1)
    np.testing.assert_allclose(gx_rb, gx_s, atol=2e-5)
    np.testing.assert_allclose(gy_rb, gy_s, atol=2e-5)


def test_max_it_respected():
    prm = _params(32, epsilon=1e-16, max_it=7)
    rhs = _manufactured(32)
    result = sor.solve_pressure(
        jnp.zeros((34, 34), dtype=jnp.float64), jnp.asarray(rhs), prm
    )
    assert int(result.iterations) == 7
    assert not bool(result.converged)


def test_jacobi_fallback_converges():
    prm = _params(16, epsilon=1e-5, omega=0.8, max_it=50000)
    rhs = _manufactured(16, seed=5)
    result = sor.solve_pressure(
        jnp.zeros((18, 18), dtype=jnp.float64), jnp.asarray(rhs), prm,
        method="jacobi",
    )
    assert bool(result.converged)


def test_mixed_precision_refinement_beats_f32_floor():
    """The f32 storage noise floor (ulp(p)*8/dx^2) exceeds the reference
    stopping threshold on 64^2 grids; iterative refinement (ops/sor.py,
    _solve_pressure_refined) must converge where direct f32 cannot, in
    essentially the same sweep count as f64."""
    n = 64
    prm = _params(n, epsilon=1e-4, max_it=20000, dtype="float32")
    rng = np.random.default_rng(0)
    rhs = np.zeros((n + 2, n + 2))
    ri = rng.standard_normal((n, n)) * 100.0
    ri -= ri.mean()
    rhs[1:-1, 1:-1] = ri

    z32 = jnp.zeros((n + 2, n + 2), jnp.float32)
    z64 = jnp.zeros((n + 2, n + 2), jnp.float64)
    rhs32, rhs64 = jnp.asarray(rhs, jnp.float32), jnp.asarray(rhs, jnp.float64)

    r64 = sor._solve_pressure_direct(z64, rhs64, prm, method="rb_sor")
    rref = sor._solve_pressure_refined(z32, rhs32, prm, method="rb_sor")
    r32 = sor._solve_pressure_direct(z32, rhs32, prm, method="rb_sor")

    assert bool(r64.converged)
    assert bool(rref.converged)
    assert not bool(r32.converged), "direct f32 unexpectedly beat its noise floor"
    # Refinement converges within one K-quantum of the f64 sweep count.
    assert int(rref.iterations) <= int(r64.iterations) + prm.sor_refine_every
    # And solve_pressure dispatches f32 inputs to the refined path.
    auto = sor.solve_pressure(z32, rhs32, prm)
    assert bool(auto.converged)


def test_ghost_fill_neumann():
    rng = np.random.default_rng(7)
    p = rng.standard_normal((8, 8))
    g = np.asarray(sor.ghost_fill(jnp.asarray(p)))
    np.testing.assert_array_equal(g[0, 1:-1], p[1, 1:-1])
    np.testing.assert_array_equal(g[-1, 1:-1], p[-2, 1:-1])
    np.testing.assert_array_equal(g[1:-1, 0], p[1:-1, 1])
    np.testing.assert_array_equal(g[1:-1, -1], p[1:-1, -2])
    # Interior untouched.
    np.testing.assert_array_equal(g[1:-1, 1:-1], p[1:-1, 1:-1])


@pytest.mark.gpu
def test_pallas_sor_matches_jnp(gpu):
    """The CUDA SOR kernel (method pallas_sor; runs on the card only) must
    reproduce the jnp red-black path to f32 rounding."""
    n = 16
    prm = _params(n, epsilon=1e-4, max_it=600, dtype="float32")
    rng = np.random.default_rng(4)
    rhs = np.zeros((n + 2, n + 2), np.float32)
    ri = rng.standard_normal((n, n)).astype(np.float32) * 20.0
    ri -= ri.mean()
    rhs[1:-1, 1:-1] = ri
    z = jnp.zeros((n + 2, n + 2), jnp.float32)

    r_jnp = sor.solve_pressure(z, jnp.asarray(rhs), prm, method="rb_sor")
    r_pl = sor.solve_pressure(z, jnp.asarray(rhs), prm, method="pallas_sor")
    assert bool(r_pl.converged)
    assert int(r_pl.iterations) == int(r_jnp.iterations)
    np.testing.assert_allclose(
        np.asarray(r_pl.p)[1:-1, 1:-1], np.asarray(r_jnp.p)[1:-1, 1:-1],
        atol=1e-5,
    )


def test_multigrid_converges_where_sor_cannot():
    """MG must satisfy the reference stopping rule in O(10) V-cycles on a
    grid where 20000 plain sweeps fail, with matching pressure gradients."""
    n = 128
    prm = _params(n, epsilon=1e-4, max_it=20000, dtype="float32")
    rng = np.random.default_rng(2)
    rhs = np.zeros((n + 2, n + 2), np.float32)
    ri = rng.standard_normal((n, n)).astype(np.float32) * 100.0
    ri -= ri.mean()
    rhs[1:-1, 1:-1] = ri
    z = jnp.zeros((n + 2, n + 2), jnp.float32)
    rhsj = jnp.asarray(rhs)

    r_mg = sor.solve_pressure(z, rhsj, prm, method="mg")
    assert bool(r_mg.converged)
    assert int(r_mg.iterations) <= 20

    # Gradient parity vs the (still converging) refined red-black solve at a
    # size where it does converge.
    n = 64
    prm = _params(n, epsilon=1e-4, max_it=20000, dtype="float32")
    rhs = np.zeros((n + 2, n + 2), np.float32)
    ri = rng.standard_normal((n, n)).astype(np.float32) * 100.0
    ri -= ri.mean()
    rhs[1:-1, 1:-1] = ri
    z = jnp.zeros((n + 2, n + 2), jnp.float32)
    rhsj = jnp.asarray(rhs)
    r_mg = sor.solve_pressure(z, rhsj, prm, method="mg")
    r_rb = sor.solve_pressure(z, rhsj, prm, method="rb_sor")
    assert bool(r_mg.converged) and bool(r_rb.converged)
    gmg = np.diff(np.asarray(r_mg.p)[1:-1, 1:-1], axis=0)
    grb = np.diff(np.asarray(r_rb.p)[1:-1, 1:-1], axis=0)
    np.testing.assert_allclose(gmg, grb, atol=2e-5)


def test_mg_cycles_per_outer():
    """Chained V-cycles (c=2): same converged answer, iterations still
    counts V-cycles (multiples of c per outer pass), bounds validated."""
    n = 64
    prm = _params(n, epsilon=1e-4, max_it=20000, dtype="float32")
    rng = np.random.default_rng(5)
    rhs = np.zeros((n + 2, n + 2), np.float32)
    ri = rng.standard_normal((n, n)).astype(np.float32) * 100.0
    ri -= ri.mean()
    rhs[1:-1, 1:-1] = ri
    z = jnp.zeros((n + 2, n + 2), jnp.float32)
    rhsj = jnp.asarray(rhs)

    r1 = sor.solve_pressure(z, rhsj, prm, method="mg")
    r2 = sor.solve_pressure(z, rhsj, prm.replace(mg_cycles_per_outer=2),
                            method="mg")
    assert bool(r2.converged)
    n1, n2 = int(r1.iterations), int(r2.iterations)
    assert n2 % 2 == 0
    # chaining may overshoot by at most one extra chained pair plus the
    # ~10% convergence slack measured on the cavity workloads
    assert n2 <= n1 + 4
    g1 = np.diff(np.asarray(r1.p)[1:-1, 1:-1], axis=0)
    g2 = np.diff(np.asarray(r2.p)[1:-1, 1:-1], axis=0)
    np.testing.assert_allclose(g1, g2, atol=2e-5)

    with pytest.raises(ValueError, match="mg_cycles_per_outer"):
        prm.replace(mg_cycles_per_outer=0)
    with pytest.raises(ValueError, match="mg_cycles_per_outer"):
        prm.replace(mg_cycles_per_outer=9)


def test_multigrid_end_to_end_oracle_contract():
    from navierstokes_parallel_tpu import solve, oracle
    from navierstokes_parallel_tpu.config import Params

    prm = Params(i_max=16, j_max=16, T=0.05, Re=100.0, tau=0.5,
                 epsilon=1e-4, max_it=500, dtype="float64")
    res_o = oracle.oracle_solve(prm)
    state, stats = solve(prm.replace(dtype="float32"), pressure_method="mg")
    assert int(stats.steps) == res_o.steps
    assert int(stats.sor_failures) == 0
    np.testing.assert_allclose(np.asarray(state.u, dtype=np.float64),
                               res_o.u, atol=1e-4)
    np.testing.assert_allclose(np.asarray(state.v, dtype=np.float64),
                               res_o.v, atol=1e-4)


def test_multigrid_rectangular_grid():
    """Anisotropic spacing (dx != dy) and non-square level hierarchy."""
    from navierstokes_parallel_tpu.ops import mg as mgmod

    prm = _params(32, epsilon=1e-4, max_it=1000, dtype="float32",
                  a=2.0, b=1.0)
    levels = mgmod.build_levels(prm)
    assert len(levels) >= 2
    rng = np.random.default_rng(3)
    rhs = np.zeros((34, 34), np.float32)
    ri = rng.standard_normal((32, 32)).astype(np.float32)
    ri -= ri.mean()
    rhs[1:-1, 1:-1] = ri
    r = sor.solve_pressure(jnp.zeros((34, 34), jnp.float32),
                           jnp.asarray(rhs), prm, method="mg")
    assert bool(r.converged)


def test_cg_fallback_converges():
    """Restarted-CG inner (method='cg'): converges under the reference rule
    with the expected O(n) Krylov iteration count, matching gradients."""
    n = 64
    prm = _params(n, epsilon=1e-4, max_it=20000, dtype="float32")
    rng = np.random.default_rng(0)
    rhs = np.zeros((n + 2, n + 2), np.float32)
    ri = rng.standard_normal((n, n)).astype(np.float32) * 100.0
    ri -= ri.mean()
    rhs[1:-1, 1:-1] = ri
    z = jnp.zeros((n + 2, n + 2), jnp.float32)
    r_cg = sor.solve_pressure(z, jnp.asarray(rhs), prm, method="cg")
    r_rb = sor.solve_pressure(z, jnp.asarray(rhs), prm, method="rb_sor")
    assert bool(r_cg.converged)
    assert int(r_cg.iterations) < int(r_rb.iterations)
    g_cg = np.diff(np.asarray(r_cg.p)[1:-1, 1:-1], axis=0)
    g_rb = np.diff(np.asarray(r_rb.p)[1:-1, 1:-1], axis=0)
    np.testing.assert_allclose(g_cg, g_rb, atol=2e-5)
