"""Compensated (two-float f32) refinement outer — ops/compensated.py and the
`Params.outer_precision="compensated"` path of ops/sor.py.

Where f64 runs far below the f32 rate the refinement outer's f64
defect/L2/master update can rival the f32 inner stage at large grids; the
compensated outer replaces it with error-free f32-pair arithmetic.  These tests pin:

  * the EFT primitives are exact (two_sum/two_prod identities vs f64);
  * the compensated defect matches a true f64 defect to ulp(residual) even
    at 2048^2-scale 1/dx^2 amplification (the regime that defeats plain f32);
  * end-to-end solves CONVERGE IDENTICALLY (same outer-iteration counts) and
    meet the reference 1e-4 comparator contract against the f64 outer, for
    every inner (rb_sor / mg / fft);
  * no global x64 is required;
  * the sharded hooks compose (ghost exchange commutes with hi+lo).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from navierstokes_parallel_tpu.config import Params
from navierstokes_parallel_tpu.ops import compensated as comp
from navierstokes_parallel_tpu.ops import sor
from navierstokes_parallel_tpu.solver import solve
from navierstokes_parallel_tpu.utils.io import tolerance_errors


def test_eft_primitives_exact():
    """two_sum/two_prod satisfy their error-free identities exactly (checked
    in f64, which holds the exact result of any single f32 op pair)."""
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.standard_normal(4096), jnp.float32)
    # Mixed scales: the EFT identities must hold regardless of alignment.
    b = jnp.asarray(rng.standard_normal(4096) * 10.0 **
                    rng.integers(-6, 6, 4096), jnp.float32)
    s, e = comp.two_sum(a, b)
    np.testing.assert_array_equal(
        np.float64(s) + np.float64(e), np.float64(a) + np.float64(b))
    p, e = comp.two_prod(a, b)
    np.testing.assert_array_equal(
        np.float64(p) + np.float64(e), np.float64(a) * np.float64(b))


def test_df_add_normalized():
    """df_add_f32 keeps the pair normalized: hi is the correctly-rounded f32
    of the exact sum, |lo| <= ulp(hi)/2."""
    rng = np.random.default_rng(1)
    hi = jnp.asarray(rng.standard_normal(1024), jnp.float32)
    lo = jnp.asarray(rng.standard_normal(1024) * 1e-8, jnp.float32)
    x = jnp.asarray(rng.standard_normal(1024) * 1e-3, jnp.float32)
    h2, l2 = comp.df_add_f32(hi, lo, x)
    exact = np.float64(hi) + np.float64(lo) + np.float64(x)
    np.testing.assert_array_equal(np.asarray(h2), np.float32(exact))
    assert np.all(np.abs(np.asarray(l2)) <=
                  np.spacing(np.abs(np.asarray(h2))) / 2 + 1e-45)


def test_residual_df_matches_f64_at_high_amplification():
    """The compensated defect matches the f64 defect to ~ulp(residual) at
    dx = 1/2048 (amplification 1/dx^2 ~ 4e6), on a smooth near-converged
    field — the regime where plain f32 fails by orders of magnitude above
    the stopping threshold."""
    rng = np.random.default_rng(0)
    n, phys = 64, 64 / 2048.0
    params = Params(i_max=n, j_max=n, a=phys, b=phys)
    dx2 = np.float32(1.0 / (params.dx * params.dx))
    x = (np.arange(n + 2) - 0.5) * params.dx
    X, Y = np.meshgrid(x, x, indexing="ij")
    p64 = np.sin(2 * np.pi * X / phys) * np.cos(2 * np.pi * Y / phys) * 3.0
    hi = np.float32(p64)
    lo = np.float32(p64 - np.float64(hi))
    pair64 = jnp.asarray(np.float64(hi) + np.float64(lo))
    # rhs ~ A p, so the defect is near-converged scale (O(1e-4)).
    lap = sor.residual(pair64, jnp.zeros((n, n)), np.float64(dx2),
                       np.float64(dx2))
    rhs32 = np.float32(np.asarray(lap) + 1e-4 * rng.standard_normal((n, n)))

    r64 = np.asarray(sor.residual(pair64, jnp.asarray(np.float64(rhs32)),
                                  np.float64(dx2), np.float64(dx2)))
    rdf = np.asarray(comp.residual_df(jnp.asarray(hi), jnp.asarray(lo),
                                      jnp.asarray(rhs32), dx2, dx2))
    diff = np.abs(rdf - r64)
    # Error model: the two-float pair carries ~2x24 bits, so the defect is
    # exact to O(eps^2) OF THE AMPLIFIED SCALE |p|/dx^2 (the lo channel's
    # plain-f32 ops square the eps), plus ulp(r) from the final collapse —
    # ~5e-6 here, vs a plain-f32 defect error of O(eps * |p|/dx^2) ~ O(1).
    eps = np.float64(np.finfo(np.float32).eps)
    bound = (32 * eps**2 * np.abs(p64).max() * np.float64(dx2)
             + 8 * eps * np.abs(r64).max())
    assert diff.max() <= bound, (
        f"max diff {diff.max():.3e} vs model bound {bound:.3e}")

    # Contrast: a plain-f32 defect is off by ORDERS OF MAGNITUDE more — the
    # compensation is load-bearing, not decorative.
    r32 = np.asarray(sor.residual(jnp.asarray(hi), jnp.asarray(rhs32),
                                  dx2, dx2))
    assert np.abs(r32 - r64).max() > 100 * diff.max()


@pytest.mark.parametrize("method", ["rb_sor", "mg", "fft"])
def test_solve_parity_with_f64_outer(method):
    """End-to-end cavity solve: identical outer-iteration counts and the
    reference 1e-4 comparator contract vs the f64-outer solve."""
    base = Params(i_max=32, j_max=32, T=0.05, Re=1000.0, tau=0.5, omega=1.7,
                  epsilon=1e-4, max_it=3000, dtype="float32",
                  sor_refine_every=64)
    s64, st64 = solve(base, pressure_method=method)
    sc, stc = solve(base.replace(outer_precision="compensated"),
                    pressure_method=method)
    assert int(stc.sor_failures) == 0
    assert int(stc.steps) == int(st64.steps)
    assert int(stc.total_sor_iterations) == int(st64.total_sor_iterations)
    assert np.max(tolerance_errors(np.asarray(s64.u), np.asarray(sc.u))) < 1e-4
    assert np.max(tolerance_errors(np.asarray(s64.v), np.asarray(sc.v))) < 1e-4


def test_residual_df_float64_rhs_split():
    """With a float64 RHS whose low f32 word is significant, the rhs_lo
    channel must recover the full-precision defect — dropping it would make
    `converged` certify against a rounded problem."""
    rng = np.random.default_rng(2)
    n, phys = 64, 64 / 2048.0
    params = Params(i_max=n, j_max=n, a=phys, b=phys)
    dx2 = np.float32(1.0 / (params.dx * params.dx))
    x = (np.arange(n + 2) - 0.5) * params.dx
    X, Y = np.meshgrid(x, x, indexing="ij")
    p64 = np.sin(2 * np.pi * X / phys) * np.cos(2 * np.pi * Y / phys) * 3.0
    hi = np.float32(p64)
    lo = np.float32(p64 - np.float64(hi))
    pair64 = np.float64(hi) + np.float64(lo)
    # Near-converged f64 rhs: A p plus a small defect.  rhs is O(1e5) with
    # significant sub-f32 words (~eps*|rhs| ~ 1e-2), while the defect itself
    # is O(1e-4) — exactly the regime where dropping rhs_lo would certify
    # convergence of a rounded problem.
    rhs64 = np.asarray(sor.residual(jnp.asarray(pair64), jnp.zeros((n, n)),
                                    np.float64(dx2), np.float64(dx2)))
    rhs64 = rhs64 + 1e-4 * rng.standard_normal((n, n))
    rhs_hi = np.float32(rhs64)
    rhs_lo = np.float32(rhs64 - np.float64(rhs_hi))
    r64 = np.asarray(sor.residual(jnp.asarray(pair64), jnp.asarray(rhs64),
                                  np.float64(dx2), np.float64(dx2)))
    r_with = np.asarray(comp.residual_df(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(rhs_hi), dx2, dx2,
        rhs_lo=jnp.asarray(rhs_lo)))
    r_without = np.asarray(comp.residual_df(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(rhs_hi), dx2, dx2))
    err_with = np.abs(r_with - r64).max()
    err_without = np.abs(r_without - r64).max()
    # With the split: well below the O(1e-4) defect scale.
    assert err_with < 0.1 * np.abs(r64).max(), (err_with, np.abs(r64).max())
    # Without it: off by the dropped low words (~eps*|rhs| >> defect).
    assert err_without > 10 * err_with, (err_without, err_with)


@pytest.mark.parametrize("method", ["mg", "fft"])
def test_solve_parity_float64_state(method):
    """float64-state solves through the compensated outer keep the f64
    outer's iteration counts and meet the comparator contract (the two-float
    input split carries the f64 rhs/p low words into the defect)."""
    base = Params(i_max=32, j_max=32, T=0.02, Re=100.0, tau=0.5,
                  epsilon=1e-4, max_it=2000, dtype="float64")
    s64, st64 = solve(base, pressure_method=method)
    sc, stc = solve(base.replace(outer_precision="compensated"),
                    pressure_method=method)
    assert int(stc.sor_failures) == 0
    assert int(stc.total_sor_iterations) == int(st64.total_sor_iterations)
    assert np.max(tolerance_errors(np.asarray(s64.u), np.asarray(sc.u))) < 1e-4


def test_no_x64_required():
    """The compensated outer runs the fft/mg methods WITHOUT global x64 —
    impossible for the f64 outer (clear error)."""
    base = Params(i_max=32, j_max=32, T=0.02, Re=100.0, tau=0.5,
                  epsilon=1e-4, max_it=2000, dtype="float32")
    sref, _ = solve(base, pressure_method="fft")
    with jax.enable_x64(False):
        st, stats = solve(base.replace(outer_precision="compensated"),
                          pressure_method="fft")
        assert int(stats.sor_failures) == 0
        with pytest.raises(ValueError, match="x64"):
            solve(base, pressure_method="fft")
    assert np.max(tolerance_errors(np.asarray(sref.u), np.asarray(st.u))) < 1e-4


@pytest.mark.parametrize("method", ["rb_sor", "mg"])
def test_sharded_compensated(method):
    """The compensated outer composes with the sharded hooks (halo ghost_fn
    applied to hi and lo independently; psum'd f32 norms)."""
    from navierstokes_parallel_tpu.parallel import topology
    from navierstokes_parallel_tpu.parallel.sharded import solve_sharded

    prm = Params(i_max=16, j_max=16, T=0.05, Re=100.0, tau=0.5,
                 epsilon=1e-4, max_it=500, dtype="float32",
                 sor_refine_every=8, outer_precision="compensated")
    mesh = topology.make_grid_mesh(4, prm.i_max, prm.j_max)
    single_state, single_stats = solve(prm, pressure_method=method)
    sh_state, sh_stats = solve_sharded(prm, mesh=mesh, pressure_method=method)
    assert int(sh_stats.steps) == int(single_stats.steps)
    np.testing.assert_allclose(np.asarray(sh_state.u[1:-1, 1:-1]),
                               np.asarray(single_state.u[1:-1, 1:-1]),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(sh_state.v[1:-1, 1:-1]),
                               np.asarray(single_state.v[1:-1, 1:-1]),
                               atol=1e-5)


def test_outer_precision_validated():
    with pytest.raises(ValueError, match="outer_precision"):
        Params(i_max=16, j_max=16, outer_precision="float32")
