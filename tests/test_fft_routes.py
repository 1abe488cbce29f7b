"""The two DCT transform routes (matmul vs rfft) are the same math.

The rfft route is Makhoul's O(n log n) DCT-II evaluation (ops/fft.py);
these tests pin it bitwise-close to the dense cosine-matrix route for even,
odd, and non-square sizes, and check the route-selection knobs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from navierstokes_parallel_tpu.config import Params
from navierstokes_parallel_tpu.ops import fft as fftmod
from navierstokes_parallel_tpu.ops import sor


@pytest.mark.parametrize("n", [4, 5, 16, 17, 32, 33, 64])
def test_dct2_rfft_matches_matrix(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, n)).astype(np.float32)
    C = fftmod._dct_matrix(n)
    ref = x @ C.T
    got = np.asarray(fftmod._dct2_rfft(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, atol=2e-5 * np.sqrt(n))


@pytest.mark.parametrize("n", [4, 5, 16, 17, 32, 33, 64])
def test_idct2_irfft_roundtrip(n):
    rng = np.random.default_rng(100 + n)
    x = rng.standard_normal((2, n)).astype(np.float32)
    back = np.asarray(fftmod._idct2_irfft(fftmod._dct2_rfft(jnp.asarray(x))))
    np.testing.assert_allclose(back, x, atol=3e-6 * np.sqrt(n))


@pytest.mark.parametrize("ni,nj", [(32, 32), (33, 32), (48, 24), (17, 17)])
def test_solve_routes_agree(ni, nj):
    """Full Poisson solve: rfft route == matmul route to f32 tolerance,
    including odd and non-square interiors."""
    params = Params(problem=1, i_max=ni, j_max=nj, T=0.05, Re=100.0,
                    tau=0.5, omega=1.7, epsilon=1e-4, max_it=50,
                    dtype="float32")
    rng = np.random.default_rng(7)
    rhs = rng.standard_normal((ni, nj)).astype(np.float32)
    rhs -= rhs.mean()
    lam = fftmod._lambda_grid(params)
    p_mat = np.asarray(fftmod._solve_matmul(jnp.asarray(rhs), lam, ni, nj))
    p_fft = np.asarray(fftmod._solve_rfft(jnp.asarray(rhs), lam))
    scale = np.abs(p_mat).max() + 1e-30
    np.testing.assert_allclose(p_fft / scale, p_mat / scale, atol=5e-5)


def test_route_knob_forces_route(monkeypatch):
    params = Params(problem=1, i_max=16, j_max=16, T=0.05, Re=100.0,
                    tau=0.5, omega=1.7, epsilon=1e-4, max_it=50,
                    dtype="float32")
    monkeypatch.setattr(fftmod, "PREFER_RFFT", True)
    assert fftmod._pick_transform_route(params) == "rfft"
    monkeypatch.setattr(fftmod, "PREFER_RFFT", False)
    assert fftmod._pick_transform_route(params) == "matmul"


def test_route_auto_cpu_heuristic(monkeypatch):
    monkeypatch.setattr(fftmod, "PREFER_RFFT", None)
    small = Params(problem=1, i_max=16, j_max=16, T=0.05, Re=100.0, tau=0.5,
                   omega=1.7, epsilon=1e-4, max_it=50, dtype="float32")
    big = small.replace(i_max=512, j_max=512)
    assert fftmod._pick_transform_route(small) == "matmul"
    assert fftmod._pick_transform_route(big) == "rfft"


def test_gspmd_stays_on_matmul(monkeypatch):
    """disable_pallas (the GSPMD backend) must keep the partitionable
    matmul transforms even when auto would pick rfft — and even when the
    user forces PREFER_RFFT (an FFT along a sharded axis degenerates to
    gather-transform-scatter under the partitioner)."""
    monkeypatch.setattr(fftmod, "PREFER_RFFT", None)
    p = Params(problem=1, i_max=512, j_max=512, T=0.05, Re=100.0, tau=0.5,
               omega=1.7, epsilon=1e-4, max_it=50, dtype="float32",
               disable_pallas=True)
    assert fftmod._pick_transform_route(p) == "matmul"
    monkeypatch.setattr(fftmod, "PREFER_RFFT", True)
    assert fftmod._pick_transform_route(p) == "matmul"


def test_solve_pressure_fft_rfft_route(monkeypatch):
    """method='fft' through the refinement outer, forced onto the rfft
    route: converges in a handful of direct solves and matches the matmul
    route's pressure gradient."""
    if not jax.config.jax_enable_x64:
        pytest.skip("needs x64 for the f64 refinement master")
    params = Params(problem=1, i_max=33, j_max=33, T=0.05, Re=100.0,
                    tau=0.5, omega=1.7, epsilon=1e-4, max_it=50,
                    dtype="float32")
    rng = np.random.default_rng(3)
    rhs = np.zeros(params.shape, np.float32)
    r = rng.standard_normal((33, 33)).astype(np.float32)
    rhs[1:-1, 1:-1] = r - r.mean()
    p0 = jnp.zeros(params.shape, jnp.float32)

    monkeypatch.setattr(fftmod, "PREFER_RFFT", True)
    res_fft = sor.solve_pressure(p0, jnp.asarray(rhs), params, method="fft")
    assert bool(res_fft.converged)
    assert int(res_fft.iterations) <= 5

    monkeypatch.setattr(fftmod, "PREFER_RFFT", False)
    res_mat = sor.solve_pressure(p0, jnp.asarray(rhs), params, method="fft")
    gx_f = np.diff(np.asarray(res_fft.p), axis=0)
    gx_m = np.diff(np.asarray(res_mat.p), axis=0)
    np.testing.assert_allclose(gx_f, gx_m, atol=5e-5)


def test_rfft_route_accuracy_large_grid(monkeypatch):
    """f32 butterfly rounding at 1024^2 stays well inside what the f64
    refinement outer absorbs: one direct solve must reduce the residual by
    >= 3 orders of magnitude (the matmul route's HIGHEST-precision solve
    achieves ~4; anything >= 3 keeps the 2-3 solves/step contract)."""
    n = 1024
    params = Params(problem=1, i_max=n, j_max=n, T=0.05, Re=100.0, tau=0.5,
                    omega=1.7, epsilon=1e-4, max_it=50, dtype="float32")
    rng = np.random.default_rng(42)
    rhs = rng.standard_normal((n, n)).astype(np.float32)
    rhs -= rhs.mean()
    lam = fftmod._lambda_grid(params)
    p = np.asarray(fftmod._solve_rfft(jnp.asarray(rhs), lam))
    # residual of the 5-point system in f64
    dx2 = float(1.0 / (params.dx * params.dx))
    pf = np.zeros((n + 2, n + 2))
    pf[1:-1, 1:-1] = p
    pf[0, 1:-1] = pf[1, 1:-1]; pf[-1, 1:-1] = pf[-2, 1:-1]
    pf[1:-1, 0] = pf[1:-1, 1]; pf[1:-1, -1] = pf[1:-1, -2]
    res = ((pf[2:, 1:-1] - 2 * pf[1:-1, 1:-1] + pf[:-2, 1:-1]) * dx2
           + (pf[1:-1, 2:] - 2 * pf[1:-1, 1:-1] + pf[1:-1, :-2]) * dx2
           - rhs)
    rel = np.linalg.norm(res) / np.linalg.norm(rhs)
    assert rel < 1e-3, f"rfft direct solve residual reduction only {rel:.2e}"


def test_fft_precision_knob():
    """fft_precision plumbs through the matmul route (validated at
    construction; on CPU Precision is a no-op for accuracy so this pins
    plumbing + the contract; the trade itself is measured on the card)."""
    import jax

    from navierstokes_parallel_tpu.solver import solve
    from navierstokes_parallel_tpu.utils.io import tolerance_errors

    base = Params(i_max=32, j_max=32, T=0.02, Re=100.0, tau=0.5,
                  epsilon=1e-4, max_it=2000, dtype="float32")
    ref, _ = solve(base, pressure_method="fft")
    for prec in ("high", "default"):
        st, stats = solve(base.replace(fft_precision=prec),
                          pressure_method="fft")
        assert int(stats.sor_failures) == 0
        assert np.max(tolerance_errors(np.asarray(ref.u),
                                       np.asarray(st.u))) < 1e-4
    with pytest.raises(ValueError, match="fft_precision"):
        base.replace(fft_precision="bf16")


def test_fft_solves_per_outer():
    """Chained direct solves (s=2): same converged answer, iterations still
    counts direct solves, and the config validates its bounds."""
    if not jax.config.jax_enable_x64:
        pytest.skip("needs x64")
    base = Params(problem=1, i_max=32, j_max=32, T=0.05, Re=100.0, tau=0.5,
                  omega=1.7, epsilon=1e-4, max_it=50, dtype="float32")
    rng = np.random.default_rng(3)
    rhs = np.zeros(base.shape, np.float32)
    r = rng.standard_normal((32, 32)).astype(np.float32)
    rhs[1:-1, 1:-1] = r - r.mean()
    p0 = jnp.zeros(base.shape, jnp.float32)

    res1 = sor.solve_pressure(p0, jnp.asarray(rhs), base, method="fft")
    res2 = sor.solve_pressure(p0, jnp.asarray(rhs),
                              base.replace(fft_solves_per_outer=2),
                              method="fft")
    assert bool(res2.converged)
    # counts direct solves (multiples of s per outer pass), bounded by the
    # s=1 count rounded up to the next multiple of 2.
    n1, n2 = int(res1.iterations), int(res2.iterations)
    assert n2 % 2 == 0
    assert n2 <= n1 + 2
    gx1 = np.diff(np.asarray(res1.p), axis=0)
    gx2 = np.diff(np.asarray(res2.p), axis=0)
    np.testing.assert_allclose(gx1, gx2, atol=5e-5)

    with pytest.raises(ValueError, match="fft_solves_per_outer"):
        base.replace(fft_solves_per_outer=0)
    with pytest.raises(ValueError, match="fft_solves_per_outer"):
        base.replace(fft_solves_per_outer=9)
