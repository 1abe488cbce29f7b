"""The red-black SOR inner stage of ops/sor_kernel.py.

The CUDA kernel (csrc/rb_sor.cu) runs only on the card, so its algorithm is
pinned here by a NumPy emulation of exactly what it does -- tile + 2k-deep
halo in shared memory, at most k sweeps per launch on a region that shrinks
by one cell per half-sweep, core written back, launches chained -- against
the plain XLA twin `_roll_sweeps_xla`.  The wrapper's launch arithmetic and
its refusals run on the CPU; the tests marked `gpu` run the kernel itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from navierstokes_parallel_tpu.config import Params
from navierstokes_parallel_tpu.ops import sor
from navierstokes_parallel_tpu.ops import sor_kernel as sk


def _params(i_max, j_max, **kw):
    return Params(problem=1, i_max=i_max, j_max=j_max, a=1.0, b=1.3,
                  T=0.01, Re=100.0, tau=0.5, omega=1.7, epsilon=1e-4,
                  max_it=500, dtype="float32", **kw)


def _rhs(params, seed=7):
    rng = np.random.default_rng(seed)
    rhs = np.zeros(params.shape, np.float32)
    rhs[1:-1, 1:-1] = rng.standard_normal(
        (params.i_max, params.j_max)).astype(np.float32)
    return rhs


def _reference_inner(rhs_neg, n_sweeps, params):
    """The jnp ghost-fill red-black inner stage (the oracle formulation)."""
    f32 = jnp.float32
    dx2_inv = jnp.asarray(1.0 / (params.dx * params.dx), f32)
    dy2_inv = jnp.asarray(1.0 / (params.dy * params.dy), f32)
    omega = jnp.asarray(params.omega, f32)
    shape_int = (params.i_max, params.j_max)
    red = sor._checkerboard(shape_int, 0)
    black = sor._checkerboard(shape_int, 1)
    d = jnp.zeros(params.shape, f32)
    rhs_int = jnp.asarray(rhs_neg)[1:-1, 1:-1].astype(f32)
    for _ in range(n_sweeps):
        d = sor.rb_sor_iteration(d, rhs_int, omega, dx2_inv, dy2_inv,
                                 red, black)
    return d


def test_roll_sweeps_xla_matches_jnp():
    params = _params(64, 64)
    rhs = _rhs(params)
    got = sk._roll_sweeps_xla(jnp.asarray(rhs), 6, params)
    want = _reference_inner(rhs, 6, params)
    np.testing.assert_allclose(np.asarray(got)[1:-1, 1:-1],
                               np.asarray(want)[1:-1, 1:-1],
                               rtol=2e-6, atol=2e-6)


def _emulate_kernel(rhs, n_sweeps, params, max_sweeps, k, tile, halo=None):
    """What csrc/rb_sor.cu computes, block by block, in float32.  `halo`
    overrides the kernel's 2k (only to show that a shallower one fails)."""
    ls = sk.launch_shape(params.shape, k, tile)
    ni, nj = params.shape
    omega, coef, dx2_inv, dy2_inv = sk._coefficients(params)
    keep = np.float32(1.0) - omega
    halo = 2 * k if halo is None else halo
    ti, tj = ls.tile
    ei, ej = ti + 2 * halo, tj + 2 * halo
    li = np.arange(ei)[:, None]
    lj = np.arange(ej)[None, :]
    dist = np.minimum(np.minimum(li, ei - 1 - li), np.minimum(lj, ej - 1 - lj))
    d = np.zeros((ni, nj), np.float32)
    for launch in range(ls.launches(max_sweeps)):
        sweeps = min(max(n_sweeps - launch * k, 0), k)
        out = np.zeros_like(d)
        for bi in range(ls.grid[1]):
            for bj in range(ls.grid[0]):
                gi = li + bi * ti - halo
                gj = lj + bj * tj - halo
                inside = (gi >= 0) & (gi < ni) & (gj >= 0) & (gj < nj)
                ci, cj = np.clip(gi, 0, ni - 1), np.clip(gj, 0, nj - 1)
                dt = np.where(inside, d[ci, cj], np.float32(0))
                rt = np.where(inside, rhs[ci, cj], np.float32(0))
                interior = ((gi >= 1) & (gi <= ni - 2)
                            & (gj >= 1) & (gj <= nj - 2))
                self_coef = (
                    ((gi == 1).astype(np.float32)
                     + (gi == ni - 2).astype(np.float32)) * dx2_inv
                    + ((gj == 1).astype(np.float32)
                       + (gj == nj - 2).astype(np.float32)) * dy2_inv)
                for h in range(1, 2 * sweeps + 1):
                    # Cells nearer than h to the tile edge are stale: skip.
                    near = dist >= min(h, halo)
                    mask = interior & ((gi + gj) % 2 == (h - 1) % 2) & near
                    nb = np.zeros_like(dt)
                    nb[1:-1, 1:-1] = (
                        (dt[:-2, 1:-1] + dt[2:, 1:-1]) * dx2_inv
                        + (dt[1:-1, :-2] + dt[1:-1, 2:]) * dy2_inv
                        + dt[1:-1, 1:-1] * self_coef[1:-1, 1:-1])
                    dt = np.where(mask, keep * dt + coef * (nb - rt), dt)
                i0, j0 = bi * ti, bj * tj
                core = dt[halo:halo + ti, halo:halo + tj]
                hi, hj = min(ti, ni - i0), min(tj, nj - j0)
                out[i0:i0 + hi, j0:j0 + hj] = core[:hi, :hj]
        d = out
    return d


# (i_max, j_max, k, tile, n_sweeps, max_sweeps): square and odd grids,
# grids that are no multiple of the tile, one-launch and chained calls,
# and calls whose last launches only copy (n_sweeps < max_sweeps).
_EMULATION_CASES = [
    (16, 16, 2, (4, 8), 4, 4),
    (16, 16, 1, (8, 8), 3, 3),
    (13, 29, 2, (5, 7), 5, 5),
    (13, 29, 3, (4, 8), 7, 9),
    (40, 7, 2, (8, 4), 6, 6),
    (33, 65, 2, (8, 16), 3, 8),
    (33, 65, 4, (16, 16), 8, 8),
    (9, 9, 3, (32, 64), 5, 6),
    (30, 18, 1, (3, 5), 2, 2),
    (21, 44, 2, (16, 32), 9, 12),
]


@pytest.mark.parametrize("i_max,j_max,k,tile,n_sweeps,max_sweeps",
                         _EMULATION_CASES)
def test_kernel_tiling_matches_roll_sweeps_xla(i_max, j_max, k, tile,
                                               n_sweeps, max_sweeps):
    params = _params(i_max, j_max)
    rhs = _rhs(params, seed=i_max * 100 + j_max)
    got = _emulate_kernel(rhs, n_sweeps, params, max_sweeps, k, tile)
    want = np.asarray(sk._roll_sweeps_xla(jnp.asarray(rhs), n_sweeps,
                                          params))
    np.testing.assert_array_equal(got[0], 0.0)       # ghost ring stays 0
    np.testing.assert_array_equal(got[:, -1], 0.0)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.max(np.abs(want)))


def test_stale_halo_would_show():
    """The emulation has teeth: with a halo of k instead of 2k cells the
    tile seams come out wrong."""
    params = _params(24, 24)
    rhs = _rhs(params)
    want = np.asarray(sk._roll_sweeps_xla(jnp.asarray(rhs), 8, params))
    got = _emulate_kernel(rhs, 8, params, 8, 4, (8, 8))
    np.testing.assert_allclose(got, want, atol=1e-5 * np.max(np.abs(want)))
    broken = _emulate_kernel(rhs, 8, params, 8, 4, (8, 8), halo=4)
    assert np.max(np.abs(broken - want)) > 1e-3 * np.max(np.abs(want))


@pytest.mark.parametrize("shape,k,tile,ext,grid,smem", [
    ((258, 258), 8, None, (48, 64), (9, 17), 24576),          # 256^2
    ((1026, 1026), 8, None, (64, 96), (17, 33), 49152),       # 1024^2
    ((2050, 2050), 8, None, (64, 96), (33, 65), 49152),       # 2048^2
    ((18, 18), 2, (4, 8), (12, 16), (3, 5), 1536),
    ((15, 31), 3, (5, 7), (17, 19), (5, 3), 2584),
    ((66, 34), 1, (64, 32), (68, 36), (2, 2), 19584),
])
def test_launch_shape_arithmetic(shape, k, tile, ext, grid, smem):
    ls = sk.launch_shape(shape, k, tile)
    assert ls.k == k
    assert ls.ext == ext
    assert ls.grid == grid
    assert ls.smem_bytes == smem
    assert ls.grid[0] * ls.tile[1] >= shape[1]
    assert ls.grid[1] * ls.tile[0] >= shape[0]


@pytest.mark.parametrize("shape,tile", [
    ((258, 258), (16, 32)),     # 256^2: 153 blocks, the larger tiles < 132
    ((514, 514), (32, 64)),
    ((1026, 1026), (32, 64)),
    ((130, 130), (16, 32)),     # too small for 132 blocks: smallest tile
    ((402, 402), (32, 32)),
])
def test_pick_tile_fills_the_card(shape, tile):
    assert sk.pick_tile(shape) == tile


@pytest.mark.parametrize("max_sweeps,launches", [
    (1, 1), (8, 1), (9, 2), (64, 8), (2048, 256)])
def test_launch_count(max_sweeps, launches):
    assert sk.launch_shape((258, 258)).launches(max_sweeps) == launches


@pytest.mark.parametrize("k,tile", [(0, (16, 32)), (8, (0, 32)),
                                    (8, (160, 160))])
def test_launch_shape_rejects(k, tile):
    with pytest.raises(ValueError):
        sk.launch_shape((258, 258), k, tile)


def test_coefficients_are_float32():
    omega, coef, dx2_inv, dy2_inv = sk._coefficients(_params(64, 32))
    for v in (omega, coef, dx2_inv, dy2_inv):
        assert v.dtype == np.float32
    assert coef == omega / (np.float32(2) * (dx2_inv + dy2_inv))


def test_pallas_sor_refused_on_cpu():
    params = _params(16, 16)
    z = jnp.zeros(params.shape, jnp.float32)
    with pytest.raises(ValueError, match="needs an NVIDIA GPU"):
        sor.solve_pressure(z, z, params, method="pallas_sor")
    with pytest.raises(ValueError, match="needs an NVIDIA GPU"):
        sk.inner_sweeps(z, 4, params, max_sweeps=4)


def test_default_method_on_cpu():
    assert sor.default_method(_params(16, 16)) == "rb_sor"
    assert sor.default_method(
        _params(16, 16, obstacles=((4, 8, 4, 8),))) == "rb_sor"


@pytest.mark.parametrize("kw,method", [
    ({}, "pallas_sor"),
    ({"obstacles": ((4, 8, 4, 8),)}, "rb_sor"),
    ({"disable_pallas": True}, "rb_sor")])
def test_default_method_on_gpu(monkeypatch, kw, method):
    """On a GPU the kernel is the default (it won end to end, PERF.md),
    except where it cannot run."""
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert sor.default_method(_params(16, 16, **kw)) == method


@pytest.mark.gpu
@pytest.mark.parametrize("i_max,j_max,n_sweeps,max_sweeps",
                         [(16, 16, 12, 16), (13, 29, 20, 20),
                          (256, 256, 64, 64)])
def test_kernel_matches_roll_sweeps_xla_on_gpu(gpu, i_max, j_max, n_sweeps,
                                               max_sweeps):
    # Both routes jitted, as the solver runs them: op-by-op the twin's
    # coefficient arithmetic rounds differently on the GPU (2.5e-5 relative
    # after 64 sweeps with dx != dy), which is not what is under test.
    params = _params(i_max, j_max)
    rhs = jnp.asarray(_rhs(params))
    got = np.asarray(jax.jit(
        lambda r: sk.inner_sweeps(r, n_sweeps, params, max_sweeps))(rhs))
    want = np.asarray(jax.jit(
        lambda r: sk._roll_sweeps_xla(r, n_sweeps, params))(rhs))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.max(np.abs(want)))
