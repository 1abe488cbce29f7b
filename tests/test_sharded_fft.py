"""Sharded spectral solver: pencil-decomposed all_to_all DCT under shard_map
(ops/fft.py::make_sharded_inner wired through parallel/sharded.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from navierstokes_parallel_tpu.config import Params
from navierstokes_parallel_tpu.ops import fft as fftmod
from navierstokes_parallel_tpu.parallel import topology
from navierstokes_parallel_tpu.parallel.sharded import solve_sharded
from navierstokes_parallel_tpu.solver import solve

from conftest import assert_close_reference_contract

try:
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map


def _params(**kw):
    base = dict(problem=1, i_max=32, j_max=32, a=1.0, b=1.0, T=0.05,
                Re=100.0, tau=0.5, omega=1.7, epsilon=1e-4, max_it=200,
                dtype="float32")
    base.update(kw)
    return Params(**base)


def test_pencil_solve_matches_single_chip():
    """The distributed direct solve == the single-chip direct solve on the
    same RHS, to f32 rounding, on an 8-device (2,4)/(4,2) mesh."""
    prm = _params()
    mesh = topology.make_grid_mesh(8, prm.i_max, prm.j_max)
    px, py = mesh.devices.shape
    li, lj = prm.i_max // px, prm.j_max // py

    rng = np.random.default_rng(5)
    rhs_int = rng.standard_normal((prm.i_max, prm.j_max)).astype(np.float32)
    rhs_int -= rhs_int.mean()

    p_single = np.asarray(fftmod.poisson_solve_dct(jnp.asarray(rhs_int), prm))

    inner = fftmod.make_sharded_inner(prm, li, lj)
    from jax.sharding import PartitionSpec as P

    def local(rhs_full_block):
        return inner(rhs_full_block, 1)

    # Build the block-layout full array: interiors only matter.
    rhs_full = np.zeros(prm.shape, np.float32)
    rhs_full[1:-1, 1:-1] = rhs_int
    from navierstokes_parallel_tpu.parallel import sharded as sh
    blocks = sh._scatter_blocks(rhs_full, px, py, li, lj)

    mapped = shard_map(local, mesh=mesh,
                       in_specs=(P("x", "y"),), out_specs=P("x", "y"),
                       check_vma=False)
    out_blocks = np.asarray(jax.jit(mapped)(blocks))
    out = sh._gather_blocks(out_blocks, px, py, li, lj, prm.shape)
    scale = np.abs(p_single).max() + 1e-30
    np.testing.assert_allclose(out[1:-1, 1:-1] / scale, p_single / scale,
                               atol=5e-5)


def test_sharded_fft_solve_matches_single_chip():
    """Full cavity solve, sharded fft vs single-chip fft: same steps, zero
    failures, velocities within f32 tolerance."""
    prm = _params(T=0.05)
    mesh = topology.make_grid_mesh(8, prm.i_max, prm.j_max)
    sh_state, sh_stats = solve_sharded(prm, mesh=mesh, pressure_method="fft")
    st, ss = solve(prm, pressure_method="fft")
    assert int(sh_stats.steps) == int(ss.steps)
    assert int(sh_stats.sor_failures) == 0
    # Direct solves per step must match the single-chip spectral count
    # (2-3/step), not SOR-like hundreds.
    assert int(sh_stats.total_sor_iterations) <= 5 * int(sh_stats.steps)
    np.testing.assert_allclose(
        np.asarray(sh_state.u)[1:-1, 1:-1], np.asarray(st.u)[1:-1, 1:-1],
        atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(sh_state.v)[1:-1, 1:-1], np.asarray(st.v)[1:-1, 1:-1],
        atol=1e-5)


def test_sharded_fft_oracle_contract():
    from navierstokes_parallel_tpu import oracle

    prm = _params(dtype="float64")
    res_o = oracle.oracle_solve(prm)
    mesh = topology.make_grid_mesh(8, prm.i_max, prm.j_max)
    sh, shs = solve_sharded(prm.replace(dtype="float32"), mesh=mesh,
                            pressure_method="fft")
    assert int(shs.steps) == res_o.steps
    assert_close_reference_contract(
        np.asarray(sh.u, dtype=np.float64)[1:-1, 1:-1],
        res_o.u[1:-1, 1:-1], tol=1e-4)


def test_sharded_fft_rejects_padded_grid():
    prm = _params(i_max=17, j_max=17)
    mesh = topology.make_grid_mesh(8, 17, 17)
    with pytest.raises(ValueError, match="evenly-divisible"):
        solve_sharded(prm, mesh=mesh, pressure_method="fft")


def test_sharded_fft_rejects_unTileable_pencils():
    """Blocks that cannot split across the other mesh axis must raise a
    clear error, not a reshape failure inside shard_map tracing."""
    with pytest.raises(ValueError, match="pencil"):
        # 8x8 grid on a (2,4) mesh: li=4 % py=4 == 0 but lj=2 % px=2 == 0 —
        # pick sizes that actually violate: 4x8 grid on (2,4): li=2%4 != 0.
        fftmod.make_sharded_inner(_params(i_max=4, j_max=8), 2, 2)


def _count_primitive(jaxpr, name) -> int:
    def sub(v):
        if hasattr(v, "eqns"):
            return _count_primitive(v, name)
        if hasattr(v, "jaxpr"):
            return _count_primitive(v.jaxpr, name)
        if isinstance(v, (list, tuple)):
            return sum(sub(item) for item in v)
        return 0

    count = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == name:
            count += 1
        count += sum(sub(v) for v in eqn.params.values())
    return count


def test_pencil_solve_is_four_all_to_alls():
    """The communication contract of the pencil decomposition: exactly 4
    tiled all_to_all transposes per direct solve (blocks -> j-pencils,
    j-pencils -> i-pencils over the combined ("x","y") axis, and the two
    inverses) and zero ppermutes — the solve never touches the halo
    machinery."""
    prm = _params()
    mesh = topology.make_grid_mesh(8, prm.i_max, prm.j_max)
    px, py = mesh.devices.shape
    li, lj = prm.i_max // px, prm.j_max // py
    inner = fftmod.make_sharded_inner(prm, li, lj)
    from jax.sharding import PartitionSpec as P

    mapped = shard_map(
        lambda r: inner(r, 1), mesh=mesh,
        in_specs=(P("x", "y"),), out_specs=P("x", "y"), check_vma=False)
    spec = jax.ShapeDtypeStruct((px * (li + 2), py * (lj + 2)), jnp.float32)
    jaxpr = jax.make_jaxpr(mapped)(spec)
    assert _count_primitive(jaxpr.jaxpr, "all_to_all") == 4
    assert _count_primitive(jaxpr.jaxpr, "ppermute") == 0


def test_sharded_fft_non_square_grid():
    """Rectangular interiors pencil-decompose too (different lam_i/lam_j
    and pencil widths per axis)."""
    prm = _params(i_max=32, j_max=64)
    mesh = topology.make_grid_mesh(8, prm.i_max, prm.j_max)
    sh_state, sh_stats = solve_sharded(prm, mesh=mesh, pressure_method="fft")
    st, ss = solve(prm, pressure_method="fft")
    assert int(sh_stats.steps) == int(ss.steps)
    assert int(sh_stats.sor_failures) == 0
    np.testing.assert_allclose(
        np.asarray(sh_state.u)[1:-1, 1:-1], np.asarray(st.u)[1:-1, 1:-1],
        atol=1e-5)


def test_sharded_fft_1d_mesh():
    """The pencil decomposition degenerates cleanly on 1xN / Nx1 meshes
    (the combined-axis transpose carries the full permutation; the manual
    sharded backend is the supported route for 1D meshes — unlike gspmd,
    which rejects them)."""
    from jax.sharding import Mesh

    prm = _params()
    st, ss = solve(prm, pressure_method="fft")
    for shape in [(1, 8), (8, 1)]:
        mesh = Mesh(np.array(jax.devices()[:8]).reshape(shape), ("x", "y"))
        sh_state, sh_stats = solve_sharded(prm, mesh=mesh,
                                           pressure_method="fft")
        assert int(sh_stats.steps) == int(ss.steps), shape
        assert int(sh_stats.sor_failures) == 0, shape
        np.testing.assert_allclose(
            np.asarray(sh_state.u)[1:-1, 1:-1],
            np.asarray(st.u)[1:-1, 1:-1], atol=1e-5,
            err_msg=f"mesh {shape}")


def test_sharded_methods_require_x64():
    """Without global x64 the refinement outer's astype(float64) silently
    stays f32 and can never meet the stopping rule — the sharded backend
    must raise eagerly like the single-chip methods do (ops/sor.py), for
    every refined method; compensated lifts the requirement."""
    from navierstokes_parallel_tpu.parallel.sharded import (
        make_sharded_step_fn,
    )

    prm = _params()
    mesh = topology.make_grid_mesh(8, prm.i_max, prm.j_max)
    with jax.enable_x64(False):
        for method in ("fft", "mg", "cg"):
            with pytest.raises(ValueError, match="x64"):
                make_sharded_step_fn(prm, mesh, pressure_method=method)
        # compensated outer: accepted (builds; execution covered elsewhere).
        make_sharded_step_fn(prm.replace(outer_precision="compensated"),
                             mesh, pressure_method="fft")


def test_rfft_lowering_probe_falls_back(monkeypatch):
    """If the rfft butterfly fails to lower (a backend failure mode the
    probe compile catches), the sharded pencil route must fall back
    to matmul instead of aborting the whole solve compile."""
    def boom(x):
        raise RuntimeError("FFT unsupported size (simulated)")

    monkeypatch.setattr(fftmod, "_RFFT_OK_CACHE", {})
    monkeypatch.setattr(fftmod, "_dct2_rfft", boom)
    assert fftmod._rfft_lowering_ok(48) is False
    # Result is cached: a second query must not re-probe (boom again).
    assert fftmod._rfft_lowering_ok(48) is False

    monkeypatch.undo()
    monkeypatch.setattr(fftmod, "_RFFT_OK_CACHE", {})
    assert fftmod._rfft_lowering_ok(48) is True


def test_sharded_fft_precision_knob():
    """fft_precision plumbs into the pencil matmul transforms too: the
    solve still meets the contract (on CPU Precision is accuracy-neutral,
    so this pins plumbing; the trade itself is measured on the card)."""
    prm = _params(fft_precision="default")
    mesh = topology.make_grid_mesh(8, prm.i_max, prm.j_max)
    with fftmod_route_forced(False):
        sh_state, sh_stats = solve_sharded(prm, mesh=mesh,
                                           pressure_method="fft")
    assert int(sh_stats.sor_failures) == 0
    st, _ = solve(prm.replace(fft_precision="highest"),
                  pressure_method="fft")
    assert_close_reference_contract(np.asarray(sh_state.u),
                                    np.asarray(st.u))


class fftmod_route_forced:
    """Force PREFER_RFFT for a block (matmul=False exercises the precision
    plumbing; restores the module global afterwards)."""

    def __init__(self, prefer):
        self.prefer = prefer

    def __enter__(self):
        self.saved = fftmod.PREFER_RFFT
        fftmod.PREFER_RFFT = self.prefer

    def __exit__(self, *exc):
        fftmod.PREFER_RFFT = self.saved
