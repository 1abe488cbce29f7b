"""Communication-avoiding deep-halo sharded inner stage (parallel/deep_halo).

The contract: ppermute a 2K-deep halo once, then run K local red-black
sweeps per shard with no exchange — numerically identical to the
single-chip folded-Neumann inner (ulp-level; identical per-cell math)
(`sor_kernel._roll_sweeps_xla`), with the exchange count independent of the
sweep count.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from navierstokes_parallel_tpu.config import Params
from navierstokes_parallel_tpu.ops import sor_kernel
from navierstokes_parallel_tpu.parallel import deep_halo, sharded
from navierstokes_parallel_tpu.parallel.topology import (
    grid_sharding,
    local_block_dims,
    make_grid_mesh,
)

try:
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map


def _params(n, **kw):
    kw.setdefault("max_it", 100)
    return Params(problem=1, i_max=n, j_max=n, T=0.01, Re=100.0,
                  epsilon=1e-4, dtype="float32", **kw)


def _run_deep_inner(params, rhs_full, n_sweeps, n_devices=8):
    """Scatter rhs over the mesh, run the deep-halo inner in shard_map,
    gather the delta back in reference layout."""
    mesh = make_grid_mesh(n_devices, params.i_max, params.j_max)
    px, py = mesh.devices.shape
    li, lj = local_block_dims((px, py), params.i_max, params.j_max)

    def local_fn(rhs_block):
        inner = deep_halo.make_deep_inner(params, li, lj)
        return inner(rhs_block, jnp.asarray(n_sweeps, jnp.int32))

    mapped = jax.jit(shard_map(
        local_fn, mesh=mesh, in_specs=(P("x", "y"),),
        out_specs=P("x", "y"), check_vma=False,
    ))
    dims = (px, py, li, lj)
    blocks = sharded._put_blocks(
        sharded._scatter_blocks(np.asarray(rhs_full, np.float32), *dims),
        grid_sharding(mesh))
    out = mapped(blocks)
    return sharded._gather_blocks(np.asarray(out), *dims, params.shape)


@pytest.mark.parametrize("n_sweeps", [4, 7, 12])
def test_deep_inner_bit_identical_to_single_chip(n_sweeps):
    """K local sweeps on 2K-extended blocks must reproduce the single-chip
    folded-Neumann inner to ulp-level: the per-cell arithmetic is identical
    (only XLA's program-dependent FMA/fusion choices differ — measured
    <= ~1e-9 absolute over 12 sweeps), so anything beyond roundoff is a
    halo/mask/parity bug."""
    params = _params(32)
    rng = np.random.default_rng(3)
    rhs = np.zeros(params.shape, np.float32)
    rhs[1:-1, 1:-1] = rng.standard_normal((32, 32)).astype(np.float32)

    want = np.asarray(sor_kernel._roll_sweeps_xla(
        jnp.asarray(rhs), n_sweeps, params))
    got = _run_deep_inner(params, rhs, n_sweeps)
    np.testing.assert_allclose(got[1:-1, 1:-1], want[1:-1, 1:-1],
                               rtol=1e-4, atol=1e-8)


def test_deep_inner_bit_identical_padded_grid():
    """Pad-to-divisible sharding (17^2 over a (2,4) mesh) with the deep
    halos: pad cells stay inert and the true interior still matches the
    single-chip inner to ulp-level."""
    params = _params(17)
    rng = np.random.default_rng(7)
    rhs = np.zeros(params.shape, np.float32)
    rhs[1:-1, 1:-1] = rng.standard_normal((17, 17)).astype(np.float32)

    want = np.asarray(sor_kernel._roll_sweeps_xla(
        jnp.asarray(rhs), 6, params))
    got = _run_deep_inner(params, rhs, 6)
    np.testing.assert_allclose(got[1:-1, 1:-1], want[1:-1, 1:-1],
                               rtol=1e-4, atol=1e-8)


def _count_ppermutes(jaxpr) -> int:
    """Recursively count collective-permute equations in a jaxpr
    (descending into ClosedJaxpr and bare Jaxpr params alike)."""

    def sub(v):
        if hasattr(v, "eqns"):         # bare Jaxpr
            return _count_ppermutes(v)
        if hasattr(v, "jaxpr"):        # ClosedJaxpr
            return _count_ppermutes(v.jaxpr)
        if isinstance(v, (list, tuple)):
            return sum(sub(item) for item in v)
        return 0

    count = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "ppermute":
            count += 1
        count += sum(sub(v) for v in eqn.params.values())
    return count


def test_exchange_count_independent_of_sweeps():
    """The static ppermute count of the deep inner must not grow with K:
    one 4-ppermute extend for the rhs + one per chunk body — whereas the
    sync path pays 2 exchanges (8 ppermutes) inside every sweep body.
    (Counts are static/trace-time: loop bodies are traced once.)"""
    params = _params(32)
    mesh = make_grid_mesh(8, 32, 32)
    px, py = mesh.devices.shape
    li, lj = local_block_dims((px, py), 32, 32)

    def traced(k):
        p = params.replace(sor_comm_every=k)

        def local_fn(rhs_block):
            inner = deep_halo.make_deep_inner(p, li, lj)
            return inner(rhs_block, jnp.asarray(64, jnp.int32))

        mapped = shard_map(local_fn, mesh=mesh, in_specs=(P("x", "y"),),
                           out_specs=P("x", "y"), check_vma=False)
        rhs_spec = jax.ShapeDtypeStruct(
            (px * (li + 2), py * (lj + 2)), jnp.float32)
        return jax.make_jaxpr(mapped)(rhs_spec)

    count_k4 = _count_ppermutes(traced(4).jaxpr)
    count_k8 = _count_ppermutes(traced(8).jaxpr)
    # rhs extend (4) + chunk-body delta extend (4): constant in K.
    assert count_k4 == count_k8 == 8


def test_sweep_loop_has_no_collectives():
    """The K-sweep extended-block function itself must contain zero
    communication primitives (that is the whole point)."""
    params = _params(32)
    H = 8
    ext_shape = (16 + 2 * H, 8 + 2 * H)
    interior, red, black, self_coef = deep_halo._ext_masks(
        ext_shape, H, 0, 0, 32, 32, 1.0, 1.0)
    jaxpr = jax.make_jaxpr(
        lambda d, r: deep_halo._ext_sweeps_jnp(
            d, r, 8, red, black, self_coef, 1.7, 1.0, 1.0)
    )(jnp.zeros(ext_shape), jnp.zeros(ext_shape))
    assert _count_ppermutes(jaxpr.jaxpr) == 0


@pytest.mark.parametrize("method", ["rb_sor"])
def test_solve_sharded_deep_matches_oracle(method):
    """End-to-end: the sharded solve with the deep-halo inner meets the
    1e-4 oracle contract."""
    from navierstokes_parallel_tpu import oracle
    from navierstokes_parallel_tpu.utils.io import tolerance_errors

    params = _params(24, max_it=2000)
    state, stats = sharded.solve_sharded(params, pressure_method=method)
    assert int(stats.sor_failures) == 0

    want = oracle.oracle_solve(params)
    for got, ref in ((state.u, want.u), (state.v, want.v)):
        err = float(np.max(tolerance_errors(
            np.asarray(got, np.float64), ref)))
        assert err <= 1e-4, f"{method}: max comparator error {err:.3e}"


def test_solve_sharded_deep_padded_matches_oracle():
    """Deep-halo inner under pad-to-divisible sharding (17^2)."""
    from navierstokes_parallel_tpu import oracle
    from navierstokes_parallel_tpu.utils.io import tolerance_errors

    params = _params(17, max_it=3000)
    state, stats = sharded.solve_sharded(params, pressure_method="rb_sor")
    assert int(stats.sor_failures) == 0
    want = oracle.oracle_solve(params)
    err = float(np.max(tolerance_errors(np.asarray(state.u, np.float64),
                                        want.u)))
    assert err <= 1e-4


def test_rb_sor_sync_still_available_and_agrees():
    """The legacy exchange-per-half-sweep path stays available as
    rb_sor_sync and agrees with the deep path through the contract."""
    from navierstokes_parallel_tpu.utils.io import tolerance_errors

    params = _params(24, max_it=2000)
    deep, _ = sharded.solve_sharded(params, pressure_method="rb_sor")
    sync, _ = sharded.solve_sharded(params, pressure_method="rb_sor_sync")
    err = float(np.max(tolerance_errors(
        np.asarray(deep.u, np.float64), np.asarray(sync.u, np.float64))))
    assert err <= 1e-4


def test_comm_depth_clamps():
    p = _params(32)
    assert deep_halo.comm_depth(p, 16, 8) == 4          # lj//2 clamps
    assert deep_halo.comm_depth(p, 256, 256) == 8       # config value
    assert deep_halo.comm_depth(p.replace(sor_comm_every=32), 256, 256) == 32
    assert deep_halo.comm_depth(p, 2, 2) == 1


def test_sharded_mg_smoother_uses_deep_halos():
    """The sharded MG smoother must pay ONE exchange per smoothing phase
    (4 ppermutes for p + 4 for rhs), not 2 per sweep: with nu=2 sweeps the
    sync smoother would trace 2 half-sweeps x 4 ppermutes inside its sweep
    loop; the deep smoother's sweep loop has none."""
    from navierstokes_parallel_tpu.ops import mg

    params = _params(32)
    mesh = make_grid_mesh(8, 32, 32)
    px, py = mesh.devices.shape
    li, lj = local_block_dims((px, py), 32, 32)
    levels = mg.build_levels_sharded(params, li, lj)
    lvl = levels[0]
    shape = lvl[0]

    def smooth(p, rhs):
        return mg._smooth_sharded(p, rhs, lvl, 2)

    mapped = shard_map(smooth, mesh=mesh,
                       in_specs=(P("x", "y"), P("x", "y")),
                       out_specs=P("x", "y"), check_vma=False)
    spec = jax.ShapeDtypeStruct((px * shape[0], py * shape[1]), jnp.float32)
    jaxpr = jax.make_jaxpr(mapped)(spec, spec)
    # extend(p): 4 ppermutes + extend(rhs): 4; the sweep loop body: 0.
    assert _count_ppermutes(jaxpr.jaxpr) == 8
