"""Communication-avoiding sharded SOR inner stage: deep halos, K local sweeps.

The exchange-per-half-sweep sharded path pays 2 ppermute halo rounds per
red-black sweep (ops/sor.py `rb_sor_iteration` with the ppermute ghost_fn),
serializing collective latency against the sweeps themselves.  This module
applies the CUDA SOR kernel's own trick *across shards* (csrc/rb_sor.cu,
where it is applied across thread-block tiles): exchange a 2K-deep halo
ONCE, then run K complete local red-black sweeps with no communication.

Why this is exact (the same argument that makes the tiled kernel exact):
the sweeps run on an extended (li+2H, lj+2H) block whose H-deep ring holds
the neighbors' pre-chunk values.  Contamination from the stale ring edge
advances one cell per half-sweep, so after K sweeps (2K half-sweeps) with
H = 2K, the central (li, lj) cells carry exactly the values a global sweep
would produce — per-cell arithmetic is identical, so the result is
*bit-identical* to the single-chip folded-Neumann formulation
(`sor_kernel._roll_sweeps_xla`), which the tests assert.

Boundary semantics ride the same global-index machinery as the rest of the
sharded path: cells outside the TRUE global interior (physical ghosts, and
pad cells under pad-to-divisible sharding) are masked out of every update
and zeroed, and the homogeneous-Neumann ghost contribution is folded into a
per-cell self-coefficient keyed on the *global* index (as in
`sor_kernel._roll_sweeps_xla`) — so no ghost filling of any kind happens
between half-sweeps.

Communication per K sweeps: ONE deep exchange (4 ppermutes) instead of 2K
exchanges (8K ppermutes).  The reference CUDA kernel re-synchronizes its
tiles through global memory every half-sweep (main.cu:684-698); this is the
multi-chip design it could not express.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..config import Params
from .halo import _shift_down, _shift_up


def comm_depth(params: Params, li: int, lj: int) -> int:
    """Sweeps per cross-shard exchange, K: the configured
    `Params.sor_comm_every` clamped so the halo depth H = 2K fits in the
    neighbor block (the exchange is single-hop: H <= min(li, lj))."""
    return max(1, min(params.sor_comm_every, li // 2, lj // 2))


def extend_block(local: jax.Array, H: int, x_axis: str = "x",
                 y_axis: str = "y") -> jax.Array:
    """(li, lj) local interior block -> (li+2H, lj+2H) extended block whose
    H-deep ring holds the mesh neighbors' edge strips (corners from the
    diagonal neighbor via the two-stage exchange, as in halo.exchange_halo).
    Ring cells with no neighbor (physical domain edge) receive zeros —
    callers mask them via the global-index validity mask."""
    lo_y = _shift_up(local[:, -H:], y_axis)    # lower-y neighbor's top strip
    hi_y = _shift_down(local[:, :H], y_axis)   # upper-y neighbor's bottom
    mid = jnp.concatenate([lo_y, local, hi_y], axis=1)
    lo_x = _shift_up(mid[-H:, :], x_axis)
    hi_x = _shift_down(mid[:H, :], x_axis)
    return jnp.concatenate([lo_x, mid, hi_x], axis=0)


def _ext_masks(ext_shape, H, ox, oy, i_max, j_max, dx2_inv, dy2_inv):
    """Global-index masks/coefficients for an extended block.  Extended cell
    (a, b) is global interior cell (gi, gj) = (ox + a - H + 1, oy + b - H + 1)
    — the same 1-based indexing as the single-chip kernels, so the parity,
    interior mask, and folded-Neumann self-coefficient all match main.cu:490
    / `sor_kernel._roll_sweeps_xla` exactly."""
    gi = lax.broadcasted_iota(jnp.int32, ext_shape, 0) + (ox - H + 1)
    gj = lax.broadcasted_iota(jnp.int32, ext_shape, 1) + (oy - H + 1)
    interior = (gi >= 1) & (gi <= i_max) & (gj >= 1) & (gj <= j_max)
    par = (gi + gj) & 1
    red = interior & (par == 0)
    black = interior & (par == 1)
    f32 = jnp.float32
    self_coef = (
        ((gi == 1).astype(f32) + (gi == i_max).astype(f32)) * dx2_inv
        + ((gj == 1).astype(f32) + (gj == j_max).astype(f32)) * dy2_inv
    )
    return interior, red, black, self_coef


def _ext_masked_weights(ext_shape, H, ox, oy, params, dx2_inv, dy2_inv,
                        li=None, lj=None):
    """Obstacle-domain analogue of `_ext_masks`: per-cell neighbor weights
    and diagonal of the masked operator (ops/masked.py::_build_weights) on
    the extended block, rebuilt from global indices — the static rect list
    folds into the program, so no mask arrays cross shard boundaries.
    With the cut-cell closure active, each fluid-fluid weight is scaled
    by its face fraction, dynamic-sliced from the same global numpy
    constants the single-chip operator folds in (`li`/`lj` locate the
    shard inside the divisibility-padded extent)."""
    from ..ops.obstacles import aperture_active, apertures, \
        fluid_from_indices

    gi = lax.broadcasted_iota(jnp.int32, ext_shape, 0) + (ox - H + 1)
    gj = lax.broadcasted_iota(jnp.int32, ext_shape, 1) + (oy - H + 1)
    fl = fluid_from_indices(gi, gj, params)
    fl_e = fluid_from_indices(gi + 1, gj, params)
    fl_w = fluid_from_indices(gi - 1, gj, params)
    fl_n = fluid_from_indices(gi, gj + 1, params)
    fl_s = fluid_from_indices(gi, gj - 1, params)
    f32 = jnp.float32
    w_e = jnp.where(fl & fl_e, dx2_inv, jnp.zeros((), f32))
    w_w = jnp.where(fl & fl_w, dx2_inv, jnp.zeros((), f32))
    w_n = jnp.where(fl & fl_n, dy2_inv, jnp.zeros((), f32))
    w_s = jnp.where(fl & fl_s, dy2_inv, jnp.zeros((), f32))
    if aperture_active(params):
        ap = apertures(params)

        def cover(arr_np):
            # Array covering global index range [-H, N_pad + H + 1]
            # (position = g + H): ext-block slices can start H-1 cells
            # before the origin and end H past the padded extent.
            npx = lax.axis_size("x") * li
            npy = lax.axis_size("y") * lj
            full = np.zeros((npx + 2 * H + 2, npy + 2 * H + 2), np.float64)
            full[H : H + arr_np.shape[0], H : H + arr_np.shape[1]] = arr_np
            return jnp.asarray(full, f32)

        au_cov, av_cov = cover(ap.au), cover(ap.av)
        # Ext cell (a, b) is global (gi, gj) = (ox - H + 1 + a, ...);
        # au[gi, gj] sits at cover position gi + H -> slice start ox + 1.
        w_e = w_e * lax.dynamic_slice(au_cov, (ox + 1, oy + 1), ext_shape)
        w_w = w_w * lax.dynamic_slice(au_cov, (ox, oy + 1), ext_shape)
        w_n = w_n * lax.dynamic_slice(av_cov, (ox + 1, oy + 1), ext_shape)
        w_s = w_s * lax.dynamic_slice(av_cov, (ox + 1, oy), ext_shape)
    diag = w_e + w_w + w_n + w_s
    diag = jnp.where(diag > 0.0, diag, jnp.ones((), f32))
    par = (gi + gj) & 1
    return fl, (w_e, w_w, w_n, w_s, diag), fl & (par == 0), fl & (par == 1)


def _ext_sweeps_masked(delta_ext, rhs_ext, ns, weights, red, black, omega):
    """ns masked red-black sweeps on the extended block — the per-cell
    arithmetic of ops/masked.py::masked_rb_iteration (diag form), so a
    sharded masked solve matches the single-chip masked solver cell for
    cell.  Same stale-ring containment argument as `_ext_sweeps_jnp`."""
    w_e, w_w, w_n, w_s, diag = weights

    def half(d, mask):
        nb = (jnp.roll(d, -1, 0) * w_e + jnp.roll(d, 1, 0) * w_w
              + jnp.roll(d, -1, 1) * w_n + jnp.roll(d, 1, 1) * w_s)
        return jnp.where(mask, (1.0 - omega) * d
                         + (omega / diag) * (nb - rhs_ext), d)

    def sweep(_, d):
        return half(half(d, red), black)

    return lax.fori_loop(0, ns, sweep, delta_ext)


def _ext_sweeps_jnp(delta_ext, rhs_ext, ns, red, black, self_coef, omega,
                    dx2_inv, dy2_inv):
    """ns red-black sweeps on the extended block — NO collectives, no ghost
    fill (folded Neumann).  Identical per-cell arithmetic to
    sor_kernel._roll_sweeps_xla; the wrap-around of the rolls lands only in
    ring cells whose pollution never reaches the central (li, lj) core
    within ns <= H/2 sweeps."""
    coef = omega / (2.0 * (dx2_inv + dy2_inv))

    def half(d, mask):
        nb = (
            (jnp.roll(d, 1, 0) + jnp.roll(d, -1, 0)) * dx2_inv
            + (jnp.roll(d, 1, 1) + jnp.roll(d, -1, 1)) * dy2_inv
            + d * self_coef
        )
        return jnp.where(mask, (1.0 - omega) * d + coef * (nb - rhs_ext), d)

    def sweep(_, d):
        return half(half(d, red), black)

    return lax.fori_loop(0, ns, sweep, delta_ext)


def make_deep_inner(params: Params, li: int, lj: int):
    """Build `inner_fn(rhs_full, n_sweeps) -> delta_full` for
    `sor._solve_pressure_refined` running inside shard_map: the
    communication-avoiding sharded inner stage.

    rhs_full / delta_full are (li+2, lj+2) padded local blocks (the
    refinement solver's layout); only their interiors are meaningful here
    (the deep exchange rebuilds everything else).
    """
    K = comm_depth(params, li, lj)
    H = 2 * K
    f32 = jnp.float32
    dx2_inv = jnp.asarray(1.0 / (params.dx * params.dx), f32)
    dy2_inv = jnp.asarray(1.0 / (params.dy * params.dy), f32)
    omega = jnp.asarray(params.omega, f32)
    i_max, j_max = params.i_max, params.j_max
    ext_shape = (li + 2 * H, lj + 2 * H)

    def inner_fn(rhs_full, n_sweeps):
        ox = lax.axis_index("x") * li
        oy = lax.axis_index("y") * lj
        interior, red, black, self_coef = _ext_masks(
            ext_shape, H, ox, oy, i_max, j_max, dx2_inv, dy2_inv)
        if params.obstacles:
            # Masked (flag-field) operator: rebuild per-cell neighbor
            # weights on the extended block and run the diag-form sweeps
            # of ops/masked.py — the sharded twin of the single-chip
            # masked solver.  The interior mask below still governs the
            # clean_extend zeroing (solid cells carry zero rhs/delta by
            # construction: mask_rhs zeroed them and the sweeps never
            # update non-fluid cells).
            _, weights, red, black = _ext_masked_weights(
                ext_shape, H, ox, oy, params, dx2_inv, dy2_inv, li, lj)

        def clean_extend(local_int):
            ext = extend_block(local_int.astype(f32), H)
            # Zero everything outside the true global interior: physical
            # ghosts (folded into self_coef), pad cells, and the zero-filled
            # no-neighbor ring — exactly the single-chip kernels' zero ghost
            # ring, generalized.
            return jnp.where(interior, ext, jnp.zeros_like(ext))

        rhs_ext = clean_extend(rhs_full[1:-1, 1:-1])

        n_sweeps = jnp.asarray(n_sweeps, jnp.int32)
        n_chunks = -(-n_sweeps // K)

        if params.obstacles:
            def ext_sweeps(delta_ext, ns):
                return _ext_sweeps_masked(delta_ext, rhs_ext, ns, weights,
                                          red, black, omega)
        else:
            def ext_sweeps(delta_ext, ns):
                return _ext_sweeps_jnp(delta_ext, rhs_ext, ns, red, black,
                                       self_coef, omega, dx2_inv, dy2_inv)

        def chunk(c, delta_int):
            ns = jnp.minimum(K, n_sweeps - c * K).astype(jnp.int32)
            delta_ext = clean_extend(delta_int)     # ONE exchange / K sweeps
            delta_ext = ext_sweeps(delta_ext, ns)
            return delta_ext[H: H + li, H: H + lj]

        delta_int = lax.fori_loop(0, n_chunks, chunk,
                                  jnp.zeros((li, lj), f32))
        return jnp.zeros((li + 2, lj + 2), f32).at[1:-1, 1:-1].set(delta_int)

    return inner_fn
