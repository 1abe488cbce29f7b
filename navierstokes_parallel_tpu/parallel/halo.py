"""Halo exchange over the device mesh (used inside `shard_map`).

Each shard holds a (li+2, lj+2) padded block: li x lj interior plus a
one-cell halo ring.  Interior shard boundaries are refreshed with
`lax.ppermute` strip exchanges between devices; physical-domain halos are
closed by per-field boundary-condition closures (see sharded.py).  This is
the multi-chip analogue of the reference CUDA kernel's shared-memory halo
loads (src/parallel/main.cu:411-484) — except the "tile" is a whole chip's
shard and the "shared memory" is its device memory.

Exchange order is y (axis 1) first, then x (axis 0) sending full columns
*including* the freshly filled y-halo entries, so corner halo cells pick up
the diagonal neighbor's value — required by the donor-cell stencils' mixed
offsets (e.g. v[i+1][j-1] in duv_dy, integration.c:17-28).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def _shift_up(strip, axis_name):
    """Send each shard's strip to the next-higher index along axis_name;
    the lowest shard receives zeros."""
    n = lax.axis_size(axis_name)
    return lax.ppermute(strip, axis_name, [(k, k + 1) for k in range(n - 1)])


def _shift_down(strip, axis_name):
    n = lax.axis_size(axis_name)
    return lax.ppermute(strip, axis_name, [(k + 1, k) for k in range(n - 1)])


def exchange_halo(local: jax.Array, x_axis: str = "x", y_axis: str = "y") -> jax.Array:
    """Refresh all four halo strips of a padded local block from mesh
    neighbors.  Halos at physical domain edges receive zeros — callers MUST
    overwrite them with the field's boundary-condition closure."""
    # --- y direction (axis 1): exchange full rows (length li+2) -----------
    from_below = _shift_up(local[:, -2], y_axis)   # neighbor below's top row
    from_above = _shift_down(local[:, 1], y_axis)  # neighbor above's bottom row
    local = local.at[:, 0].set(from_below)
    local = local.at[:, -1].set(from_above)
    # --- x direction (axis 0): exchange full columns (length lj+2),
    # including the y-halo entries just written -> corners become diagonal
    # neighbor values.
    from_left = _shift_up(local[-2, :], x_axis)
    from_right = _shift_down(local[1, :], x_axis)
    local = local.at[0, :].set(from_left)
    local = local.at[-1, :].set(from_right)
    return local


def edge_masks(x_axis: str = "x", y_axis: str = "y"):
    """Booleans identifying this shard's position on the physical boundary."""
    xi = lax.axis_index(x_axis)
    yi = lax.axis_index(y_axis)
    return {
        "left": xi == 0,
        "right": xi == lax.axis_size(x_axis) - 1,
        "bottom": yi == 0,
        "top": yi == lax.axis_size(y_axis) - 1,
    }


def _where_set_col(arr, j, cond, values):
    return arr.at[:, j].set(jnp.where(cond, values, arr[:, j]))


def _where_set_row(arr, i, cond, values):
    return arr.at[i, :].set(jnp.where(cond, values, arr[i, :]))


def close_pressure_halo(p: jax.Array, edges) -> jax.Array:
    """Homogeneous Neumann closure at physical edges (integration.c:138-146):
    the ghost cell copies its interior neighbor.  The four GLOBAL corners are
    excluded — the serial ghost fill only writes side strips (io-visible:
    output files carry zero corners), and the masked ghost variant matches;
    halo copies of neighbor shards' ghost cells (which land on this shard's
    strip ends mid-mesh) ARE written, keeping replicas consistent without a
    second exchange."""
    ni, nj = p.shape
    col = lax.iota(jnp.int32, nj)
    row = lax.iota(jnp.int32, ni)
    col_ok = ~(edges["bottom"] & (col == 0)) & ~(edges["top"] & (col == nj - 1))
    row_ok = ~(edges["left"] & (row == 0)) & ~(edges["right"] & (row == ni - 1))
    p = _where_set_row(p, 0, edges["left"] & col_ok, p[1, :])
    p = _where_set_row(p, -1, edges["right"] & col_ok, p[-2, :])
    p = _where_set_col(p, 0, edges["bottom"] & row_ok, p[:, 1])
    p = _where_set_col(p, -1, edges["top"] & row_ok, p[:, -2])
    return p


def neumann_or_exchange(p: jax.Array) -> jax.Array:
    """The sharded ghost_fn for the SOR solver: ppermute interior halos,
    Neumann-close physical ones.  Assumes the physical boundary coincides
    with the block edges (evenly-divisible grids); for padded blocks use
    `make_masked_ghost_fn`."""
    edges = edge_masks()
    return close_pressure_halo(exchange_halo(p), edges)


def padded_global_indices(shape, x_axis: str = "x", y_axis: str = "y"):
    """(gi, gj) global PADDED-layout indices for every cell of a padded local
    block (halo ring included): gi = shard_origin_x + local_index, so gi == 0
    is the global left ghost column and gi == i_max + 1 the right ghost —
    which, when the interior is padded to divisibility, may lie strictly
    inside a block rather than on its halo ring."""
    li, lj = shape[0] - 2, shape[1] - 2
    ox = lax.axis_index(x_axis) * li
    oy = lax.axis_index(y_axis) * lj
    gi = lax.broadcasted_iota(jnp.int32, shape, 0) + ox
    gj = lax.broadcasted_iota(jnp.int32, shape, 1) + oy
    return gi, gj


def make_masked_ghost_fn(i_max: int, j_max: int):
    """ghost_fn for (possibly padded) sharded blocks: ppermute halo exchange,
    then the homogeneous-Neumann closure (integration.c:138-146) written as
    global-index-masked roll copies — correct wherever the TRUE physical
    boundary falls, block edge or block interior.  Junk cells beyond the
    ghost ring (gi > i_max+1 / gj > j_max+1, present only when the grid is
    padded to divisibility) are zeroed so reductions and sweeps stay clean.

    Masked writes are applied at halo positions too, which keeps every
    shard's halo copy of a ghost cell consistent with its owner without a
    second exchange (the roll source is valid at all positions that any
    in-bounds cell ever reads)."""

    def ghost(p: jax.Array) -> jax.Array:
        p = exchange_halo(p)
        gi, gj = padded_global_indices(p.shape)
        in_j = (gj >= 1) & (gj <= j_max)
        in_i = (gi >= 1) & (gi <= i_max)
        p = jnp.where((gi == 0) & in_j, jnp.roll(p, -1, 0), p)
        p = jnp.where((gi == i_max + 1) & in_j, jnp.roll(p, 1, 0), p)
        p = jnp.where(in_i & (gj == 0), jnp.roll(p, -1, 1), p)
        p = jnp.where(in_i & (gj == j_max + 1), jnp.roll(p, 1, 1), p)
        return jnp.where((gi > i_max + 1) | (gj > j_max + 1),
                         jnp.zeros_like(p), p)

    return ghost
