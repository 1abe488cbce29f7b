"""Geometric multigrid pressure solver (method="mg").

The reference (and our parity paths) solve the pressure-Poisson system with
plain SOR, which needs O(n) sweeps per digit of accuracy — at 2048^2 the
reference burns up to 20000 sweeps per time step *and still fails its own
convergence test* (max_it, silently ignored, main.c:123).  Multigrid is the
textbook fix: a V-cycle contracts the error by ~5-10x independent of grid
size, so the same stopping rule L2(res) <= eps*(||p0||+1.5) is met in a
handful of cycles instead of thousands of sweeps.

Design: cell-centered V(2,2)-cycle on the homogeneous-Neumann 5-point
Laplacian.

  * smoother: red-black Gauss-Seidel (omega=1) in the roll+self-coefficient
    formulation (docs/numerics.md) — the MG smoother is deliberately NOT the
    config's over-relaxed omega, which is a poor smoother;
  * restriction: 2x2 full-weighting average (cell-centered);
  * prolongation: piecewise-constant injection;
  * coarse solve: a few dozen red-black sweeps on the <=8^2 grid.

Measured negative results (kept as the record, like the bf16 sweeps in
docs/performance.md): cell-centered BILINEAR prolongation (0.75/0.25
separable stencil, Neumann clamp) *increases* cavity-workload cycle counts
(18->20 at 128^2, 31->38 at 512^2 — the FW-restriction/constant-injection
pair already satisfies the transfer-order rule m_r + m_p > 2m for the
2nd-order operator, and the smoother-limited cycle gains nothing from the
smoother transfer); V(1,1) cuts smoothing work/cycle in half but needs
1.5x the cycles (24 vs 16 at 256^2), a wash on sweep work that LOSES on
per-cycle f64 outer passes; smoother over-relaxation omega=1.15 saves ~6%
cycles at V(2,2) but destabilizes V(1,1) (27 cycles) and omega=1.3
diverges toward 50 — omega=1 stays.  Chaining cycles per outer pass (the
win that did survive) is `Params.mg_cycles_per_outer`.

It plugs into the SAME mixed-precision refinement outer loop as SOR
(ops/sor.py): the f64 master pressure, the f64 defect, and the exact
reference convergence test are unchanged — one V-cycle on the f32
correction replaces K red-black sweeps.  `iterations` then counts V-cycles.
All levels are static python structure, so the whole cycle jits into one
fused program; everything runs on any backend (CPU/GPU, and under shard_map
it would need halo-aware ops — single-chip only for now).
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..config import Params


class _Level(NamedTuple):
    shape: Tuple[int, int]   # padded (n_i + 2, n_j + 2)
    dx2_inv: float
    dy2_inv: float


def build_levels(params: Params, min_cells: int = 8) -> List[_Level]:
    """Coarsen by 2 in both directions while both stay even and >= min."""
    ni, nj = params.i_max, params.j_max
    dx2_inv = 1.0 / (params.dx * params.dx)
    dy2_inv = 1.0 / (params.dy * params.dy)
    levels = [_Level((ni + 2, nj + 2), dx2_inv, dy2_inv)]
    while (
        ni % 2 == 0 and nj % 2 == 0 and ni // 2 >= min_cells and nj // 2 >= min_cells
    ):
        ni //= 2
        nj //= 2
        dx2_inv /= 4.0
        dy2_inv /= 4.0
        levels.append(_Level((ni + 2, nj + 2), dx2_inv, dy2_inv))
    return levels


@functools.lru_cache(maxsize=None)
def _masks(shape: Tuple[int, int], dx2_inv: float, dy2_inv: float):
    """(red, black, self_coef) interior/parity masks for a padded level.

    Built in NumPy and cached (concrete values are safe to reuse across jit
    traces; jnp arrays built inside a trace would leak tracers)."""
    import numpy as np

    ni, nj = shape
    ii, jj = np.meshgrid(np.arange(ni), np.arange(nj), indexing="ij")
    interior = (ii >= 1) & (ii <= ni - 2) & (jj >= 1) & (jj <= nj - 2)
    par = (ii + jj) % 2
    self_coef = (
        ((ii == 1).astype(np.float32) + (ii == ni - 2).astype(np.float32))
        * np.float32(dx2_inv)
        + ((jj == 1).astype(np.float32) + (jj == nj - 2).astype(np.float32))
        * np.float32(dy2_inv)
    )
    return interior & (par == 0), interior & (par == 1), self_coef


def _neighbor_sum(p, lvl: _Level, self_coef):
    return (
        (jnp.roll(p, 1, 0) + jnp.roll(p, -1, 0)) * lvl.dx2_inv
        + (jnp.roll(p, 1, 1) + jnp.roll(p, -1, 1)) * lvl.dy2_inv
        + p * self_coef
    )


def _smooth(p, rhs, lvl: _Level, n_sweeps: int, omega: float = 1.0):
    red, black, self_coef = _masks(lvl.shape, lvl.dx2_inv, lvl.dy2_inv)
    coef = omega / (2.0 * (lvl.dx2_inv + lvl.dy2_inv))

    def half(p, mask):
        nb = _neighbor_sum(p, lvl, self_coef)
        return jnp.where(mask, (1.0 - omega) * p + coef * (nb - rhs), p)

    def sweep(_, p):
        return half(half(p, red), black)

    # fori_loop keeps the jaxpr small (an unrolled 32-sweep coarse solve
    # inside the time/time-step while_loops made compiles minutes long).
    return lax.fori_loop(0, n_sweeps, sweep, p)


def ghost_zero(p):
    """Zero the ghost ring (the roll+self-coef Laplacian expects it)."""
    return jnp.zeros_like(p).at[1:-1, 1:-1].set(p[1:-1, 1:-1])


def _lap(p, lvl: _Level):
    _, _, self_coef = _masks(lvl.shape, lvl.dx2_inv, lvl.dy2_inv)
    s2 = 2.0 * (lvl.dx2_inv + lvl.dy2_inv)
    return _neighbor_sum(p, lvl, self_coef) - s2 * p


@functools.lru_cache(maxsize=None)
def _injection_matrix(n_fine: int):
    """U (n_fine x n_fine/2) with ones at (2i, i), (2i+1, i): constant
    prolongation as a matmul (0.5*U^T is the full-weighting
    restriction)."""
    import numpy as np

    m = n_fine // 2
    U = np.zeros((n_fine, m), np.float32)
    U[2 * np.arange(m), np.arange(m)] = 1.0
    U[2 * np.arange(m) + 1, np.arange(m)] = 1.0
    return U


def _restrict(r_fine, coarse_shape):
    """2x2 full-weighting average of the fine interior into a padded coarse
    array (zeros elsewhere)."""
    avg = 0.25 * lax.reduce_window(
        r_fine[1:-1, 1:-1], 0.0, lax.add, (2, 2), (2, 2), "VALID"
    )
    return jnp.zeros(coarse_shape, r_fine.dtype).at[1:-1, 1:-1].set(avg)


def _prolong(e_coarse, fine_shape):
    """Piecewise-constant injection of the coarse interior onto the fine
    interior (padded), as two matmuls: e_f = U e_c U^T.  HIGHEST
    precision keeps them float32: a GPU's default would round the
    correction to TF32."""
    interior = e_coarse[1:-1, 1:-1]
    ni, nj = fine_shape[0] - 2, fine_shape[1] - 2
    Ui = jnp.asarray(_injection_matrix(ni))
    Uj = jnp.asarray(_injection_matrix(nj))
    hp = lax.Precision.HIGHEST
    up = jnp.matmul(jnp.matmul(Ui, interior, precision=hp), Uj.T,
                    precision=hp)
    return jnp.zeros(fine_shape, e_coarse.dtype).at[1:-1, 1:-1].set(up)


def v_cycle(p, rhs, levels: List[_Level], depth: int = 0,
            nu1: int = 2, nu2: int = 2, coarse_sweeps: int = 32):
    """One V(nu1, nu2) cycle on A p = rhs at `depth`; returns improved p."""
    lvl = levels[depth]
    if depth == len(levels) - 1:
        return _smooth(p, rhs, lvl, coarse_sweeps)

    p = _smooth(p, rhs, lvl, nu1)
    r = rhs - _lap(p, lvl)
    # Zero the residual's ghost ring so restriction sees interior only.
    coarse = levels[depth + 1]
    r_c = _restrict(r, coarse.shape)
    e_c = jnp.zeros(coarse.shape, p.dtype)
    e_c = v_cycle(e_c, r_c, levels, depth + 1, nu1, nu2, coarse_sweeps)
    p = p + _prolong(e_c, lvl.shape)
    return _smooth(p, rhs, lvl, nu2)


def inner_v_cycle(rhs_neg: jax.Array, n_cycles, params: Params) -> jax.Array:
    """Refinement-inner: delta = (approx A^{-1}) rhs_neg via `n_cycles`
    V-cycles from delta = 0 (n_cycles is traced; typically 1 per outer)."""
    levels = build_levels(params)
    rhs = rhs_neg.astype(jnp.float32)

    def one(_, d):
        return v_cycle(d, rhs, levels)

    # NOTE: for the standard refinement flow n_cycles == 1; the fori_loop
    # keeps the accounting exact if a caller asks for more.  Subsequent
    # cycles operate on the residual-corrected state implicitly because
    # v_cycle takes the current d.
    return lax.fori_loop(0, jnp.asarray(n_cycles, jnp.int32), one,
                         jnp.zeros(params.shape, jnp.float32))


# ---------------------------------------------------------------------------
# Sharded multigrid (used inside shard_map; see parallel/sharded.py).
#
# Coarsening by 2 keeps the block decomposition aligned: restriction (2x2
# average) and prolongation (constant injection) act on each shard's local
# interior with NO communication at all; only the smoother and the level
# residual need halo exchanges (lax.ppermute), and the outer defect norm is
# psum'd by the refinement loop.  Masks/self-coefficients are built from
# *global* indices via the shard's mesh coordinates so physical-boundary
# Neumann folding and the checkerboard stay globally consistent.
# ---------------------------------------------------------------------------


def build_levels_sharded(params: Params, li: int, lj: int,
                         min_local: int = 4):
    """Per-shard level list: (local padded shape, global interior dims,
    level dx2_inv/dy2_inv).  Coarsen while the LOCAL block stays even."""
    gi, gj = params.i_max, params.j_max
    dx2_inv = 1.0 / (params.dx * params.dx)
    dy2_inv = 1.0 / (params.dy * params.dy)
    levels = [((li + 2, lj + 2), (gi, gj), dx2_inv, dy2_inv)]
    while (
        li % 2 == 0 and lj % 2 == 0
        and li // 2 >= min_local and lj // 2 >= min_local
    ):
        li //= 2; lj //= 2; gi //= 2; gj //= 2
        dx2_inv /= 4.0; dy2_inv /= 4.0
        levels.append(((li + 2, lj + 2), (gi, gj), dx2_inv, dy2_inv))
    return levels


def _sharded_level_masks(shape, g_dims, dx2_inv, dy2_inv):
    """Traced masks from global indices (shard origin via axis_index)."""
    ni_l, nj_l = shape  # local padded
    i_max_l, j_max_l = g_dims
    li_l, lj_l = ni_l - 2, nj_l - 2
    ox = lax.axis_index("x") * li_l
    oy = lax.axis_index("y") * lj_l
    gi = lax.broadcasted_iota(jnp.int32, shape, 0) + ox  # global padded idx
    gj = lax.broadcasted_iota(jnp.int32, shape, 1) + oy
    interior = (gi >= 1) & (gi <= i_max_l) & (gj >= 1) & (gj <= j_max_l) & (
        lax.broadcasted_iota(jnp.int32, shape, 0) >= 1
    ) & (lax.broadcasted_iota(jnp.int32, shape, 0) <= ni_l - 2) & (
        lax.broadcasted_iota(jnp.int32, shape, 1) >= 1
    ) & (lax.broadcasted_iota(jnp.int32, shape, 1) <= nj_l - 2)
    par = (gi + gj) % 2
    f32 = jnp.float32
    self_coef = (
        ((gi == 1).astype(f32) + (gi == i_max_l).astype(f32)) * dx2_inv
        + ((gj == 1).astype(f32) + (gj == j_max_l).astype(f32)) * dy2_inv
    )
    return interior & (par == 0), interior & (par == 1), self_coef


def _nb_sum_sh(d, dx2_inv, dy2_inv, self_coef):
    return (
        (jnp.roll(d, 1, 0) + jnp.roll(d, -1, 0)) * dx2_inv
        + (jnp.roll(d, 1, 1) + jnp.roll(d, -1, 1)) * dy2_inv
        + d * self_coef
    )


def _smooth_sharded_deep(p, rhs, level, n_sweeps: int, omega: float):
    """Communication-avoiding smoother (parallel/deep_halo.py applied to a
    warm start): ONE 2n-deep halo exchange of p and rhs, then n local
    red-black sweeps on the extended block with zero communication.
    Mathematically identical to the exchange-per-half-sweep smoother — ring
    cells of the extended block replicate the neighbor's interior cells and
    update in lockstep with them, so the values a half-sweep reads are
    exactly the values an exchange would have delivered (contamination from
    the stale ring edge advances one cell per half-sweep and never reaches
    the central (li, lj) core within n <= H/2 sweeps)."""
    from ..parallel import deep_halo as dh

    shape, g_dims, dx2_inv, dy2_inv = level
    li, lj = shape[0] - 2, shape[1] - 2
    H = 2 * n_sweeps
    i_max_l, j_max_l = g_dims
    ox = lax.axis_index("x") * li
    oy = lax.axis_index("y") * lj
    ext_shape = (li + 2 * H, lj + 2 * H)
    interior, red, black, self_coef = dh._ext_masks(
        ext_shape, H, ox, oy, i_max_l, j_max_l, dx2_inv, dy2_inv)

    def clean_extend(local_int):
        ext = dh.extend_block(local_int, H)
        return jnp.where(interior, ext, jnp.zeros_like(ext))

    p_ext = clean_extend(p[1:-1, 1:-1])
    rhs_ext = clean_extend(rhs[1:-1, 1:-1])
    out = dh._ext_sweeps_jnp(p_ext, rhs_ext, n_sweeps, red, black,
                             self_coef, omega, dx2_inv, dy2_inv)
    return p.at[1:-1, 1:-1].set(out[H: H + li, H: H + lj])


def _smooth_sharded(p, rhs, level, n_sweeps, omega: float = 1.0):
    """Red-black sweeps on a local block.  When the 2n-deep halo fits the
    neighbor block (single-hop exchange), the deep-halo smoother pays ONE
    exchange for all n sweeps; otherwise fall back to a ppermute halo
    refresh before each half-sweep (physical-edge halos need no refresh
    either way: the self-coefficient folds the Neumann BC, and rolled-in
    garbage is masked out)."""
    from ..parallel import halo

    shape, g_dims, dx2_inv, dy2_inv = level
    li, lj = shape[0] - 2, shape[1] - 2
    if isinstance(n_sweeps, int) and 2 * n_sweeps <= min(li, lj):
        return _smooth_sharded_deep(p, rhs, level, n_sweeps, omega)

    red, black, self_coef = _sharded_level_masks(shape, g_dims, dx2_inv, dy2_inv)
    coef = omega / (2.0 * (dx2_inv + dy2_inv))

    def half(p, mask):
        p = halo.exchange_halo(p)
        nb = _nb_sum_sh(p, dx2_inv, dy2_inv, self_coef)
        return jnp.where(mask, (1.0 - omega) * p + coef * (nb - rhs), p)

    def sweep(_, p):
        return half(half(p, red), black)

    return lax.fori_loop(0, n_sweeps, sweep, p)


def _lap_sharded(p, level):
    from ..parallel import halo

    shape, g_dims, dx2_inv, dy2_inv = level
    _, _, self_coef = _sharded_level_masks(shape, g_dims, dx2_inv, dy2_inv)
    p = halo.exchange_halo(p)
    return _nb_sum_sh(p, dx2_inv, dy2_inv, self_coef) - 2.0 * (
        dx2_inv + dy2_inv
    ) * p


def _coarse_solve_replicated(p, rhs, level, nu1, nu2, coarse_sweeps):
    """Coarsest-sharded-level solve WITHOUT a per-shard cell floor: all-gather
    the (tiny) coarse level onto every shard, continue the V-cycle recursion
    on the replicated global array down to the usual <=8^2 coarse grid, and
    slice the local block back out.

    The gather is cheap — by the time the per-shard block hits the local
    floor the whole level is a few KB — and it removes the round-1 weakness
    where sharded MG's coarse-grid correction degraded with device count
    (the coarse solve used to be a fixed number of halo-exchanged sweeps on
    whatever local size remained)."""
    shape, g_dims, dx2_inv, dy2_inv = level
    li, lj = shape[0] - 2, shape[1] - 2
    gi_n, gj_n = g_dims

    def gather_global(arr):
        tile = arr[1:-1, 1:-1]
        if gi_n > li:
            tile = lax.all_gather(tile, "x", axis=0, tiled=True)
        if gj_n > lj:
            tile = lax.all_gather(tile, "y", axis=1, tiled=True)
        return jnp.zeros((gi_n + 2, gj_n + 2), arr.dtype).at[1:-1, 1:-1].set(
            tile)

    p_g = gather_global(p)
    rhs_g = gather_global(rhs)

    glevels = [_Level((gi_n + 2, gj_n + 2), dx2_inv, dy2_inv)]
    ni, nj, d2x, d2y = gi_n, gj_n, dx2_inv, dy2_inv
    while ni % 2 == 0 and nj % 2 == 0 and ni // 2 >= 8 and nj // 2 >= 8:
        ni //= 2; nj //= 2; d2x /= 4.0; d2y /= 4.0
        glevels.append(_Level((ni + 2, nj + 2), d2x, d2y))

    e_g = v_cycle(p_g, rhs_g, glevels, nu1=nu1, nu2=nu2,
                  coarse_sweeps=coarse_sweeps)

    ox = lax.axis_index("x") * li
    oy = lax.axis_index("y") * lj
    return lax.dynamic_slice(e_g, (ox, oy), (li + 2, lj + 2))


def v_cycle_sharded(p, rhs, levels, depth: int = 0, nu1: int = 2,
                    nu2: int = 2, coarse_sweeps: int = 32):
    lvl = levels[depth]
    if depth == len(levels) - 1:
        return _coarse_solve_replicated(p, rhs, lvl, nu1, nu2, coarse_sweeps)
    p = _smooth_sharded(p, rhs, lvl, nu1)
    r = rhs - _lap_sharded(p, lvl)
    r_c = _restrict(r, levels[depth + 1][0])
    e_c = jnp.zeros(levels[depth + 1][0], p.dtype)
    e_c = v_cycle_sharded(e_c, r_c, levels, depth + 1, nu1, nu2,
                          coarse_sweeps)
    p = p + _prolong(e_c, lvl[0])
    return _smooth_sharded(p, rhs, lvl, nu2)


def make_sharded_cg_inner(params: Params, li: int, lj: int):
    """inner_fn for the refinement loop: n conjugate-gradient iterations on
    B x = -b (B = -A, SPD for the Neumann Laplacian) over local padded
    blocks — ppermute-halo Laplacian (`_lap_sharded`), psum'd dot products.
    Works on padded (non-divisible) grids: every CG vector is masked to the
    TRUE local interior, so pad cells and the (neighbor-duplicating) halo
    ring contribute neither to the operator nor to the inner products."""
    from ..parallel import halo
    from ..parallel.topology import MESH_AXES

    shape = (li + 2, lj + 2)
    level = (shape, (params.i_max, params.j_max),
             1.0 / (params.dx * params.dx), 1.0 / (params.dy * params.dy))

    def inner(rhs_neg, n_iters):
        f32 = jnp.float32
        gi, gj = halo.padded_global_indices(shape)
        aa = lax.broadcasted_iota(jnp.int32, shape, 0)
        bb = lax.broadcasted_iota(jnp.int32, shape, 1)
        valid = (
            (gi >= 1) & (gi <= params.i_max)
            & (gj >= 1) & (gj <= params.j_max)
            & (aa >= 1) & (aa <= li) & (bb >= 1) & (bb <= lj)
        )

        def mask(x):
            return jnp.where(valid, x, jnp.zeros_like(x))

        def B(x):
            return mask(-_lap_sharded(x, level))

        def dot(a, c):
            return lax.psum(jnp.sum(a * c), MESH_AXES)

        b = mask(rhs_neg.astype(f32))
        x0 = jnp.zeros(shape, f32)
        r0 = -b
        rs0 = dot(r0, r0)

        def body(_, carry):
            x, r, d, rs = carry
            Bd = B(d)
            denom = dot(d, Bd)
            alpha = jnp.where(denom > 0, rs / denom, 0.0)
            x = x + alpha * d
            r = r - alpha * Bd
            rs_new = dot(r, r)
            beta = jnp.where(rs > 0, rs_new / rs, 0.0)
            d = r + beta * d
            return x, r, d, rs_new

        x, _, _, _ = lax.fori_loop(
            0, jnp.asarray(n_iters, jnp.int32), body, (x0, r0, r0, rs0)
        )
        return x

    return inner


def make_sharded_inner(params: Params, li: int, lj: int):
    """inner_fn(neg_res32_local_padded, n_cycles) for the refinement loop."""
    levels = build_levels_sharded(params, li, lj)

    def inner(rhs_neg, n_cycles):
        rhs = rhs_neg.astype(jnp.float32)

        def one(_, d):
            return v_cycle_sharded(d, rhs, levels)

        return lax.fori_loop(0, jnp.asarray(n_cycles, jnp.int32), one,
                             jnp.zeros(levels[0][0], jnp.float32))

    return inner
