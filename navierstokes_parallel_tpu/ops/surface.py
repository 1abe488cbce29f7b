"""Free-surface (marker-and-cell) machinery: traced flag fields, surface
boundary conditions, and the Dirichlet-anchored masked pressure solve.

This restores the free-boundary capability of the serial lineage (Griebel
et al. 1998 ch. 8: flag fields from marker particles, surface cells, the
p=0 atmospheric condition) that the reference repo dropped entirely — and
it is the "M" in MAC that `particles.py` makes possible.  The vectorized
formulation replaces the serial code's per-cell 16-way neighbor case
analysis with three vectorized passes over static-shaped masks:

  * The flag field is a *traced* bool array rebuilt every step from a
    scatter-add of particle counts — so ONE compiled XLA program serves
    the entire evolving geometry (the serial codes re-run branchy C over
    new flags each step; a CUDA port would re-upload flag buffers).
  * Surface-cell velocity BCs are a single divergence-zeroing correction:
    each surface cell distributes its residual divergence equally over its
    free faces (faces toward empty cells).  For one empty neighbor this IS
    the book's discrete-continuity rule (eq. 8.10); for 2/3/4 empty
    neighbors it is the symmetric generalization of the book's case table,
    and it zeroes the cell divergence EXACTLY in every case (each free
    face has a unique fluid owner, so corrections never collide).
  * The pressure Poisson problem keeps only BULK fluid cells (fluid cells
    with no empty neighbor) as unknowns; surface cells carry the Dirichlet
    atmospheric condition p = 0 (Griebel eq. 8.8 with surface tension and
    the viscous normal stress neglected).  The Dirichlet anchor removes
    the Neumann null space, so the solve needs no deflation.  The operator
    is ops/masked.py's neighbor-weight form with TRACED weights — the
    masked red-black sweeps, residual, and the f64-master/f32-correction
    refinement outer are reused verbatim (they only ever jnp.asarray the
    weight fields, so numpy constants and traced arrays both work).

Obstacle flag fields (Params.obstacles) COMPOSE with free surfaces:
obstacle cells are excluded from the interior in cell_flags, so they act
exactly like the ghost ring (wall semantics) everywhere downstream — the
traced pressure weights drop them (homogeneous Neumann), they never make
a fluid neighbor a surface cell, and the continuation never redefines
their faces.  models/freesurface.py applies the obstacle velocity BCs
(ops/obstacles.py) alongside the container-wall BCs each step; particle
advection deactivates markers that enter a solid cell (particles.py).
Validated by exact domain equivalence (obstacle-blocked strip == smaller
container) and submerged-block hydrostatics in tests/test_freesurface.py.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..config import Params
from .sor import NORM_OFFSET, SORResult, _checkerboard
from . import masked


class Flags(NamedTuple):
    """Per-step cell classification, padded (i_max+2, j_max+2) arrays.
    The ghost ring is neither fluid nor empty (walls)."""

    fluid: jax.Array    # interior cell containing >= 1 active particle
    empty: jax.Array    # interior cell with no particle
    surface: jax.Array  # fluid cell with >= 1 empty 4-neighbor
    bulk: jax.Array     # fluid cell with no empty neighbor (pressure unknown)
    fill: jax.Array     # fraction of the cell occupied by fluid, in [0, 1]


def cell_flags(x: jax.Array, y: jax.Array, active: jax.Array,
               params: Params, ppc: Optional[int] = None,
               min_count: int = 1) -> Flags:
    """Flag field from particle positions (Griebel sect. 8.1: a cell is
    fluid iff it contains a marker particle).  One scatter-add over all
    particles; inactive particles do not count.  `ppc` is the seeding
    density (particles per cell AXIS, defaults to
    params.particles_per_cell — the density the setups record):
    count/ppc^2 estimates the cell's fill fraction, the sub-cell surface
    position the interpolated surface-pressure condition reads.
    `min_count` > 1 culls near-empty cells (spray: a lone particle
    otherwise makes a "fluid" cell whose pinned faces carry unphysical
    frozen velocities)."""
    if ppc is None:
        ppc = params.particles_per_cell
    nx, ny = params.i_max + 2, params.j_max + 2
    ci = jnp.clip(jnp.floor(x / params.dx).astype(jnp.int32) + 1,
                  1, params.i_max)
    cj = jnp.clip(jnp.floor(y / params.dy).astype(jnp.int32) + 1,
                  1, params.j_max)
    counts = jnp.zeros(nx * ny, jnp.int32).at[ci * ny + cj].add(
        active.astype(jnp.int32)).reshape(nx, ny)
    interior = jnp.zeros((nx, ny), bool).at[1:-1, 1:-1].set(True)
    if params.obstacles:
        # Obstacle cells are neither fluid nor empty — they behave like
        # the ghost ring (walls): they never make a neighbor a surface
        # cell, their pressure weight is dropped (Neumann), and the
        # velocity continuation never redefines their faces.  The
        # static mask folds into the jit program as a constant.
        from . import obstacles as obs
        interior = interior & jnp.asarray(obs.fluid_mask(params))
    fluid = (counts >= min_count) & interior
    fill = jnp.clip(counts / float(ppc * ppc), 0.0, 1.0)
    return classify(fluid, interior, fill)


def classify(fluid: jax.Array, interior=None, fill=None) -> Flags:
    """Surface/bulk split of a padded fluid mask.  'Empty neighbor' counts
    only interior non-fluid cells — ghost (wall) neighbors never make a
    cell a surface cell."""
    if interior is None:
        interior = jnp.zeros_like(fluid).at[1:-1, 1:-1].set(True)
    if fill is None:
        fill = fluid.astype(jnp.float32)
    empty = interior & ~fluid
    near_empty = jnp.zeros_like(fluid)
    near_empty = near_empty.at[1:-1, 1:-1].set(
        empty[2:, 1:-1] | empty[:-2, 1:-1]
        | empty[1:-1, 2:] | empty[1:-1, :-2])
    surface = fluid & near_empty
    return Flags(fluid=fluid, empty=empty, surface=surface,
                 bulk=fluid & ~near_empty, fill=fill)


def _interior_divergence(u, v, params: Params):
    """(i_max, j_max) cell divergences from padded face arrays."""
    du = (u[1:-1, 1:-1] - u[:-2, 1:-1]) / params.dx
    dv = (v[1:-1, 1:-1] - v[1:-1, :-2]) / params.dy
    return du + dv


def apply_surface_bcs(u: jax.Array, v: jax.Array, flags: Flags,
                      params: Params, dt=None) -> Tuple[jax.Array, jax.Array]:
    """Free-surface velocity conditions, two vectorized passes.

    Pass 1 (continuity, Griebel eq. 8.10 generalized): every surface cell
    zeroes its discrete divergence by correcting its free faces equally.
    A free face (fluid cell -> empty neighbor) has exactly one fluid
    owner, so the four scatter-adds below never write one face twice.
    When `dt` is given, the body force is integrated into the free faces
    FIRST (the serial lineage's SET_UVP_SURFACE does the same): free
    faces are pinned out of the momentum equation, so without this a
    detached droplet never falls and the crest faces never feel gravity.
    The continuity correction runs on the post-gravity field, so cell
    divergence is still zeroed exactly, and on a flat resting surface
    (one free face per cell) the correction cancels the gravity add
    bit-for-bit — hydrostatic equilibrium is untouched.

    Pass 2 (velocity continuation into the empty region): faces BETWEEN
    two empty cells take the average of their defined 4-neighbor faces
    (defined = adjacent to at least one fluid cell, or a wall face); empty
    faces with no defined neighbor are zeroed.  Only the first empty layer
    matters — it is what near-surface particle interpolation touches and
    what seeds the momentum eq. when the front advances a cell."""
    fl, em, surf = flags.fluid, flags.empty, flags.surface
    si = surf[1:-1, 1:-1]
    e_free = si & em[2:, 1:-1]
    w_free = si & em[:-2, 1:-1]
    n_free = si & em[1:-1, 2:]
    s_free = si & em[1:-1, :-2]
    k = (e_free.astype(u.dtype) + w_free + n_free + s_free)
    if dt is not None:
        gx = dt * params.g_x
        gy = dt * params.g_y
        u = u.at[1:-1, 1:-1].add(jnp.where(e_free, gx, 0.0))
        u = u.at[0:-2, 1:-1].add(jnp.where(w_free, gx, 0.0))
        v = v.at[1:-1, 1:-1].add(jnp.where(n_free, gy, 0.0))
        v = v.at[1:-1, 0:-2].add(jnp.where(s_free, gy, 0.0))
    div = _interior_divergence(u, v, params)
    share = jnp.where(k > 0, div / jnp.maximum(k, 1), 0.0)
    dx, dy = params.dx, params.dy
    # East face of cell (i,j) is u[i, j] (padded); west face is u[i-1, j].
    u = u.at[1:-1, 1:-1].add(jnp.where(e_free, -share * dx, 0.0))
    u = u.at[0:-2, 1:-1].add(jnp.where(w_free, share * dx, 0.0))
    v = v.at[1:-1, 1:-1].add(jnp.where(n_free, -share * dy, 0.0))
    v = v.at[1:-1, 0:-2].add(jnp.where(s_free, share * dy, 0.0))

    # Pass 2: continuation.  u face (i, j) sits between cells (i, j) and
    # (i+1, j): empty-empty iff both are empty (ghost-adjacent faces are
    # wall faces, never redefined).
    u_ee = jnp.zeros_like(fl).at[1:-2, 1:-1].set(
        em[1:-2, 1:-1] & em[2:-1, 1:-1])
    v_ee = jnp.zeros_like(fl).at[1:-1, 1:-2].set(
        em[1:-1, 1:-2] & em[1:-1, 2:-1])
    u = _extend(u, u_ee)
    v = _extend(v, v_ee)
    return u, v


def _extend(a: jax.Array, undef: jax.Array) -> jax.Array:
    """One Jacobi continuation pass: undefined entries take the mean of
    their defined 4-neighbors (zero if none)."""
    defined = (~undef).astype(a.dtype)
    av = jnp.where(undef, 0.0, a)

    def nb(arr):
        return (jnp.roll(arr, 1, 0) + jnp.roll(arr, -1, 0)
                + jnp.roll(arr, 1, 1) + jnp.roll(arr, -1, 1))

    num = nb(av)
    den = nb(defined)
    return jnp.where(undef, jnp.where(den > 0, num / jnp.maximum(den, 1), 0.0),
                     a)


def _traced_weights(flags: Flags, params: Params) -> masked._Weights:
    """Neighbor-weight operator for the free-surface Poisson problem,
    shaped exactly like ops/masked.py's _Weights but TRACED: unknowns are
    bulk cells; a fluid neighbor (bulk or surface) keeps its geometric
    weight — surface neighbors are Dirichlet cells whose VALUE rides in
    the pressure array (0 for the plain-MAC condition, nonzero for the
    interpolated/hydrostatic conditions), so the off-diagonal term pulls
    the prescribed value with its geometric weight while the unknown set
    stays bulk-only; ghost (wall) neighbors are dropped from both
    (homogeneous Neumann), exactly as in masked.py."""
    dx2_inv = 1.0 / (params.dx * params.dx)
    dy2_inv = 1.0 / (params.dy * params.dy)
    fl, bulk = flags.fluid, flags.bulk
    bi = bulk[1:-1, 1:-1]
    w_e = jnp.where(bi & fl[2:, 1:-1], dx2_inv, 0.0)
    w_w = jnp.where(bi & fl[:-2, 1:-1], dx2_inv, 0.0)
    w_n = jnp.where(bi & fl[1:-1, 2:], dy2_inv, 0.0)
    w_s = jnp.where(bi & fl[1:-1, :-2], dy2_inv, 0.0)
    diag = w_e + w_w + w_n + w_s
    diag = jnp.where(diag > 0.0, diag, 1.0)
    return masked._Weights(w_e=w_e, w_w=w_w, w_n=w_n, w_s=w_s, diag=diag,
                           fluid=bi, n_fluid=jnp.maximum(jnp.sum(bi), 1))


def surface_pressure(flags: Flags, params: Params) -> jax.Array:
    """EXPLICIT sub-cell hydrostatic Dirichlet values for surface cells.
    Kept as a measured-NEGATIVE record — use the implicit SUMMAC
    condition (interp_coeffs, p_surface="interpolated") instead.

      * GROUNDED top-of-column surface cells (no fluid anywhere above in
        their column AND no empty cell below — fluid contiguous to the
        floor, so the column elevation IS their surface position) use the
        COLUMN elevation eta_i = dy * sum_j fill[i, j]:
        p_c = |g_y| * (eta_i - y_c).
      * Other surface cells (blob undersides, cavity ceilings, AND the
        top of any detached blob — its column height counts only the
        blob's thickness, not its altitude, so the columnar value would
        put a large spurious suction on an airborne drop, measured: the
        free-fall COM bias grows 4.5x) use the local fill fraction:
        p_c = |g_y| * dy * (fill - 1/2), exact for a surface crossing
        that cell horizontally.

    The measured failure: hydrostatic equilibrium is exact (the profile
    references the true top face), but on the mode-1 sloshing eigenmode
    the column-mass -> full-hydrostatic-pressure feedback is STIFF and
    time-EXPLICIT — the wave amplitude grows ~4x per period until the
    flow shreds (umax 0.45 vs the 0.07 linear-wave scale by t = 2
    periods; horizontally pre-smoothing eta does not save it).  The
    interpolated condition gets the same equilibrium exactness with the
    feedback solved implicitly in the pressure iteration, and is stable
    (tests/test_freesurface.py::test_sloshing_dispersion)."""
    g = abs(params.g_y)
    dy = params.dy
    fill_int = flags.fill[1:-1, 1:-1]
    fluid_int = flags.fluid[1:-1, 1:-1]
    eta = dy * jnp.sum(fill_int, axis=1, keepdims=True)     # (i_max, 1)
    # Any fluid strictly above (i, j) in the column?  Reverse cumsum.
    above = jnp.flip(jnp.cumsum(
        jnp.flip(fluid_int.astype(jnp.int32), axis=1), axis=1), axis=1)
    above_excl = above - fluid_int.astype(jnp.int32)
    empty_int = flags.empty[1:-1, 1:-1].astype(jnp.int32)
    empty_below_excl = jnp.cumsum(empty_int, axis=1) - empty_int
    top = (flags.surface[1:-1, 1:-1] & (above_excl == 0)
           & (empty_below_excl == 0))
    y_c = (jnp.arange(params.j_max, dtype=eta.dtype) + 0.5) * dy
    p_col = g * (eta - y_c[None, :])
    p_loc = g * dy * (fill_int - 0.5)
    p_int = jnp.where(top, p_col,
                      jnp.where(flags.surface[1:-1, 1:-1], p_loc, 0.0))
    return jnp.zeros(flags.fill.shape, p_int.dtype).at[1:-1, 1:-1].set(p_int)


def interp_coeffs(flags: Flags) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Coefficients of the SUMMAC interpolated surface condition (Chan &
    Street 1970): the pressure is linear in y through the surface cell's
    center and its vertical FLUID neighbor, and vanishes at the sub-cell
    surface position read from the fill fraction.  Eliminating the
    surface position gives p_c = alpha * p_ref with

        alpha = t / (1 + t),   t = fill - 1/2,

    for BOTH orientations (fluid below with the surface in the upper half,
    t > 0, and fluid above a blob underside, by symmetry) — full cell
    (t = 1/2) gives p_c = p_ref/3, i.e. the exact hydrostatic top-face
    reference, and a half-full cell gives plain MAC's p_c = 0.  Unlike a
    column-mass hydrostatic Dirichlet (measured: unstable — the stiff
    explicit surface-pressure feedback pumps the sloshing eigenmode until
    the flow shreds), p_ref is the SOLVED field, so the condition is
    implicit in the pressure and only the geometry is time-explicit.

    Returns (use_below, use_above, alpha) interior (i_max, j_max) arrays:
    vertical-only interpolation where exactly one vertical neighbor is
    fluid; side-surface cells (both vertical neighbors fluid) and
    one-cell sheets (both empty) fall back to p_c = 0.  t is clipped to
    [-0.45, 0.5]: near-empty cells would send alpha -> -1 (extrapolation,
    not interpolation) and amplify sweep noise."""
    si = flags.surface[1:-1, 1:-1]
    fl = flags.fluid
    below_fl = fl[1:-1, :-2]
    above_fl = fl[1:-1, 2:]
    use_below = si & below_fl & ~above_fl
    use_above = si & above_fl & ~below_fl
    t = jnp.clip(flags.fill[1:-1, 1:-1] - 0.5, -0.45, 0.5)
    alpha = t / (1.0 + t)
    return use_below, use_above, alpha


def mask_pressure(p: jax.Array, flags: Flags,
                  p_surf: Optional[jax.Array] = None) -> jax.Array:
    """Impose the Dirichlet conditions: p_surf (default 0) on surface
    cells, 0 on empty cells and ghosts; bulk values pass through."""
    out = jnp.where(flags.bulk, p, jnp.zeros_like(p))
    if p_surf is not None:
        out = jnp.where(flags.surface, p_surf.astype(p.dtype), out)
    return out


def solve_pressure_free(p: jax.Array, rhs: jax.Array, flags: Flags,
                        params: Params,
                        p_surf: Optional[jax.Array] = None,
                        interpolated: bool = False,
                        inner_fn=None) -> SORResult:
    """Pressure solve on the traced free-surface geometry: ops/masked.py's
    f64-master / f32-correction refinement outer over the traced-weight
    operator.  The surface Dirichlet cells (value `p_surf`, default 0)
    anchor the solution, so there is no null space and no deflation hook.
    The Dirichlet values ride in the pressure ARRAY: sweeps only update
    bulk cells, so the neighbor sums pick surface values up with their
    geometric weight — no separate rhs fold.  With `interpolated=True`
    the surface values are instead the SUMMAC condition p_c = alpha *
    p_ref (interp_coeffs): a refresh from the current field runs once per
    refinement outer, a Picard fixed point that contracts with factor
    |alpha| <= 0.82 per outer on top of the defect correction (the
    residual is only measured over bulk cells, whose equations see the
    refreshed values).  Requires x64 like every
    refined solve (CLI/bench enable it).

    `inner_fn(neg_r32, n_inner, w, red, black) -> delta` optionally
    replaces the f32 correction-sweep stage — the hook the shard_map twin
    (parallel/sharded_free.py) plugs its partitioned sweeps into; the f64
    master/defect/refresh logic is shared verbatim."""
    if not jax.config.jax_enable_x64:
        raise ValueError("free-surface runs need jax x64 for the f64 "
                         "refinement master (CLI/bench enable it)")
    if params.obstacles:
        # Defensive re-classification: only cell_flags folds the static
        # obstacle mask into `interior`; flags built directly via
        # classify() would mark obstacle cells EMPTY (making their fluid
        # neighbors spurious Dirichlet surface cells).  Idempotent for
        # cell_flags-built flags.
        from . import obstacles as obs
        interior = (jnp.zeros_like(flags.fluid).at[1:-1, 1:-1].set(True)
                    & jnp.asarray(obs.fluid_mask(params)))
        flags = classify(flags.fluid & interior, interior, flags.fill)
    f64, f32 = jnp.float64, jnp.float32
    w = _traced_weights(flags, params)
    omega32 = jnp.asarray(params.omega, f32)
    shape_int = (params.i_max, params.j_max)
    red = _checkerboard(shape_int, 0) & w.fluid
    black = _checkerboard(shape_int, 1) & w.fluid
    K = max(1, params.sor_refine_every)

    if inner_fn is not None:
        def inner(neg_r32, n_inner):
            return inner_fn(neg_r32, n_inner, w, red, black)
    else:
        def inner(neg_r32, n_inner):
            def sweep(_, d):
                return masked.masked_rb_iteration(d, neg_r32, omega32, w,
                                                  red, black)
            return lax.fori_loop(0, n_inner, sweep,
                                 jnp.zeros(params.shape, f32))

    if interpolated:
        use_below, use_above, alpha = interp_coeffs(flags)
        refresh_mask = use_below | use_above

        def refresh(p64):
            ref = jnp.where(use_below, p64[1:-1, :-2], p64[1:-1, 2:])
            return p64.at[1:-1, 1:-1].set(
                jnp.where(refresh_mask, alpha * ref, p64[1:-1, 1:-1]))
    else:
        def refresh(p64):
            return p64

    p64 = refresh(mask_pressure(p.astype(f64), flags, p_surf))
    rhs_int64 = jnp.where(w.fluid, rhs[1:-1, 1:-1].astype(f64), 0.0)
    norm_p0 = masked._l2_fluid(jnp.where(w.fluid, p64[1:-1, 1:-1], 0.0), w)
    threshold = params.epsilon * (norm_p0 + NORM_OFFSET)

    def defect(p64):
        return masked.masked_residual(p64, rhs_int64, w)

    def cond(carry):
        _, _, it, res_norm = carry
        return jnp.logical_and(it < params.max_it, res_norm > threshold)

    def body(carry):
        p64, r64, it, _ = carry
        n_inner = jnp.minimum(K, params.max_it - it)
        delta = inner(-r64.astype(f32), n_inner)
        p64 = p64.at[1:-1, 1:-1].add(
            jnp.where(w.fluid, delta[1:-1, 1:-1].astype(f64), 0.0))
        p64 = refresh(p64)
        r64 = defect(p64)
        return p64, r64, it + n_inner, masked._l2_fluid(r64, w)

    r64_0 = defect(p64)
    init = (p64, r64_0, jnp.zeros((), jnp.int32), jnp.asarray(jnp.inf, f64))
    p64, _, it, res_norm = lax.while_loop(cond, body, init)
    return SORResult(
        p=p64.astype(p.dtype),
        iterations=it,
        res_norm=res_norm.astype(p.dtype),
        converged=res_norm <= threshold,
    )


def fluid_face_masks(flags: Flags) -> Tuple[jax.Array, jax.Array]:
    """Interior-update-aligned masks of momentum faces: u faces between
    two FLUID cells (shape (i_max-1, j_max), matching the slice
    momentum.project_velocities writes, u[1:i_max, 1:-1]) and likewise for
    v.  Non-fluid faces keep their BC/continuation values through both the
    tentative-velocity pin and the projection."""
    fl = flags.fluid
    u_ff = fl[1:-2, 1:-1] & fl[2:-1, 1:-1]
    v_ff = fl[1:-1, 1:-2] & fl[1:-1, 2:-1]
    return u_ff, v_ff


def pin_fg(F: jax.Array, G: jax.Array, u: jax.Array, v: jax.Array,
           flags: Flags) -> Tuple[jax.Array, jax.Array]:
    """F = u / G = v on every face that is not fluid-fluid (Griebel eq.
    8.11's boundary treatment): the Poisson RHS then sees the surface-BC
    face values, and the projection leaves them untouched."""
    u_ff, v_ff = fluid_face_masks(flags)
    F = F.at[1:-2, 1:-1].set(jnp.where(u_ff, F[1:-2, 1:-1], u[1:-2, 1:-1]))
    G = G.at[1:-1, 1:-2].set(jnp.where(v_ff, G[1:-1, 1:-2], v[1:-1, 1:-2]))
    # Faces outside the interior update region always carry F=u/G=v
    # (momentum.compute_fg already sets the walls; empty-region faces too).
    F = jnp.where(jnp.zeros_like(F, bool).at[1:-2, 1:-1].set(True), F,
                  u.astype(F.dtype))
    G = jnp.where(jnp.zeros_like(G, bool).at[1:-1, 1:-2].set(True), G,
                  v.astype(G.dtype))
    return F, G
