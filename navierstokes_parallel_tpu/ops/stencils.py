"""Finite-difference stencils, vectorized as shifted-slice arithmetic.

Vectorized re-design of the reference's eight pointwise stencil functions
(reference: src/serial/integration.c:7-71 — four donor-cell convective
stencils with gamma-weighted upwinding, four central second derivatives).
Instead of scalar functions evaluated per (i, j) in a loop, each stencil here
is one fused jnp expression over the whole interior: XLA compiles these
into a handful of elementwise passes, and fuses them into the surrounding
momentum computation.

Every function takes full padded (i_max+2, j_max+2) arrays and returns an
(i_max, j_max) array of values for the interior points i in [1, i_max],
j in [1, j_max].  Points where the reference never evaluates a stencil
(e.g. the F-row i = i_max) are computed here too — harmlessly, the arrays are
padded so the reads are in-bounds — and discarded by the caller's mask/slice.
"""

from __future__ import annotations

import jax.numpy as jnp


def shifted(x, di: int, dj: int):
    """Interior view of `x` shifted by (di, dj); offsets in {-1, 0, +1}.

    shifted(x, 0, 0)[i-1, j-1] == x[i, j] for interior (i, j).
    """
    ni, nj = x.shape[-2], x.shape[-1]
    return x[..., 1 + di : ni - 1 + di, 1 + dj : nj - 1 + dj]


# ---------------------------------------------------------------------------
# Donor-cell convective stencils (gamma-weighted upwinding).
# Mirrors the math of reference integration.c:7-51, vectorized.
# ---------------------------------------------------------------------------

def du2_dx(u, v, dx, gamma):
    """d(u^2)/dx at u-locations (reference integration.c:7-15)."""
    uc, ue, uw = shifted(u, 0, 0), shifted(u, 1, 0), shifted(u, -1, 0)
    avg_e = 0.5 * (uc + ue)       # u averaged to the cell center right of face
    avg_w = 0.5 * (uw + uc)       # ... and left
    upw_e = jnp.abs(avg_e) * 0.5 * (uc - ue)
    upw_w = jnp.abs(avg_w) * 0.5 * (uw - uc)
    return (avg_e * avg_e - avg_w * avg_w) / dx + gamma / dx * (upw_e - upw_w)


def duv_dy(u, v, dy, gamma):
    """d(uv)/dy at u-locations (reference integration.c:17-28)."""
    uc, un, us = shifted(u, 0, 0), shifted(u, 0, 1), shifted(u, 0, -1)
    vc, ve = shifted(v, 0, 0), shifted(v, 1, 0)
    vs, vse = shifted(v, 0, -1), shifted(v, 1, -1)
    v_n = 0.5 * (vc + ve)         # v averaged onto the u-node's north edge
    v_s = 0.5 * (vs + vse)        # ... and south edge
    flux_n = v_n * 0.5 * (uc + un)
    flux_s = v_s * 0.5 * (us + uc)
    upw_n = jnp.abs(v_n) * 0.5 * (uc - un)
    upw_s = jnp.abs(v_s) * 0.5 * (us - uc)
    return (flux_n - flux_s) / dy + gamma / dy * (upw_n - upw_s)


def dv2_dy(u, v, dy, gamma):
    """d(v^2)/dy at v-locations (reference integration.c:30-38)."""
    vc, vn, vs = shifted(v, 0, 0), shifted(v, 0, 1), shifted(v, 0, -1)
    avg_n = 0.5 * (vc + vn)
    avg_s = 0.5 * (vs + vc)
    upw_n = jnp.abs(avg_n) * 0.5 * (vc - vn)
    upw_s = jnp.abs(avg_s) * 0.5 * (vs - vc)
    return (avg_n * avg_n - avg_s * avg_s) / dy + gamma / dy * (upw_n - upw_s)


def duv_dx(u, v, dx, gamma):
    """d(uv)/dx at v-locations (reference integration.c:40-51)."""
    vc, ve, vw = shifted(v, 0, 0), shifted(v, 1, 0), shifted(v, -1, 0)
    uc, un = shifted(u, 0, 0), shifted(u, 0, 1)
    uw, unw = shifted(u, -1, 0), shifted(u, -1, 1)
    u_e = 0.5 * (uc + un)         # u averaged onto the v-node's east edge
    u_w = 0.5 * (uw + unw)        # ... and west edge
    flux_e = u_e * 0.5 * (vc + ve)
    flux_w = u_w * 0.5 * (vw + vc)
    upw_e = jnp.abs(u_e) * 0.5 * (vc - ve)
    upw_w = jnp.abs(u_w) * 0.5 * (vw - vc)
    return (flux_e - flux_w) / dx + gamma / dx * (upw_e - upw_w)


# ---------------------------------------------------------------------------
# Central second derivatives (reference integration.c:57-71).
# ---------------------------------------------------------------------------

def d2_dx2(x, dx):
    """Central second derivative along x of any staggered field."""
    return (shifted(x, 1, 0) - 2.0 * shifted(x, 0, 0) + shifted(x, -1, 0)) / (dx * dx)


def d2_dy2(x, dy):
    """Central second derivative along y of any staggered field."""
    return (shifted(x, 0, 1) - 2.0 * shifted(x, 0, 0) + shifted(x, 0, -1)) / (dy * dy)


# Aliases matching the reference's per-field naming, for test parity.
def d2u_dx2(u, dx):
    return d2_dx2(u, dx)


def d2u_dy2(u, dy):
    return d2_dy2(u, dy)


def d2v_dx2(v, dx):
    return d2_dx2(v, dx)


def d2v_dy2(v, dy):
    return d2_dy2(v, dy)


# ---------------------------------------------------------------------------
# Pressure gradients — forward differences (reference integration.c:101-110).
# ---------------------------------------------------------------------------

def dp_dx(p, dx):
    """Forward difference (p[i+1,j] - p[i,j]) / dx at interior points."""
    return (shifted(p, 1, 0) - shifted(p, 0, 0)) / dx


def dp_dy(p, dy):
    """Forward difference (p[i,j+1] - p[i,j]) / dy at interior points."""
    return (shifted(p, 0, 1) - shifted(p, 0, 0)) / dy


# ---------------------------------------------------------------------------
# Reductions (reference integration.c:115-124, io.c:122-161).
# ---------------------------------------------------------------------------

def l2_norm(interior_vals, i_max: int, j_max: int):
    """sqrt(sum(m^2) / (i_max * j_max)) over the interior (integration.c:115)."""
    return jnp.sqrt(jnp.sum(interior_vals * interior_vals) / (i_max * j_max))


def max_interior(x):
    """Signed max over the interior, seeded with the ghost corner x[0, 0].

    Reproduces the reference's max_mat quirk (io.c:122-139): it is a *signed*
    max (not abs) whose initial candidate is x[0][0].
    """
    return jnp.maximum(x[0, 0], jnp.max(x[1:-1, 1:-1]))
