"""Velocity boundary conditions on the staggered grid.

Implements the *serial* reference semantics (src/serial/boundaries.c:3-39):
fixed normal velocity on the wall edge, tangential velocity reflected through
the wall by ghost-cell averaging.  The reference's CUDA port drifted from
these semantics (it touches only the ghost perimeter, src/parallel/
main.cu:883-925, e.g. writing v[i][j_max+1] where serial writes v[i][j_max]);
we deliberately implement the serial — mathematically correct staggered —
version and note the CUDA drift as a reference bug (see SURVEY.md §2.2).

As pure functions these are static slice updates (`x.at[...].set(...)`),
which XLA fuses into the surrounding step — the reference's precomputed
border-point lists and 1D boundary kernels (src/parallel/main.cu:194-215,
838-944) have no analogue here because no scatter machinery is needed.
"""

from __future__ import annotations

import enum
from typing import Tuple

import jax
import jax.numpy as jnp


class Side(enum.Enum):
    TOP = "top"
    BOTTOM = "bottom"
    LEFT = "left"
    RIGHT = "right"


def set_inflow(
    u: jax.Array,
    v: jax.Array,
    side: Side,
    u_fix,
    v_fix,
) -> Tuple[jax.Array, jax.Array]:
    """Fix (u_fix, v_fix) velocity on one wall (reference boundaries.c:7-39).

    The component normal to the wall lives exactly on the wall edge and is set
    directly; the tangential component has no node on the wall, so its ghost
    value is set such that the average of ghost and first-interior node equals
    the prescribed wall value.
    """
    # Interior ranges: i in [1, i_max] is u[1:-1], j in [1, j_max] is v[:, 1:-1].
    if side is Side.TOP:
        # wall at y = b: v on edge j_max, u reflected through ghost j_max+1
        v = v.at[1:-1, -2].set(v_fix)
        u = u.at[1:-1, -1].set(2.0 * u_fix - u[1:-1, -2])
    elif side is Side.BOTTOM:
        # wall at y = 0: v on edge 0, u reflected through ghost 0
        v = v.at[1:-1, 0].set(v_fix)
        u = u.at[1:-1, 0].set(2.0 * u_fix - u[1:-1, 1])
    elif side is Side.LEFT:
        # wall at x = 0: u on edge 0, v reflected through ghost 0
        u = u.at[0, 1:-1].set(u_fix)
        v = v.at[0, 1:-1].set(2.0 * v_fix - v[1, 1:-1])
    elif side is Side.RIGHT:
        # wall at x = a: u on edge i_max, v reflected through ghost i_max+1
        u = u.at[-2, 1:-1].set(u_fix)
        v = v.at[-1, 1:-1].set(2.0 * v_fix - v[-2, 1:-1])
    else:  # pragma: no cover
        raise ValueError(f"unknown side {side}")
    return u, v


def set_noslip(u: jax.Array, v: jax.Array, side: Side) -> Tuple[jax.Array, jax.Array]:
    """No-slip wall = inflow with zero velocity (reference boundaries.c:3-5)."""
    return set_inflow(u, v, side, 0.0, 0.0)


def set_freeslip(u: jax.Array, v: jax.Array, side: Side) -> Tuple[jax.Array, jax.Array]:
    """Free-slip wall (Griebel et al. sect. 3.3, 'slip condition'): zero
    normal velocity on the wall edge, zero normal GRADIENT of the
    tangential component — the ghost copies the first interior node
    instead of negating it.  No reference analogue (its problems are all
    no-slip); the free-surface container walls use it (the standard
    dam-break setting — no-slip pins a spurious particle film to the
    walls)."""
    if side is Side.TOP:
        v = v.at[1:-1, -2].set(0.0)
        u = u.at[1:-1, -1].set(u[1:-1, -2])
    elif side is Side.BOTTOM:
        v = v.at[1:-1, 0].set(0.0)
        u = u.at[1:-1, 0].set(u[1:-1, 1])
    elif side is Side.LEFT:
        u = u.at[0, 1:-1].set(0.0)
        v = v.at[0, 1:-1].set(v[1, 1:-1])
    elif side is Side.RIGHT:
        u = u.at[-2, 1:-1].set(0.0)
        v = v.at[-1, 1:-1].set(v[-2, 1:-1])
    else:  # pragma: no cover
        raise ValueError(f"unknown side {side}")
    return u, v


def apply_cavity_bcs(u, v, lid_u) -> Tuple[jax.Array, jax.Array]:
    """No-slip left/right/bottom walls + moving lid on top.

    `lid_u` may be a traced scalar (the oscillating-lid problem passes
    sin(f*t), reference main.c:104).  Side order matches the reference driver
    (main.c:95-104) and is LOAD-BEARING: the writes are disjoint, but TOP's
    ghost update reads u[i_max, j_max] which RIGHT writes (to 0), so RIGHT
    must precede TOP exactly as in the reference.
    """
    u, v = set_noslip(u, v, Side.LEFT)
    u, v = set_noslip(u, v, Side.RIGHT)
    u, v = set_noslip(u, v, Side.BOTTOM)
    u, v = set_inflow(u, v, Side.TOP, lid_u, 0.0)
    return u, v


def lid_velocity(problem: int, f: float, t):
    """Lid speed for the given problem type (reference main.c:95-108)."""
    if problem == 1:
        return jnp.asarray(1.0, dtype=jnp.result_type(t))
    elif problem == 2:
        return jnp.sin(f * t)
    raise ValueError(f"unknown problem type {problem}")


def apply_freeslip_box(u: jax.Array, v: jax.Array) -> Tuple[jax.Array,
                                                            jax.Array]:
    """Free-slip (no-stress) walls on all four sides — problem 4, the
    Taylor-Green box (models/taylorgreen.py).  No reference analogue (its
    problems are all no-slip); side order follows the free-surface
    container (models/freesurface.py::_box_bcs): the writes commute here
    (every wall-normal edge is set to the constant 0 and every tangential
    ghost copies an interior node no other side writes), unlike the
    cavity's load-bearing RIGHT-before-TOP order."""
    u, v = set_freeslip(u, v, Side.LEFT)
    u, v = set_freeslip(u, v, Side.RIGHT)
    u, v = set_freeslip(u, v, Side.BOTTOM)
    u, v = set_freeslip(u, v, Side.TOP)
    return u, v


def set_outflow(u: jax.Array, v: jax.Array, side: Side) -> Tuple[jax.Array, jax.Array]:
    """Zero-gradient outflow (Griebel et al. sect. 3.3, 'outflow'): copy the
    wall-normal edge velocity from its upstream interior neighbor and
    zero-gradient the tangential ghost.  No reference analogue (the
    reference ships only the enclosed-cavity problems 1-2); this is the
    beyond-reference channel model family (models/channel.py)."""
    if side is Side.RIGHT:
        u = u.at[-2, 1:-1].set(u[-3, 1:-1])
        v = v.at[-1, 1:-1].set(v[-2, 1:-1])
    elif side is Side.LEFT:
        u = u.at[0, 1:-1].set(u[1, 1:-1])
        v = v.at[0, 1:-1].set(v[1, 1:-1])
    elif side is Side.TOP:
        v = v.at[1:-1, -2].set(v[1:-1, -3])
        u = u.at[1:-1, -1].set(u[1:-1, -2])
    elif side is Side.BOTTOM:
        v = v.at[1:-1, 0].set(v[1:-1, 1])
        u = u.at[1:-1, 0].set(u[1:-1, 1])
    else:  # pragma: no cover
        raise ValueError(f"unknown side {side}")
    return u, v


def poiseuille_profile(params, u_max: float = 1.0):
    """Parabolic channel inflow u(y) = 4 u_max y (b - y) / b^2 sampled at
    the u-node heights y_j = (j - 1/2) dy, j = 1..j_max."""
    j = jnp.arange(1, params.j_max + 1)
    y = (j - 0.5) * params.dy
    return 4.0 * u_max * y * (params.b - y) / (params.b * params.b)


def apply_channel_bcs(u, v, params) -> Tuple[jax.Array, jax.Array]:
    """Plane-channel BCs (problem 3): parabolic inflow on the left,
    zero-gradient outflow on the right, no-slip bottom/top walls.

    The Poisson RHS is compatible (orthogonal to the Neumann null space)
    only if the boundary fluxes balance exactly: sum_j F[i_max, j] must
    equal sum_j F[0, j] since momentum.compute_fg pins F = u on both edges
    and G = v = 0 on the walls.  The raw zero-gradient copy violates that
    during transients, which would floor every pressure solver above the
    eps*(||p0||+1.5) contract — so a uniform additive correction pins the
    outflow flux to the inflow flux (standard global mass-balance fix; it
    vanishes identically at the developed steady state)."""
    if params.obstacles:
        # Obstacle-aware inflow (a parabola per contiguous fluid span of
        # the inflow column — the backward-facing step's upper-half inflow)
        # and a flux balance restricted to the fluid rows of the outflow
        # column (obstacle faces there must stay no-slip).
        from . import obstacles as obs

        profile = jnp.asarray(obs.inflow_profile(params)).astype(u.dtype)
        out_fluid = jnp.asarray(obs.masks(params).fluid[-2, 1:-1])
        n_out = max(1, int(obs.masks(params).fluid[-2, 1:-1].sum()))
    else:
        profile = poiseuille_profile(params).astype(u.dtype)
        out_fluid = True
        n_out = params.j_max
    u, v = set_inflow(u, v, Side.LEFT, profile, 0.0)
    u, v = set_outflow(u, v, Side.RIGHT)
    q_in = jnp.sum(u[0, 1:-1])
    q_out = jnp.sum(jnp.where(out_fluid, u[-2, 1:-1], 0.0))
    u = u.at[-2, 1:-1].add(
        jnp.where(out_fluid, (q_in - q_out) / n_out, 0.0).astype(u.dtype))
    u, v = set_noslip(u, v, Side.BOTTOM)
    u, v = set_noslip(u, v, Side.TOP)
    return u, v
