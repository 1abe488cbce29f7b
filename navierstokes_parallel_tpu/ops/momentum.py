"""Momentum step: tentative velocities F/G, Poisson RHS, projection, CFL dt.

Accelerator redesign of the reference's momentum path (src/serial/
integration.c:73-96 `FG`, main.c:116-120 RHS, main.c:131-136 projection,
main.c:89-92 adaptive dt).  Each piece is one fused elementwise expression
over the whole grid; under jit XLA fuses the eight stencils, the F/G update,
and the RHS into a handful of fused passes — the analogue of the reference's
hand-written calculate_F/G/RHS CUDA kernels (src/parallel/main.cu:219-382)
without any kernel-launch or synchronization cost.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import Params
from . import stencils as st


def compute_fg(
    u: jax.Array,
    v: jax.Array,
    dt,
    gamma,
    params: Params,
    g_x=None,
    g_y=None,
) -> Tuple[jax.Array, jax.Array]:
    """Tentative velocities (reference integration.c:73-96).

    F is defined at u-locations for i in [1, i_max-1], j in [1, j_max];
    G at v-locations for i in [1, i_max], j in [1, j_max-1].  On the domain
    boundary we set F = u and G = v (Griebel et al. eq. 3.42); the reference
    instead leaves calloc-zeros there (integration.c:75-91 never writes them),
    which coincides with F=u/G=v for every supported problem since the wall
    normal velocities are zero — so this is a strict generalization with
    identical results on the reference workloads.
    """
    dx, dy, Re = params.dx, params.dy, params.Re
    i_max, j_max = params.i_max, params.j_max
    # Traced body-force overrides (the differentiable path, diff.py, takes
    # gradients w.r.t. these; None = the static Params values).
    g_x = params.g_x if g_x is None else g_x
    g_y = params.g_y if g_y is None else g_y

    diff_u = (st.d2_dx2(u, dx) + st.d2_dy2(u, dy)) / Re
    conv_u = st.du2_dx(u, v, dx, gamma) + st.duv_dy(u, v, dy, gamma)
    f_int = st.shifted(u, 0, 0) + dt * (diff_u - conv_u + g_x)

    diff_v = (st.d2_dx2(v, dx) + st.d2_dy2(v, dy)) / Re
    conv_v = st.duv_dx(u, v, dx, gamma) + st.dv2_dy(u, v, dy, gamma)
    g_int = st.shifted(v, 0, 0) + dt * (diff_v - conv_v + g_y)

    F = jnp.zeros_like(u)
    G = jnp.zeros_like(v)
    # Interior minus the last row/column where F/G live on the boundary.
    F = F.at[1:i_max, 1:-1].set(f_int[: i_max - 1, :])
    G = G.at[1:-1, 1:j_max].set(g_int[:, : j_max - 1])
    # Boundary values: F = u on the left/right walls, G = v on bottom/top.
    F = F.at[0, 1:-1].set(u[0, 1:-1])
    F = F.at[i_max, 1:-1].set(u[i_max, 1:-1])
    G = G.at[1:-1, 0].set(v[1:-1, 0])
    G = G.at[1:-1, j_max].set(v[1:-1, j_max])
    return F, G


def compute_rhs(F: jax.Array, G: jax.Array, dt, params: Params) -> jax.Array:
    """Poisson RHS = div(F, G)/dt on the interior (reference main.c:116-120)."""
    dx, dy = params.dx, params.dy
    div = (st.shifted(F, 0, 0) - st.shifted(F, -1, 0)) / dx + (
        st.shifted(G, 0, 0) - st.shifted(G, 0, -1)
    ) / dy
    rhs = jnp.zeros_like(F)
    return rhs.at[1:-1, 1:-1].set(div / dt)


def project_velocities(
    u: jax.Array,
    v: jax.Array,
    F: jax.Array,
    G: jax.Array,
    p: jax.Array,
    dt,
    params: Params,
) -> Tuple[jax.Array, jax.Array]:
    """u = F - dt dp/dx, v = G - dt dp/dy (reference main.c:131-136).

    Only u[1:i_max-1, 1:j_max] and v[1:i_max, 1:j_max-1] are updated; the
    wall-edge values (set by the BCs) and ghosts carry over unchanged, exactly
    like the reference's guarded in-place loop.
    """
    i_max, j_max = params.i_max, params.j_max
    u_new = st.shifted(F, 0, 0) - dt * st.dp_dx(p, params.dx)
    v_new = st.shifted(G, 0, 0) - dt * st.dp_dy(p, params.dy)
    u = u.at[1:i_max, 1:-1].set(u_new[: i_max - 1, :])
    v = v.at[1:-1, 1:j_max].set(v_new[:, : j_max - 1])
    return u, v


def adaptive_dt_gamma(u, v, params: Params):
    """CFL time step and donor-cell weight (reference main.c:89-92).

    dt = tau * min(Re/2/(1/dx^2+1/dy^2), dx/|u_max|, dy/|v_max|), with u_max,
    v_max the reference's *signed* interior maxima (io.c:122).  gamma =
    max(u_max*dt/dx, v_max*dt/dy).  Division by a zero max yields +inf which
    drops out of the min, matching C float semantics.
    """
    dx, dy, Re, tau = params.dx, params.dy, params.Re, params.tau
    u_max = st.max_interior(u)
    v_max = st.max_interior(v)
    visc = Re / 2.0 / (1.0 / (dx * dx) + 1.0 / (dy * dy))
    dt = tau * jnp.minimum(
        visc, jnp.minimum(dx / jnp.abs(u_max), dy / jnp.abs(v_max))
    )
    if params.gamma_fixed is not None:
        # Decouple the upwind weight from dt (see config.py::gamma_fixed):
        # the donor-cell blend becomes a fixed spatial operator, so
        # temporal refinement measures the integrator alone.
        gamma = jnp.asarray(params.gamma_fixed, dt.dtype)
    else:
        gamma = jnp.maximum(u_max * dt / dx, v_max * dt / dy)
    return dt, gamma
