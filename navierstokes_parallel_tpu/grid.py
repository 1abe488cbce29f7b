"""Staggered (MAC) grid state.

The reference allocates seven ragged ``double**`` grids with per-field shapes
(src/serial/memory.c:3-26): p/res/RHS/F/G are (i_max+2, j_max+2), u is
(i_max+1, j_max+2), v is (i_max+2, j_max+1).  Here we use *uniform*
(i_max+2, j_max+2) padded arrays for every field (like the reference's CUDA
path, src/parallel/main.cu:48-49): the extra row of u / column of v is never
read or written, and uniform shapes let XLA fuse everything and keep one
sharding spec for the whole state.

Staggering convention (Griebel et al. 1998):
  - ``p[i, j]``  pressure at cell centers
  - ``u[i, j]``  x-velocity at the *right* edge of cell (i, j)
  - ``v[i, j]``  y-velocity at the *top*  edge of cell (i, j)
Axis 0 is x (index i), axis 1 is y (index j).  One ghost layer on each side.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .config import Params


class State(NamedTuple):
    """Solver state pytree. All fields are (i_max+2, j_max+2) arrays."""

    u: jax.Array  # x-velocity
    v: jax.Array  # y-velocity
    p: jax.Array  # pressure
    t: jax.Array  # scalar: current simulation time
    n: jax.Array  # scalar int: completed time steps


def allocate_state(params: Params, dtype=None) -> State:
    """Zero-initialized state (the reference calloc-zeros all grids)."""
    dtype = dtype or params.jnp_dtype
    shape = params.shape
    zeros = jnp.zeros(shape, dtype=dtype)
    return State(
        u=zeros,
        v=zeros,
        p=zeros,
        t=jnp.zeros((), dtype=dtype),
        n=jnp.zeros((), dtype=jnp.int32),
    )


def state_from_arrays(u, v, p, t=0.0, n=0, dtype=jnp.float32) -> State:
    return State(
        u=jnp.asarray(u, dtype=dtype),
        v=jnp.asarray(v, dtype=dtype),
        p=jnp.asarray(p, dtype=dtype),
        t=jnp.asarray(t, dtype=dtype),
        n=jnp.asarray(n, dtype=jnp.int32),
    )


def interior(x: jax.Array) -> jax.Array:
    """The (i_max, j_max) interior view of a padded field."""
    return x[1:-1, 1:-1]
