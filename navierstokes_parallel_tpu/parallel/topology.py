"""Device-mesh topology for 2D grid sharding.

The reference has no multi-device capability at all (SURVEY.md §2.4): its
only parallelism is CUDA thread-block tiling inside one GPU.  This module is
the framework's genuinely new scaling layer: a 2D `jax.sharding.Mesh`
("x", "y") onto which the staggered grid's interior is block-sharded, the
multi-device analogue of the CUDA tile decomposition (main.cu:407-486) with
ppermute halo exchange standing in for shared-memory halo loads.  The mesh
follows the grid alone: the cards of one host reach each other at the same
rate, so `make_grid_mesh` only reshapes `jax.devices()`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

MESH_AXES = ("x", "y")


def _factor_pairs(n: int):
    """All (px, py) with px * py == n, ordered nearest-square first."""
    pairs = []
    for px in range(1, n + 1):
        if n % px == 0:
            pairs.append((px, n // px))
    pairs.sort(key=lambda ab: abs(ab[0] - ab[1]))
    return pairs


def choose_mesh_shape(
    n_devices: int, i_max: int, j_max: int
) -> Tuple[int, int]:
    """Pick (px, py) with px*py == n_devices that evenly divides the interior
    grid, preferring a near-square decomposition (minimum halo perimeter).
    Raises when no factorization divides evenly — callers that can handle
    padded blocks should use `choose_mesh_shape_padded` instead."""
    for px, py in _factor_pairs(n_devices):
        if i_max % px == 0 and j_max % py == 0:
            return px, py
    raise ValueError(
        f"cannot shard a {i_max}x{j_max} interior over {n_devices} devices: "
        f"no factorization divides the grid evenly"
    )


def choose_mesh_shape_padded(
    n_devices: int, i_max: int, j_max: int
) -> Tuple[int, int]:
    """Pick (px, py) with px*py == n_devices minimizing the PADDED interior
    area ceil(i/px)*px * ceil(j/py)*py, tie-broken nearest-square.  Always
    succeeds: any grid — including the reference's default 257^2
    (parameters.txt:3-4) — shards via pad-to-divisible blocks whose pad
    cells are masked out of every update and reduction (see sharded.py)."""
    best = None
    for px, py in _factor_pairs(n_devices):
        ip = -(-i_max // px) * px
        jp = -(-j_max // py) * py
        cost = (ip * jp, abs(px - py))
        if best is None or cost < best[0]:
            best = (cost, (px, py))
    return best[1]


def choose_mesh_shape_square(n_devices: int) -> Tuple[int, int]:
    """Nearest-square (px, py) with px*py == n_devices and, whenever the
    device count allows it, BOTH axes > 1.  The GSPMD backend requires
    this: XLA's SPMD partitioner miscompiles composed boundary slice
    updates on (1,N)/(N,1) meshes (see gspmd._check_mesh).  Raises for
    prime n_devices > 2 (only trivial-axis factorizations exist)."""
    for px, py in _factor_pairs(n_devices):
        if min(px, py) > 1 or n_devices == 1:
            return px, py
    raise ValueError(
        f"{n_devices} devices admit only 1x{n_devices} meshes (prime count); "
        "the gspmd backend needs both mesh axes > 1 — use a composite "
        "device count or the manual sharded backend"
    )


def local_block_dims(
    mesh_shape: Tuple[int, int], i_max: int, j_max: int
) -> Tuple[int, int]:
    """Per-shard interior block dims (li, lj) = ceil(i_max/px), ceil(j_max/py);
    the global interior is padded to (px*li, py*lj)."""
    px, py = mesh_shape
    return -(-i_max // px), -(-j_max // py)


def make_grid_mesh(
    n_devices: Optional[int] = None,
    i_max: int = 0,
    j_max: int = 0,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a 2D ("x", "y") mesh over the given (or all) devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = list(devices)[:n_devices]
    px, py = choose_mesh_shape_padded(n_devices, i_max, j_max)
    dev_array = np.asarray(devices).reshape(px, py)
    return Mesh(dev_array, MESH_AXES)


def grid_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding of an (i_max, j_max) interior block over the mesh."""
    return NamedSharding(mesh, P(*MESH_AXES))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
