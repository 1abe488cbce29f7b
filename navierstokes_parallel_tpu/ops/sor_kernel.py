"""Red-black SOR inner stage: a CUDA kernel and its plain XLA twin.

Both compute `delta` = n red-black SOR sweeps on A delta = rhs_neg from
delta = 0 -- the inner stage of the mixed-precision refinement solver
(ops/sor.py), which owns the f64 master pressure, the defect and the
reference convergence rule.  Both use the folded-Neumann formulation: the
ghost ring of delta stays zero and the missing neighbour of a
boundary-adjacent cell comes back through a per-cell self-coefficient, so no
ghost fill runs between half-sweeps.

`_roll_sweeps_xla` expresses the sweeps as fused XLA ops and is the oracle.
`inner_sweeps` runs csrc/rb_sor.cu through `jax.ffi`: each thread block
loads a tile plus a 2k-deep halo into shared memory and runs k sweeps there
before writing its core back -- the shared-memory tile of the reference's
`sor_shared_memory_kernel` (src/parallel/main.cu:384-511) with k sweeps per
launch instead of one half-sweep.  The kernel needs an NVIDIA GPU of compute
capability 9.0 (sm_90a); it is built by `make -C csrc cuda` on first use.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..config import Params

_REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", ".."))
_SRC_PATH = os.path.join(_REPO_ROOT, "csrc", "rb_sor.cu")
_LIB_PATH = os.path.join(_REPO_ROOT, "build", "libnsp_rbsor.so")
_TARGET = "nsp_rb_sor_sweeps"

# Sweeps per launch (the halo is 2k deep).
SWEEPS_PER_LAUNCH = 8
# Core tiles, largest first: the largest that still gives every SM of an
# H100 (132) a block is taken (PERF.md has the per-sweep times behind it).
TILES = ((32, 64), (32, 32), (16, 32))
MIN_BLOCKS = 132
# Shared memory one block may use on sm_90 (232,448 bytes).
SMEM_LIMIT_BYTES = 227 * 1024


class LaunchShape(NamedTuple):
    """How csrc/rb_sor.cu covers a padded (ni, nj) grid."""
    k: int            # most sweeps per launch
    tile: tuple       # (tile_i, tile_j) core cells written by one block
    ext: tuple        # (tile_i + 4k, tile_j + 4k) cells held in shared memory
    grid: tuple       # (blocks along j, blocks along i): CUDA's (x, y)
    smem_bytes: int   # delta + rhs tiles in float32

    def launches(self, max_sweeps: int) -> int:
        """Kernel launches one call makes for at most `max_sweeps` sweeps."""
        return -(-max_sweeps // self.k)


def _blocks(shape, tile) -> int:
    return -(-shape[0] // tile[0]) * -(-shape[1] // tile[1])


def pick_tile(shape) -> tuple:
    """The largest of TILES that gives at least MIN_BLOCKS blocks."""
    for tile in TILES:
        if _blocks(shape, tile) >= MIN_BLOCKS:
            return tile
    return TILES[-1]


def launch_shape(shape, k: int = SWEEPS_PER_LAUNCH,
                 tile=None) -> LaunchShape:
    """How the kernel covers a padded (ni, nj) grid; `tile` defaults to
    `pick_tile(shape)`."""
    ni, nj = (int(s) for s in shape)
    ti, tj = (int(t) for t in (tile or pick_tile((ni, nj))))
    if k < 1 or ti < 1 or tj < 1:
        raise ValueError(f"k and tile sizes must be positive, got k={k}, "
                         f"tile={tile}")
    ext = (ti + 4 * k, tj + 4 * k)
    smem = 2 * 4 * ext[0] * ext[1]
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"tile {(ti, tj)} with k={k} needs {smem} bytes of shared "
            f"memory; a block has {SMEM_LIMIT_BYTES}")
    return LaunchShape(k=k, tile=(ti, tj), ext=ext,
                       grid=(-(-nj // tj), -(-ni // ti)), smem_bytes=smem)


def _coefficients(params: Params):
    """float32 (omega, coef, dx2_inv, dy2_inv), rounded as the XLA twin
    rounds them."""
    f32 = np.float32
    dx2_inv = f32(1.0 / (params.dx * params.dx))
    dy2_inv = f32(1.0 / (params.dy * params.dy))
    omega = f32(params.omega)
    coef = omega / (f32(2.0) * (dx2_inv + dy2_inv))
    return omega, coef, dx2_inv, dy2_inv


def _roll_sweeps_xla(rhs_neg: jax.Array, n_sweeps, params: Params) -> jax.Array:
    """The plain twin of the CUDA kernel: the same roll + self-coefficient
    red-black formulation as fused XLA ops.  Wrap-around of the rolls lands
    only in the zero ghost ring, which the interior mask never updates."""
    ni, nj = params.shape
    f32 = jnp.float32
    dx2_inv = jnp.asarray(1.0 / (params.dx * params.dx), f32)
    dy2_inv = jnp.asarray(1.0 / (params.dy * params.dy), f32)
    omega = jnp.asarray(params.omega, f32)
    coef = omega / (2.0 * (dx2_inv + dy2_inv))

    ii = lax.broadcasted_iota(jnp.int32, (ni, nj), 0)
    jj = lax.broadcasted_iota(jnp.int32, (ni, nj), 1)
    interior = (ii >= 1) & (ii <= ni - 2) & (jj >= 1) & (jj <= nj - 2)
    par = (ii + jj) % 2
    red = interior & (par == 0)
    black = interior & (par == 1)
    self_coef = (
        ((ii == 1).astype(f32) + (ii == ni - 2).astype(f32)) * dx2_inv
        + ((jj == 1).astype(f32) + (jj == nj - 2).astype(f32)) * dy2_inv
    )
    rhs = rhs_neg.astype(f32)

    def half(d, mask):
        nb = (
            (jnp.roll(d, 1, 0) + jnp.roll(d, -1, 0)) * dx2_inv
            + (jnp.roll(d, 1, 1) + jnp.roll(d, -1, 1)) * dy2_inv
            + d * self_coef
        )
        return jnp.where(mask, (1.0 - omega) * d + coef * (nb - rhs), d)

    def sweep(_, d):
        return half(half(d, red), black)

    return lax.fori_loop(0, jnp.asarray(n_sweeps, jnp.int32), sweep,
                         jnp.zeros((ni, nj), f32))


def require_gpu() -> None:
    """Refuse, with the reason, to run the kernel anywhere but a GPU."""
    backend = jax.default_backend()
    if backend != "gpu":
        raise ValueError(
            f"pallas_sor runs the CUDA red-black SOR kernel (csrc/rb_sor.cu),"
            f" which needs an NVIDIA GPU; JAX's backend is {backend!r} -- "
            f"use method 'rb_sor'")


def build(force: bool = False) -> str:
    """Compile csrc/rb_sor.cu into build/ if needed; returns the library."""
    if force or not os.path.exists(_LIB_PATH) or (
            os.path.getmtime(_SRC_PATH) > os.path.getmtime(_LIB_PATH)):
        proc = subprocess.run(
            ["make", "-C", os.path.join(_REPO_ROOT, "csrc"), "cuda",
             f"PYTHON={sys.executable}"],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building the CUDA SOR kernel failed (make -C csrc cuda):\n"
                f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    return _LIB_PATH


_registered = False


def _register() -> None:
    global _registered
    if not _registered:
        lib = ctypes.cdll.LoadLibrary(build())
        jax.ffi.register_ffi_target(
            _TARGET, jax.ffi.pycapsule(lib.NspRbSorSweeps), platform="CUDA")
        _registered = True


def inner_sweeps(rhs_neg: jax.Array, n_sweeps, params: Params,
                 max_sweeps: int) -> jax.Array:
    """n_sweeps (traced, at most `max_sweeps`) red-black sweeps on the GPU;
    the same result as `_roll_sweeps_xla` up to FMA contraction."""
    return _launch(rhs_neg, n_sweeps, params, max_sweeps,
                   launch_shape(params.shape))


def _launch(rhs_neg, n_sweeps, params: Params, max_sweeps: int,
            ls: LaunchShape) -> jax.Array:
    """`inner_sweeps` with the launch shape given (scripts/sor_tile_probe.py
    times other tiles and k through it)."""
    require_gpu()
    _register()
    if max_sweeps < 1:
        raise ValueError(f"max_sweeps must be >= 1, got {max_sweeps}")
    omega, coef, dx2_inv, dy2_inv = _coefficients(params)
    field = jax.ShapeDtypeStruct(params.shape, jnp.float32)
    out, _ = jax.ffi.ffi_call(_TARGET, (field, field))(
        rhs_neg.astype(jnp.float32), jnp.asarray(n_sweeps, jnp.int32),
        k=np.int32(ls.k), tile_i=np.int32(ls.tile[0]),
        tile_j=np.int32(ls.tile[1]), max_sweeps=np.int32(max_sweeps),
        omega=omega, coef=coef, dx2_inv=dx2_inv, dy2_inv=dy2_inv)
    return out
