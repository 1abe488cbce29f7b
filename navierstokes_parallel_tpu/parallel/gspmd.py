"""GSPMD auto-sharded backend: `jit` + `NamedSharding`, XLA inserts the
collectives.

The framework ships two complementary multi-chip paths:

  * `parallel/sharded.py` — the *manual* SPMD path: `shard_map` over local
    blocks, explicit `lax.ppermute` halo exchange, explicit `psum`/`pmax`
    reductions.  Maximum control; the direct analogue of the reference's
    CUDA tile + shared-memory-halo design (main.cu:384-511).
  * this module — the *compiler* path, the canonical JAX scaling recipe:
    annotate the state arrays' sharding over a 2D device mesh, `jit` the
    UNMODIFIED single-chip solver (solver.py), and let XLA's SPMD
    partitioner insert collective-permutes for the stencil shifts and
    all-reduces for the norms/maxima.

Because the partitioner shards arbitrary jnp programs, EVERY pressure
method — rb_sor, jacobi, mg (V-cycles incl. `reduce_window` restriction and
prolongation matmuls), cg, and the fft/DCT direct solve (distributed
matmuls) — runs multi-chip here with zero method-specific communication
code, closing the gap where the manual path supports only rb_sor/mg/cg.
Grids need not divide the mesh — the state is zero-padded to the next mesh
multiple only at the jit boundary (`_padded_shape`) and sliced back inside,
so the reference's default 257^2 workload (parameters.txt:3-4) shards as-is
with zero changes to the solver math.

The only ops the partitioner cannot shard are the opaque Pallas kernel
calls (it would gather their operands to one device), so this backend sets
`Params.disable_pallas`, routing momentum and the SOR inner stage through
the pure-jnp formulations.  Single-chip-per-method peak therefore belongs
to the Pallas backends; this path is about *scaling* the same math.

Reference analogue: none (the reference is single-GPU, SURVEY.md §2.4).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import Params
from ..grid import State, allocate_state
from ..solver import (AB2State, SolveStats, StepDiagnostics, ab2_init,
                      _solve_ab2_on_device, _solve_on_device, step,
                      step_ab2)
from .topology import MESH_AXES, choose_mesh_shape_square


def _default_mesh() -> Mesh:
    """Near-square mesh over all devices (both axes > 1 when possible —
    see _check_mesh; grid divisibility is irrelevant here, gspmd pads)."""
    devs = jax.devices()
    px, py = choose_mesh_shape_square(len(devs))
    return Mesh(np.asarray(devs).reshape(px, py), MESH_AXES)

# Every jnp-expressible pressure method; pallas_sor is excluded by design
# (see module docstring).
GSPMD_METHODS = ("rb_sor", "jacobi", "mg", "cg", "fft")


def _check_method(pressure_method: str) -> None:
    if pressure_method not in GSPMD_METHODS:
        raise ValueError(
            f"gspmd backend supports pressure methods {GSPMD_METHODS}, "
            f"got {pressure_method!r} (the Pallas kernels are opaque to the "
            f"SPMD partitioner)"
        )


def _check_mesh(mesh: Mesh) -> None:
    """Reject meshes with one trivial axis: XLA's SPMD partitioner
    MISCOMPILES composed boundary slice updates on (1,N)/(N,1) meshes —
    `p.at[0,1:-1].set(...).at[1:-1,0].set(...)` returns wrong VALUES, not
    an error (verified jax 0.9.0, CPU backend; minimal repro pinned as a
    canary in tests/test_gspmd.py so the guard is lifted when upstream
    fixes it).  Every method diverged or went NaN on such meshes.  The
    manual sharded backend is unaffected (its shard_map blocks never cross
    that partitioner path) and handles 1D meshes correctly."""
    px, py = mesh.devices.shape
    if mesh.devices.size > 1 and min(px, py) == 1:
        raise ValueError(
            f"gspmd backend rejects the {px}x{py} mesh: XLA's SPMD "
            "partitioner miscompiles boundary slice-update compositions "
            "when one mesh axis is trivial (silently wrong results). "
            "Use a 2D factorization (topology.choose_mesh_shape_square) "
            "or --backend sharded, which is correct on 1D meshes."
        )


def _shardings(mesh: Mesh):
    grid = NamedSharding(mesh, P(*MESH_AXES))
    rep = NamedSharding(mesh, P())
    return grid, rep


def _padded_shape(mesh: Mesh, shape) -> tuple:
    """Top-level jax.Arrays must divide the mesh evenly (uniform shard
    shapes); the GSPMD partitioner pads *intermediates* itself but not the
    jit boundary.  So the state crosses the boundary padded to the next
    per-axis mesh multiple, and the solver body slices the real
    (i_max+2, j_max+2) view back out — a sharded static slice, free for XLA."""
    px, py = mesh.devices.shape
    return (-(-shape[0] // px) * px, -(-shape[1] // py) * py)


def _put(host, sharding: NamedSharding):
    """Device-place host data under `sharding`; uses
    make_array_from_callback when some target devices belong to other
    processes (multi-process jax.distributed runs), where a plain
    device_put of global data would fail."""
    if all(d.process_index == jax.process_index()
           for d in sharding.device_set):
        return jax.device_put(host, sharding)
    host = np.asarray(host)
    return jax.make_array_from_callback(host.shape, sharding,
                                        lambda idx: host[idx])


def _fetch(x) -> np.ndarray:
    """Host-fetch a (possibly cross-process) sharded array."""
    if all(d.process_index == jax.process_index()
           for d in x.sharding.device_set):
        return np.asarray(x)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def _all_local(sharding_or_array) -> bool:
    dev = getattr(sharding_or_array, "device_set", None)
    if dev is None:
        dev = sharding_or_array.sharding.device_set
    return all(d.process_index == jax.process_index() for d in dev)


def place_state(state: State, mesh: Mesh) -> State:
    """Device-place a State: grid arrays boundary-padded and block-sharded
    over the mesh, scalars replicated.  Single-process: the pad happens
    on-device and device_put reshards device-to-device (no host round-trip
    — a full-grid host round-trip is expensive).  Multi-process
    jax.distributed: scattered via make_array_from_callback (per-process
    addressable shards)."""
    grid, rep = _shardings(mesh)
    pi, pj = _padded_shape(mesh, state.u.shape)

    def put(arr):
        ni, nj = arr.shape
        if _all_local(grid):
            padded = jnp.zeros((pi, pj), arr.dtype).at[:ni, :nj].set(
                jnp.asarray(arr))
            return jax.device_put(padded, grid)
        host = np.zeros((pi, pj), arr.dtype)
        host[:ni, :nj] = np.asarray(arr)
        return _put(host, grid)

    return State(
        u=put(state.u),
        v=put(state.v),
        p=put(state.p),
        t=_put(np.asarray(state.t), rep),
        n=_put(np.asarray(state.n), rep),
    )


def fetch_state(state: State, params: Params) -> State:
    """Reference-layout State from a (padded, sharded) output.  Single-
    process: a device-resident sliced view (np.asarray gathers lazily, like
    the pre-multiprocess behavior).  Multi-process: allgathered to host."""
    s = unpad_state(state, params)
    if _all_local(state.u):
        return s
    return State(u=jnp.asarray(_fetch(s.u)), v=jnp.asarray(_fetch(s.v)),
                 p=jnp.asarray(_fetch(s.p)), t=s.t, n=s.n)


def unpad_state(state: State, params: Params) -> State:
    """Slice the real (i_max+2, j_max+2) arrays back out of a
    boundary-padded State (still device-resident/sharded)."""
    ni, nj = params.shape
    return State(u=state.u[:ni, :nj], v=state.v[:ni, :nj],
                 p=state.p[:ni, :nj], t=state.t, n=state.n)


def _make_padded_jit(params: Params, mesh: Mesh, inner, aux_shardings):
    """Jit `inner(state) -> (State, aux)` over boundary-padded sharded
    arrays: unpad at entry, repad at exit, pin the output shardings."""
    grid, rep = _shardings(mesh)
    out_state = State(u=grid, v=grid, p=grid, t=rep, n=rep)
    ni, nj = params.shape
    pi, pj = _padded_shape(mesh, (ni, nj))

    def fn(padded: State):
        out, aux = inner(unpad_state(padded, params))
        return (
            State(u=_pad_grid(out.u, pi, pj, ni, nj),
                  v=_pad_grid(out.v, pi, pj, ni, nj),
                  p=_pad_grid(out.p, pi, pj, ni, nj),
                  t=out.t, n=out.n),
            aux,
        )

    return jax.jit(fn, out_shardings=(out_state, aux_shardings))


def _pad_grid(a, pi, pj, ni, nj):
    """Boundary-padded (pi, pj) embedding of a reference-layout grid —
    the ONE padding rule for every gspmd padded-jit wrapper (Euler and
    AB2 alike must never diverge on fill value or dtype)."""
    return jnp.zeros((pi, pj), a.dtype).at[:ni, :nj].set(a)


def _make_padded_jit_ab2(params: Params, mesh: Mesh, inner, aux_shardings):
    """AB2State twin of _make_padded_jit: the carried pytree additionally
    holds the two tendency grids (block-sharded like u/v) and the
    replicated dt_prev scalar — the GSPMD recipe shards the UNMODIFIED
    second-order stepper (solver.step_ab2), per the round-4 verdict."""
    grid, rep = _shardings(mesh)
    out_ab2 = AB2State(
        s=State(u=grid, v=grid, p=grid, t=rep, n=rep),
        ru=grid, rv=grid, dt_prev=rep,
    )
    ni, nj = params.shape
    pi, pj = _padded_shape(mesh, (ni, nj))

    def fn(padded: AB2State):
        out, aux = inner(AB2State(
            s=unpad_state(padded.s, params),
            ru=padded.ru[:ni, :nj], rv=padded.rv[:ni, :nj],
            dt_prev=padded.dt_prev,
        ))
        s = out.s
        return (
            AB2State(
                s=State(u=_pad_grid(s.u, pi, pj, ni, nj),
                        v=_pad_grid(s.v, pi, pj, ni, nj),
                        p=_pad_grid(s.p, pi, pj, ni, nj),
                        t=s.t, n=s.n),
                ru=_pad_grid(out.ru, pi, pj, ni, nj),
                rv=_pad_grid(out.rv, pi, pj, ni, nj),
                dt_prev=out.dt_prev,
            ),
            aux,
        )

    return jax.jit(fn, out_shardings=(out_ab2, aux_shardings))


def place_ab2(ab2: AB2State, mesh: Mesh) -> AB2State:
    """Device-place an AB2State (see place_state)."""
    grid, rep = _shardings(mesh)
    pi, pj = _padded_shape(mesh, ab2.s.u.shape)

    def put(arr):
        ni, nj = arr.shape
        if _all_local(grid):
            return jax.device_put(
                _pad_grid(jnp.asarray(arr), pi, pj, ni, nj), grid)
        host = np.zeros((pi, pj), np.asarray(arr).dtype)
        host[:ni, :nj] = np.asarray(arr)
        return _put(host, grid)

    return AB2State(s=place_state(ab2.s, mesh), ru=put(ab2.ru),
                    rv=put(ab2.rv),
                    dt_prev=_put(np.asarray(ab2.dt_prev), rep))


@functools.lru_cache(maxsize=32)
def _make_solve_ab2(params: Params, mesh: Mesh, pressure_method: str):
    rep = _shardings(mesh)[1]
    return _make_padded_jit_ab2(
        params, mesh,
        lambda ab2: _solve_ab2_on_device(params, ab2, pressure_method),
        SolveStats(rep, rep, rep, rep),
    )


@functools.lru_cache(maxsize=32)
def _make_step_ab2(params: Params, mesh: Mesh, pressure_method: str):
    rep = _shardings(mesh)[1]
    return _make_padded_jit_ab2(
        params, mesh,
        lambda ab2: step_ab2(ab2, params, pressure_method=pressure_method),
        StepDiagnostics(rep, rep, rep, rep),
    )


@functools.lru_cache(maxsize=32)
def _make_solve(params: Params, mesh: Mesh, pressure_method: str):
    rep = _shardings(mesh)[1]
    return _make_padded_jit(
        params, mesh,
        lambda state: _solve_on_device(params, state, pressure_method),
        SolveStats(rep, rep, rep, rep),
    )


@functools.lru_cache(maxsize=32)
def _make_step(params: Params, mesh: Mesh, pressure_method: str):
    rep = _shardings(mesh)[1]
    return _make_padded_jit(
        params, mesh,
        lambda state: step(state, params, pressure_method=pressure_method),
        StepDiagnostics(rep, rep, rep, rep),
    )


# Compiled-executable cache for compile_gspmd_solve (placement shardings
# are fully determined by the mesh in the key, so reuse is sound).
_SOLVE_EXEC_CACHE: dict = {}


def compile_gspmd_solve(
    params: Params,
    state: Optional[State] = None,
    mesh: Optional[Mesh] = None,
    *,
    pressure_method: str = "rb_sor",
    time_order: int = 1,
):
    """Place the state and AOT-compile the full gspmd solve; returns
    `run() -> (State, SolveStats)` so callers can time execution without
    compile dilution (reference protocol: solver seconds only).
    time_order=2 shards the unmodified AB2 integration (solver.solve_ab2);
    the returned State is the .s of the final AB2State."""
    _check_method(pressure_method)
    params = params.replace(disable_pallas=True)
    if state is None:
        state = allocate_state(params)
    if mesh is None:
        mesh = _default_mesh()
    _check_mesh(mesh)
    if time_order == 2:
        placed = place_ab2(ab2_init(state), mesh)
        maker = _make_solve_ab2
    else:
        placed = place_state(state, mesh)
        maker = _make_solve
    # Cache the AOT executable: .lower().compile() bypasses jit's call
    # cache, so without this every solve_gspmd call would re-trace and
    # re-compile (10-60 s per shape on the remote compile service).
    key = (params, mesh, pressure_method, time_order,
           jax.tree.map(lambda x: (x.shape, str(x.dtype)), placed))
    compiled = _SOLVE_EXEC_CACHE.get(key)
    if compiled is None:
        compiled = maker(params, mesh, pressure_method).lower(
            placed).compile()
        if len(_SOLVE_EXEC_CACHE) >= 32:
            _SOLVE_EXEC_CACHE.clear()
        _SOLVE_EXEC_CACHE[key] = compiled

    def run() -> Tuple[State, SolveStats]:
        out, stats = compiled(placed)
        if time_order == 2:
            out = out.s
        return unpad_state(out, params), stats

    return run


def solve_gspmd(
    params: Params,
    state: Optional[State] = None,
    mesh: Optional[Mesh] = None,
    *,
    pressure_method: str = "rb_sor",
) -> Tuple[State, SolveStats]:
    """Auto-sharded drop-in for solver.solve(): the whole `while t < T`
    integration is one jitted on-device while_loop over sharded arrays.
    The returned State's grid arrays remain sharded (np.asarray gathers)."""
    return compile_gspmd_solve(
        params, state, mesh, pressure_method=pressure_method)()


class GspmdStepper:
    """Host-loop adapter (periodic output / checkpoint / history) for the
    GSPMD backend; twin of cli._SingleChipStepper and sharded.ShardedStepper."""

    def __init__(self, params: Params, state: State,
                 mesh: Optional[Mesh] = None,
                 pressure_method: str = "rb_sor",
                 time_order: int = 1):
        _check_method(pressure_method)
        params = params.replace(disable_pallas=True)
        if mesh is None:
            mesh = _default_mesh()
        _check_mesh(mesh)
        self.params = params
        self.mesh = mesh
        self.time_order = time_order
        if time_order == 2:
            self._fn = _make_step_ab2(params, mesh, pressure_method)
            self._state = place_ab2(ab2_init(state), mesh)
        else:
            self._fn = _make_step(params, mesh, pressure_method)
            self._state = place_state(state, mesh)

    def _base(self) -> State:
        return self._state.s if self.time_order == 2 else self._state

    @property
    def t(self) -> float:
        return float(self._base().t)

    @property
    def n(self) -> int:
        return int(self._base().n)

    def warm(self) -> None:
        """AOT-compile the step so timed host loops exclude compilation."""
        self._fn = self._fn.lower(self._state).compile()

    def step(self) -> StepDiagnostics:
        self._state, diag = self._fn(self._state)
        return diag

    def state(self) -> State:
        return fetch_state(self._base(), self.params)
