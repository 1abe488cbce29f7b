"""Runtime numerical guards.

The reference's failure handling is an abort-on-error CUDA macro
(CHECK_CUDA_ERROR, main.cu:36-43) and silently-ignored SOR non-convergence
(main.c:123).  The framework's equivalents:

  * XLA raises on compile/runtime errors by itself;
  * SOR non-convergence is *tracked* (SolveStats.sor_failures) and surfaced
    by the CLI --stats;
  * this module adds explicit finite-ness guards: `validate_state` for host
    boundaries (checkpoint save/load, output), and `enable_nan_debugging`
    which turns on jax_debug_nans so the first NaN-producing primitive
    faults with a traceback instead of silently polluting the simulation
    (the CFL dt feeding on a NaN max is the classic blowup mode).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..grid import State


class NonFiniteStateError(RuntimeError):
    pass


def validate_state(state: State, where: str = "") -> State:
    """Host-side guard: raise if any field contains NaN/Inf.  Accepts any
    state family (State, ThermalState) — the temperature field is checked
    when present."""
    names = ("u", "v", "p") + (("T",) if hasattr(state, "T") else ())
    for name in names:
        arr = np.asarray(getattr(state, name))
        if not np.all(np.isfinite(arr)):
            bad = int(np.sum(~np.isfinite(arr)))
            raise NonFiniteStateError(
                f"{bad} non-finite values in {name}"
                f"{' at ' + where if where else ''} (t={float(state.t):.6f}); "
                f"likely CFL blowup — lower tau or refine the grid"
            )
    return state


def enable_nan_debugging(enable: bool = True) -> None:
    """Fault on the first NaN-producing op (device-side, debug builds)."""
    jax.config.update("jax_debug_nans", enable)


def divergence_norm(u, v, params) -> float:
    """L2 norm of the discrete velocity divergence over the interior.

    The projection step exists to drive this to ~0 (incompressibility);
    its residual is bounded by the pressure solve's stopping tolerance
    times dt — a cheap end-to-end physics invariant."""
    u = np.asarray(u)
    v = np.asarray(v)
    div = (u[1:-1, 1:-1] - u[:-2, 1:-1]) / params.dx + (
        v[1:-1, 1:-1] - v[1:-1, :-2]
    ) / params.dy
    return float(np.sqrt(np.sum(div**2) / (params.i_max * params.j_max)))


def cfl_report(u, v, params) -> dict:
    """Diagnostic: current CFL numbers (how close to the stability limit)."""
    u_max = float(jnp.max(jnp.abs(u[1:-1, 1:-1])))
    v_max = float(jnp.max(jnp.abs(v[1:-1, 1:-1])))
    visc = params.Re / 2.0 / (1.0 / params.dx**2 + 1.0 / params.dy**2)
    return {
        "u_max": u_max,
        "v_max": v_max,
        "dt_viscous_limit": visc,
        "dt_convective_x": params.dx / u_max if u_max else float("inf"),
        "dt_convective_y": params.dy / v_max if v_max else float("inf"),
    }
