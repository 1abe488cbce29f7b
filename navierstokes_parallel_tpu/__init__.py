"""navierstokes_parallel_tpu — a GPU-accelerated incompressible Navier-Stokes
framework.

A from-scratch JAX/XLA re-design of the capabilities of
guilherme-webster/NavierStokes-parallel (a serial-C + CUDA 2D staggered-grid
lid-driven-cavity solver): donor-cell momentum stencils, red-black SOR
pressure-Poisson solver, adaptive CFL time stepping, Ghia et al. 1982
validation, exact parameter-file / output-format compatibility — plus what
the reference never had: a fully on-device convergence loop, a CUDA SOR
kernel that runs several sweeps per launch, multi-device grid sharding,
and checkpoint/resume.
"""

from .config import Params, load_params
from .grid import State, allocate_state, interior
from .solver import (
    SolveStats,
    StepDiagnostics,
    center_values,
    make_step_fn,
    solve,
    step,
)

__version__ = "0.1.0"

__all__ = [
    "Params",
    "load_params",
    "State",
    "allocate_state",
    "interior",
    "SolveStats",
    "StepDiagnostics",
    "center_values",
    "make_step_fn",
    "solve",
    "step",
    "__version__",
]
