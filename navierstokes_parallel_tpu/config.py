"""Simulation configuration.

`Params` is the framework's equivalent of the reference's 15-line
positional parameter file (reference: src/serial/io.c:12-59, format documented
in parameters.txt:1-15).  It round-trips the exact ``.in`` format so the
reference's ``tests/1.in``-``4.in`` and ``parameters.txt`` run unmodified,
while also being a plain dataclass for idiomatic programmatic use.

File format (one value per line, ``#`` comments ignored):

    1  problem   (int)    1 = lid-driven cavity, 2 = oscillating lid,
                          3 = plane channel (beyond-reference,
                          models/channel.py), 4 = free-slip box
                          (beyond-reference, models/taylorgreen.py)
    2  f         (float)  lid oscillation frequency (problem 2 only)
    3  i_max     (int)    interior cells in x
    4  j_max     (int)    interior cells in y
    5  a         (float)  domain length in x
    6  b         (float)  domain length in y
    7  T         (float)  integration end time
    8  Re        (float)  Reynolds number
    9  g_x       (float)  body force x
    10 g_y       (float)  body force y
    11 tau       (float)  CFL safety factor
    12 omega     (float)  SOR relaxation factor
    13 epsilon   (float)  SOR relative tolerance
    14 max_it    (int)    SOR max iterations
    15 n_print   (int)    output every n-th step
"""

from __future__ import annotations

import dataclasses
from typing import Union

import jax.numpy as jnp

# (name, type) in exact file order — the contract from the reference parser.
_FIELD_ORDER = (
    ("problem", int),
    ("f", float),
    ("i_max", int),
    ("j_max", int),
    ("a", float),
    ("b", float),
    ("T", float),
    ("Re", float),
    ("g_x", float),
    ("g_y", float),
    ("tau", float),
    ("omega", float),
    ("epsilon", float),
    ("max_it", int),
    ("n_print", int),
)

_FIELD_COMMENTS = {
    "problem": "problem (1: lid-driven cavity, 2: periodic boundary)",
    "f": "f: frequency of the periodic boundary conditions (only if problem = 2)",
    "i_max": "i_max",
    "j_max": "j_max",
    "a": "Side a length",
    "b": "Side b length",
    "T": "Time to integrate",
    "Re": "Reynolds number",
    "g_x": "x-component of g",
    "g_y": "y-component of g",
    "tau": "Security factor tau.",
    "omega": "Relaxation factor for SOR. (1.0 is Gauss-Seidel)",
    "epsilon": "Relative tolerance for SOR.",
    "max_it": "Maximum iterations for SOR.",
    "n_print": "Print results to file every nth step.",
}


@dataclasses.dataclass(frozen=True)
class Params:
    """All solver parameters. Frozen so it can be closed over by jitted fns."""

    problem: int = 1
    f: float = 1.0
    i_max: int = 128
    j_max: int = 128
    a: float = 1.0
    b: float = 1.0
    T: float = 1.0
    Re: float = 1000.0
    g_x: float = 0.0
    g_y: float = 0.0
    tau: float = 1.0
    omega: float = 1.7
    epsilon: float = 1e-4
    max_it: int = 500
    n_print: int = 1

    # Solver knobs (not part of the .in format).
    dtype: str = "float32"
    # Donor-cell upwind weight override.  The reference ties gamma to the
    # CFL number every step (main.c:92: gamma = max(u dt/dx, v dt/dy) —
    # when dt is advection-limited this is exactly tau), which entangles
    # the temporal refinement with the spatial operator: reducing dt also
    # reduces the upwind dissipation by O(dt), an error term LINEAR in
    # tau that no higher-order integrator can remove (measured: the AB2
    # stepper's observed temporal order is 1 under adaptive gamma, 2 with
    # gamma held fixed — tests/test_ab2.py).  Set a float to decouple:
    # any fixed gamma >= the worst-step CFL (<= tau by construction) is
    # admissible (Griebel et al. sect. 3.2.4 require CFL <= gamma <= 1);
    # 0.0 selects pure central differencing (stable when the cell Peclet
    # number u*dx*Re < 2).  None keeps the reference's adaptive gamma.
    gamma_fixed: float | None = None
    # Mixed-precision SOR: re-baseline the f64 master pressure (and check
    # convergence) every K f32 sweeps; 0 disables refinement (see ops/sor.py).
    # Only used when dtype == float32 and jax x64 is enabled.
    sor_refine_every: int = 64
    # Route every compute stage through plain jnp/XLA instead of the CUDA
    # SOR kernel (method "pallas_sor").  Set by the GSPMD auto-sharded
    # backend (parallel/gspmd.py) and the batched ensemble: XLA's SPMD
    # partitioner can shard any jnp op but not an opaque foreign call.
    disable_pallas: bool = False
    # Sharded backend: local sweeps per cross-shard halo exchange in the
    # communication-avoiding deep-halo inner stage (parallel/deep_halo.py).
    # Each exchange carries a 2K-deep strip and buys K exact local sweeps
    # (clamped to the local block size at solve time).
    sor_comm_every: int = 8
    # Free-surface runs: marker-seeding density in particles per CELL AXIS
    # (models/freesurface.py fill_region).  Lives in Params because the
    # fill-fraction normalization count/ppc^2 (ops/surface.py cell_flags,
    # read by the sub-cell SUMMAC surface condition) MUST match the
    # seeding density — threading it out-of-band through every call made
    # silent mismatches (saturated/quantized fill fractions) too easy.
    # Setups that need finer fill resolution (models/freesurface.py
    # sloshing seeds 6) set it here once.
    particles_per_cell: int = 3
    # Spectral method: direct DCT solves chained per f64 refinement pass,
    # with cheap f32 defect re-evaluation between them (ops/fft.py
    # inner_direct).  >1 amortizes the f64 outer pass where it rivals the
    # transform cost at large grids, at the price of overshooting
    # convergence by up to s-1 solves.  Single-chip only;
    # the sharded pencil inner always runs 1 (its outer norms are psum'd).
    fft_solves_per_outer: int = 1
    # Multigrid: V-cycles chained per f64 refinement pass (the mg analogue
    # of fft_solves_per_outer; ops/mg.py inner_v_cycle's n_cycles).  The
    # chained cycles smooth the implicit f32 residual, so convergence costs
    # ~10% extra cycles at c=2 (measured 16->18 at 256^2, 31->34 at 512^2)
    # while the f64 outer passes HALVE — a net win wherever the
    # outer pass rivals the V-cycle cost (A/B with
    # scripts/step_breakdown.py before flipping).  Single-chip mg only; the
    # sharded mg inner keeps 1 (its outer norms are psum'd).
    mg_cycles_per_outer: int = 1
    # Matmul precision of the DCT matmul route ("highest" = full f32;
    # "high" and "default" let an H100 round the operands to TF32).
    # Lower precision cuts transform cost; each direct solve reduces the
    # defect less, so the refinement outer runs more solves — the
    # convergence CONTRACT is unchanged (the outer's defect check is
    # exact), only the solve count moves.  Measure on the card before use;
    # the rfft route ignores this (its butterflies are true f32).
    fft_precision: str = "highest"
    # Precision strategy of the refinement outer (defect + L2 + master
    # update, ops/sor.py).  "float64" is the reference-faithful default;
    # "compensated" replaces it with error-free two-float f32 arithmetic
    # (ops/compensated.py) — same convergence contract, no f64 ops and no
    # global x64 requirement.  Measure before flipping the default.
    outer_precision: str = "float64"
    # Obstacle cells (flag-field domains, Griebel et al. sect. 5.1 — the
    # reference has NO analogue): a static tuple of axis-aligned rectangles
    # ((i0, i1, j0, j1), ...) of 1-based INCLUSIVE interior cell ranges
    # marked solid.  Static (hashable) so the masks fold into the jit
    # program as constants.  Velocity faces get no-slip, the pressure
    # operator drops solid neighbors per cell (ops/obstacles.py,
    # ops/masked.py); obstacle runs use the masked rb_sor/mg solvers
    # (fft/cg/pallas_sor reject them; the sharded backend runs rb_sor).
    obstacles: tuple = ()
    # Optional analytic surfaces behind the rasterized obstacle cells, for
    # SECOND-ORDER boundary conditions (ghost-fluid interpolated
    # reflection, ops/obstacles.py::ib_weights): a static tuple of shape
    # descriptors — ("circle", cx, cy, r), ("box", x0, x1, y0, y1), or
    # ("plane", nx, ny, c) with the solid on the nx*x + ny*y < c side.
    # The level set phi (positive in fluid) of the union locates the TRUE
    # wall along each grid line, so BC-controlled velocity edges get
    # linearly interpolated/extrapolated values that put the numerical
    # wall on the analytic surface instead of the cell staircase —
    # removing the O(dx) staircase geometry error that leaves the
    # Schäfer-Turek force coefficients 2-5% low.  Empty () keeps the
    # plain mirror/zero staircase semantics.
    obstacle_surfaces: tuple = ()
    # Pressure operator at immersed boundaries (ops/masked.py):
    #   "staircase" — binary neighbor weights (solid neighbor -> weight 0),
    #                 the homogeneous-Neumann wall sits on the cell faces.
    #   "aperture"  — cut-cell face fractions from the obstacle_surfaces
    #                 level set (ops/obstacles.py::apertures): each
    #                 fluid-fluid face weight is scaled by its open
    #                 fraction and the Poisson RHS uses the aperture-
    #                 weighted divergence, so the Neumann wall sits on the
    #                 TRUE surface (second order, vs O(dx) staircase
    #                 placement).  Requires obstacle_surfaces.
    #   "auto"      — aperture iff obstacle_surfaces is set.
    # The round-3/4 Schäfer-Turek ladders showed the staircase pressure
    # operator is what keeps cd/cl outside the published bands even with
    # second-order ghost-fluid velocity BCs.
    obstacle_pressure: str = "auto"
    # Problem 5 (natural convection, models/convection.py) thermal
    # parameters — reachable from the reference protocol via OPTIONAL
    # extra parameter-file lines 16 (Ra) and 17 (Pr), see from_lines.
    # The family uses the convective velocity scale sqrt(g*beta*dT*L), in
    # which Re = sqrt(Ra/Pr): when Ra > 0 it is authoritative and Re is
    # DERIVED from it in __post_init__; Ra = 0 derives Ra = Re^2 * Pr
    # from the file's Re line instead.  Both are always consistent after
    # construction.  t_hot/t_cold are the Dirichlet wall temperatures
    # (hot left / cold right — the de Vahl Davis benchmark orientation).
    Ra: float = 0.0
    Pr: float = 0.71
    t_hot: float = 0.5
    t_cold: float = -0.5
    # Problem 6 (free-surface flow, models/freesurface.py) — the initial
    # liquid region [fluid_x0, fluid_x1] x [fluid_y0, fluid_y1] seeded
    # with marker particles, reachable from the reference protocol via
    # OPTIONAL extra parameter-file lines 16-19 (x0, x1, y0, y1), see
    # from_lines.  Sentinels -1 derive the dam-break default column
    # x in [0, a/4], y in [0, b/2] in __post_init__.  Gravity comes from
    # the standard g_x/g_y lines.
    fluid_x0: float = 0.0
    fluid_x1: float = -1.0
    fluid_y0: float = 0.0
    fluid_y1: float = -1.0

    def __post_init__(self):
        if self.problem not in (1, 2, 3, 4, 5, 6):
            raise ValueError(
                f"unknown problem type {self.problem} (expected 1: cavity, "
                f"2: oscillating lid, 3: plane channel, 4: free-slip box, "
                f"5: natural convection, 6: free surface)")
        if self.problem == 6:
            # Only the exact -1 sentinel means "use the default"; any other
            # negative value is a misconfiguration and falls through to the
            # box validation below.
            if self.fluid_x1 == -1.0:
                object.__setattr__(self, "fluid_x1", 0.25 * self.a)
            if self.fluid_y1 == -1.0:
                object.__setattr__(self, "fluid_y1", 0.5 * self.b)
            if not (0.0 <= self.fluid_x0 < self.fluid_x1 <= self.a
                    and 0.0 <= self.fluid_y0 < self.fluid_y1 <= self.b):
                raise ValueError(
                    f"problem 6 fluid region [{self.fluid_x0}, "
                    f"{self.fluid_x1}] x [{self.fluid_y0}, {self.fluid_y1}]"
                    f" must be a nonempty box inside the {self.a} x "
                    f"{self.b} domain")
        if self.problem == 5:
            if self.Pr <= 0.0:
                raise ValueError(f"Pr must be > 0, got {self.Pr}")
            if self.Ra < 0.0:
                raise ValueError(f"Ra must be >= 0, got {self.Ra}")
            if self.Ra > 0.0:
                object.__setattr__(
                    self, "Re", float((self.Ra / self.Pr) ** 0.5))
            else:
                object.__setattr__(
                    self, "Ra", float(self.Re * self.Re * self.Pr))
        if self.i_max < 2 or self.j_max < 2:
            raise ValueError("grid must be at least 2x2 interior cells")
        if not (0.0 < self.omega < 2.0):
            raise ValueError(f"SOR omega must be in (0, 2), got {self.omega}")
        if self.max_it < 1:
            raise ValueError("max_it must be >= 1")
        if self.sor_comm_every < 1:
            raise ValueError(
                f"sor_comm_every must be >= 1, got {self.sor_comm_every}")
        if not (1 <= self.fft_solves_per_outer <= 8):
            raise ValueError(
                f"fft_solves_per_outer must be in 1..8, got "
                f"{self.fft_solves_per_outer}")
        if not (2 <= self.particles_per_cell <= 16):
            # >= 2 per axis is the standard guard against spurious cell
            # emptying (Griebel sect. 8.1); 16^2 = 256/cell is far past
            # any useful density.
            raise ValueError(
                f"particles_per_cell must be in 2..16, got "
                f"{self.particles_per_cell}")
        if self.obstacles:
            # Normalize to a hashable tuple-of-tuples (callers may pass
            # lists); frozen dataclass needs object.__setattr__.
            rects = tuple(tuple(int(x) for x in r) for r in self.obstacles)
            object.__setattr__(self, "obstacles", rects)
            for r in rects:
                if len(r) != 4:
                    raise ValueError(
                        f"obstacle rect must be (i0, i1, j0, j1), got {r}")
                i0, i1, j0, j1 = r
                if not (1 <= i0 <= i1 <= self.i_max
                        and 1 <= j0 <= j1 <= self.j_max):
                    raise ValueError(
                        f"obstacle rect {r} outside the interior "
                        f"[1, {self.i_max}] x [1, {self.j_max}]")
        if self.obstacle_surfaces:
            if not self.obstacles:
                raise ValueError(
                    "obstacle_surfaces requires obstacles (the analytic "
                    "surfaces refine the rasterized cells' BCs — they do "
                    "not define geometry on their own)")
            _ARITY = {"circle": 4, "box": 5, "plane": 4}
            surfs = []
            for s in self.obstacle_surfaces:
                s = tuple(s)
                if not s or s[0] not in _ARITY:
                    raise ValueError(
                        f"unknown obstacle surface {s!r} (expected "
                        f"('circle', cx, cy, r), ('box', x0, x1, y0, y1) "
                        f"or ('plane', nx, ny, c))")
                if len(s) != _ARITY[s[0]]:
                    raise ValueError(
                        f"obstacle surface {s!r} has wrong arity")
                vals = tuple(float(x) for x in s[1:])
                if s[0] == "circle" and vals[2] <= 0:
                    raise ValueError(f"circle radius must be > 0: {s!r}")
                if s[0] == "plane" and vals[0] == 0 and vals[1] == 0:
                    raise ValueError(f"plane normal must be nonzero: {s!r}")
                surfs.append((s[0],) + vals)
            object.__setattr__(self, "obstacle_surfaces", tuple(surfs))
        if self.obstacle_pressure not in ("auto", "staircase", "aperture"):
            raise ValueError(
                f"obstacle_pressure must be 'auto', 'staircase' or "
                f"'aperture', got {self.obstacle_pressure!r}")
        if self.obstacle_pressure == "aperture" and not self.obstacle_surfaces:
            raise ValueError(
                "obstacle_pressure='aperture' needs obstacle_surfaces (the "
                "face fractions come from the analytic level set)")
        if not (1 <= self.mg_cycles_per_outer <= 8):
            raise ValueError(
                f"mg_cycles_per_outer must be in 1..8, got "
                f"{self.mg_cycles_per_outer}")
        if self.fft_precision not in ("highest", "high", "default"):
            raise ValueError(
                f"fft_precision must be 'highest', 'high' or 'default', got "
                f"{self.fft_precision!r}")
        if self.outer_precision not in ("float64", "compensated"):
            raise ValueError(
                f"outer_precision must be 'float64' or 'compensated', got "
                f"{self.outer_precision!r}")

    # -- derived quantities ------------------------------------------------
    @property
    def dx(self) -> float:
        return self.a / self.i_max

    @property
    def dy(self) -> float:
        return self.b / self.j_max

    @property
    def jnp_dtype(self):
        return jnp.dtype(self.dtype)

    @property
    def shape(self) -> tuple:
        """Padded field shape: one ghost layer on each side."""
        return (self.i_max + 2, self.j_max + 2)

    # -- .in format round-trip ----------------------------------------------
    @classmethod
    def from_file(cls, path: str, **overrides) -> "Params":
        """Parse the reference's 15-line positional parameter format."""
        with open(path, "r") as fh:
            lines = fh.readlines()
        return cls.from_lines(lines, **overrides)

    @classmethod
    def from_lines(cls, lines, **overrides) -> "Params":
        values = {}
        if len(lines) < len(_FIELD_ORDER):
            raise ValueError(
                f"parameter file has {len(lines)} lines, need {len(_FIELD_ORDER)}"
            )
        for (name, typ), line in zip(_FIELD_ORDER, lines):
            token = line.split("#", 1)[0].split()
            if not token:
                raise ValueError(f"missing value for '{name}'")
            # int fields may be written as '500' or '500.0'
            values[name] = typ(float(token[0])) if typ is int else typ(token[0])
        # Problem 5 (natural convection): optional extra lines 16 = Ra,
        # 17 = Pr.  The 15-line reference format stays valid (Ra derived
        # from the Re line via Ra = Re^2 * Pr, see __post_init__).
        if values.get("problem") == 5:
            for name, line in zip(("Ra", "Pr"), lines[len(_FIELD_ORDER):]):
                token = line.split("#", 1)[0].split()
                if token:
                    values[name] = float(token[0])
        # Problem 6 (free surface): optional extra lines 16-19 = the
        # initial liquid box x0, x1, y0, y1 (defaults: dam-break column,
        # see __post_init__).
        if values.get("problem") == 6:
            names = ("fluid_x0", "fluid_x1", "fluid_y0", "fluid_y1")
            for name, line in zip(names, lines[len(_FIELD_ORDER):]):
                token = line.split("#", 1)[0].split()
                if token:
                    values[name] = float(token[0])
        values.update(overrides)
        return cls(**values)

    def to_file(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write(self.to_text())

    def to_text(self) -> str:
        out = []
        for name, typ in _FIELD_ORDER:
            val = getattr(self, name)
            sval = str(int(val)) if typ is int else repr(float(val))
            out.append(f"{sval:<12}# {_FIELD_COMMENTS[name]}")
        if self.problem == 5:
            out.append(f"{self.Ra!r:<12}# Ra: Rayleigh number (problem 5)")
            out.append(f"{self.Pr!r:<12}# Pr: Prandtl number (problem 5)")
        if self.problem == 6:
            for name, label in (("fluid_x0", "x0"), ("fluid_x1", "x1"),
                                ("fluid_y0", "y0"), ("fluid_y1", "y1")):
                out.append(f"{getattr(self, name)!r:<12}# {label}: initial "
                           f"liquid box (problem 6)")
        return "\n".join(out) + "\n"

    def replace(self, **kw) -> "Params":
        return dataclasses.replace(self, **kw)


def load_params(path_or_params: Union[str, Params], **overrides) -> Params:
    if isinstance(path_or_params, Params):
        return path_or_params.replace(**overrides) if overrides else path_or_params
    return Params.from_file(path_or_params, **overrides)
