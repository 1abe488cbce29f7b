"""Kármán vortex street (models/karman.py).

Layers: rasterizer geometry units, frequency-extraction units on
synthetic signals, and end-to-end shedding runs — the square cylinder
(exact geometry, cheap) asserts onset + a sustained limit cycle + a
Strouhal band, and the Schäfer-Turek circle asserts the staircase
cylinder's St against the published 2D-2 band with a documented
resolution allowance (the fine-grid numbers live in
artifacts/karman_strouhal.csv)."""

import jax.numpy as jnp
import numpy as np
import pytest

from navierstokes_parallel_tpu.models import karman as K
from navierstokes_parallel_tpu.ops import obstacles as obs


def test_circle_rasterization_geometry():
    """The staircase disk passes the obstacle geometry validation at
    every resolution, is symmetric about both axes of the Schäfer-Turek
    center, and its area converges to pi/4 at O(dx)."""
    for n in (10, 20, 30):
        params = K.schafer_turek(n_per_d=n, T=1.0)
        m = obs.masks(params)    # raises on thin walls / disconnection
        solid = ~m.fluid[1:-1, 1:-1]
        area = solid.sum() * params.dx * params.dy
        assert abs(area - np.pi / 4) < 2.5 / n, (n, area)
        # Center (2.0, 2.0) sits on a cell corner at these resolutions ->
        # the rasterized disk is mirror-symmetric in both axes.
        ci = int(round(2.0 / params.dx))     # cells 1..ci mirror ci+1..2ci
        cj = int(round(2.0 / params.dy))
        block = solid[: 2 * ci, : 2 * cj]
        np.testing.assert_array_equal(block, block[::-1, :])
        np.testing.assert_array_equal(block, block[:, ::-1])


def test_circle_rasterization_rejects_unresolved():
    with pytest.raises(ValueError, match="zero cells|refine"):
        K.circle_rects(2.0, 2.0, 0.01, 0.1, 0.1, 220, 41)
    with pytest.raises(ValueError, match="multiple of 10"):
        K.schafer_turek(n_per_d=16)


def test_strouhal_synthetic():
    """Exact recovery of a known frequency from nonuniformly-sampled data
    (adaptive dt makes the real records nonuniform), and a 0 verdict for
    a dead wake."""
    rng = np.random.default_rng(0)
    t = np.cumsum(0.02 + 0.01 * rng.random(4000))
    f = 0.21
    sig = 0.3 * np.sin(2 * np.pi * f * t) + 0.05   # mean offset
    st, amp = K.strouhal(t, sig, d=1.0, u_mean=1.0)
    assert abs(st - f) / f < 0.01, st
    assert abs(amp - 0.3) < 0.01
    st0, amp0 = K.strouhal(t, np.full_like(t, 0.7))
    assert st0 == 0.0 and amp0 < 1e-12


def test_square_cylinder_sheds():
    """Confined square cylinder at Re_D = 100 (Breuer et al. 2000
    geometry): an impulsive start develops a saturated vortex street —
    sustained cross-stream oscillation in the wake and a Strouhal number
    in the physical band.  Band: measured 0.194 (u_mean convention) at
    8 cells/D; +-20% guards the test against grid/probe sensitivity
    while still failing for a dead wake (St 0), a symmetric solution, or
    a broken obstacle mask (no oscillation at all)."""
    params = K.square_cylinder(n_per_d=8, T=80.0)
    trace = K.shedding_signal(params, method="mg")
    assert trace.stats.sor_failures == 0
    st, amp = K.strouhal(trace.t, trace.v)
    assert amp > 0.1, f"wake never saturated (amp={amp})"
    assert 0.155 <= st <= 0.235, st


def test_schafer_turek_circle_strouhal_and_forces():
    """Schäfer-Turek 2D-2 (circular cylinder, Re_D = 100): published
    fine-grid bands are St in [0.2950, 0.3050], cd_max in [3.22, 3.24],
    cl_max in [0.99, 1.01], dp in [2.46, 2.50] (Schäfer & Turek 1996,
    table 4).  At 10 cells/D the staircase disk measures St 0.261,
    cd_max 3.64, cl_max 0.64, dp 2.32, converging first-order toward
    the bands (the resolution study is the recorded artifact,
    artifacts/karman_strouhal.csv).  The asserted windows around the
    coarse-grid values catch a dead wake, a wrong normalization (u_max
    vs u_mean), a broken masked solver, or a sign/face error in the
    control-volume force balance — each of which moves a quantity far
    outside its window."""
    # T=85 (analysis window starts at 0.7*85 = 59.5): the wake is fully
    # saturated well before that — every golden below re-measured at T=85
    # within 0.2% of its T=110 value (2026-08-20), so the shorter run
    # asserts the same numbers at ~75% of the single-core cost.
    params = K.schafer_turek(n_per_d=10, T=85.0)
    rec = K.surface_force_record_fn(params, 5, *K.probe_node(params))
    trace = K.shedding_signal(params, method="mg", record_fn=rec)
    assert trace.stats.sor_failures == 0
    st, amp = K.strouhal(trace.t, trace.v, skip_frac=0.7)
    assert amp > 0.2, f"wake never saturated (amp={amp})"
    co = K.coefficients(trace, params, skip_frac=0.7)
    # Golden coarse-grid values (sharp ghost-fluid velocity BCs + cut-cell
    # aperture pressure operator — the sharp default, measured 2026-08-19
    # on CPU x64 with the f32 state): a 15% force regression sailed
    # through the old physical-band windows (round-3 verdict); +-3%
    # around the committed values catches drift while absorbing
    # cross-platform f32 reduction noise.  The staircase-pressure A/B at
    # this grid: st 0.2606, cd_max 3.7084, cl_max 0.6675, dp 2.3161.
    assert st == pytest.approx(0.2626, rel=0.03), st
    assert co["cd_max"] == pytest.approx(3.6127, rel=0.03), co
    assert co["cl_max"] == pytest.approx(0.6310, rel=0.03), co
    assert co["dp_mean"] == pytest.approx(2.3130, rel=0.03), co
    assert abs(co["cl_mean"]) < 0.15, co        # lift oscillates about 0
    # The INDEPENDENT surface-traction estimator on the same trace: at
    # 10 cells/D its probe rings (1.2h/2.2h off the wall) span a good
    # fraction of the boundary layer, so it reads systematically low —
    # the goldens pin that coarse-grid behavior; the two estimators
    # converge toward each other on the recorded ladder
    # (artifacts/karman_strouhal.csv).
    assert co["cd_s_max"] == pytest.approx(2.8473, rel=0.03), co
    assert co["cl_s_max"] == pytest.approx(0.5553, rel=0.03), co
    assert abs(co["cl_s_mean"]) < 0.15, co


def test_control_volume_force_zero_on_uniform_flow():
    """On a uniform field (u = const, v = 0, p = 0) every control-volume
    face integral cancels exactly and the CV momentum is constant —
    catches any off-by-one asymmetry in the staggered face slices."""
    from navierstokes_parallel_tpu.grid import allocate_state

    params = K.schafer_turek(n_per_d=10, T=1.0)
    rec = K.force_record_fn(params, 4, *K.probe_node(params))
    state = allocate_state(params)
    state = state._replace(u=state.u + 0.7)
    out = rec(state)
    assert abs(float(out["sx"])) < 1e-12
    assert abs(float(out["sy"])) < 1e-12
    assert abs(float(out["dp"])) < 1e-12
    # Momentum = 0.7 * fluid area of the CV.
    I0, I1, J0, J1 = K.control_volume(params, 4)
    from navierstokes_parallel_tpu.ops.obstacles import fluid_mask
    area = fluid_mask(params)[I0:I1 + 1, J0:J1 + 1].sum() \
        * params.dx * params.dy
    # f32 state by default -> pairwise-sum accumulation noise only.
    np.testing.assert_allclose(float(out["mx"]), 0.7 * area, rtol=1e-5)
    assert abs(float(out["my"])) < 1e-12


def test_surface_quadrature_linear_pressure_exact():
    """Manufactured linear pressure p = a x + b y with zero velocity: the
    traction integral must equal the divergence-theorem force
    -grad(p) * pi r^2 to machine precision — bilinear interpolation and
    the linear wall extrapolation are both exact on linear fields because
    every probe stencil is all-fluid by construction (surface_quadrature
    pushes the rings outward until it is)."""
    params = K.schafer_turek(n_per_d=20, T=1.0)
    q = obs.surface_quadrature(params)
    # Every gather stencil reads genuine fluid nodes only.
    m = obs.masks(params)
    for tbl, valid in ((q.p1, m.fluid), (q.p2, m.fluid),
                       (q.u1, ~m.u_solid), (q.u2, ~m.u_solid),
                       (q.v1, ~m.v_solid), (q.v2, ~m.v_solid)):
        ii, jj, _ = tbl
        assert valid[ii, jj].all()
    ni, nj = params.i_max + 2, params.j_max + 2
    x = (np.arange(ni)[:, None] - 0.5) * params.dx
    y = (np.arange(nj)[None, :] - 0.5) * params.dy
    p = jnp.asarray(3.0 * x + 2.0 * y)
    z = jnp.zeros((ni, nj))
    fx, fy = obs.surface_force(z, z, p, params, q)
    exact = -np.pi * 0.25 * np.array([3.0, 2.0])   # r = 1/2
    np.testing.assert_allclose([float(fx), float(fy)], exact,
                               rtol=0, atol=1e-10)


def test_surface_quadrature_wall_slope():
    """Manufactured tangential field u_t = omega * (rho - r) (vanishes on
    the circle, linear in wall distance along every normal): the fitted
    wall slope du_t/dn must recover omega at every sample to the bilinear
    interpolation error O(h^2), and a constant-pressure field must
    extrapolate to exactly that constant with zero net pressure force."""
    params = K.schafer_turek(n_per_d=20, T=1.0)
    q = obs.surface_quadrature(params)
    cx, cy, r, om = 2.0, 2.0, 0.5, 0.8
    ni, nj = params.i_max + 2, params.j_max + 2

    def vel(xu, yu, xv, yv):
        rho_u = np.hypot(xu - cx, yu - cy)
        rho_v = np.hypot(xv - cx, yv - cy)
        u = -om * (yu - cy) * (1.0 - r / np.maximum(rho_u, 1e-9))
        v = om * (xv - cx) * (1.0 - r / np.maximum(rho_v, 1e-9))
        return u, v

    iu = np.arange(ni)[:, None] * params.dx           # u node x = i dx
    ju = (np.arange(nj)[None, :] - 0.5) * params.dy
    iv = (np.arange(ni)[:, None] - 0.5) * params.dx
    jv = np.arange(nj)[None, :] * params.dy
    u, v = vel(iu, ju, iv, jv)
    p = jnp.full((ni, nj), 5.0)
    fx, fy, ps, dutdn = obs.surface_force(
        jnp.asarray(u), jnp.asarray(v), p, params, q, return_samples=True)
    np.testing.assert_allclose(np.asarray(ps), 5.0, rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(dutdn), om, rtol=0.03)
    # Constant pressure and the symmetric shear both integrate to ~0 net.
    assert abs(float(fx)) < 1e-3 and abs(float(fy)) < 1e-3


def test_surface_quadrature_rejects_non_circle():
    params = K.square_cylinder(n_per_d=8, T=1.0)
    with pytest.raises(ValueError, match="circle"):
        obs.surface_quadrature(params)


def test_initial_state_perturbation_local():
    """The onset kick is confined to the near wake and never touches the
    inflow column (the inflow BC is re-imposed every step anyway, but a
    clean initial state keeps the impulsive-start story honest)."""
    params = K.square_cylinder(n_per_d=8, T=1.0)
    state = K.initial_state(params, perturb=0.3)
    v = np.asarray(state.v)
    assert abs(v[1, :]).max() < 1e-3
    assert abs(v).max() > 0.2
    state0 = K.initial_state(params, perturb=0.0)
    assert float(jnp.max(jnp.abs(state0.v))) == 0.0
