"""Error-free-transformation (two-float) arithmetic for the refinement outer.

Where float64 runs far below the float32 rate, the refinement outer in
ops/sor.py::_solve_pressure_refined — the per-K-sweeps f64 defect, L2 norm,
and master-pressure update — can rival the cost of the f32 inner stage
itself at large grids (scripts/step_breakdown.py measures the split).  The outer needs beyond-f32 precision in exactly two places:

  1. the master pressure accumulator `p += delta` (f32 rounding of the
     large-magnitude iterate is what the refinement exists to avoid, see
     docs/numerics.md), and
  2. the defect `A p - rhs`, whose 5-point terms are O(|p|/dx^2) and cancel
     down to O(threshold) — a ulp(p)*8/dx^2 noise floor in plain f32.

Both are handled here with classic compensated (double-float) arithmetic on
f32 pairs (hi, lo) — Knuth two_sum, Dekker split/two_prod (no FMA primitive
is exposed; f32 add/mul must be IEEE-rounded, which these algorithms
require).
The pair carries ~48 mantissa bits, comfortably below the reference's 1e-4
comparator contract and the eps*(||p0||+1.5) stopping rule's needs, in
f32 arithmetic only.

Key accuracy facts used by `residual_df` (the compensated defect):

  * every cancellation on the path from O(|p|/dx^2) down to the defect —
    the neighbor differences (exact only when operands sit within 2x of
    each other, which smooth fields violate near zero crossings), the E/W
    (N/S) pairing, the 1/dx^2 scaling, and the -rhs subtraction — is kept
    exact via two_sum/two_prod and collapsed once at the end, leaving a
    per-cell error of O(eps^2 * |p|/dx^2) + O(ulp(residual)) — the plain-f32
    error with eps SQUARED, i.e. a ~48-bit evaluation rounded to f32.

No reference analogue: the reference runs f64 end-to-end on hardware that
has it (src/serial/integration.c, src/parallel/main.cu).  This module
meets the same precision requirement without f64.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

# Dekker split constant for f32: 2**ceil(24/2) + 1.
_SPLIT = 4097.0


def two_sum(a: jax.Array, b: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """s = fl(a+b) and the EXACT rounding error e, so a + b == s + e."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a: jax.Array, b: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """two_sum specialization requiring |a| >= |b| (3 flops)."""
    s = a + b
    e = b - (s - a)
    return s, e


def split(a: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Dekker split: a == hi + lo with hi, lo holding <= 12 mantissa bits."""
    t = jnp.float32(_SPLIT) * a
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a: jax.Array, b: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """p = fl(a*b) and the EXACT error e, so a * b == p + e (Dekker, no FMA)."""
    p = a * b
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


def df_add_f32(hi: jax.Array, lo: jax.Array,
               x: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Add an f32 array into a normalized two-float pair; returns the
    renormalized (hi, lo) with |lo| <= ulp(hi)/2 (so hi alone is the
    correctly-rounded f32 value of the pair)."""
    s, e = two_sum(hi, x)
    return quick_two_sum(s, lo + e)


def residual_df(p_hi: jax.Array, p_lo: jax.Array, rhs_int: jax.Array,
                dx2_inv: jax.Array, dy2_inv: jax.Array,
                rhs_lo=None) -> jax.Array:
    """Compensated 5-point Poisson defect on the interior, f32 result.

    Evaluates (to ~eps^2 |p|/dx^2 + ulp(result)) the same quantity as
    ops/sor.py::residual run in f64 on (p_hi + p_lo):

        r = (pE - 2p + pW)/dx^2 + (pN - 2p + pS)/dy^2 - (rhs + rhs_lo)

    `rhs_lo` carries the low f32 word of a float64 RHS (two-float split) so
    float64-state solves certify convergence against the FULL-precision RHS,
    not its f32 rounding; pass None (not zeros) when the RHS is f32-native.
    """
    c_hi = p_hi[1:-1, 1:-1]
    c_lo = p_lo[1:-1, 1:-1]

    def diff(n_hi, n_lo):
        # Neighbor difference as a two-float.  The hi subtraction is NOT
        # always exact (Sterbenz needs operands within 2x; a smooth field
        # can put neighbors at 3x near zero crossings, and the lost bit
        # times 1/dx^2 would exceed the stopping threshold) — two_sum
        # captures its error exactly.  The lo parts are O(ulp(p)), so their
        # plain-f32 arithmetic error is O(ulp^2): negligible.
        d_hi, e = two_sum(n_hi, -c_hi)
        return d_hi, (n_lo - c_lo) + e

    dE_hi, dE_lo = diff(p_hi[2:, 1:-1], p_lo[2:, 1:-1])
    dW_hi, dW_lo = diff(p_hi[:-2, 1:-1], p_lo[:-2, 1:-1])
    dN_hi, dN_lo = diff(p_hi[1:-1, 2:], p_lo[1:-1, 2:])
    dS_hi, dS_lo = diff(p_hi[1:-1, :-2], p_lo[1:-1, :-2])
    # Second difference per axis: the E/W (N/S) pair cancels from O(dx|∇p|)
    # down to O(dx^2|∇²p|) — keep that cancellation exact.
    sx, ex = two_sum(dE_hi, dW_hi)
    lx = ex + (dE_lo + dW_lo)
    sy, ey = two_sum(dN_hi, dS_hi)
    ly = ey + (dN_lo + dS_lo)
    # Scale by 1/dx^2 (the O(1/dx^2) amplification) with exact products.
    tx, etx = two_prod(sx, dx2_inv)
    ltx = etx + lx * dx2_inv
    ty, ety = two_prod(sy, dy2_inv)
    lty = ety + ly * dy2_inv
    # tx + ty - rhs: O(|rhs|) terms cancelling to O(threshold) near
    # convergence — compensated accumulation, single final collapse.
    u, eu = two_sum(tx, ty)
    v, ev = two_sum(u, -rhs_int)
    corr = ((eu + ev) + ltx) + lty
    if rhs_lo is not None:
        corr = corr - rhs_lo
    return v + corr
