"""Direct spectral pressure solver (method="fft"): DCT-II diagonalization
of the Neumann Laplacian, executed as dense matmuls or FFT butterflies.

The pressure-Poisson system the reference iterates on with SOR
(integration.c:129-173) is the constant-coefficient 5-point Laplacian with
homogeneous Neumann BCs on a cell-centered grid.  Its eigenvectors are the
DCT-II cosines  v_k(i) = cos(pi k (i+1/2)/n)  — they satisfy the reflective
ghost closure v(-1)=v(0), v(n)=v(n-1) exactly — with eigenvalues
lambda_k = (2 cos(pi k / n) - 2) / dx^2.  So one forward transform, a
pointwise divide, and one inverse transform solve the system DIRECTLY, to
rounding error.

Two interchangeable transform routes (equivalent math; a size heuristic
picks one — PREFER_RFFT below):

* "matmul": dense cosine-matrix matmuls — O(n^3) flops, cheap at small n,
  and the route the SPMD partitioner shards best.
* "rfft": Makhoul's O(n^2 log n) evaluation via a real FFT of the
  even-odd permuted sequence (the standard identity
  DCT2(x)[k] = 2 Re(e^{-i pi k/2n} FFT(perm(x))[k]); inverse by the
  conjugate identity).  At 2048^2+ this replaces ~17-137 GFLOP of matmul
  per 1D transform stage with an O(n^2 log n) butterfly.

Precision: transforms run in f32 (HIGHEST-precision matmuls on the matmul
route — no TF32 unless Params.fft_precision asks for it; f32 butterflies on
the rfft route); plugged into the SAME mixed-precision refinement outer as
SOR/MG
(ops/sor.py), the f64 defect re-baseline mops up the f32 transform
rounding, so the exact reference convergence contract
L2(res) <= eps*(||p0|| + 1.5) is met in 2-3 direct solves per time step —
`iterations` counts them.

Compatibility: the Neumann problem is singular (constant nullspace); the
discrete RHS is compatible by construction (the divergence of F/G
telescopes to wall values that are identically zero, main.c:116-120), so
zeroing the k=(0,0) mode selects the minimum-norm solution.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..config import Params


@functools.lru_cache(maxsize=None)
def _dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II analysis matrix C (k, i): C @ C.T = I."""
    i = np.arange(n, dtype=np.float64)
    k = np.arange(n, dtype=np.float64)[:, None]
    C = np.cos(np.pi * k * (i + 0.5) / n) * np.sqrt(2.0 / n)
    C[0] *= np.sqrt(0.5)
    return C.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _eigenvalues(n: int, d2_inv: float) -> np.ndarray:
    k = np.arange(n, dtype=np.float64)
    return ((2.0 * np.cos(np.pi * k / n) - 2.0) * d2_inv).astype(np.float32)


# ---------------------------------------------------------------------------
# rfft transform route (Makhoul): O(n log n) per 1D transform, exact same
# orthonormal convention as _dct_matrix (validated to machine epsilon for
# every n, odd sizes included, in tests/test_fft_routes.py).


@functools.lru_cache(maxsize=None)
def _twiddle(n: int) -> np.ndarray:
    """exp(-i pi k / 2n) for k = 0..n//2 (f64 phase, stored complex64)."""
    k = np.arange(n // 2 + 1, dtype=np.float64)
    return np.exp(-1j * np.pi * k / (2.0 * n)).astype(np.complex64)


def _dct2_rfft(x: jax.Array) -> jax.Array:
    """Orthonormal DCT-II along the last axis via one real FFT."""
    n = x.shape[-1]
    v = jnp.concatenate([x[..., 0::2], x[..., 1::2][..., ::-1]], axis=-1)
    Z = jnp.asarray(_twiddle(n)) * jnp.fft.rfft(v, axis=-1)
    head = 2.0 * Z.real                     # k = 0 .. n//2
    ntail = n - (n // 2 + 1)                # k = n//2+1 .. n-1 (= X[n-k])
    tail = (-2.0 * Z[..., 1:ntail + 1].imag)[..., ::-1]
    X = jnp.concatenate([head, tail], axis=-1) * np.float32(
        np.sqrt(1.0 / (2.0 * n)))
    return X.at[..., 0].multiply(np.float32(np.sqrt(0.5)))


def _idct2_irfft(X: jax.Array) -> jax.Array:
    """Inverse of _dct2_rfft (orthonormal DCT-III) along the last axis."""
    n = X.shape[-1]
    h = (n + 1) // 2
    m = n // 2 + 1
    c = X * np.float32(np.sqrt(2.0 * n))
    c = c.at[..., 0].multiply(np.float32(np.sqrt(2.0)))
    c_rev = jnp.concatenate(
        [jnp.zeros_like(c[..., :1]), c[..., ::-1][..., : m - 1]], axis=-1
    )  # c_rev[k] = c[n-k] for k >= 1
    V = jnp.conj(jnp.asarray(_twiddle(n))) * (c[..., :m] - 1j * c_rev) * 0.5
    v = jnp.fft.irfft(V, n=n, axis=-1)
    head, tail = v[..., :h], v[..., h:][..., ::-1]
    # Interleave even/odd output slots without scatter: stack + reshape when
    # n is even; odd n pads the (one-shorter) odd half then trims.
    if n % 2 == 0:
        return jnp.stack([head, tail], axis=-1).reshape(*v.shape[:-1], n)
    tail = jnp.concatenate([tail, jnp.zeros_like(tail[..., :1])], axis=-1)
    return jnp.stack([head, tail], axis=-1).reshape(
        *v.shape[:-1], n + 1)[..., :n]


def _solve_rfft(rhs_int: jax.Array, lam: jax.Array) -> jax.Array:
    rhat = _dct2_rfft(jnp.swapaxes(_dct2_rfft(rhs_int), 0, 1))
    phat = jnp.swapaxes(rhat, 0, 1) / lam
    phat = phat.at[0, 0].set(0.0)
    return _idct2_irfft(jnp.swapaxes(_idct2_irfft(
        jnp.swapaxes(phat, 0, 1)), 0, 1))


# Params.fft_precision -> matmul precision.  On a GPU HIGHEST is full f32;
# HIGH and DEFAULT let a card with tensor cores (H100) round to TF32.
_PRECISIONS = {
    "highest": jax.lax.Precision.HIGHEST,
    "high": jax.lax.Precision.HIGH,
    "default": jax.lax.Precision.DEFAULT,
}


def _solve_matmul(rhs_int: jax.Array, lam: jax.Array, ni: int,
                  nj: int, precision: str = "highest") -> jax.Array:
    Ci = jnp.asarray(_dct_matrix(ni))
    Cj = jnp.asarray(_dct_matrix(nj))
    # Lower precision trades per-solve accuracy for transform throughput;
    # the refinement outer re-checks the defect exactly, so the
    # convergence contract is untouched — only the solve count moves
    # (Params.fft_precision).
    hp = _PRECISIONS[precision]
    rhat = jnp.matmul(jnp.matmul(Ci, rhs_int, precision=hp),
                      Cj.T, precision=hp)
    phat = rhat / lam
    phat = phat.at[0, 0].set(0.0)  # singular constant mode -> zero mean
    return jnp.matmul(jnp.matmul(Ci.T, phat, precision=hp), Cj,
                      precision=hp)


# Transform-route control: None = size heuristic; True/False force
# rfft/matmul.  The GSPMD backend (params.disable_pallas) always takes the
# matmul route — the partitioner has mature sharding rules for dot_general,
# while an FFT along a sharded axis degenerates to gather-transform-scatter.
PREFER_RFFT = None


def _pick_transform_route(params: Params) -> str:
    """'rfft' or 'matmul' for this grid size.

    The GSPMD pin (disable_pallas) takes precedence over PREFER_RFFT: an
    FFT along a sharded axis degenerates to gather-transform-scatter under
    the partitioner, so forcing rfft there would be a trap, not a knob."""
    if params.disable_pallas:
        return "matmul"
    if PREFER_RFFT is not None:
        return "rfft" if PREFER_RFFT else "matmul"
    # O(n^3) matmul flops outgrow the O(n^2 log n) butterflies with n;
    # PERF.md records both routes' times on the H100 from 512^2 up.
    return "rfft" if max(params.i_max, params.j_max) >= 512 else "matmul"


@functools.lru_cache(maxsize=32)
def _lambda_grid(params: Params) -> np.ndarray:
    """Eigenvalue denominator as a PURE NUMPY constant.

    As numpy, the value is a trace-time constant everywhere it is used,
    including callers that are being traced."""
    lam = (
        _eigenvalues(params.i_max, 1.0 / (params.dx * params.dx))[:, None]
        + _eigenvalues(params.j_max, 1.0 / (params.dy * params.dy))[None, :]
    )
    return np.where(lam == 0, np.float32(1.0), lam)


def poisson_solve_dct(rhs_int: jax.Array, params: Params) -> jax.Array:
    """Solve A p = rhs (interior (i_max, j_max), Neumann, zero-mean) in one
    shot: p = C_i^T [ (C_i rhs C_j^T) / (lam_i + lam_j) ] C_j, with the
    transforms evaluated by the route `_pick_transform_route` picks."""
    lam = _lambda_grid(params)
    rhs32 = rhs_int.astype(jnp.float32)
    if _pick_transform_route(params) == "rfft":
        return _solve_rfft(rhs32, lam)
    return _solve_matmul(rhs32, lam, params.i_max, params.j_max,
                         params.fft_precision)


_RFFT_OK_CACHE: dict = {}


def _rfft_lowering_ok(n: int) -> bool:
    """Probe-compile the rfft DCT at transform length n (cached per
    backend): should an FFT size fail to lower on a backend, the sharded
    pencil solve falls back to matmul BEFORE the whole solve program
    compiles around the failing butterfly."""
    key = (int(n), jax.default_backend())
    if key not in _RFFT_OK_CACHE:
        try:
            jax.jit(_dct2_rfft).lower(
                jax.ShapeDtypeStruct((2, int(n)), jnp.float32)).compile()
            _RFFT_OK_CACHE[key] = True
        except Exception as exc:  # lowering/compile failure -> matmul
            import sys

            print(f"[fft] sharded rfft unavailable for n={n}: {exc} "
                  "-> matmul", file=sys.stderr)
            _RFFT_OK_CACHE[key] = False
    return _RFFT_OK_CACHE[key]


def make_sharded_inner(params: Params, li: int, lj: int):
    """Multi-chip direct DCT solve on block-sharded interiors: the classic
    pencil decomposition — `lax.all_to_all` transposes over the
    ("x", "y") mesh re-layout the grid so every 1D transform is local, then
    the eigenvalue divide runs in the i-pencil layout where each shard's
    global mode indices are known statically-per-shard.

    Data movement per solve: 4 tiled all_to_alls — j-pencils out (over "y"),
    j-pencils -> i-pencils DIRECTLY over the combined ("x","y") axis (the
    flattened-axis transpose; combined index is x-major ax*py + ay, verified
    by the bit-parity tests), i-pencils -> j-pencils back, j-pencils -> blocks
    — each moving one interior's worth of bytes between devices, vs the
    gather-everything alternative's px*py-fold replication.  Compute per
    shard is 1/(px*py) of the single-chip solve.

    Constraints (checked at trace time): the interior must divide evenly
    over the mesh (like sharded mg), and pencils must tile: li % py == 0 and
    lj % px == 0 (the latter is equivalent to nj % (px*py) == 0, the
    combined-transpose width requirement).

    Plugged into the same f64 refinement outer as the single-chip fft route
    (ops/sor.py), preserving the exact reference convergence contract;
    `iterations` counts direct solves, matching single-chip fft exactly."""
    ni, nj = params.i_max, params.j_max
    px, py = ni // li, nj // lj
    if px * li != ni or py * lj != nj:
        raise ValueError(
            f"sharded fft requires an evenly-divisible grid; {ni}x{nj} "
            f"does not tile into {li}x{lj} blocks")
    if li % py != 0 or lj % px != 0:
        raise ValueError(
            f"sharded fft pencil decomposition needs li % py == 0 and "
            f"lj % px == 0; got blocks {li}x{lj} on a {px}x{py} mesh")
    lam_i = jnp.asarray(_eigenvalues(ni, 1.0 / (params.dx * params.dx)))
    lam_j = jnp.asarray(_eigenvalues(nj, 1.0 / (params.dy * params.dy)))

    # Route: PREFER_RFFT if forced, else the single-chip size heuristic on
    # the GLOBAL transform length, gated on a probe compile so that an FFT
    # size a backend cannot lower falls back to matmul.
    if PREFER_RFFT is None:
        use_rfft = (max(ni, nj) >= 512 and _rfft_lowering_ok(nj)
                    and (ni == nj or _rfft_lowering_ok(ni)))
    else:
        use_rfft = bool(PREFER_RFFT)

    pencil_hp = _PRECISIONS[params.fft_precision]

    def fwd_last(x, n):
        if use_rfft:
            return _dct2_rfft(x)
        C = jnp.asarray(_dct_matrix(n))
        return jnp.matmul(x, C.T, precision=pencil_hp)

    def inv_last(x, n):
        if use_rfft:
            return _idct2_irfft(x)
        C = jnp.asarray(_dct_matrix(n))
        return jnp.matmul(x, C, precision=pencil_hp)

    w = nj // (px * py)  # i-pencil j-mode width (== lj // px)

    def inner_fn(rhs_neg_full: jax.Array, _n_sweeps) -> jax.Array:
        r = rhs_neg_full[1:-1, 1:-1].astype(jnp.float32)  # (li, lj)
        # Forward transform along j: j-pencils (li//py, nj), rows stay rows.
        xj = lax.all_to_all(r, "y", split_axis=0, concat_axis=1, tiled=True)
        xj = fwd_last(xj, nj)
        # j-pencils -> i-pencils in ONE transpose over the combined axis:
        # rows concatenate in x-major sender order, which IS ascending
        # global i; the shard keeps j-mode slice [k*w, (k+1)*w) where
        # k = ax*py + ay is its combined index.
        xi = lax.all_to_all(xj, ("x", "y"), split_axis=1, concat_axis=0,
                            tiled=True)  # (ni, w)
        xi = fwd_last(xi.T, ni).T
        k = lax.axis_index("x") * py + lax.axis_index("y")
        qj = k * w
        lam_j_loc = lax.dynamic_slice(lam_j, (qj,), (w,))
        lam = lam_i[:, None] + lam_j_loc[None, :]
        xi = xi / jnp.where(lam == 0, 1.0, lam)
        # Zero the singular (0, 0) constant mode wherever it lives.
        ki = lax.broadcasted_iota(jnp.int32, xi.shape, 0)
        kj = lax.broadcasted_iota(jnp.int32, xi.shape, 1) + qj
        xi = jnp.where((ki == 0) & (kj == 0), 0.0, xi)
        # Inverse transform along i, transpose back to j-pencils.
        xi = inv_last(xi.T, ni).T
        xj = lax.all_to_all(xi, ("x", "y"), split_axis=0, concat_axis=1,
                            tiled=True)  # (li//py, nj)
        xj = inv_last(xj, nj)
        d = lax.all_to_all(xj, "y", split_axis=1, concat_axis=0, tiled=True)
        return jnp.zeros(rhs_neg_full.shape, jnp.float32).at[
            1:-1, 1:-1].set(d)

    return inner_fn


def inner_direct(rhs_neg_full: jax.Array, n_solves, params: Params):
    """Refinement-inner hook: `n_solves` chained direct solves of
    A delta = rhs_neg, with the defect re-evaluated IN F32 between solves
    (delta is small-scale, so the f32 residual has no cancellation floor).

    n_solves = Params.fft_solves_per_outer (via the outer's K): chaining
    amortizes the f64 outer pass where it rivals the transform cost at
    large grids, while each extra solve only costs
    one f32 residual pass on top of the transform."""
    rhs_int = rhs_neg_full[1:-1, 1:-1].astype(jnp.float32)
    if params.fft_solves_per_outer == 1:
        # Fast path: one solve, no defect pass (the measured default).
        delta_int = poisson_solve_dct(rhs_int, params)
        return jnp.zeros(params.shape, jnp.float32).at[1:-1, 1:-1].set(
            delta_int)
    from . import sor as sormod

    dx2 = jnp.float32(1.0 / (params.dx * params.dx))
    dy2 = jnp.float32(1.0 / (params.dy * params.dy))

    def body(_, delta_full):
        # A delta - rhs with the Neumann ghost closure; solve the correction
        # system A e = -(A delta - rhs) and accumulate.
        res = sormod.residual(sormod.ghost_fill(delta_full), rhs_int,
                              dx2, dy2)
        e = poisson_solve_dct(-res, params)
        return delta_full.at[1:-1, 1:-1].add(e)

    delta0 = jnp.zeros(params.shape, jnp.float32)
    return lax.fori_loop(0, jnp.asarray(n_solves, jnp.int32), body, delta0)
