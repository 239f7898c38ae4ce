"""Dense symmetric-indefinite LDL^T factorization with inertia.

TPU-native replacement for the reference's sparse multifrontal solvers
(MA27/MA57/MUMPS wrappers, /root/reference/uno/ingredients/subproblem_solvers/
MA57Solver.cpp, MUMPSSolver.cpp): analyze/factorize/solve/inertia behind one
interface (DirectSymmetricIndefiniteLinearSolver.hpp:12-26).

Design rationale (not a port): accelerators want dense, static-shaped,
batched linear algebra.  CUTEst-class KKT systems (dimension n+m up to a few
thousand) are faster dense on matrix units than any scatter/gather sparse
scheme.
We use an *unpivoted* right-looking LDL^T: pivoting is data-dependent control
flow that XLA cannot vectorize, and the surrounding primal-dual inertia
correction (Uno's PrimalDualRegularization.hpp:133-226, same role as in
IPOPT/MadNLP-GPU) already repairs indefinite/singular pivots by bumping the
regularization — the standard approach of the GPU-NLP literature (condensed
KKT + regularized LDL^T).  The inertia is read off the signs of D.

Two implementations:
  * `ldlt_factor`        — column-at-a-time rank-1 updates (reference impl)
  * `ldlt_factor_blocked`— panel factorization + matmul trailing update
Both are jit/vmap-compatible (static shapes, fori_loop).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax


class LDLT(NamedTuple):
    L: jnp.ndarray        # unit lower-triangular factor (n, n)
    d: jnp.ndarray        # diagonal of D (n,)
    num_pos: jnp.ndarray  # inertia: positive pivots (scalar int)
    num_neg: jnp.ndarray  # inertia: negative pivots
    num_zero: jnp.ndarray # inertia: |pivot| below threshold (singularity)


def _pivot_threshold(d, zero_pivot_rtol):
    """|pivot| below rtol * max|d| counts as zero (singular).

    NOTE: legitimate pivot magnitudes of a barrier KKT matrix span ~18 orders
    of magnitude within one matrix (primal barrier entries ~ mu/slack^2 vs
    Schur-complement dual pivots ~ slack^2/mu), so the default rtol must only
    catch essentially-exact zeros; the inertia-correction loop upstream
    handles near-singularity via regularization instead."""
    scale = jnp.maximum(jnp.max(jnp.abs(d)), 1.0)
    return zero_pivot_rtol * scale


def _safe(dj):
    tiny = jnp.asarray(1e-35, dtype=dj.dtype)
    return jnp.where(jnp.abs(dj) < tiny, jnp.where(dj < 0, -tiny, tiny), dj)


def _inertia(d, zero_pivot_rtol):
    thresh = _pivot_threshold(d, zero_pivot_rtol)
    zero = jnp.abs(d) <= thresh
    pos = jnp.sum((d > 0) & ~zero)
    neg = jnp.sum((d < 0) & ~zero)
    return pos, neg, jnp.sum(zero)


@partial(jax.jit, static_argnames=("zero_pivot_rtol",))
def ldlt_factor(A: jnp.ndarray, zero_pivot_rtol: float = 1e-32) -> LDLT:
    """Unpivoted LDL^T by sequential rank-1 updates (O(n) fused steps)."""
    n = A.shape[-1]
    row_idx = lax.broadcasted_iota(jnp.int32, (n,), 0)

    def body(j, M):
        dj = M[j, j]
        col = M[:, j]
        below = row_idx > j
        l = jnp.where(below, col / _safe(dj), 0.0)
        M = M - dj * jnp.outer(l, l)
        M = M.at[:, j].set(jnp.where(below, l, col))
        M = M.at[j, j].set(dj)
        return M

    M = lax.fori_loop(0, n, body, A)
    d = jnp.diagonal(M)
    L = jnp.tril(M, -1) + jnp.eye(n, dtype=A.dtype)
    pos, neg, zero = _inertia(d, zero_pivot_rtol)
    return LDLT(L, d, pos, neg, zero)


@partial(jax.jit, static_argnames=("zero_pivot_rtol",))
def ldlt_factor_unrolled(A: jnp.ndarray, zero_pivot_rtol: float = 1e-32) -> LDLT:
    """Fully unrolled LDL^T on the shrinking trailing submatrix.

    For small KKT dimensions (CUTEst-class, n <= ~32) this beats the
    fori_loop variant under vmap: every slice is STATIC, so XLA emits fused
    elementwise kernels instead of per-column dynamic-update-slices, and the
    trailing update shrinks with j (half the flops of the full-matrix
    rank-1 form).
    """
    n = A.shape[-1]
    M = A
    cols = []
    ds = []
    for j in range(n):
        dj = M[0, 0]
        l = M[1:, 0] / _safe(dj)                     # (n-j-1,)
        ds.append(dj)
        cols.append(l)
        M = M[1:, 1:] - dj * (l[:, None] * l[None, :])
    d = jnp.stack(ds)
    # L columns: [zeros(j+1); l_j], stacked along the last axis
    Lcols = [jnp.pad(l, (n - l.shape[0], 0)) for l in cols]
    L = jnp.stack(Lcols, axis=-1) + jnp.eye(n, dtype=A.dtype)
    pos, neg, zero = _inertia(d, zero_pivot_rtol)
    return LDLT(L, d, pos, neg, zero)


# Precision of the trailing-update products.  HIGHEST keeps f32 products
# out of reduced-precision tensor-core modes (TF32 on the H100): inertia is
# read off these pivots.  On the CPU and in f64 it changes nothing.
FACTOR_PRECISION = lax.Precision.HIGHEST


@partial(jax.jit, static_argnames=("block", "zero_pivot_rtol", "precision"))
def ldlt_factor_blocked(A: jnp.ndarray, block: int = 32,
                        zero_pivot_rtol: float = 1e-32,
                        precision=FACTOR_PRECISION) -> LDLT:
    """Blocked right-looking LDL^T: sequential panel factorization (width
    `block`) followed by one (n,b)x(b,n) matmul trailing update per panel.

    The matrix is padded with a +1 identity tail to a multiple of `block`;
    the padding contributes `pad` known positive pivots which are removed
    from the reported inertia.  `precision` is that of the trailing-update
    products; chip_smoke.py passes DEFAULT to record what TF32 would cost.
    """
    n0 = A.shape[-1]
    nb = -(-max(n0, 1) // block)
    n = nb * block
    pad = n - n0
    if pad:
        A = jnp.pad(A, ((0, pad), (0, pad)))
        A = A.at[jnp.arange(n0, n), jnp.arange(n0, n)].set(1.0)

    row_idx = lax.broadcasted_iota(jnp.int32, (n,), 0)

    def factor_panel(M, k):
        """Factor columns [k*block, (k+1)*block) of M; returns (P, d_panel)."""
        Pm = lax.dynamic_slice(M, (0, k * block), (n, block))

        def body(jj, carry):
            Pm, P, dpan = carry
            j = k * block + jj
            col = lax.dynamic_slice_in_dim(Pm, jj, 1, axis=1)[:, 0]
            dj = col[j]
            below = row_idx > j
            l = jnp.where(below, col / _safe(dj), 0.0)
            lpan = lax.dynamic_slice(l, (k * block,), (block,))
            Pm = Pm - dj * jnp.outer(l, lpan)
            P = lax.dynamic_update_slice(P, l[:, None], (0, jj))
            dpan = dpan.at[jj].set(dj)
            return Pm, P, dpan

        # derive carries from M so the types stay axis-varying under
        # shard_map (plain jnp.zeros would be replicated-typed)
        P0 = Pm * 0.0
        d0 = Pm[0] * 0.0
        _, P, dpan = lax.fori_loop(0, block, body, (Pm, P0, d0))
        return P, dpan

    def outer_body(k, carry):
        M, L, d = carry
        P, dpan = factor_panel(M, k)
        # trailing update as one matrix product; already-factored region
        # gets garbage that is never read again
        M = M - jnp.dot(P * dpan[None, :], P.T, precision=precision,
                        preferred_element_type=M.dtype)
        L = lax.dynamic_update_slice(L, P, (0, k * block))
        d = lax.dynamic_update_slice(d, dpan, (k * block,))
        return M, L, d

    L0 = A * 0.0
    d0 = A[0] * 0.0
    _, L, d = lax.fori_loop(0, nb, outer_body, (A, L0, d0))

    L = jnp.tril(L, -1) + jnp.eye(n, dtype=A.dtype)
    L = L[:n0, :n0]
    d = d[:n0]
    pos, neg, zero = _inertia(d, zero_pivot_rtol)
    return LDLT(L, d, pos, neg, zero)


@jax.jit
def ldlt_solve(fac: LDLT, rhs: jnp.ndarray) -> jnp.ndarray:
    """Solve A x = rhs given A = L D L^T.  rhs may be (n,) or (n, k).

    Small systems (n <= 32, the batched CUTEst-class hot path) use fully
    unrolled forward/backward substitution: n^2 static-slice FMAs that fuse
    into a handful of elementwise kernels across the batch lanes, where a
    TriangularSolve can lower to a dynamic-slice loop that serializes under
    vmap.  The n <= 32 cut was chosen on another machine and is not yet
    measured on the H100 (ROADMAP C7)."""
    n = rhs.shape[0]
    if n <= 32 and rhs.ndim == 1:
        z = jnp.zeros_like(rhs)
        for i in range(n):
            z = z.at[i].set(rhs[i] - jnp.dot(fac.L[i], z))
        z = z / _safe(fac.d)
        x = jnp.zeros_like(rhs)
        for i in range(n - 1, -1, -1):
            x = x.at[i].set(z[i] - jnp.dot(fac.L[:, i], x))
        return x
    vec = rhs.ndim == 1
    b = rhs[:, None] if vec else rhs
    z = jax.scipy.linalg.solve_triangular(fac.L, b, lower=True, unit_diagonal=True)
    z = z / _safe(fac.d)[:, None]
    x = jax.scipy.linalg.solve_triangular(fac.L.T, z, lower=False, unit_diagonal=True)
    return x[:, 0] if vec else x


@jax.jit
def ldlt_refine(A: jnp.ndarray, fac: LDLT, rhs: jnp.ndarray,
                x: jnp.ndarray) -> jnp.ndarray:
    """One step of iterative refinement (mirrors MA57's option,
    reference MA57Solver.cpp:137-145); essential for f32 factorizations."""
    r = rhs - jnp.matmul(A, x, precision=FACTOR_PRECISION)
    return x + ldlt_solve(fac, r)


def barrier_kkt_like(n: int, m: int, seed: int, spread: float = 9):
    """Test/bench generator (numpy f64): a symmetric indefinite matrix with
    barrier-KKT structure — H + Sigma (diagonal 1e-spread..1e+spread) on the
    (1,1) block, J coupling, small -eps dual block — the spectrum the
    inertia-correction loop actually sees."""
    import numpy as np

    rng = np.random.default_rng(seed)
    dim = n + m
    H = rng.standard_normal((n, n)) * 0.1
    H = (H + H.T) / 2
    H[np.diag_indices(n)] = 10.0 ** rng.uniform(-spread, spread, n)
    J = rng.standard_normal((m, n))
    K = np.zeros((dim, dim))
    K[:n, :n] = H
    K[n:, :n] = J
    K[:n, n:] = J.T
    K[np.diag_indices(dim)[0][n:], np.diag_indices(dim)[1][n:]] = \
        -(10.0 ** rng.uniform(-8, -2, m))
    return K
