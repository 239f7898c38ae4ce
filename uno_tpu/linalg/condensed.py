"""Condensed-space (lifted) KKT backend: Cholesky instead of LDL^T.

TPU-first alternative to the augmented-system factorization, following the
condensed-space line of GPU NLP solvers (MadNLP "LiftedKKT", arXiv
2405.14236; hybrid direct-iterative KKT, arXiv 2110.03636): with the dual
block -C (C = elastic condensation + dual regularization, diagonal >= 0)
lifted by a small relaxation tau,

    [ Hd  J^T ] [dx]   [r_x]            M = Hd + J^T diag(1/(C+tau)) J
    [ J   -C  ] [ w] = [r_c]    =>      M dx = r_x + J^T (r_c / (C+tau))
                                        w = (J dx - r_c) / (C+tau)

M is positive definite whenever the augmented matrix has the correct
inertia (n, m, 0) — so "factorization succeeded" IS the inertia test: a
failed Cholesky (NaN diagonal) plays the role of a wrong-inertia LDL^T and
drives the same delta-bump regularization loop.  tau perturbs the equality
rows by O(tau * |w|); the IPM's f64 iterative refinement against the TRUE
augmented matrix (solvers/ipm.py) removes that error, so the condensed
factor effectively acts as a preconditioner.

Why: Cholesky is a single library kernel with no pivot-order
serialization and no inertia bookkeeping, and the delta loop needs no
pivot-sign reduction.  NOT recommended for vmapped batches of tiny
problems: XLA's triangular solve serializes badly under vmap (see
linalg/ldlt.py), which is why the unrolled LDL^T remains the batched
default.

Wired into the IPM via `kkt_formulation="lifted"` through the same
(factorize, solve) seam as the distributed backend (reference parity: this
replaces the MA57-class solver exactly at the
DirectSymmetricIndefiniteLinearSolver.hpp:12-26 interface).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax


class LiftedKKT(NamedTuple):
    L: jnp.ndarray            # Cholesky factor of the condensed matrix
    J: jnp.ndarray            # (m, n) block, saved for the back-out
    cinv: jnp.ndarray         # 1 / (C + tau)  (m,)
    num_pos: jnp.ndarray      # inertia contract for the regularization loop
    num_neg: jnp.ndarray
    num_zero: jnp.ndarray


def make_lifted_kkt_backend(n: int, m: int, tau: float = 1e-8):
    """(factorize, solve) pair over the ASSEMBLED augmented matrix, with the
    same contract as `pick_factorizer` + `ldlt_solve` (the regularization
    loop only consumes the inertia fields and carries the factor pytree)."""

    def factorize(A) -> LiftedKKT:
        Hd = A[:n, :n]
        if m:
            J = A[n:, :n]
            C = -jnp.diagonal(A[n:, n:])          # dual block is -(C)
            cinv = 1.0 / (C + tau)
            M = Hd + jnp.matmul(J.T * cinv[None, :], J,
                                precision=lax.Precision.HIGHEST)
        else:
            J = jnp.zeros((0, n), dtype=A.dtype)
            cinv = jnp.zeros((0,), dtype=A.dtype)
            M = Hd
        L = jnp.linalg.cholesky(M)
        ok = jnp.all(jnp.isfinite(L))
        # success <=> augmented inertia (n, m, 0); report a wrong inertia on
        # failure so regularize_and_factor bumps delta and retries
        zero = jnp.asarray(0)
        return LiftedKKT(
            L=jnp.where(ok, L, 0.0), J=J, cinv=cinv,
            num_pos=jnp.where(ok, n, 0),
            num_neg=jnp.where(ok, m, 0),
            num_zero=jnp.where(ok, zero, n + m))

    def solve(fac: LiftedKKT, rhs):
        r_x, r_c = rhs[:n], rhs[n:]
        b = r_x + (fac.J.T @ (r_c * fac.cinv) if m else 0.0)
        z = jax.scipy.linalg.solve_triangular(fac.L, b, lower=True)
        dx = jax.scipy.linalg.solve_triangular(fac.L.T, z, lower=False)
        if m:
            w = (fac.J @ dx - r_c) * fac.cinv
            return jnp.concatenate([dx, w])
        return dx

    return factorize, solve
