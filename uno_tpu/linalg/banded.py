"""Banded symmetric linear algebra: block-tridiagonal Cholesky.

TPU-native replacement for the *sparse multifrontal* capability class of the
reference's MA27/MA57/MUMPS solvers (MA57Solver.cpp:40-90 symbolic analysis,
MUMPSSolver.cpp:60-123): instead of elimination trees over general sparsity,
the structured path targets the dominant CUTEst-large structure — banded
Lagrangian Hessians (chained sums, discretized 1-D/2-D operators, optimal
control staircases) — and factorizes them as a BLOCK-TRIDIAGONAL Cholesky:

    A (half-bandwidth b, dim n)  ->  blocks of size nb >= b
    A = [D_0  E_0^T           ]      scan over N = n/nb block steps,
        [E_0  D_1   E_1^T     ]      each step: one nb x nb Cholesky,
        [      E_1  D_2   ... ]      one triangular solve, one matmul
                                     — all dense matrix ops, O(n*nb^2) FLOPs
                                     and O(n*nb) memory vs dense O(n^3)/O(n^2).

Positive definiteness doubles as the inertia test (same contract as the
lifted/condensed backend, linalg/condensed.py): a failed Cholesky (NaN
diagonal) reports wrong inertia and drives the delta-bump regularization
loop (ingredients/regularization.py).

Band storage is LOWER band-major: band[d, j] = A[j + d, j] for d in [0, b];
columns beyond n are zero-padded to N*nb (padded diagonal set to 1 so the
factorization stays PD).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

# f32 block products run at full f32 precision, never a reduced tensor-core
# mode: the factorization's inertia check reads these results
_HI = lax.Precision.HIGHEST


def pick_block_size(bandwidth: int) -> int:
    """Smallest multiple-of-8 block STRICTLY greater than the
    half-bandwidth, as band_to_blocks requires.  Larger blocks only
    lengthen the sequential critical path (the scan is serial-latency-bound
    per pivot regardless of blocking); depth reduction comes from cyclic
    reduction (btd_cholesky_cr), not blocking.  Chosen on another machine
    and not yet measured on the H100 (ROADMAP A8)."""
    return (int(bandwidth) // 8 + 1) * 8


def band_matvec(band: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Symmetric banded matvec.  band (b+1, n) lower storage, v (n,)."""
    b = band.shape[0] - 1
    n = band.shape[1]
    out = band[0] * v
    for d in range(1, b + 1):
        # A[j+d, j] couples v[j] -> out[j+d] and v[j+d] -> out[j]
        lo = band[d, : n - d]
        out = out.at[d:].add(lo * v[: n - d])
        out = out.at[: n - d].add(lo * v[d:])
    return out


class BTDFactor(NamedTuple):
    """Block-tridiagonal Cholesky factor.

    L:  (N, nb, nb) lower-triangular diagonal blocks
    Ct: (N, nb, nb) with Ct[i] = L_i^{-1} E_i^T (the transposed
        subdiagonal factor; Ct[N-1] is zero)
    num_pos/num_neg/num_zero: inertia contract for regularize_and_factor
    """
    L: jnp.ndarray
    Ct: jnp.ndarray
    num_pos: jnp.ndarray
    num_neg: jnp.ndarray
    num_zero: jnp.ndarray


def band_to_blocks(band: jnp.ndarray, nb: int):
    """(b+1, n) lower band -> (D, E): (N, nb, nb) diagonal blocks and
    (N, nb, nb) subdiagonal blocks (E[i] = A[(i+1)nb:(i+2)nb, i*nb:(i+1)nb];
    E[N-1] is zero).  Zero-padded columns get unit diagonal."""
    b = band.shape[0] - 1
    n = band.shape[1]
    assert b < nb, f"bandwidth {b} must be < block size {nb}"
    N = -(-n // nb)
    n_pad = N * nb
    pad = jnp.zeros((b + 1, n_pad - n), dtype=band.dtype)
    if n_pad > n:
        pad = pad.at[0, :].set(1.0)
    bandp = jnp.concatenate([band, pad], axis=1)

    # Packing WITHOUT gathers (profiled: the fancy-indexed gather version
    # cost more than the factorization itself).
    # With T[d, i, c] = band[d, i*nb + c], the block entries are
    #   D[i][r, c] = band[r-c, i*nb+c]      (0 <= r-c <= b)
    #   E[i][r, c] = band[nb+r-c, i*nb+c]   (1 <= nb+r-c <= b)
    # i.e. small placement CONTRACTIONS  D = einsum('drc,dic->irc', P, T)
    # with 0/1 placement tensors P — plain contractions, no scatter/gather.
    T = bandp.reshape(b + 1, N, nb)
    r = np.arange(nb)[:, None]
    c = np.arange(nb)[None, :]
    d = np.arange(b + 1)[:, None, None]
    PD = ((r - c)[None] == d).astype(band.dtype)          # (b+1, nb, nb)
    Dl = jnp.einsum("drc,dic->irc", jnp.asarray(PD), T, precision=_HI)
    D = Dl + jnp.triu(Dl.transpose(0, 2, 1), 1)

    PE = ((nb + r - c)[None] == d).astype(band.dtype)
    if N > 1:
        E = jnp.einsum("drc,dic->irc", jnp.asarray(PE), T[:, :-1],
                       precision=_HI)
        E = jnp.concatenate([E, jnp.zeros((1, nb, nb), dtype=band.dtype)])
    else:
        E = jnp.zeros((1, nb, nb), dtype=band.dtype)
    return D, E


def btd_cholesky(D: jnp.ndarray, E: jnp.ndarray) -> BTDFactor:
    """Cholesky of the block-tridiagonal matrix given by (D, E).
    One lax.scan of N steps; failure (non-PD) yields NaNs in L and a
    wrong-inertia report."""
    N, nb, _ = D.shape
    n_dim = N * nb

    def step(carry, inp):
        Ssub = carry                       # C_{i-1} C_{i-1}^T
        D_i, E_i = inp
        L_i = jnp.linalg.cholesky(D_i - Ssub)
        # Ct_i = L_i^{-1} E_i^T
        Ct_i = jax.scipy.linalg.solve_triangular(L_i, E_i.T, lower=True)
        return jnp.matmul(Ct_i.T, Ct_i, precision=_HI), (L_i, Ct_i)

    _, (L, Ct) = lax.scan(step, jnp.zeros((nb, nb), dtype=D.dtype), (D, E))
    ok = jnp.all(jnp.isfinite(L))
    zero = jnp.asarray(0)
    return BTDFactor(
        L=jnp.where(ok, L, 0.0), Ct=Ct,
        num_pos=jnp.where(ok, n_dim, 0),
        num_neg=zero,
        num_zero=jnp.where(ok, zero, n_dim))


def btd_solve(fac: BTDFactor, rhs: jnp.ndarray) -> jnp.ndarray:
    """Solve A x = rhs given the BTD Cholesky factor.  rhs (n,) is padded
    internally to N*nb."""
    N, nb, _ = fac.L.shape
    n = rhs.shape[0]
    n_pad = N * nb
    r = jnp.concatenate([rhs, jnp.zeros((n_pad - n,), dtype=rhs.dtype)]) \
        if n_pad > n else rhs
    rb = r.reshape(N, nb)

    # forward: L y = r, block rows  L_i y_i = r_i - C_{i-1} y_{i-1},
    # C_{i-1} = Ct_{i-1}^T
    def fwd(y_prev, inp):
        r_i, L_i, Ct_prev = inp
        y_i = jax.scipy.linalg.solve_triangular(
            L_i, r_i - Ct_prev.T @ y_prev, lower=True)
        return y_i, y_i

    Ct_shift = jnp.concatenate(
        [jnp.zeros((1, nb, nb), dtype=fac.Ct.dtype), fac.Ct[:-1]])
    _, y = lax.scan(fwd, jnp.zeros((nb,), dtype=rhs.dtype),
                    (rb, fac.L, Ct_shift))

    # backward: L^T x = y, block rows  L_i^T x_i = y_i - Ct_i x_{i+1}
    def bwd(x_next, inp):
        y_i, L_i, Ct_i = inp
        x_i = jax.scipy.linalg.solve_triangular(
            L_i.T, y_i - Ct_i @ x_next, lower=False)
        return x_i, x_i

    _, x = lax.scan(bwd, jnp.zeros((nb,), dtype=rhs.dtype),
                    (y, fac.L, fac.Ct), reverse=True)
    return x.reshape(-1)[:n]


@partial(jax.jit, static_argnames=("nb",))
def band_cholesky_solve(band, rhs, nb: int):
    """Convenience: factor + solve in one call (tests, one-shot uses)."""
    D, E = band_to_blocks(band, nb)
    fac = btd_cholesky(D, E)
    return btd_solve(fac, rhs), fac


# ---------------------------------------------------------------------------
# Block cyclic reduction: O(log N) depth for the block-tridiagonal solve
# ---------------------------------------------------------------------------

class CRFactor(NamedTuple):
    """Cyclic-reduction 'factorization' of an SPD block-tridiagonal matrix.

    The sequential BTD Cholesky (btd_cholesky) sits on the serial critical
    path of ~n pivots.  Cyclic reduction eliminates all ODD blocks of a
    level simultaneously (vmapped Cholesky + batched block products),
    halving the system per level: depth log2(N) x O(nb) instead of
    N x O(nb) — the classic parallel tridiagonal algorithm, here blockwise.
    ~4x the flops of the scan variant, all batched matrix products.

    levels: per level l a tuple (Lo_chol, M1, M2, L_o, LT_o1) of
        (N_l/2, nb, nb) arrays — the odd-block Cholesky factors and the
        reduction operators; the top holds the final 1-block Cholesky.
    num_pos/num_neg/num_zero: the regularize_and_factor inertia contract
        (PD success <=> inertia (n, 0, 0), like btd_cholesky).
    """
    levels: tuple
    top_chol: jnp.ndarray
    num_pos: jnp.ndarray
    num_neg: jnp.ndarray
    num_zero: jnp.ndarray


def _chol_solve_b(chol, X):
    """Batched D^{-1} X via the batched Cholesky factor (N, nb, nb)."""
    Z = jax.scipy.linalg.solve_triangular(chol, X, lower=True)
    return jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(chol, -1, -2), Z, lower=False)


def btd_cholesky_cr(D: jnp.ndarray, E: jnp.ndarray) -> CRFactor:
    """Cyclic-reduction factorization of the SPD block-tridiagonal (D, E)
    (same inputs as btd_cholesky; E[i] = A[(i+1)b:(i+2)b, ib:(i+1)b],
    E[N-1] unused).

    Index algebra per level (N even; L[i] couples row i to x_{i-1}):
      odd o_k = 2k+1, even j_k = 2k, k = 0..N/2-1
      M1_k = L_{2k}   D_{2k-1}^{-1}   (0 for k = 0)
      M2_k = L_{2k+1}^T D_{2k+1}^{-1}
      D'_k = D_{2k} - M1_k L_{2k}^T - M2_k L_{2k+1}
      L'_k = -M1_k L_{2k-1}
    eliminating every odd block in one batched step."""
    N, nb, _ = D.shape
    n_dim = N * nb
    N2 = 1 << max((N - 1).bit_length(), 1)
    if N2 != N:
        pad = N2 - N
        eye = jnp.broadcast_to(jnp.eye(nb, dtype=D.dtype), (pad, nb, nb))
        D = jnp.concatenate([D, eye])
        E = jnp.concatenate([E, jnp.zeros((pad, nb, nb), dtype=E.dtype)])
    L = jnp.concatenate([jnp.zeros((1, nb, nb), dtype=D.dtype), E[:-1]])

    def swapT(A):
        return jnp.swapaxes(A, -1, -2)

    levels = []
    ok = jnp.asarray(True)
    Ncur = N2
    while Ncur > 1:
        De, Do = D[0::2], D[1::2]
        Le, Lo = L[0::2], L[1::2]

        Co = jnp.linalg.cholesky(Do)
        ok = ok & jnp.all(jnp.isfinite(Co))
        Co_safe = jnp.where(jnp.isfinite(Co), Co, 0.0)

        # M1_k = L_{2k} D_{2k-1}^{-1} = (D_{2k-1}^{-1} L_{2k}^T)^T, k >= 1
        M1_tail = swapT(_chol_solve_b(Co_safe[:-1], swapT(Le[1:])))
        M1 = jnp.concatenate(
            [jnp.zeros((1, nb, nb), dtype=D.dtype), M1_tail])
        # M2_k = L_{2k+1}^T D_{2k+1}^{-1} = (D_{2k+1}^{-1} L_{2k+1})^T
        M2 = swapT(_chol_solve_b(Co_safe, Lo))

        D_new = (De - jnp.matmul(M1, swapT(Le), precision=_HI)
                 - jnp.matmul(M2, Lo, precision=_HI))
        Lo_shift = jnp.concatenate(
            [jnp.zeros((1, nb, nb), dtype=D.dtype), Lo[:-1]])
        L_new = -jnp.matmul(M1, Lo_shift, precision=_HI)

        # back-substitution data: x_o needs L_{o+1}^T = L_even[k+1]^T
        LT_next = swapT(jnp.concatenate(
            [Le[1:], jnp.zeros((1, nb, nb), dtype=D.dtype)]))

        levels.append((Co_safe, M1, M2, Lo, LT_next))
        D, L = D_new, L_new
        Ncur //= 2

    top = jnp.linalg.cholesky(D[0])
    ok = ok & jnp.all(jnp.isfinite(top))
    top = jnp.where(jnp.isfinite(top), top, 0.0)
    zero = jnp.asarray(0)
    return CRFactor(
        levels=tuple(levels), top_chol=top,
        num_pos=jnp.where(ok, n_dim, 0), num_neg=zero,
        num_zero=jnp.where(ok, zero, n_dim))


def btd_solve_cr(fac: CRFactor, rhs: jnp.ndarray) -> jnp.ndarray:
    """Solve A x = rhs with the cyclic-reduction factor."""
    nb = fac.top_chol.shape[0]
    n = rhs.shape[0]
    N2 = (1 << max(len(fac.levels), 0)) if fac.levels else 1
    n_pad = N2 * nb
    r = jnp.concatenate([rhs, jnp.zeros((n_pad - n,), dtype=rhs.dtype)]) \
        if n_pad > n else rhs
    r = r.reshape(-1, nb)

    # forward: reduce the rhs level by level
    # r'_k = r_{2k} - M1_k r_{2k-1} - M2_k r_{2k+1}
    saved = []
    for (Co, M1, M2, Lo, LT_o1) in fac.levels:
        ro, re = r[1::2], r[0::2]
        saved.append(ro)
        ro_prev = jnp.concatenate([jnp.zeros((1, nb), dtype=r.dtype),
                                   ro[:-1]])
        r = re - (M1 @ ro_prev[..., None])[..., 0] \
            - (M2 @ ro[..., None])[..., 0]

    # top solve
    z = jax.scipy.linalg.solve_triangular(fac.top_chol, r[0], lower=True)
    x = jax.scipy.linalg.solve_triangular(fac.top_chol.T, z, lower=False)
    xs = x[None, :]

    # backward: recover odd unknowns level by level (reverse order)
    for (Co, M1, M2, Lo, LT_o1), ro in zip(reversed(fac.levels),
                                           reversed(saved)):
        x_even = xs                                     # (N_l/2, nb)
        x_next = jnp.concatenate([x_even[1:],
                                  jnp.zeros((1, nb), dtype=xs.dtype)])
        t = ro - (Lo @ x_even[..., None])[..., 0] \
            - (LT_o1 @ x_next[..., None])[..., 0]
        z = jax.scipy.linalg.solve_triangular(Co, t[..., None], lower=True)
        x_odd = jax.scipy.linalg.solve_triangular(
            jnp.swapaxes(Co, -1, -2), z, lower=False)[..., 0]
        # interleave even/odd back
        N_l = x_even.shape[0] * 2
        xs = jnp.stack([x_even, x_odd], axis=1).reshape(N_l, nb)

    return xs.reshape(-1)[:n]
