"""Structured (banded) condensed KKT backend for the interior-point method.

The TPU-native answer to the reference's sparse multifrontal solvers
(MA27/MA57/MUMPS consume CSC sparsity after symbolic analysis,
MA57Solver.cpp:40-90, MUMPSSolver.cpp:60-123; the KKT pipeline builds static
sparse structure, Subproblem.cpp:57-70).  Here the static structure is
declared on the model (model/nlp.py NLPStructure): a banded Lagrangian
Hessian plus windowed constraint Jacobian rows — the dominant structure of
large CUTEst families (chained sums, discretized 1-D/2-D operators, optimal
control staircases).

Formulation: condensed-space with analytic slack elimination.  The IPM's
augmented system over (x0, s, w) — x0 the structural variables, s the
inequality slacks (homogenize transform), w the constraint dual step — is

    [ B     0     J0^T ] [dx0]   [r0]      B  = H00 + Sigma_0 + delta*I
    [ 0   sig_s  -E^T  ] [ds ] = [rs]      sig_s = Sigma_s + delta (diag)
    [ J0   -E    -C    ] [ w ]   [rc]      C  = D_e + eps (diag)

Slack k of row i couples only via E[i,k] = 1, so s eliminates analytically:
    ds = (rs + E^T w) / sig_s
    w  = (J0 dx0 - rc') / denom,   rc' = rc + E (rs / sig_s),
                                   denom = C + E sig_s^{-1} E^T + tau
    M dx0 = r0 + J0^T (rc' / denom),  M = B + J0^T diag(1/denom) J0

M inherits the band: half-bandwidth max(hess_bw, jac_width - 1).  It is
positive definite exactly when the augmented matrix has inertia (n, m, 0),
so the block-tridiagonal Cholesky (linalg/banded.py) doubles as the inertia
test, driving the same delta-bump loop as the dense backends.  tau is the
lifted relaxation (linalg/condensed.py); the IPM's f64 iterative refinement
against the TRUE augmented operator (bkkt_matvec) removes its error.

Cost per factorization: O(n*nb^2) + O(m*w^2) assembly — vs dense
O((n+m)^3); memory O(n*nb) vs O((n+m)^2).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from uno_tpu.linalg.banded import (band_matvec, band_to_blocks,
                                   btd_cholesky, btd_cholesky_cr, btd_solve,
                                   btd_solve_cr, pick_block_size)


class BandedKKT(NamedTuple):
    """Structured assembled KKT (the banded analogue of the dense augmented
    matrix): all leaves are arrays so regularize_and_factor can tree-cast."""
    H_band: jnp.ndarray     # (bh+1, n0) Lagrangian Hessian band (x0 block)
    diag0: jnp.ndarray      # (n0,) Sigma_0 + prox + delta
    sig_s: jnp.ndarray      # (ns,) slack diagonal Sigma_s + prox_s + delta
    J_local: jnp.ndarray    # (m, w) windowed Jacobian rows (x0 columns)
    C: jnp.ndarray          # (m,) dual diagonal D_e + eps


class BandedKKTFactor(NamedTuple):
    btd: object             # BTDFactor (scan) or CRFactor (cyclic reduction)
    kkt: BandedKKT          # saved for the back-out
    denom: jnp.ndarray      # (m,) C + E sig_s^{-1} E^T + tau
    num_pos: jnp.ndarray    # inertia contract (n_full on success)
    num_neg: jnp.ndarray
    num_zero: jnp.ndarray


def jtdj_band(J_local, starts_np, dinv, bw: int, n0: int):
    """Accumulate J0^T diag(dinv) J0 into (bw+1, n0) lower-band storage.
    starts_np is a static numpy (m,) array of window start columns."""
    m, w = J_local.shape
    band = jnp.zeros((bw + 1, n0), dtype=J_local.dtype)
    if m == 0:
        return band
    JD = J_local * dinv[:, None]
    for d in range(min(w, bw + 1)):
        # entries (row=start+t+d, col=start+t): J[i, t+d] * J[i, t]
        vals = JD[:, d:] * J_local[:, : w - d]
        cols = jnp.asarray(starts_np[:, None] + np.arange(w - d)[None])
        band = band.at[d, cols].add(vals)
    return band


def win_mv(J_local, starts_np, v):
    """J0 @ v using windowed rows."""
    m, w = J_local.shape
    if m == 0:
        return jnp.zeros((0,), dtype=v.dtype)
    idx = jnp.asarray(starts_np[:, None] + np.arange(w)[None])
    return jnp.sum(J_local * v[idx], axis=1)


def win_mtv(J_local, starts_np, u, n0: int):
    """J0^T @ u using windowed rows."""
    m, w = J_local.shape
    out = jnp.zeros((n0,), dtype=u.dtype)
    if m == 0:
        return out
    idx = jnp.asarray(starts_np[:, None] + np.arange(w)[None])
    return out.at[idx].add(J_local * u[:, None])


def dense_from_windows(J_local, starts_np, n: int, slack_cols_np):
    """Materialize the full dense (m, n) Jacobian (x0 windows + slack
    columns with coefficient -1) for the parts of the IPM that want a plain
    matrix (rhs, line search, residuals).  O(m*w) scatter."""
    m, w = J_local.shape
    J = jnp.zeros((m, n), dtype=J_local.dtype)
    if m == 0:
        return J
    rows = jnp.asarray(np.repeat(np.arange(m), w))
    cols = jnp.asarray((starts_np[:, None] + np.arange(w)[None]).reshape(-1))
    J = J.at[rows, cols].add(J_local.reshape(-1))
    has = slack_cols_np >= 0
    if np.any(has):
        r = jnp.asarray(np.nonzero(has)[0])
        c = jnp.asarray(slack_cols_np[has])
        J = J.at[r, c].set(-1.0)
    return J


def make_banded_kkt_backend(n_full: int, n0: int, m: int,
                            starts_np: np.ndarray,
                            slack_of_constraint: np.ndarray,
                            hess_bw: int, jac_w: int,
                            tau: float = 1e-8):
    """(factorize, solve, matvec) triple over BandedKKT pytrees.

    slack_of_constraint: (m,) column index (in the FULL variable vector) of
    the slack of each constraint row, -1 for none (homogenize transform).
    The solution layout matches the dense backends: [dx_full, w] with
    dy = -w."""
    ns = n_full - n0
    bw = max(hess_bw, max(jac_w - 1, 0)) if m else hess_bw
    nb = pick_block_size(bw)
    has_slack = slack_of_constraint >= 0
    # slack k (order of columns n0..n_full) belongs to row slack_row[k]
    order = np.argsort(slack_of_constraint[has_slack], kind="stable")
    slack_row_np = np.nonzero(has_slack)[0][order]
    assert np.array_equal(np.sort(slack_of_constraint[has_slack]),
                          np.arange(n0, n_full)), \
        "slack columns must be contiguous after x0"
    has_slack_j = jnp.asarray(has_slack)
    slack_row = jnp.asarray(slack_row_np)

    def scatter_slack(vals_k):
        """(ns,) per-slack values -> (m,) per-row (0 where no slack)."""
        out = jnp.zeros((m,), dtype=vals_k.dtype)
        return out.at[slack_row].set(vals_k) if ns else out

    def gather_slack(vals_m):
        """(m,) per-row -> (ns,) per-slack."""
        return vals_m[slack_row] if ns else vals_m[:0]

    def factorize(kkt: BandedKKT) -> BandedKKTFactor:
        dt = kkt.H_band.dtype
        if m:
            W = scatter_slack(1.0 / kkt.sig_s) if ns else jnp.zeros((m,), dt)
            denom = kkt.C + W + jnp.asarray(tau, dt)
            jb = jtdj_band(kkt.J_local, starts_np, 1.0 / denom, bw, n0)
        else:
            denom = jnp.zeros((0,), dt)
            jb = jnp.zeros((bw + 1, n0), dt)
        band = jb.at[: kkt.H_band.shape[0], :].add(kkt.H_band)
        band = band.at[0, :].add(kkt.diag0)
        D, E = band_to_blocks(band, nb)
        # depth selection: the sequential scan wins for few blocks; cyclic
        # reduction's log2(N) depth wins once the block count is large.
        # The threshold of 64 blocks was chosen on another machine and is
        # not yet measured on the H100 (ROADMAP A8)
        if D.shape[0] >= 64:
            btd = btd_cholesky_cr(D, E)
        else:
            btd = btd_cholesky(D, E)
        ok = btd.num_zero == 0
        zero = jnp.asarray(0)
        return BandedKKTFactor(
            btd=btd, kkt=kkt, denom=denom,
            num_pos=jnp.where(ok, n_full, 0),
            num_neg=jnp.where(ok, m, 0),
            num_zero=jnp.where(ok, zero, n_full + m))

    def solve(fac: BandedKKTFactor, rhs):
        kkt = fac.kkt
        r0, rs, rc = rhs[:n0], rhs[n0:n_full], rhs[n_full:]
        if m:
            rc1 = rc + scatter_slack(rs / kkt.sig_s) if ns else rc
            b = r0 + win_mtv(kkt.J_local, starts_np, rc1 / fac.denom, n0)
        else:
            rc1 = rc
            b = r0
        solve_fn = btd_solve_cr if hasattr(fac.btd, "levels") else btd_solve
        dx0 = solve_fn(fac.btd, b)
        if m:
            w = (win_mv(kkt.J_local, starts_np, dx0) - rc1) / fac.denom
            ds = (rs + gather_slack(w)) / kkt.sig_s if ns else rs
        else:
            w = rc
            ds = rs
        return jnp.concatenate([dx0, ds, w])

    def matvec(kkt: BandedKKT, sol):
        """Exact augmented-operator matvec A @ [dz; w] for f64 iterative
        refinement (matches the dense assemble() semantics)."""
        dx0, ds, w = sol[:n0], sol[n0:n_full], sol[n_full:]
        out0 = band_matvec(kkt.H_band, dx0) + kkt.diag0 * dx0 \
            + (win_mtv(kkt.J_local, starts_np, w, n0) if m else 0.0)
        outs = kkt.sig_s * ds - gather_slack(w) if ns else ds[:0]
        if m:
            outc = win_mv(kkt.J_local, starts_np, dx0) \
                - scatter_slack(ds) - kkt.C * w
        else:
            outc = w[:0]
        return jnp.concatenate([out0, outs, outc])

    return factorize, solve, matvec
