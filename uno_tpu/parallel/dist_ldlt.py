"""Mesh-distributed dense symmetric-indefinite LDL^T with inertia.

The GENERAL-matrix analogue of the reference's MPI-parallel MUMPS over
ScaLAPACK/BLACS (SURVEY.md §2.9, §5.8) — `parallel/schur.py` covers the
block-arrow/scenario structure; this module covers KKT systems with no
exploitable block structure that are too large (in compute) for one chip.

Design (ScaLAPACK-style, TPU-native):
  * 1D block-cyclic column distribution: panel g (block columns) lives on
    device g % P at local slot g // P — balances the right-looking trailing
    work across the mesh axis.
  * Right-looking factorization: at step g every device factors its slot's
    panel (uniform SPMD program; only the owner's result is used), the
    factored panel + pivots are broadcast with a masked `psum` over the device interconnect,
    and each device applies one matmul to its local trailing columns.
    Communication: G = n/block panel broadcasts of (n, block).
  * Inertia: the pivot vector d is replicated as it is produced, so the
    same inertia-corrected regularization loop used by the IPM applies
    unchanged (the linear-solver seam of DirectSymmetricIndefiniteLinear-
    Solver.hpp:12-26).
  * Solves keep the factor distributed (no L gather): forward/backward
    substitution walk the panels, the owner does the small unit-triangular
    solve + its matvec, and the replicated rhs is updated with a masked
    `psum` per panel.

Like the single-chip kernels (linalg/ldlt.py), the factorization is
unpivoted; indefinite/singular pivots are repaired upstream by the
regularization loop.

Entry point:
  make_dist_ldlt(mesh, n, axis, block) -> (factor, solve, perm)
    factor(A_cyc) -> DistLDLT          A_cyc = A[:, perm] sharded (None, axis)
    solve(fac, rhs) -> x               rhs/x (n,) replicated, global order
    perm: the block-cyclic column permutation (numpy, for the caller)
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from uno_tpu.linalg.ldlt import _inertia, _safe

try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map


class DistLDLT(NamedTuple):
    L_cyc: jnp.ndarray       # (n, n) column-cyclic, sharded (None, axis)
    d: jnp.ndarray           # (n,) pivots, replicated, global order
    num_pos: jnp.ndarray
    num_neg: jnp.ndarray
    num_zero: jnp.ndarray


def cyclic_permutation(n: int, nproc: int, block: int) -> np.ndarray:
    """perm such that A[:, perm] laid out in contiguous device slices gives
    device p the global panels {p, p+nproc, p+2*nproc, ...}."""
    assert n % (nproc * block) == 0
    spp = n // (nproc * block)          # slots per device
    perm = np.empty(n, dtype=np.int64)
    pos = 0
    for p in range(nproc):
        for s in range(spp):
            g = p + s * nproc
            perm[pos:pos + block] = np.arange(g * block, (g + 1) * block)
            pos += block
    return perm


def _varying_like(x, ref, axis):
    """Mark x as device-varying over `axis` (shard_map VMA typing) so loop
    carries that mix replicated inits with per-device data typecheck."""
    del ref
    try:
        return lax.pcast(x, (axis,), to="varying")
    except ValueError:    # already varying
        return x


def _panel_factor(C, row0, n, block, axis):
    """Unblocked LDL^T panel factor: C (n, block) holding global columns
    [row0, row0+block) of the working matrix; pivots on rows row0+jj.
    Returns (L-panel with implied unit diagonal, pivots)."""
    riota = lax.broadcasted_iota(jnp.int32, (n, 1), 0)
    ciota = lax.broadcasted_iota(jnp.int32, (1, block), 1)

    def step(jj, carry):
        C, d = carry
        pr = row0 + jj
        dj = jnp.sum(jnp.where((riota == pr) & (ciota == jj), C, 0.0))
        inv = 1.0 / _safe(dj)
        l_col = jnp.sum(jnp.where(ciota == jj, C, 0.0), axis=1, keepdims=True)
        l_col = jnp.where(riota > pr, l_col * inv, 0.0)          # (n, 1)
        # both update factors from the same column data (dj * l ⊗ l_panel):
        # reading the pivot ROW instead introduces ulp-level asymmetries that
        # the unpivoted factorization's element growth amplifies into a
        # measurably worse backward error (observed 3.6e-5 vs 1.1e-8 at
        # n=512 on a saddle KKT matrix)
        l_pan = lax.dynamic_slice(l_col, (row0, 0), (block, 1))  # (block, 1)
        C = C - dj * (l_col * l_pan.T)
        C = jnp.where(ciota == jj, l_col, C)       # commit column jj of L
        d = jnp.where(lax.broadcasted_iota(jnp.int32, (block,), 0) == jj,
                      dj, d)
        return C, d

    d0 = _varying_like(jnp.zeros((block,), dtype=C.dtype), C, axis)
    return lax.fori_loop(jnp.int32(0), jnp.int32(block), step, (C, d0))


def _unit_lower_solve(L11, b, block, axis):
    """x with (I + strict_lower(L11)) x = b; L11 (block, block), b (block,)."""
    iota = lax.broadcasted_iota(jnp.int32, (block,), 0)
    b = _varying_like(b, L11, axis)

    def step(jj, x):
        xj = jnp.sum(jnp.where(iota == jj, x, 0.0))
        col = jnp.sum(jnp.where(
            lax.broadcasted_iota(jnp.int32, (block, block), 1) == jj,
            L11, 0.0), axis=1)
        return jnp.where(iota > jj, x - xj * col, x)

    return lax.fori_loop(jnp.int32(0), jnp.int32(block), step, b)


def _unit_upper_solve_t(L11, b, block, axis):
    """x with (I + strict_lower(L11))^T x = b (backward substitution)."""
    iota = lax.broadcasted_iota(jnp.int32, (block,), 0)
    b = _varying_like(b, L11, axis)

    def step(k, x):
        jj = block - 1 - k
        col = jnp.sum(jnp.where(
            lax.broadcasted_iota(jnp.int32, (block, block), 1) == jj,
            L11, 0.0), axis=1)                     # column jj of L11
        # x_jj -= dot(col[below], x[below]); col is zero at/above jj
        corr = jnp.sum(jnp.where(iota > jj, col * x, 0.0))
        return jnp.where(iota == jj, x - corr, x)

    return lax.fori_loop(jnp.int32(0), jnp.int32(block), step, b)


def make_dist_ldlt(mesh: Mesh, n: int, axis: str = "kkt", block: int = 64,
                   zero_pivot_rtol: float = 1e-32):
    """Build jitted (factor, solve) over `mesh`'s `axis`; see module doc.

    Requires n % (P * block) == 0 (pad with an identity tail upstream —
    its +1 pivots are easy to subtract from the inertia)."""
    nproc = mesh.shape[axis]
    assert n % (nproc * block) == 0, (n, nproc, block)
    G = n // block
    nloc = n // nproc
    row_iota = np.arange(n)

    def local_factor(A_loc):                       # (n, nloc)
        dev = lax.axis_index(axis)
        lidx = jnp.arange(nloc)
        gpanel = dev + (lidx // block) * nproc     # global panel per local col
        gcol = gpanel * block + lidx % block       # global col per local col

        work = A_loc
        L_loc = jnp.zeros_like(A_loc)
        d_full = jnp.zeros((n,), dtype=A_loc.dtype)
        for g in range(G):                         # static panel sweep
            owner, slot = g % nproc, g // nproc
            C = work[:, slot * block:(slot + 1) * block]
            C_fac, dpan = _panel_factor(C, g * block, n, block, axis)
            is_owner = dev == owner
            panel = lax.psum(jnp.where(is_owner, C_fac, 0.0), axis)
            dpan = lax.psum(jnp.where(is_owner, dpan, 0.0), axis)
            L_loc = jnp.where(
                is_owner,
                lax.dynamic_update_slice(L_loc, C_fac, (0, slot * block)),
                L_loc)
            d_full = lax.dynamic_update_slice(d_full, dpan, (g * block,))
            # trailing update of local columns in panels > g (one matmul)
            rest_rows = row_iota >= (g + 1) * block          # static
            if not rest_rows.any():
                continue
            prow = jnp.take(panel, gcol, axis=0)             # (nloc, block)
            upd = lax.dot_general(panel * dpan[None, :], prow,
                                  (((1,), (1,)), ((), ())),
                                  precision=lax.Precision.HIGHEST,
                                  preferred_element_type=work.dtype)
            mask = (jnp.asarray(rest_rows)[:, None]
                    & (gpanel > g)[None, :])
            work = work - jnp.where(mask, upd, 0.0)
        return L_loc, d_full

    def local_solve(L_loc, d_full, rhs):           # rhs (n,) replicated
        dev = lax.axis_index(axis)
        y = rhs
        # forward: (I + strict_lower(L)) y = rhs, walking panels left->right
        for g in range(G):
            owner, slot = g % nproc, g // nproc
            pnl = L_loc[:, slot * block:(slot + 1) * block]  # (n, block)
            L11 = lax.dynamic_slice(pnl, (g * block, 0), (block, block))
            y_blk = lax.dynamic_slice(y, (g * block,), (block,))
            y_blk = _unit_lower_solve(L11, y_blk, block, axis)
            # owner's update of everything below the panel + the solved block
            below = jnp.asarray(row_iota >= (g + 1) * block)
            l_below = jnp.where(below[:, None], pnl, 0.0)
            delta = jnp.matmul(l_below, y_blk,
                               precision=lax.Precision.HIGHEST) \
                - jnp.where(jnp.asarray((row_iota >= g * block)
                                        & (row_iota < (g + 1) * block)),
                            lax.dynamic_update_slice(jnp.zeros_like(y),
                                                     y_blk, (g * block,))
                            - y, 0.0)
            y = y - lax.psum(jnp.where(dev == owner, delta, 0.0), axis)
        x = y / jnp.where(jnp.abs(d_full) < 1e-35,
                          jnp.where(d_full < 0, -1e-35, 1e-35), d_full)
        # backward: (I + strict_lower(L))^T x = y/d, panels right->left
        for g in reversed(range(G)):
            owner, slot = g % nproc, g // nproc
            pnl = L_loc[:, slot * block:(slot + 1) * block]
            L11 = lax.dynamic_slice(pnl, (g * block, 0), (block, block))
            below = jnp.asarray(row_iota >= (g + 1) * block)
            # rhs_blk = x_blk - L21^T x_below  (owner matvec)
            corr = (jnp.where(below[:, None], pnl, 0.0) * x[:, None]).sum(0)
            x_blk = lax.dynamic_slice(x, (g * block,), (block,)) - corr
            x_blk = _unit_upper_solve_t(L11, x_blk, block, axis)
            blk_mask = jnp.asarray((row_iota >= g * block)
                                   & (row_iota < (g + 1) * block))
            delta = jnp.where(
                blk_mask,
                lax.dynamic_update_slice(jnp.zeros_like(x), x_blk,
                                         (g * block,)) - x, 0.0)
            x = x + lax.psum(jnp.where(dev == owner, delta, 0.0), axis)
        return x

    factor_sh = shard_map(local_factor, mesh=mesh,
                          in_specs=(P(None, axis),),
                          out_specs=(P(None, axis), P()))
    solve_sh = shard_map(local_solve, mesh=mesh,
                         in_specs=(P(None, axis), P(), P()),
                         out_specs=P())

    @jax.jit
    def factor(A_cyc) -> DistLDLT:
        L_cyc, d = factor_sh(A_cyc)
        pos, neg, zero = _inertia(d, zero_pivot_rtol)
        return DistLDLT(L_cyc, d, pos, neg, zero)

    @jax.jit
    def solve(fac: DistLDLT, rhs):
        return solve_sh(fac.L_cyc, fac.d, rhs)

    return factor, solve, cyclic_permutation(n, nproc, block)

def make_dist_kkt_backend(mesh: Mesh, n_kkt: int, axis: str = "kkt",
                          block: int = 64, zero_pivot_rtol: float = 1e-32):
    """KKT-solver backend pair (factorize, solve) with the same contract as
    `pick_factorizer(...)` + `ldlt_solve` (linalg/ldlt.py), factoring over
    the mesh axis.  Wired into the IPM via `ldlt_backend="distributed"` —
    the inertia-corrected regularization loop (ingredients/regularization.py)
    consumes the returned DistLDLT unchanged.

    Handles arbitrary n_kkt by padding to a multiple of P*block with a +1
    identity tail (its known-positive pivots are removed from the reported
    inertia) and applies the block-cyclic column permutation internally, so
    callers pass the matrix and rhs in global order.

    Note: the augmented matrix is assembled replicated and resharded here —
    this backend scales the O(n^3) factorization compute across chips, not
    the O(n^2) assembly memory."""
    nproc = mesh.shape[axis]
    unit = nproc * block
    n_pad = -(-max(n_kkt, 1) // unit) * unit
    pad = n_pad - n_kkt
    factor_p, solve_p, perm = make_dist_ldlt(mesh, n_pad, axis, block,
                                             zero_pivot_rtol)
    perm_j = jnp.asarray(perm)

    def factorize(A):
        if pad:
            A = jnp.pad(A, ((0, pad), (0, pad)))
            A = A.at[jnp.arange(n_kkt, n_pad),
                     jnp.arange(n_kkt, n_pad)].set(1.0)
        fac = factor_p(jnp.take(A, perm_j, axis=1))
        return DistLDLT(fac.L_cyc, fac.d,
                        fac.num_pos - pad, fac.num_neg, fac.num_zero)

    def solve(fac: DistLDLT, rhs):
        if pad:
            rhs = jnp.pad(rhs, (0, pad))
        x = solve_p(fac, rhs)
        return x[:n_kkt]

    return factorize, solve
