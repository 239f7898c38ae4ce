"""General static-sparsity supernodal LDL^T with exact inertia.

The TPU-native closing of the last gap vs the reference's sparse solvers:
MA57 accepts an ARBITRARY symmetric sparsity pattern and runs fill-reducing
symbolic analysis before numeric factorization
(/root/reference/uno/ingredients/subproblem_solvers/MA57/MA57Solver.cpp:40-90,
analyze = ordering + elimination tree; MUMPS adds nested-dissection class
orderings, /root/reference/CMakeLists.txt:173-216).  The round-4 banded path
(linalg/banded_kkt.py) covers bandwidth-reducible patterns only; this module
covers the *irregular* static-sparsity class (arrow/bordered patterns,
polygon-style constraint graphs, anything a fill-minimizing ordering helps).

Design (idiomatic TPU, not a port of the multifrontal algorithm):

* Symbolic phase — host-side numpy, once per problem STRUCTURE:
    1. minimum-degree ordering on the KKT adjacency graph, with a
       *dual-eligibility rule*: a node whose structural diagonal is zero
       (a constraint-dual row of the augmented system — the (2,2) block is
       -(D_e+eps) with D_e = 0 in the optimality phase) may only be
       eliminated after at least one neighbor has been eliminated, so its
       pivot has received a (generically nonzero, negative) Schur update.
       This is the static stand-in for MA57's numerical 2x2 pivoting: the
       surrounding PrimalDualRegularization loop
       (ingredients/regularization.py) backstops the remaining failures by
       bumping delta/eps exactly as it does for the unpivoted dense path.
    2. exact symbolic Cholesky (column-merge) -> fill pattern + elimination
       tree implicit in column structures.
    3. supernode partition: fundamental supernodes + greedy amalgamation
       under a padding-waste budget, width-capped so every panel is a
       static (r_max, w_max) block.
    4. a static *update schedule*: for every supernode, the list of earlier
       supernodes whose rows intersect its columns, with precomputed
       gather maps (selI/selJ) into their padded panels.

* Numeric phase — one jitted lax.scan over supernodes (sequential in the
  elimination order, which is the irreducible data dependence of any
  direct factorization); each step is dense, static-shaped work:
    F  = gather A[rows, cols]                      (panel assembly)
    F -= sum_u (P_u[selI] * d_u) @ P_u[selJ]^T     (batched einsum)    
    panel LDL^T, w_max unrolled rank-1 steps       (elementwise)
  Inertia is read off the signs of the assembled pivot vector — the same
  contract as the dense backends (LDLT.num_pos/num_neg/num_zero), so the
  inertia-correction loop drives this backend unchanged.

Everything is static-shaped: the plan arrays are compile-time constants of
the jitted factorization, so XLA sees plain gathers/matmuls with no dynamic
sparsity bookkeeping at run time.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from uno_tpu.linalg.ldlt import _inertia, _safe


# ---------------------------------------------------------------------------
# symbolic phase (host, numpy, once per structure)
# ---------------------------------------------------------------------------

def minimum_degree(pattern: np.ndarray, eliminate_late=None) -> np.ndarray:
    """Minimum-degree ordering of the graph of `pattern` (N, N bool).

    eliminate_late: optional (N,) bool — nodes that may only be eliminated
    after receiving at least one Schur update from an eliminated neighbor
    (zero-structural-diagonal dual rows; see module docstring).  Returns
    perm with the usual convention: permuted node k is original perm[k].

    Dense-matrix quotient-free variant: adequate for KKT dimensions up to a
    few thousand, runs once per problem structure.
    """
    A = np.asarray(pattern, dtype=bool)
    A = A | A.T
    np.fill_diagonal(A, False)
    N = A.shape[0]
    late = (np.zeros(N, dtype=bool) if eliminate_late is None
            else np.asarray(eliminate_late, dtype=bool).copy())
    alive = np.ones(N, dtype=bool)
    updated = np.zeros(N, dtype=bool)
    deg = A.sum(axis=1).astype(np.int64)
    order = np.empty(N, dtype=np.int64)
    for k in range(N):
        elig = alive & (~late | updated)
        cand = np.nonzero(elig)[0]
        if cand.size == 0:
            cand = np.nonzero(alive)[0]  # isolated late nodes: last resort
        i = cand[np.argmin(deg[cand])]
        order[k] = i
        alive[i] = False
        nb = np.nonzero(A[i] & alive)[0]
        if nb.size:
            # eliminate i: neighbors form a clique
            A[np.ix_(nb, nb)] = True
            A[nb, nb] = False
            A[nb, i] = False
            A[i, nb] = False
            updated[nb] = True
            deg[nb] = A[nb][:, alive].sum(axis=1)
    return order


def _symbolic_cholesky(pattern_perm: np.ndarray):
    """Exact symbolic factorization of the permuted pattern.

    Returns a list of sorted numpy arrays: below-diagonal row structure of
    each column of L (column-merge algorithm: struct(L_j) accumulates into
    its elimination-tree parent min(struct(L_j)))."""
    N = pattern_perm.shape[0]
    A = pattern_perm | pattern_perm.T
    cols = [set(np.nonzero(A[j + 1:, j])[0] + j + 1) for j in range(N)]
    for j in range(N):
        s = cols[j]
        if s:
            parent = min(s)
            cols[parent] |= s - {parent}
    return [np.array(sorted(s), dtype=np.int64) for s in cols]


@dataclass(frozen=True)
class SparsePlan:
    """Static supernodal elimination plan (all numpy, host-resident)."""
    N: int
    w_max: int              # supernode width cap (panel column count)
    r_max: int              # panel row count = w_max + max below-rows
    u_max: int              # max updaters of any supernode
    perm: np.ndarray        # (N,) permuted k holds original perm[k]
    iperm: np.ndarray       # (N,) inverse
    col_start: np.ndarray   # (K,) first permuted column of supernode s
    width: np.ndarray       # (K,) actual width
    col_ids: np.ndarray     # (K, w_max) permuted col ids, sentinel N
    row_ids: np.ndarray     # (K, r_max) permuted row ids (diag rows first,
                            # then below rows), sentinel N
    upd_t: np.ndarray       # (K, u_max) updater supernode id, dummy K
    upd_selI: np.ndarray    # (K, u_max, r_max) row-position map into the
                            # updater's padded panel rows, dummy r_max
    upd_selJ: np.ndarray    # (K, u_max, w_max) col-position map, dummy r_max
    nnz_factor: int         # true |L| (for cost reporting)
    padded_cells: int       # sum of padded panel cells

    @property
    def num_supernodes(self) -> int:
        return self.col_start.shape[0]

    def padded_flops(self) -> float:
        """Scheduled (padded) flop estimate of one numeric factorization."""
        K = self.num_supernodes
        upd = 2.0 * K * self.u_max * self.r_max * self.w_max * self.w_max
        panel = 2.0 * K * self.w_max * self.r_max * self.w_max
        return upd + panel

    def dense_flops(self) -> float:
        return self.N ** 3 / 3.0 * 2.0


def build_plan(pattern: np.ndarray, is_dual=None, w_cap: int = 16,
               amalgamation_waste: float = 0.35) -> SparsePlan:
    """Symbolic analysis: ordering + fill + supernodes + update schedule.

    pattern: (N, N) bool KKT sparsity (diagonal assumed present).
    is_dual: (N,) bool — zero-structural-diagonal rows (constraint duals).
    """
    N = pattern.shape[0]
    perm = minimum_degree(pattern, is_dual)
    iperm = np.empty(N, dtype=np.int64)
    iperm[perm] = np.arange(N)
    pp = pattern[np.ix_(perm, perm)]
    Lcols = _symbolic_cholesky(pp)
    nnz_factor = int(sum(len(c) for c in Lcols) + N)

    # fundamental supernodes: columns j, j+1 merge when
    # struct(L_j) == {j+1} ∪ struct(L_{j+1})
    bounds = [0]
    for j in range(1, N):
        prev, cur = Lcols[j - 1], Lcols[j]
        fundamental = (prev.size == cur.size + 1 and prev.size > 0
                       and prev[0] == j and np.array_equal(prev[1:], cur))
        if not fundamental or (j - bounds[-1]) >= w_cap:
            bounds.append(j)
    bounds.append(N)
    sn = [(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)]

    def below(snode):
        a, b = snode
        rows = set()
        for j in range(a, b):
            rows.update(Lcols[j].tolist())
        return np.array(sorted(r for r in rows if r >= b), dtype=np.int64)

    # greedy amalgamation of consecutive supernodes under a waste budget
    merged = [sn[0]]
    for cur in sn[1:]:
        a0, b0 = merged[-1]
        a1, b1 = cur
        if b1 - a0 <= w_cap:
            r_old = (len(below((a0, b0))) + (b0 - a0)) * (b0 - a0) \
                + (len(below((a1, b1))) + (b1 - a1)) * (b1 - a1)
            rows_m = below((a0, b1))
            r_new = (len(rows_m) + (b1 - a0)) * (b1 - a0)
            # relative waste budget plus an absolute slack: merging tiny
            # supernodes (arrow chains) costs little in padded cells but
            # collapses the sequential scan length, which is what the
            # factorization is actually bound by
            if r_new <= max((1.0 + amalgamation_waste) * r_old, r_old + 128):
                merged[-1] = (a0, b1)
                continue
        merged.append(cur)
    sn = merged
    K = len(sn)
    w_max = max(b - a for a, b in sn)
    belows = [below(s) for s in sn]
    b_max = max((b.size for b in belows), default=0)
    r_max = w_max + b_max

    col_start = np.array([a for a, _ in sn], dtype=np.int32)
    width = np.array([b - a for a, b in sn], dtype=np.int32)
    col_ids = np.full((K, w_max), N, dtype=np.int32)
    row_ids = np.full((K, r_max), N, dtype=np.int32)
    # position of permuted row r inside supernode s's padded panel
    pos_of = np.full(N, -1, dtype=np.int64)
    sn_of_col = np.empty(N, dtype=np.int64)
    for s, ((a, b), br) in enumerate(zip(sn, belows)):
        w = b - a
        col_ids[s, :w] = np.arange(a, b)
        row_ids[s, :w] = np.arange(a, b)
        row_ids[s, w_max:w_max + br.size] = br
        sn_of_col[a:b] = s

    # update schedule: supernode t updates s iff some below-row of t is a
    # column of s
    updaters = [[] for _ in range(K)]
    for t in range(K):
        hit = np.unique(sn_of_col[belows[t]])
        for s in hit:
            updaters[int(s)].append(t)
    u_max = max((len(u) for u in updaters), default=0)
    u_max = max(u_max, 1)
    upd_t = np.full((K, u_max), K, dtype=np.int32)
    upd_selI = np.full((K, u_max, r_max), r_max, dtype=np.int32)
    upd_selJ = np.full((K, u_max, w_max), r_max, dtype=np.int32)
    for s in range(K):
        a, b = sn[s]
        for u, t in enumerate(updaters[s]):
            upd_t[s, u] = t
            # below-row r of t sits at padded position w_max + k
            tb = belows[t]
            pos_of[tb] = w_max + np.arange(tb.size)
            rs = row_ids[s]
            valid = rs < N
            sel = np.full(r_max, r_max, dtype=np.int32)
            rr = rs[valid].astype(np.int64)
            in_t = np.isin(rr, tb)
            sel_valid = np.full(rr.shape, r_max, dtype=np.int32)
            sel_valid[in_t] = pos_of[rr[in_t]]
            sel[valid] = sel_valid
            upd_selI[s, u] = sel
            cj = col_ids[s]
            cvalid = cj < N
            selj = np.full(w_max, r_max, dtype=np.int32)
            cc = cj[cvalid].astype(np.int64)
            in_tc = np.isin(cc, tb)
            selj_valid = np.full(cc.shape, r_max, dtype=np.int32)
            selj_valid[in_tc] = pos_of[cc[in_tc]]
            selj[cvalid] = selj_valid
            upd_selJ[s, u] = selj
            pos_of[tb] = -1

    padded_cells = int(K * r_max * w_max)
    # compact index dtypes: the plan arrays ride inside jitted programs as
    # constants, so size matters — selI/selJ index panel rows (< r_max+1),
    # ids index N+1
    if r_max + 1 < 2 ** 15:
        upd_selI = upd_selI.astype(np.int16)
        upd_selJ = upd_selJ.astype(np.int16)
    if N + 1 < 2 ** 15:
        col_ids = col_ids.astype(np.int16)
        row_ids = row_ids.astype(np.int16)
    return SparsePlan(N=N, w_max=w_max, r_max=r_max, u_max=u_max,
                      perm=perm, iperm=iperm, col_start=col_start,
                      width=width, col_ids=col_ids, row_ids=row_ids,
                      upd_t=upd_t, upd_selI=upd_selI, upd_selJ=upd_selJ,
                      nnz_factor=nnz_factor, padded_cells=padded_cells)


# ---------------------------------------------------------------------------
# numeric phase (jitted; plan arrays are trace-time constants)
# ---------------------------------------------------------------------------

class SparseLDLT(NamedTuple):
    P: jnp.ndarray        # (K+1, r_max+1, w_max) padded panels (unit-lower
                          # diag block + below-diagonal L rows; zero pads)
    dvec: jnp.ndarray     # (N,) pivots in permuted order
    num_pos: jnp.ndarray
    num_neg: jnp.ndarray
    num_zero: jnp.ndarray


def make_sparse_ldlt(plan: SparsePlan, zero_pivot_rtol: float = 1e-32):
    """Returns (factorize, solve): factorize(K_dense) -> SparseLDLT,
    solve(fac, rhs) -> x.  K_dense is the assembled (N, N) matrix in the
    ORIGINAL ordering (the permutation is internal)."""
    N, K = plan.N, plan.num_supernodes
    w_max, r_max, u_max = plan.w_max, plan.r_max, plan.u_max
    perm = jnp.asarray(plan.perm, dtype=jnp.int32)
    iperm = jnp.asarray(plan.iperm, dtype=jnp.int32)
    col_ids = jnp.asarray(plan.col_ids)
    row_ids = jnp.asarray(plan.row_ids)
    widths = jnp.asarray(plan.width)
    upd_t = jnp.asarray(plan.upd_t)
    upd_selI = jnp.asarray(plan.upd_selI)
    upd_selJ = jnp.asarray(plan.upd_selJ)
    rowpos = np.arange(r_max)

    def factorize(Kmat: jnp.ndarray) -> SparseLDLT:
        dt = Kmat.dtype
        Kperm = Kmat[perm][:, perm]
        Kp = jnp.pad(Kperm, ((0, 1), (0, 1)))  # sentinel row/col N -> 0

        Pbuf0 = jnp.zeros((K + 1, r_max + 1, w_max), dtype=dt)
        dbuf0 = jnp.zeros((K + 1, w_max), dtype=dt)

        def step(carry, xs):
            Pbuf, dbuf = carry
            s, rids, cids, wd, ts, selI, selJ = xs
            # panel assembly: gather A at (rows x cols); sentinels hit the
            # zero pad row/col of Kp
            F = Kp[rids[:, None], cids[None, :]]
            # accumulated updates from earlier supernodes (batched einsum)
            Pts = Pbuf[ts]                                   # (u, r_max+1, w)
            dts = dbuf[ts]                                   # (u, w)
            PI = jnp.take_along_axis(
                Pts, selI[:, :, None].astype(jnp.int32), axis=1)  # (u,r,w)
            PJ = jnp.take_along_axis(
                Pts, selJ[:, :, None].astype(jnp.int32), axis=1)  # (u,w,w)
            U = jnp.einsum("uaw,ubw->ab", PI * dts[:, None, :], PJ,
                           precision=lax.Precision.HIGHEST,
                           preferred_element_type=dt)
            F = F - U
            # dense panel LDL^T: w_max rank-1 steps under fori_loop (keeps
            # the traced program small; w_max is 16-32)
            rp = jnp.asarray(rowpos, dtype=jnp.int32)

            def panel_body(j, Fd):
                F, d = Fd
                active = j < wd
                dj = lax.dynamic_slice(F, (j, j), (1, 1))[0, 0]
                dj = jnp.where(active, dj, jnp.asarray(1.0, dt))
                col = lax.dynamic_slice_in_dim(F, j, 1, axis=1)[:, 0]
                l = jnp.where((rp > j) & active, col / _safe(dj),
                              jnp.asarray(0.0, dt))
                F = F - dj * l[:, None] * l[None, :w_max]
                colj = l.at[j].set(jnp.where(active, 1.0, 0.0))
                F = lax.dynamic_update_slice_in_dim(F, colj[:, None], j,
                                                    axis=1)
                d = d.at[j].set(jnp.where(active, dj, 0.0))
                return F, d

            F, d = lax.fori_loop(
                0, jnp.asarray(w_max, jnp.int32), panel_body,
                (F, jnp.zeros((w_max,), dtype=dt)))
            Ppan = jnp.pad(F, ((0, 1), (0, 0)))  # zero pad row at r_max
            z32 = jnp.asarray(0, jnp.int32)
            Pbuf = lax.dynamic_update_slice(Pbuf, Ppan[None], (s, z32, z32))
            dbuf = lax.dynamic_update_slice(dbuf, d[None], (s, z32))
            return (Pbuf, dbuf), None

        xs = (jnp.arange(K, dtype=jnp.int32), row_ids, col_ids, widths,
              upd_t, upd_selI, upd_selJ)
        (Pbuf, dbuf), _ = lax.scan(step, (Pbuf0, dbuf0), xs)

        # pivot vector in permuted order (every real column is active in
        # exactly one supernode; sentinel writes land in the trash slot)
        dvec = jnp.zeros((N + 1,), dtype=dt)
        dvec = dvec.at[col_ids.reshape(-1)].set(dbuf[:K].reshape(-1))[:N]
        pos, neg, zero = _inertia(dvec, zero_pivot_rtol)
        return SparseLDLT(P=Pbuf, dvec=dvec, num_pos=pos, num_neg=neg,
                          num_zero=zero)

    def solve(fac: SparseLDLT, rhs: jnp.ndarray) -> jnp.ndarray:
        dt = rhs.dtype
        b = jnp.pad(rhs[perm], (0, 1))  # trash slot N

        cpos = jnp.arange(w_max)

        def fwd(b, xs):
            s, rids, cids, wd = xs
            P = fac.P[s][:r_max].astype(dt)               # (r_max, w_max)
            zc = jnp.where(cpos < wd, b[cids], 0.0)
            # unit-lower solve on the diag block; inactive columns of P are
            # zero, which unit_diagonal treats as identity rows
            L = P[:w_max, :w_max]
            zc = jax.scipy.linalg.solve_triangular(
                L, zc, lower=True, unit_diagonal=True)
            b = b.at[cids].set(zc)
            upd = P @ zc
            upd = upd.at[:w_max].set(0.0)                 # diag rows done
            b = b.at[rids].add(-upd)
            return b, None

        xs = (jnp.arange(K, dtype=jnp.int32), row_ids, col_ids,
              jnp.asarray(widths))
        b, _ = lax.scan(fwd, b, xs)
        z = b[:N] / _safe(fac.dvec.astype(dt))
        z = jnp.pad(z, (0, 1))

        def bwd(z, xs):
            s, rids, cids, wd = xs
            P = fac.P[s][:r_max].astype(dt)
            xb = z[rids].at[:w_max].set(0.0)              # below rows only
            xc = jnp.where(cpos < wd, z[cids] - P.T @ xb, 0.0)
            L = P[:w_max, :w_max]
            xc = jax.scipy.linalg.solve_triangular(
                L.T, xc, lower=False, unit_diagonal=True)
            z = z.at[cids].set(xc)
            return z, None

        z, _ = lax.scan(bwd, z, xs, reverse=True)
        return z[:N][iperm]

    return jax.jit(factorize), jax.jit(solve)
