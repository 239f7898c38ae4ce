"""QP/LP subproblem solver: primal-dual interior point with inertia correction.

TPU-native replacement for the reference's BQPD (Fortran active-set QP,
/root/reference/uno/ingredients/subproblem_solvers/BQPD/BQPDSolver.cpp) and
HiGHS LP (HiGHSSolver.cpp) behind the QPSolver/LPSolver interface
(LPSolver.hpp:21-34).  Active-set pivoting is data-dependent control flow
that XLA cannot vectorize; an interior-point method over the same dense
LDL^T kernel is the TPU-idiomatic equivalent (SURVEY.md §7 stage 4a).
Indefinite Hessians are convexified by the inertia-correction loop (the
reference finds local solutions of the nonconvex QP via BQPD instead —
documented deviation).

Problem form (the Subproblem view, Subproblem.cpp:106-119 + .hpp:78-86):
    min  g^T d + 1/2 d^T H d
    s.t. rl <= J d <= ru        (rows with rl == ru are equalities)
         dl <= d  <= du         (box: variable bounds intersected with TR)

Inequality rows get a slack with barrier; the slack block is condensed into
the dual diagonal (-Sigma_s^{-1}), so the KKT matrix stays (n+m) with the
standard saddle inertia (n, m, 0).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from uno_tpu.ingredients import barrier as bar
from uno_tpu.ingredients.regularization import regularize_and_factor
from uno_tpu.linalg.ldlt import ldlt_solve
from uno_tpu.options import Options

QP_OPTIMAL = 0
QP_INFEASIBLE = 1
QP_UNBOUNDED = 2
QP_ERROR = 3

HUGE = 1e25


class QPResult(NamedTuple):
    d: jnp.ndarray        # primal solution (n,)
    y: jnp.ndarray        # constraint multipliers, Uno sign convention (m,)
    zl: jnp.ndarray       # bound duals on d (n,)
    zu: jnp.ndarray
    status: jnp.ndarray   # scalar int
    objective: jnp.ndarray
    iterations: jnp.ndarray
    kkt_error: jnp.ndarray


@dataclass(frozen=True)
class QPStructure:
    """Static sparsity/bound structure of a QP family."""
    n: int
    m: int
    has_dl: np.ndarray    # (n,) finite lower box bound
    has_du: np.ndarray
    is_eq: np.ndarray     # (m,) rows with rl == ru
    has_rl: np.ndarray    # (m,) finite row lower bound (inequality rows)
    has_ru: np.ndarray


def build_qp_solver(struct: QPStructure, opts: Options,
                    tol: float = 1e-10, max_iterations: int = 150,
                    purify: bool = True):
    """Returns a jittable solve(g, H, J, rl, ru, dl, du) -> QPResult."""
    n, m = struct.n, struct.m
    has_dl = jnp.asarray(struct.has_dl)
    has_du = jnp.asarray(struct.has_du)
    is_eq = jnp.asarray(struct.is_eq)
    has_rl = jnp.asarray(struct.has_rl & ~struct.is_eq)
    has_ru = jnp.asarray(struct.has_ru & ~struct.is_eq)
    is_ineq = ~is_eq
    k1 = opts.barrier_push_variable_to_interior_k1
    k2 = opts.barrier_push_variable_to_interior_k2
    # within ONE QP solve the Hessian is fixed, so the convexification delta
    # should track its static requirement closely: the NLP-level schedule
    # (/3 then x8/x100) oscillates an order of magnitude around the needed
    # value and destroys the tail convergence rate.  /2 with x2 (x10 fast)
    # keeps delta within a factor 2 of the minimum.
    reg_opts = opts.replace(primal_regularization_decrease_factor=2.0,
                            primal_regularization_slow_increase_factor=2.0,
                            primal_regularization_fast_increase_factor=10.0)

    def solve(g, H, J, rl, ru, dl, du, warm_d=None, warm_y=None,
              H_purify=None):
        """warm_d/warm_y: primal/dual warmstart (the IP analogue of BQPD's
        active-set reuse, BQPDSolver.cpp:246-258): start from the previous
        QP's solution pushed interior with a small initial barrier, so TR
        re-solves at the same iterate converge in a few centering steps.

        H_purify: optional UNREGULARIZED Hessian for the dual-purification
        fit.  When the caller pre-convexified H (+delta*I), the solved QP's
        duals absorb O(delta*|d|) — real duals of the regularized problem,
        but NOT of the caller's problem.  BQPD solves the unregularized QP
        exactly, so parity requires extracting multipliers against the
        original Hessian (e.g. zero duals for a feasibility LP whose
        linearized constraints are satisfiable)."""
        dl = jnp.where(has_dl, dl, -HUGE)
        du = jnp.where(has_du, du, HUGE)
        # slack bounds: inequality rows only; equality rows pin s = rl
        sl = jnp.where(has_rl, rl, -HUGE) if m else jnp.zeros((0,))
        su = jnp.where(has_ru, ru, HUGE) if m else jnp.zeros((0,))

        if warm_d is None:
            d0 = bar.push_to_interior(jnp.zeros((n,)), dl, du, k1, k2)
            y0 = jnp.zeros((m,))
            mu0 = 0.1
            zl0 = jnp.where(has_dl, 1.0, 0.0)
            zu0 = jnp.where(has_du, -1.0, 0.0)
        else:
            d0 = bar.push_to_interior(jnp.asarray(warm_d), dl, du, k1, k2)
            y0 = jnp.zeros((m,)) if warm_y is None else jnp.asarray(warm_y)
            mu0 = 1e-3
            # mu-centered bound duals at the warm point
            zl0 = jnp.where(has_dl,
                            jnp.clip(mu0 / jnp.maximum(d0 - dl, 1e-10),
                                     1e-8, 1e8), 0.0)
            zu0 = jnp.where(has_du,
                            -jnp.clip(mu0 / jnp.maximum(du - d0, 1e-10),
                                      1e-8, 1e8), 0.0)
        if m:
            s0 = jnp.where(is_eq, rl, bar.push_to_interior(J @ d0, sl, su, k1, k2))
        else:
            s0 = jnp.zeros((0,))
        wl0 = jnp.where(has_rl, 1.0, 0.0)
        wu0 = jnp.where(has_ru, -1.0, 0.0)

        def kkt_error(d, s, y, zl, zu, wl, wu):
            r_d = g + H @ d - (J.T @ y if m else 0.0) - zl - zu
            err = jnp.max(jnp.abs(r_d), initial=0.0)
            if m:
                r_c = J @ d - s
                err = jnp.maximum(err, jnp.max(jnp.abs(r_c), initial=0.0))
                # slack stationarity: y - wl - wu = 0 on inequality rows
                r_s = jnp.where(is_ineq, y - wl - wu, 0.0)
                err = jnp.maximum(err, jnp.max(jnp.abs(r_s), initial=0.0))
            cl = bar.bound_complementarity_error(d, zl, zu, dl, du, has_dl, has_du)
            err = jnp.maximum(err, jnp.max(jnp.abs(cl), initial=0.0))
            if m:
                cs = bar.bound_complementarity_error(s, wl, wu, sl, su, has_rl, has_ru)
                err = jnp.maximum(err, jnp.max(jnp.abs(cs), initial=0.0))
            return err

        def body(carry):
            d, s, y, zl, zu, wl, wu, mu, prev_delta, it, status, min_pres = carry

            Sigma_d = bar.barrier_hessian_diag(d, zl, zu, dl, du, has_dl, has_du)
            g_bar_d = g + H @ d \
                + bar.barrier_gradient(d, dl, du, has_dl, has_du, mu, 0.0)
            rhs_d = -(g_bar_d - (J.T @ y if m else 0.0))

            if m:
                Sigma_s = bar.barrier_hessian_diag(s, wl, wu, sl, su, has_rl, has_ru)
                g_bar_s = bar.barrier_gradient(s, sl, su, has_rl, has_ru, mu, 0.0)
                # slack stationarity residual r_s = g_bar_s + y  (Uno sign: -J~^T y
                # with J~ slack column -I gives +y)
                r_s = g_bar_s + y
                inv_Ss = jnp.where(is_ineq, 1.0 / jnp.maximum(Sigma_s, 1e-35), 0.0)
                r_c = J @ d - s
                rhs_c = -r_c - inv_Ss * r_s
                rhs = jnp.concatenate([rhs_d, rhs_c])
            else:
                rhs = rhs_d

            def assemble(delta, eps):
                Hd = H + jnp.diag(Sigma_d + delta)
                if m == 0:
                    return Hd
                dual_block = -jnp.diag(inv_Ss + eps)
                return jnp.block([[Hd, J.T], [J, dual_block]])

            reg = regularize_and_factor(assemble, n, m, jnp.sqrt(mu), prev_delta,
                                        reg_opts, block=opts.ldlt_block_size)
            if opts.kkt_dtype == "float32":
                sol = ldlt_solve(reg.fac, rhs.astype(jnp.float32)).astype(rhs.dtype)
                K64 = assemble(reg.delta, reg.eps)
                for _ in range(2):
                    resid = rhs - K64 @ sol
                    sol = sol + ldlt_solve(reg.fac, resid.astype(jnp.float32)).astype(rhs.dtype)
            else:
                sol = ldlt_solve(reg.fac, rhs)
            dd = sol[:n]
            w = sol[n:] if m else jnp.zeros((0,))
            dy = -w
            if m:
                ds = jnp.where(is_ineq, inv_Ss * (-r_s + w), 0.0)
                dwl, dwu = bar.bound_dual_direction(s, ds, wl, wu, sl, su, has_rl, has_ru, mu)
            else:
                ds = dwl = dwu = jnp.zeros((0,))
            dzl, dzu = bar.bound_dual_direction(d, dd, zl, zu, dl, du, has_dl, has_du, mu)

            tau = jnp.maximum(0.99, 1.0 - mu)
            a_p = bar.primal_fraction_to_boundary(d, dd, dl, du, has_dl, has_du, tau)
            a_z = bar.dual_fraction_to_boundary(zl, zu, dzl, dzu, has_dl, has_du, tau)
            if m:
                a_p = jnp.minimum(a_p, bar.primal_fraction_to_boundary(
                    s, ds, sl, su, has_rl, has_ru, tau))
                a_z = jnp.minimum(a_z, bar.dual_fraction_to_boundary(
                    wl, wu, dwl, dwu, has_rl, has_ru, tau))

            d = d + a_p * dd
            s = s + a_p * ds
            y = y + a_z * dy
            zl, zu = zl + a_z * dzl, zu + a_z * dzu
            wl, wu = wl + a_z * dwl, wu + a_z * dwu

            # monotone barrier decrease
            err = kkt_error(d, s, y, zl, zu, wl, wu)
            mu = jnp.where(err <= 10.0 * mu,
                           jnp.maximum(tol / 10.0,
                                       jnp.minimum(0.2 * mu, jnp.power(mu, 1.5))),
                           mu)

            it = it + 1
            finite = jnp.all(jnp.isfinite(d)) & jnp.all(jnp.isfinite(y))
            status = jnp.where(err <= tol, QP_OPTIMAL, status)
            status = jnp.where(jnp.max(jnp.abs(d), initial=0.0) > 1e10,
                               QP_UNBOUNDED, status)
            status = jnp.where(reg.failed | ~finite, QP_ERROR, status)
            # best primal feasibility ever achieved (NaN-safe): the
            # infeasibility classifier below uses it — an IP that never
            # came close to primal feasibility was solving an infeasible QP
            pres = jnp.max(jnp.abs(J @ d - s), initial=0.0) if m \
                else jnp.asarray(0.0)
            pres = jnp.where(jnp.isfinite(pres), pres, jnp.inf)
            min_pres = jnp.minimum(min_pres, pres)
            return (d, s, y, zl, zu, wl, wu, mu, reg.prev_delta, it, status,
                    min_pres)

        def cond(carry):
            *_, it, status, _min_pres = carry
            return (status == -1) & (it < max_iterations)

        init = (d0, s0, y0, zl0, zu0, wl0, wu0,
                jnp.asarray(mu0), jnp.asarray(0.0), jnp.asarray(0),
                jnp.asarray(-1), jnp.asarray(jnp.inf))
        (d, s, y, zl, zu, wl, wu, mu, _, it, status,
         min_pres) = lax.while_loop(cond, body, init)

        err = kkt_error(d, s, y, zl, zu, wl, wu)

        # ---- dual purification (BQPD-parity, BQPDSolver.cpp:310-348) -------
        # An interior-point QP leaves "dual dust": inactive constraints carry
        # duals ~sqrt(mu_final) instead of exact zeros, and active duals are
        # off by the same order.  BQPD extracts exact multipliers from the
        # active set; we do the same — identify the eps-active set at the
        # converged d and recompute the multipliers by (ridge-regularized)
        # least squares on the active gradients, zeroing the rest.  Accepted
        # only when it does not worsen the stationarity residual.
        if purify:
            eps_a = 1e-6
            act_lo = has_dl & ((d - dl) <= eps_a * (1.0 + jnp.abs(dl)))
            act_up = has_du & ((du - d) <= eps_a * (1.0 + jnp.abs(du)))
            rvec = g + (H if H_purify is None else H_purify) @ d
            if m:
                r_rows = J @ d
                row_lo = has_rl & ((r_rows - rl) <= eps_a * (1.0 + jnp.abs(rl)))
                row_up = has_ru & ((ru - r_rows) <= eps_a * (1.0 + jnp.abs(ru)))
                act_row = is_eq | row_lo | row_up
                A = jnp.concatenate([J.T * act_row[None, :],
                                     jnp.diag(jnp.where(act_lo, 1.0, 0.0)),
                                     jnp.diag(jnp.where(act_up, 1.0, 0.0))],
                                    axis=1)
            else:
                A = jnp.concatenate([jnp.diag(jnp.where(act_lo, 1.0, 0.0)),
                                     jnp.diag(jnp.where(act_up, 1.0, 0.0))],
                                    axis=1)
            lam = 1e-10 * (1.0 + jnp.max(jnp.abs(A)))
            AtA = A.T @ A + lam * jnp.eye(A.shape[1])
            # solve the SPD normal equations with the in-repo LDL^T (the
            # same factorization as every other KKT solve, in f64)
            from uno_tpu.linalg.ldlt import ldlt_factor
            w = ldlt_solve(ldlt_factor(AtA), A.T @ rvec)
            if m:
                y_p = jnp.where(act_row, w[:m], 0.0)
                # one-sided active inequality rows have signed multipliers
                y_p = jnp.where(is_eq, y_p,
                                jnp.where(row_lo & ~row_up,
                                          jnp.maximum(y_p, 0.0),
                                          jnp.where(row_up & ~row_lo,
                                                    jnp.minimum(y_p, 0.0),
                                                    y_p)))
                zl_p = jnp.maximum(jnp.where(act_lo, w[m:m + n], 0.0), 0.0)
                zu_p = jnp.minimum(jnp.where(act_up, w[m + n:], 0.0), 0.0)
            else:
                y_p = y
                zl_p = jnp.maximum(jnp.where(act_lo, w[:n], 0.0), 0.0)
                zu_p = jnp.minimum(jnp.where(act_up, w[n:], 0.0), 0.0)
            # active-bound duals absorb the solver's own O(err) residual in
            # the fit; values below the solve's resolution are noise, snap
            # them to the exact zeros an active-set solver would return.
            # The fit residual itself is a second noise floor: when the fit
            # is inconsistent (d solves a regularized QP, H_purify is the
            # unregularized Hessian), least squares smears the residual
            # into small spurious multipliers that exact stationarity on
            # free variables (BQPD's extraction) would force to zero.
            fit_res = jnp.max(jnp.abs(rvec - (J.T @ y_p if m else 0.0)
                                      - zl_p - zu_p), initial=0.0)
            noise = jnp.maximum(100.0 * err, fit_res)
            if m:
                y_p = jnp.where(jnp.abs(y_p) <= noise, 0.0, y_p)
            zl_p = jnp.where(jnp.abs(zl_p) <= noise, 0.0, zl_p)
            zu_p = jnp.where(jnp.abs(zu_p) <= noise, 0.0, zu_p)
            stat_old = jnp.max(jnp.abs(rvec - (J.T @ y if m else 0.0)
                                       - zl - zu), initial=0.0)
            stat_new = jnp.max(jnp.abs(rvec - (J.T @ y_p if m else 0.0)
                                       - zl_p - zu_p), initial=0.0)
            # the IP's dust duals balance its own O(err) primal residual, so
            # exactly-complementary duals may cost O(err * |J|) stationarity;
            # accept within 100x of the solver's exit error — the purified
            # duals are then BQPD-like (exact zeros off the active set) at
            # no meaningful loss
            better = stat_new <= jnp.maximum(stat_old, 100.0 * err + tol)
            y = jnp.where(better, y_p, y) if m else y
            zl = jnp.where(better, zl_p, zl)
            zu = jnp.where(better, zu_p, zu)

        primal_res = jnp.max(jnp.abs(J @ d - s), initial=0.0) if m else jnp.asarray(0.0)
        # iteration cap without tight convergence: accept at a loose tolerance
        # (convexified nonconvex QPs converge linearly in the tail); declare
        # INFEASIBLE only with a certificate-like signature (stalled primal
        # residual AND diverging duals) — a merely-unconverged solve must be
        # ERROR, or the outer loop would enter restoration spuriously
        status = jnp.where((status == -1) & (err <= 1e-6), QP_OPTIMAL, status)
        ynorm = jnp.max(jnp.abs(y), initial=0.0) if m else jnp.asarray(0.0)
        # infeasibility classification at the iteration cap: on a FEASIBLE
        # QP the (linear) primal residual converges quickly, so a residual
        # still large relative to the constraint scale after max_iterations
        # is a practical infeasibility certificate even when the duals did
        # not diverge (the monotone-mu rule freezes mu when the error
        # stalls, so the classic diverging-dual ray may never develop)
        if m:
            bscale = 1.0 + jnp.max(
                jnp.where(has_rl | is_eq, jnp.abs(jnp.where(has_rl | is_eq, rl, 0.0)), 0.0)
                + jnp.where(has_ru | is_eq, jnp.abs(jnp.where(has_ru | is_eq, ru, 0.0)), 0.0),
                initial=0.0)
        else:
            bscale = jnp.asarray(1.0)
        status = jnp.where(status == -1,
                           jnp.where((min_pres > 1e-3 * bscale)
                                     | ((primal_res > 1e-6) & (ynorm > 1e4)),
                                     QP_INFEASIBLE, QP_ERROR),
                           status)
        # an ERROR exit while primal feasibility was NEVER approached is the
        # infeasibility signature of an IPM (the primal residual of a
        # feasible QP is driven down by every Newton step regardless of
        # curvature trouble; staying far from feasibility until breakdown
        # means no feasible point exists).  min_pres is NaN-safe, and the
        # dual norm is NOT consulted: purification zeros the exploded
        # dual-ray multipliers of an infeasible solve.  A minimum iteration
        # count guards against a first-iterations breakdown (e.g. a
        # regularization failure before any fraction-to-boundary step has
        # had a chance to reduce ||Jd-s||) being mistaken for a certificate
        # — an early breakdown stays ERROR and the outer loop treats it as
        # such instead of spuriously entering feasibility restoration.
        status = jnp.where((status == QP_ERROR)
                           & (min_pres > 1e-3 * bscale) & (it >= 5),
                           QP_INFEASIBLE, status)
        objective = g @ d + 0.5 * d @ (H @ d)
        return QPResult(d=d, y=y, zl=zl, zu=zu, status=status,
                        objective=objective, iterations=it, kkt_error=err)

    # jit: one executable per QP family (+1 for the warmstarted signature)
    # instead of thousands of per-op dispatches per solve
    return jax.jit(solve)


def qp_structure_from_bounds(rl, ru, dl, du) -> QPStructure:
    """Build the static structure from representative bound arrays
    (finiteness pattern must be constant across solves of the family)."""
    rl, ru = np.asarray(rl), np.asarray(ru)
    dl, du = np.asarray(dl), np.asarray(du)
    return QPStructure(
        n=dl.shape[0], m=rl.shape[0],
        has_dl=np.isfinite(dl) & (dl > -1e20),
        has_du=np.isfinite(du) & (du < 1e20),
        is_eq=(rl == ru) & np.isfinite(rl),
        has_rl=np.isfinite(rl) & (rl > -1e20),
        has_ru=np.isfinite(ru) & (ru < 1e20),
    )
