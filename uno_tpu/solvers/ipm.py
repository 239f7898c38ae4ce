"""Primal-dual interior-point solver — the `ipopt` preset path, fully jitted.

Functional re-design (NOT a port) of the reference call stack (SURVEY.md §3.1):
  Uno::solve outer loop                      (uno/Uno.cpp:61-78)
  BacktrackingLineSearch                     (BacktrackingLineSearch.cpp:51-113)
  FeasibilityRestoration phases              (FeasibilityRestoration.cpp:78-207)
  PrimalDualInteriorPointMethod/Problem      (PrimalDualInteriorPoint*.cpp)
  BarrierParameterUpdateStrategy             (BarrierParameterUpdateStrategy.cpp:33-63)
  PrimalDualRegularization loop              (PrimalDualRegularization.hpp:133-226)
  WaechterFilterMethod acceptance            (WaechterFilterMethod.cpp:25-90)
  termination tests with residual scaling    (ConstraintRelaxationStrategy.cpp:128-258)

TPU-first architecture decisions:
  * One `lax.while_loop` drives the outer iteration over a single state
    pytree; exceptions of the reference (UnstableRegularization, eval errors,
    "LS failed") are status flags in the state.
  * ONE static KKT shape for both phases: the feasibility-restoration l1
    elastics (p, q >= 0 with barrier) are condensed out of the augmented
    system analytically, contributing a diagonal -D_e = -(P/Zp + Q/Zq) to the
    dual block.  The reference instead re-allocates a larger problem
    (l1RelaxedProblem, +2m variables); condensation keeps XLA shapes static
    and the factorization cost identical in both phases.
  * The entire solver is vmap-able over batched instances (same structure,
    different params/x0) — the TPU scale axis (SURVEY.md §2.15).

Deviations from the reference control flow (documented):
  * Phase switches take effect at the next outer iteration (the reference
    re-solves the new phase's subproblem within the same iteration); this
    costs at most one extra cheap iteration per switch.
  * The l1 elastic initialization uses the reference's actual behavior
    (constraint value treated as 0, PrimalDualInteriorPointMethod.cpp:214),
    i.e. p = q = mu/rho; see the inline note at the restoration-entry block
    for the round-2 A/B sweep of the "true" IPOPT formula (net negative).
  * On a line-search failure the small-step termination test runs at the
    current iterate rather than the last rejected trial.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from uno_tpu.ingredients import barrier as bar
from uno_tpu.ingredients import filters as flt
from uno_tpu.ingredients.regularization import regularize_and_factor
from uno_tpu.linalg.ldlt import ldlt_factor_blocked, ldlt_solve
from uno_tpu.ingredients.regularization import pick_factorizer
from uno_tpu.model.nlp import NLP, vector_norm
from uno_tpu.model import transforms
from uno_tpu.options import Options

# status codes
RUNNING = 0
OPTIMAL = 1            # FEASIBLE_KKT_POINT at tight tolerance
ALMOST_OPTIMAL = 2     # FEASIBLE_KKT_POINT at loose tolerance (15 consecutive)
INFEASIBLE_STATIONARY = 3
UNBOUNDED = 4
ALGORITHMIC_ERROR = 5  # unstable regularization / LS failed
MAX_ITERATIONS = 6
TIME_LIMIT = 7         # reference OptimizationStatus::TIME_LIMIT

STATUS_NAMES = {
    RUNNING: "running",
    OPTIMAL: "optimal",
    ALMOST_OPTIMAL: "almost_optimal",
    INFEASIBLE_STATIONARY: "infeasible_stationary_point",
    UNBOUNDED: "unbounded",
    ALGORITHMIC_ERROR: "algorithmic_error",
    MAX_ITERATIONS: "iteration_limit",
    TIME_LIMIT: "time_limit",
}

# f32-range-safe; chosen for a machine whose f64 was emulated in f32 pairs,
# not yet re-decided for native f64 on the H100 (ROADMAP C3)
LARGE_BOUND = 1e25


def _mv(A, x):
    """A @ x for tiny matrices as broadcast-multiply + reduce: the explicit
    form fuses into plain elementwise code under vmap.  Chosen for a machine
    whose f64 dot was emulated; not yet re-measured on the H100
    (ROADMAP C3)."""
    return jnp.sum(A * x[None, :], axis=1)


def _mtv(A, y):
    """A.T @ y, same rationale as _mv."""
    return jnp.sum(A * y[:, None], axis=0)


class IPMState(NamedTuple):
    # primal-dual iterate (n includes slacks from homogenization)
    x: jnp.ndarray
    y: jnp.ndarray       # optimality constraint multipliers (m,)
    zl: jnp.ndarray      # optimality bound duals (n,)
    zu: jnp.ndarray
    # feasibility-phase multipliers
    y_f: jnp.ndarray
    zl_f: jnp.ndarray
    zu_f: jnp.ndarray
    # l1 elastics (restoration phase), strictly positive placeholders in OPT
    p: jnp.ndarray       # (m,)
    q: jnp.ndarray
    zp: jnp.ndarray
    zq: jnp.ndarray
    # barrier
    mu: jnp.ndarray
    mu_backup: jnp.ndarray
    prev_delta: jnp.ndarray
    # phase machine
    phase: jnp.ndarray           # 0 = optimality, 1 = feasibility restoration
    skip_mu_update: jnp.ndarray  # bool: first iteration after entering FEAS
    subproblem_changed: jnp.ndarray
    # globalization
    filter: flt.FilterState
    gs_scalar: jnp.ndarray       # funnel width | merit smallest-known h | unused
    x_ref: jnp.ndarray           # proximal center (restoration)
    h_ref: jnp.ndarray           # reference infeasibility at phase switch
    h_initial: jnp.ndarray
    # progress measures of the current iterate
    h_cur: jnp.ndarray
    f_cur: jnp.ndarray
    aux_cur: jnp.ndarray
    # residuals of the current iterate
    stat: jnp.ndarray
    stat_scaling: jnp.ndarray
    compl: jnp.ndarray
    compl_scaling: jnp.ndarray
    primal_feas: jnp.ndarray
    feas_stat: jnp.ndarray
    feas_stat_scaling: jnp.ndarray
    feas_compl: jnp.ndarray
    feas_compl_scaling: jnp.ndarray
    # bookkeeping
    loose_count: jnp.ndarray
    iteration: jnp.ndarray
    status: jnp.ndarray
    step_norm: jnp.ndarray
    num_subproblems: jnp.ndarray
    num_factorizations: jnp.ndarray
    num_obj_evals: jnp.ndarray
    num_con_evals: jnp.ndarray
    # per-instance NLP parameters (batch axis for vmapped multi-instance
    # solves); None for single-instance problems
    params: object


@dataclass(frozen=True)
class IPMWorkspace:
    """Static (compile-time) problem data for the reformulated NLP."""
    n: int
    m: int
    lb: np.ndarray
    ub: np.ndarray
    has_lb: np.ndarray
    has_ub: np.ndarray
    n_bounded: int       # |lb set| + |ub set|  (residual scalings)
    constrained: bool


def _build_workspace(prob: NLP) -> IPMWorkspace:
    has_lb, has_ub = prob.has_x_lb, prob.has_x_ub
    lb = np.where(has_lb, prob.x_lb, -LARGE_BOUND)
    ub = np.where(has_ub, prob.x_ub, LARGE_BOUND)
    return IPMWorkspace(
        n=prob.n, m=prob.m, lb=lb, ub=ub,
        has_lb=has_lb, has_ub=has_ub,
        n_bounded=int(has_lb.sum() + has_ub.sum()),
        constrained=prob.m > 0,
    )


# --------------------------------------------------------------------------
# residuals & termination  (ConstraintRelaxationStrategy.cpp:128-258)
# --------------------------------------------------------------------------

def _residuals(prob: NLP, ws: IPMWorkspace, opts: Options, x, y, zl, zu,
               y_f, zl_f, zu_f, p, q, zp, zq, sigma, nu, params=None):
    g = prob.objective_gradient(x, params)
    c = prob.constraints(x, params)
    J = prob.constraint_jacobian(x, params)
    lbj, ubj = jnp.asarray(ws.lb), jnp.asarray(ws.ub)
    hlb, hub = jnp.asarray(ws.has_lb), jnp.asarray(ws.has_ub)
    rn = opts.residual_norm

    # optimality stationarity: sigma*grad f - J^T y - zl - zu
    cons_contrib = -(_mtv(J, y) if ws.m else jnp.zeros_like(x)) - zl - zu
    stat = vector_norm(sigma * g + cons_contrib, rn)
    # primal feasibility (homogenized model: all equalities at 0)
    primal_feas = prob.constraint_violation(c, rn)
    # complementarity (bounds only; no inequality constraints remain)
    compl_vec = bar.bound_complementarity_error(x, zl, zu, lbj, ubj, hlb, hub)
    compl = vector_norm(compl_vec, rn)

    # scalings (residual_scaling_threshold = 100)
    thr = opts.residual_scaling_threshold

    def stat_scaling_of(yv, zlv, zuv):
        total = ws.n_bounded + ws.m
        if total == 0:
            return jnp.asarray(1.0)
        norm1 = jnp.sum(jnp.abs(yv)) + jnp.sum(jnp.abs(zlv)) + jnp.sum(jnp.abs(zuv))
        return jnp.maximum(1.0, norm1 / (thr * total))

    def compl_scaling_of(zlv, zuv):
        if ws.n_bounded == 0:
            return jnp.asarray(1.0)
        norm1 = jnp.sum(jnp.abs(zlv)) + jnp.sum(jnp.abs(zuv))
        return jnp.maximum(1.0, norm1 / (thr * ws.n_bounded))

    stat_scaling = stat_scaling_of(y, zl, zu)
    compl_scaling = compl_scaling_of(zl, zu)

    # feasibility problem (l1 relaxed, rho=0, no proximal) residuals
    feas_x = -(_mtv(J, y_f) if ws.m else jnp.zeros_like(x)) - zl_f - zu_f
    if ws.m:
        feas_p = nu - y_f - zp
        feas_q = nu + y_f - zq
        feas_stat = vector_norm(jnp.concatenate([feas_x, feas_p, feas_q]), rn)
        el_compl = jnp.concatenate([
            jnp.where(zp > 0, zp * p, 0.0), jnp.where(zq > 0, zq * q, 0.0)])
    else:
        feas_stat = vector_norm(feas_x, rn)
        el_compl = jnp.zeros((0,), dtype=x.dtype)
    feas_compl_vec = bar.bound_complementarity_error(x, zl_f, zu_f, lbj, ubj, hlb, hub)
    feas_compl = vector_norm(jnp.concatenate([feas_compl_vec, el_compl]), rn)
    feas_stat_scaling = stat_scaling_of(y_f, zl_f, zu_f)
    feas_compl_scaling = compl_scaling_of(zl_f, zu_f)

    return dict(stat=stat, stat_scaling=stat_scaling, compl=compl,
                compl_scaling=compl_scaling, primal_feas=primal_feas,
                feas_stat=feas_stat, feas_stat_scaling=feas_stat_scaling,
                feas_compl=feas_compl, feas_compl_scaling=feas_compl_scaling)


def _first_order_status(ws, opts, res, sigma, y_f, zl_f, zu_f, tol):
    """IterateStatus per tolerance (check_first_order_convergence :230-258)."""
    stationarity = res["stat"] / res["stat_scaling"] <= tol
    primal_feas_ok = res["primal_feas"] <= tol
    compl_ok = res["compl"] / res["compl_scaling"] <= tol
    kkt = stationarity & primal_feas_ok & (sigma > 0) & compl_ok

    feas_stat_ok = res["feas_stat"] <= tol
    feas_compl_ok = res["feas_compl"] <= tol
    nontrivial = (jnp.max(jnp.abs(y_f), initial=0.0) > tol) | \
                 (jnp.max(jnp.abs(zl_f + zu_f), initial=0.0) > tol)
    infeas_stat = ws.constrained & feas_stat_ok & ~primal_feas_ok & \
        feas_compl_ok & nontrivial
    return kkt, infeas_stat


# --------------------------------------------------------------------------
# barrier parameter update  (BarrierParameterUpdateStrategy.cpp:33-63)
# --------------------------------------------------------------------------

def _update_barrier_parameter(ws, opts, mu, x, zl, zu, p, q, zp, zq, is_feas,
                              sigma, stat, stat_scaling, compl, compl_scaling,
                              primal_feas):
    lbj, ubj = jnp.asarray(ws.lb), jnp.asarray(ws.ub)
    hlb, hub = jnp.asarray(ws.has_lb), jnp.asarray(ws.has_ub)
    scaled_stat = stat / stat_scaling
    pf = jnp.where(sigma == 0.0, 0.0, primal_feas)
    error0 = jnp.maximum(jnp.maximum(scaled_stat, pf), compl / compl_scaling)
    tol_fraction = opts.tolerance / opts.barrier_update_fraction

    def centrality(mu_n):
        e = bar.centrality_error(x, zl, zu, lbj, ubj, hlb, hub, mu_n)
        if ws.m:
            # elastic complementarity enters in the feasibility phase
            e_p = jnp.max(jnp.where(zp > 0, jnp.abs(zp * p - mu_n), 0.0), initial=0.0)
            e_q = jnp.max(jnp.where(zq > 0, jnp.abs(zq * q - mu_n), 0.0), initial=0.0)
            e = jnp.where(is_feas, jnp.maximum(e, jnp.maximum(e_p, e_q)), e)
        return e

    def cond(carry):
        mu_c, err, _ = carry
        return (err <= opts.barrier_k_epsilon * mu_c) & (tol_fraction < mu_c)

    def body(carry):
        mu_c, _, _ = carry
        mu_n = jnp.maximum(tol_fraction,
                           jnp.minimum(opts.barrier_k_mu * mu_c,
                                       jnp.power(mu_c, opts.barrier_theta_mu)))
        cent = centrality(mu_n) / compl_scaling
        err_n = jnp.maximum(jnp.maximum(scaled_stat, pf), cent)
        return mu_n, err_n, jnp.asarray(True)

    mu_new, _, changed = lax.while_loop(cond, body, (mu, error0, jnp.asarray(False)))
    return mu_new, changed


# --------------------------------------------------------------------------
# the solver step
# --------------------------------------------------------------------------

def make_ipm_step(prob: NLP, ws: IPMWorkspace, opts: Options,
                  kkt_backend=None):
    """kkt_backend: optional (factorize, solve[, matvec]) tuple replacing the
    built-in LDL^T — e.g. the mesh-distributed backend
    (parallel/dist_ldlt.py) for KKT systems whose factorization should be
    sharded over chips, or the structured banded backend
    (linalg/banded_kkt.py), whose `assemble` produces a BandedKKT pytree
    instead of a dense matrix and whose matvec implements the exact
    augmented operator for f64 refinement.
    Builds the jittable single-outer-iteration function state -> state."""
    if kkt_backend:
        kkt_factorizer, kkt_solver = kkt_backend[0], kkt_backend[1]
        kkt_matvec = kkt_backend[2] if len(kkt_backend) > 2 else None
    else:
        kkt_factorizer = kkt_solver = kkt_matvec = None
    banded = kkt_matvec is not None  # structured-assembly mode
    n, m = ws.n, ws.m
    nu = opts.l1_constraint_violation_coefficient
    lbj, ubj = jnp.asarray(ws.lb), jnp.asarray(ws.ub)
    hlb, hub = jnp.asarray(ws.has_lb), jnp.asarray(ws.has_ub)
    damping = opts.barrier_damping_factor
    eps_machine = float(np.finfo(np.float64).eps)

    def prox_scaling(x_ref):
        s = jnp.minimum(1.0, 1.0 / jnp.maximum(jnp.abs(x_ref), 1e-35))
        return s * s

    def aux_measure(x, p, q, mu, is_feas):
        a = bar.barrier_auxiliary_measure(x, lbj, ubj, hlb, hub, mu, damping)
        if m:
            # elastics are single-lower-bounded at 0
            ael = mu * jnp.sum(-jnp.log(jnp.maximum(p, 1e-35))
                               - jnp.log(jnp.maximum(q, 1e-35))
                               + damping * (p + q))
            a = a + jnp.where(is_feas, ael, 0.0)
        return a

    def progress(x, p, q, mu, is_feas, params):
        f_val = prob.objective(x, params)
        c = prob.constraints(x, params)
        h = prob.constraint_violation(c, opts.progress_norm)
        aux = aux_measure(x, p, q, mu, is_feas)
        return h, f_val, aux

    # ---- globalization strategy dispatch (static at build time) ----------
    # reference: GlobalizationStrategyFactory.cpp — l1_merit |
    # fletcher_filter_method | waechter_filter_method | funnel_method, each
    # combinable with the IPM (the reference only excludes IPM+TR); filters
    # come in standard and nonmonotone variants (FilterFactory).
    gs = opts.globalization_strategy
    if gs not in ("l1_merit", "fletcher_filter_method",
                  "waechter_filter_method", "funnel_method"):
        raise ValueError(f"unknown globalization strategy {gs!r}")
    nonmono = opts.filter_type == "nonmonotone"
    max_dom = opts.nonmonotone_filter_number_dominated_entries

    def _flt_acceptable(f, h_t, phi_t):
        if nonmono:
            return flt.nm_filter_acceptable(f, h_t, phi_t, opts.filter_beta,
                                            opts.filter_gamma, max_dom)
        return flt.filter_acceptable(f, h_t, phi_t, opts.filter_beta,
                                     opts.filter_gamma)

    def _flt_acceptable_wrt(f, h_c, phi_c, h_t, phi_t):
        if nonmono:
            return flt.nm_filter_acceptable_wrt(f, h_c, phi_c, h_t, phi_t,
                                                opts.filter_beta,
                                                opts.filter_gamma, max_dom)
        return flt.filter_acceptable_wrt(h_c, phi_c, h_t, phi_t,
                                         opts.filter_beta, opts.filter_gamma)

    def _flt_add(f, h_c, phi_c):
        if nonmono:
            return flt.nm_filter_add(f, h_c, phi_c, max_dom)
        return flt.filter_add(f, h_c, phi_c, opts.filter_beta)

    def _actual_reduction(f, merit_cur, h_cur, merit_tri, roundoff):
        if nonmono:
            return flt.nm_actual_objective_reduction(
                f, merit_cur, h_cur, merit_tri, opts.filter_gamma, max_dom) \
                + roundoff
        return merit_cur - merit_tri + roundoff

    def step(s: IPMState) -> IPMState:
        is_feas = s.phase == 1
        sigma = jnp.where(is_feas, 0.0, 1.0)

        # active multiplier set for the current phase
        y_a = jnp.where(is_feas, s.y_f, s.y)
        zl_a = jnp.where(is_feas, s.zl_f, s.zl)
        zu_a = jnp.where(is_feas, s.zu_f, s.zu)

        # -- barrier parameter update (uses current-iterate residuals) -------
        stat_u = jnp.where(is_feas, s.feas_stat, s.stat)
        stat_sc_u = jnp.where(is_feas, s.feas_stat_scaling, s.stat_scaling)
        compl_u = jnp.where(is_feas, s.feas_compl, s.compl)
        compl_sc_u = jnp.where(is_feas, s.feas_compl_scaling, s.compl_scaling)
        mu_new, mu_changed = _update_barrier_parameter(
            ws, opts, s.mu, s.x, zl_a, zu_a, s.p, s.q, s.zp, s.zq, is_feas,
            sigma, stat_u, stat_sc_u, compl_u, compl_sc_u, s.primal_feas)
        mu = jnp.where(s.skip_mu_update, s.mu, mu_new)
        mu_changed = jnp.where(s.skip_mu_update, False, mu_changed)

        # subproblem changed -> reset the filter (keep its upper bound)
        changed = s.subproblem_changed | mu_changed
        filt = flt.FilterState(
            jnp.where(changed, jnp.full_like(s.filter.h, jnp.inf), s.filter.h),
            jnp.where(changed, jnp.full_like(s.filter.phi, jnp.inf), s.filter.phi),
            s.filter.ub,
        )

        # current-iterate progress under (possibly new) mu
        h_cur, f_cur, aux_cur = progress(s.x, s.p, s.q, mu, is_feas, s.params)
        # filter objective measure phi(1) + aux (SwitchingMethod::unconstrained_merit)
        merit_cur = f_cur + aux_cur

        # -- evaluate derivatives at current x ------------------------------
        g = prob.objective_gradient(s.x, s.params)
        c = prob.constraints(s.x, s.params)
        if banded:
            # structured path: windowed Jacobian extraction (O(w) jvp probes)
            # + banded Hessian extraction (O(b) hvp probes) — the dense J is
            # still materialized (O(m*w) scatter) for the rhs/LS/residual
            # code below, but never refactorized densely
            from uno_tpu.linalg.banded_kkt import dense_from_windows
            bst = prob.structure
            slack_cols = prob.slack_of_constraint \
                if prob.slack_of_constraint is not None \
                else np.full(m, -1, dtype=np.int64)
            n0_b = n - int(np.sum(slack_cols >= 0))
            if m:
                J_local = prob.constraint_jacobian_windows(s.x, s.params)
                J = dense_from_windows(J_local, bst.jac_starts, n, slack_cols)
            else:
                J_local = jnp.zeros((0, max(bst.jac_width, 1)), dtype=s.x.dtype)
                J = prob.constraint_jacobian(s.x, s.params)
            bh = bst.hess_bandwidth
            if opts.hessian_model == "identity":
                H_band = jnp.zeros((bh + 1, n0_b), dtype=s.x.dtype) \
                    .at[0, :].set(1.0)
                hess_slack_diag = 1.0
            elif opts.hessian_model == "zero":
                H_band = jnp.zeros((bh + 1, n0_b), dtype=s.x.dtype)
                hess_slack_diag = 0.0
            else:
                H_band = prob.lagrangian_hessian_band(
                    s.x, y_a, sigma, s.params)[:, :n0_b]
                hess_slack_diag = 0.0
        else:
            J = prob.constraint_jacobian(s.x, s.params)
            # Hessian model (reference hessian_models/: exact | identity |
            # zero, HessianModelFactory.cpp); static, folds at trace
            if opts.hessian_model == "identity":
                H_lag = jnp.eye(n, dtype=s.x.dtype)
            elif opts.hessian_model == "zero":
                H_lag = jnp.zeros((n, n), dtype=s.x.dtype)
            else:
                H_lag = prob.lagrangian_hessian(s.x, y_a, sigma, s.params)

        # proximal term (feasibility phase only): sqrt(mu)*diag(scaling^2)
        prox_coef = jnp.sqrt(mu)
        prox_diag = jnp.where(is_feas, prox_coef * prox_scaling(s.x_ref), 0.0)
        Sigma = bar.barrier_hessian_diag(s.x, zl_a, zu_a, lbj, ubj, hlb, hub)
        if not banded:
            H = H_lag + jnp.diag(prox_diag + Sigma)

        # barrier + proximal gradient
        g_bar = sigma * g \
            + bar.barrier_gradient(s.x, lbj, ubj, hlb, hub, mu, damping) \
            + jnp.where(is_feas, prox_coef * prox_scaling(s.x_ref) * (s.x - s.x_ref), 0.0)

        # rhs x-part: -(grad_bar - J^T y)  (Subproblem::assemble_augmented_rhs)
        rhs_x = -(g_bar - (_mtv(J, y_a) if m else 0.0))

        if m:
            # condensed elastic terms (see module docstring)
            r_p = nu + damping * mu - mu / s.p - y_a
            r_q = nu + damping * mu - mu / s.q + y_a
            inv_sp = s.p / s.zp
            inv_sq = s.q / s.zq
            D_e = jnp.where(is_feas, inv_sp + inv_sq, 0.0)
            r_c = c + jnp.where(is_feas, s.p - s.q, 0.0)
            rhs_c = -r_c + jnp.where(is_feas, inv_sp * r_p - inv_sq * r_q, 0.0)
            rhs = jnp.concatenate([rhs_x, rhs_c])
        else:
            rhs = rhs_x

        # -- assemble + inertia-corrected factorization ---------------------
        if banded:
            from uno_tpu.linalg.banded_kkt import BandedKKT

            def assemble(delta, eps):
                sd = prox_diag + Sigma
                return BandedKKT(
                    H_band=H_band,
                    diag0=sd[:n0_b] + delta,
                    sig_s=sd[n0_b:] + hess_slack_diag + delta,
                    J_local=J_local,
                    C=(D_e if m else jnp.zeros((0,), dtype=s.x.dtype)) + eps)
        else:
            def assemble(delta, eps):
                Hd = H + delta * jnp.eye(n, dtype=H.dtype)
                if m == 0:
                    return Hd
                dual_block = -jnp.diag(D_e + eps)
                return jnp.block([[Hd, J.T], [J, dual_block]])

        dual_reg_param = jnp.power(mu, opts.barrier_regularization_exponent)
        reg = regularize_and_factor(assemble, n, m, dual_reg_param,
                                    s.prev_delta, opts, block=opts.ldlt_block_size,
                                    factorizer=kkt_factorizer)
        _solve = kkt_solver if kkt_solver is not None else ldlt_solve
        if opts.kkt_dtype == "float32":
            # mixed-precision: f32 factors + f64 iterative refinement.
            # The residual matvec is written as broadcast-multiply + reduce
            # (see _mv; ROADMAP C3).
            sol = _solve(reg.fac, rhs.astype(jnp.float32)).astype(rhs.dtype)
            K64 = assemble(reg.delta, reg.eps)
            for _ in range(opts.kkt_refinement_steps):
                if banded:
                    resid = rhs - kkt_matvec(K64, sol)
                else:
                    resid = rhs - jnp.sum(K64 * sol[None, :], axis=1)
                sol = sol + _solve(reg.fac, resid.astype(jnp.float32)).astype(rhs.dtype)
        else:
            sol = _solve(reg.fac, rhs)
            if banded:
                # the lifted tau leaves O(tau*|w|) error on equality rows;
                # one f64 refinement against the exact augmented operator
                # removes it (same role as the lifted backend's refinement)
                K64 = assemble(reg.delta, reg.eps)
                for _ in range(opts.kkt_refinement_steps):
                    resid = rhs - kkt_matvec(K64, sol)
                    sol = sol + _solve(reg.fac, resid)
        dx = sol[:n]
        w = sol[n:] if m else jnp.zeros((0,), dtype=sol.dtype)
        dy = -w
        kkt_failed = reg.failed  # unstable regularization -> restoration

        # -- direction assembly + fraction-to-boundary ----------------------
        dzl, dzu = bar.bound_dual_direction(s.x, dx, zl_a, zu_a, lbj, ubj, hlb, hub, mu)
        if m:
            dp = jnp.where(is_feas, inv_sp * (-r_p - w), 0.0)
            dq = jnp.where(is_feas, inv_sq * (-r_q + w), 0.0)
            dzp = jnp.where(is_feas, (mu - dp * s.zp) / s.p - s.zp, 0.0)
            dzq = jnp.where(is_feas, (mu - dq * s.zq) / s.q - s.zq, 0.0)
        else:
            dp = dq = dzp = dzq = jnp.zeros((0,), dtype=dx.dtype)

        tau = jnp.maximum(opts.barrier_tau_min, 1.0 - mu)
        alpha_p = bar.primal_fraction_to_boundary(s.x, dx, lbj, ubj, hlb, hub, tau)
        alpha_z = bar.dual_fraction_to_boundary(zl_a, zu_a, dzl, dzu, hlb, hub, tau)
        if m:
            # elastics: lower bound 0 on p, q; their duals zp, zq stay > 0
            zero_m = jnp.zeros((m,), dtype=dx.dtype)
            big_m = zero_m + LARGE_BOUND
            tm = jnp.ones((m,), dtype=bool)
            fm = jnp.zeros((m,), dtype=bool)
            a_pp = bar.primal_fraction_to_boundary(s.p, dp, zero_m, big_m, tm, fm, tau)
            a_pq = bar.primal_fraction_to_boundary(s.q, dq, zero_m, big_m, tm, fm, tau)
            a_zp = bar.primal_fraction_to_boundary(s.zp, dzp, zero_m, big_m, tm, fm, tau)
            a_zq = bar.primal_fraction_to_boundary(s.zq, dzq, zero_m, big_m, tm, fm, tau)
            alpha_p = jnp.where(is_feas, jnp.minimum(alpha_p, jnp.minimum(a_pp, a_pq)), alpha_p)
            alpha_z = jnp.where(is_feas, jnp.minimum(alpha_z, jnp.minimum(a_zp, a_zq)), alpha_z)

        dx = dx * alpha_p
        dy = dy * alpha_p
        dzl, dzu = dzl * alpha_z, dzu * alpha_z
        dp, dq = dp * alpha_p, dq * alpha_p
        dzp, dzq = dzp * alpha_z, dzq * alpha_z
        dir_norm = jnp.max(jnp.abs(dx), initial=0.0)

        # -- backtracking line search ---------------------------------------
        roundoff = jnp.where(opts.protect_actual_reduction_against_roundoff,
                             10.0 * eps_machine * jnp.abs(merit_cur), 0.0)

        # alpha-independent pieces hoisted out of the LS while body: XLA does
        # not LICM f64 dots out of while loops, and the double-double
        # emulation makes each one expensive (profiled)
        Jdx = _mv(J, dx) if m else None
        gdx = jnp.sum(g * dx)
        bdd_h = bar.barrier_directional_derivative(s.x, dx, lbj, ubj, hlb, hub,
                                                   mu, damping)
        if m:
            el_dd_h = jnp.sum((-mu / s.p + damping * mu) * dp
                              + (-mu / s.q + damping * mu) * dq)
            bdd_h = bdd_h + jnp.where(is_feas, el_dd_h, 0.0)

        def ls_trial(alpha):
            dual_alpha = alpha if opts.LS_scale_duals_with_step_length else 1.0
            x_t = jnp.clip(s.x + alpha * dx, lbj, ubj)
            y_t = y_a + dual_alpha * dy
            zl_t, zu_t = zl_a + dzl, zu_a + dzu
            p_t = s.p + alpha * dp
            q_t = s.q + alpha * dq
            zp_t, zq_t = s.zp + dzp, s.zq + dzq
            # postprocess: k_sigma rescale (PrimalDualInteriorPointProblem:348)
            zl_t, zu_t = bar.k_sigma_rescale(x_t, zl_t, zu_t, lbj, ubj, hlb, hub,
                                             mu, opts.barrier_k_sigma)
            if m:
                coef = mu / jnp.maximum(p_t, 1e-35)
                zp_t = jnp.where(is_feas, jnp.clip(zp_t, coef / opts.barrier_k_sigma,
                                                   coef * opts.barrier_k_sigma), zp_t)
                coef = mu / jnp.maximum(q_t, 1e-35)
                zq_t = jnp.where(is_feas, jnp.clip(zq_t, coef / opts.barrier_k_sigma,
                                                   coef * opts.barrier_k_sigma), zq_t)
            h_t, f_t, aux_t = progress(x_t, p_t, q_t, mu, is_feas, s.params)
            finite = jnp.isfinite(f_t) & jnp.isfinite(h_t) & jnp.isfinite(aux_t)

            # predicted reductions at step length alpha
            c_lin = c + alpha * Jdx if m else c
            pred_h = h_cur - prob.constraint_violation(c_lin, opts.progress_norm)
            pred_obj = alpha * (-gdx)  # evaluated at multiplier 1
            pred_aux = alpha * (-bdd_h)

            # acceptance: strategy-specific regular test; the deferred
            # `augment` flag means "filter add of the current point" for
            # filter methods and "h-type funnel width update" for the funnel
            merit_t = f_t + aux_t
            merit_pred = pred_obj + pred_aux
            merit_actual = _actual_reduction(filt, merit_cur, h_cur, merit_t,
                                             roundoff)
            switching = (merit_pred > 0.0) & flt.switching_condition(
                merit_pred, h_cur, opts.switching_delta,
                opts.switching_infeasibility_exponent)
            sufficient = flt.armijo_sufficient_decrease(
                merit_pred, merit_actual, opts.armijo_decrease_fraction,
                opts.armijo_tolerance)
            if gs == "waechter_filter_method":
                # WaechterFilterMethod.cpp:25-90
                filter_ok = _flt_acceptable(filt, h_t, merit_t)
                small_inf = h_cur <= 1e-4 * jnp.maximum(1.0, s.h_initial)
                f_type = small_inf & switching
                accept_h = (~f_type) & _flt_acceptable_wrt(
                    filt, h_cur, merit_cur, h_t, merit_t)
                accept_reg = filter_ok & ((f_type & sufficient) | accept_h)
                augment_t = accept_reg & (~switching | ~sufficient)
            elif gs == "fletcher_filter_method":
                # FletcherFilterMethod.cpp:15-66
                pair_ok = _flt_acceptable(filt, h_t, merit_t) & \
                    _flt_acceptable_wrt(filt, h_cur, merit_cur, h_t, merit_t)
                accept_reg = pair_ok & jnp.where(switching, sufficient, True)
                augment_t = accept_reg & ~switching
            elif gs == "funnel_method":
                dec = flt.funnel_is_acceptable(
                    s.gs_scalar, h_cur, merit_cur, h_t, merit_t,
                    merit_pred, opts, roundoff)
                accept_reg, augment_t = dec.accept, dec.h_type
            else:  # l1_merit (l1MeritFunction.cpp); sigma = 1 in this phase
                accept_reg = flt.l1_merit_acceptable(
                    h_cur, f_cur, aux_cur, h_t, f_t, aux_t,
                    pred_h, pred_obj, pred_aux, opts, roundoff)
                augment_t = jnp.asarray(False)
            accept_feas = flt.feasibility_armijo_acceptable(
                h_cur, aux_cur, h_t, aux_t, pred_h, pred_aux, opts)
            accept = jnp.where(is_feas, accept_feas, accept_reg) & finite
            # zero-primal-step acceptance over the RELAXED problem's primals
            # (x AND elastics): a pure dual-correction step — e.g. re-centering
            # an overshot elastic dual at the restoration subproblem optimum —
            # cannot improve any primal progress measure and must be accepted
            # to pick up the fresh multipliers
            # (ConstraintRelaxationStrategy.cpp:110-115); 1e-10 instead of
            # exact zero over the f32-factorization solve dust
            prim_step = dir_norm
            if m:
                prim_step = jnp.maximum(
                    prim_step, jnp.maximum(jnp.max(jnp.abs(dp), initial=0.0),
                                           jnp.max(jnp.abs(dq), initial=0.0)))
            accept = accept | (prim_step <= 1e-10)
            augment = augment_t & ~is_feas
            trial = (x_t, y_t, zl_t, zu_t, p_t, q_t, zp_t, zq_t, h_t, f_t, aux_t)
            return accept, trial, augment

        def ls_cond(carry):
            alpha, accepted, ls_failed, k, _, _ = carry
            return ~accepted & ~ls_failed & (k < opts.max_line_search_iterations)

        NC = max(1, int(opts.LS_batch_candidates))

        def ls_body(carry):
            alpha, accepted, ls_failed, k, trial, augment = carry
            acc, tr, aug = ls_trial(alpha)
            ls_failed = ~acc & (alpha < opts.LS_min_step_length)
            alpha_next = jnp.where(acc | ls_failed, alpha,
                                   alpha * opts.LS_backtracking_ratio)
            trial = jax.tree_util.tree_map(lambda a, b: jnp.where(acc, b, a), trial, tr)
            augment = jnp.where(acc, aug, augment)
            return alpha_next, acc, ls_failed, k + 1, trial, augment

        def ls_body_vectorized(carry):
            """Evaluate NC backtracking candidates {a, a*r, ..., a*r^(NC-1)}
            per loop trip and take the FIRST acceptable one — identical
            accept/fail decisions to the sequential body (acceptance of a
            trial depends only on the frozen current iterate and filter, so
            later candidates cannot be affected by earlier rejections), but
            the while loop usually runs once: the candidate axis is cheap
            data parallelism at these sizes while each while-loop trip
            costs serial latency."""
            alpha, accepted, ls_failed, k, trial, augment = carry
            ratios = opts.LS_backtracking_ratio ** jnp.arange(NC, dtype=alpha.dtype)
            alphas = alpha * ratios
            acc_v, tr_v, aug_v = jax.vmap(ls_trial)(alphas)
            small = alphas < opts.LS_min_step_length
            any_small = jnp.any(small)
            # sequential trying stops at the first too-small alpha
            J = jnp.where(any_small, jnp.argmax(small), NC - 1)
            iota_nc = jnp.arange(NC)
            acc_t = acc_v & (iota_nc <= J)
            any_acc = jnp.any(acc_t)
            idx = jnp.argmax(acc_t)     # first acceptable (0 if none; gated)

            def pick(tv):
                # tv[idx] without a gather: static-unrolled select chain
                out = tv[NC - 1]
                for j in range(NC - 2, -1, -1):
                    out = jnp.where(idx == j, tv[j], out)
                return out

            trial = jax.tree_util.tree_map(
                lambda a, tv: jnp.where(any_acc, pick(tv), a), trial, tr_v)
            augment = jnp.where(any_acc, pick(aug_v), augment)
            ls_failed = ~any_acc & any_small
            alpha_next = jnp.where(
                any_acc, pick(alphas),
                jnp.where(ls_failed, alpha,
                          alpha * opts.LS_backtracking_ratio ** NC))
            tried = jnp.where(any_acc, idx + 1, J + 1)
            return alpha_next, any_acc, ls_failed, k + tried, trial, augment

        trial0 = (s.x, y_a, zl_a, zu_a, s.p, s.q, s.zp, s.zq, h_cur, f_cur, aux_cur)
        carry0 = (jnp.asarray(1.0), jnp.asarray(False), jnp.asarray(False),
                  jnp.asarray(0), trial0, jnp.asarray(False))
        alpha, accepted, ls_failed, ls_iters, trial, augment = lax.while_loop(
            ls_cond, ls_body if NC == 1 else ls_body_vectorized, carry0)
        # a failed KKT solve invalidates the direction entirely
        accepted = accepted & ~kkt_failed
        ls_failed = ls_failed | kkt_failed | \
            ((~accepted) & ~kkt_failed & (ls_iters >= opts.max_line_search_iterations))

        (x_t, yv_t, zl_t, zu_t, p_t, q_t, zp_t, zq_t, h_t, f_t, aux_t) = trial

        # deferred globalization state update (once, not per LS trial)
        gs_scalar = s.gs_scalar
        if gs in ("waechter_filter_method", "fletcher_filter_method"):
            filt_aug = _flt_add(filt, h_cur, merit_cur)
            filt = jax.tree_util.tree_map(
                lambda a, b: jnp.where(augment & accepted, b, a), filt, filt_aug)
        elif gs == "funnel_method":
            w_new = flt.funnel_update_width(
                s.gs_scalar, h_cur, h_t, opts.funnel_beta, opts.funnel_kappa,
                opts.funnel_update_strategy)
            gs_scalar = jnp.where(augment & accepted, w_new, gs_scalar)
        else:  # l1_merit: track smallest known infeasibility (.cpp:39)
            gs_scalar = jnp.where(accepted & ~is_feas,
                                  jnp.minimum(gs_scalar, h_t), gs_scalar)

        # -- commit the trial iterate (or keep current on failure) ----------
        x_n = jnp.where(accepted, x_t, s.x)
        y_n = jnp.where(accepted & ~is_feas, yv_t, s.y)
        zl_n = jnp.where(accepted & ~is_feas, zl_t, s.zl)
        zu_n = jnp.where(accepted & ~is_feas, zu_t, s.zu)
        y_f_n = jnp.where(accepted & is_feas, yv_t, s.y_f)
        zl_f_n = jnp.where(accepted & is_feas, zl_t, s.zl_f)
        zu_f_n = jnp.where(accepted & is_feas, zu_t, s.zu_f)
        p_n = jnp.where(accepted, p_t, s.p)
        q_n = jnp.where(accepted, q_t, s.q)
        zp_n = jnp.where(accepted, zp_t, s.zp)
        zq_n = jnp.where(accepted, zq_t, s.zq)
        h_n = jnp.where(accepted, h_t, h_cur)
        f_n = jnp.where(accepted, f_t, f_cur)
        aux_n = jnp.where(accepted, aux_t, aux_cur)

        # -- phase transitions ----------------------------------------------
        # (a) restoration -> optimality: strategy-specific
        # is_infeasibility_sufficiently_reduced (GlobalizationStrategy.hpp:27)
        merit_n = f_n + aux_n
        if gs == "waechter_filter_method":
            # WaechterFilterMethod.cpp:85-88
            inf_reduced = \
                (h_n <= opts.filter_sufficient_infeasibility_decrease_factor * s.h_ref) & \
                _flt_acceptable(filt, h_n, merit_n)
        elif gs == "fletcher_filter_method":
            # FletcherFilterMethod.cpp:66-69: beat the filter's smallest h
            smallest_h = jnp.min(filt.h, initial=jnp.inf)
            inf_reduced = h_n < opts.filter_beta * smallest_h
        elif gs == "funnel_method":
            # FunnelMethod.cpp:97-100: in funnel + sufficient decrease
            inf_reduced = (h_n <= gs_scalar) & \
                (h_n <= opts.funnel_beta * s.h_ref)
        else:  # l1_merit (.cpp:48-52): beat best-known infeasibility
            inf_reduced = h_n <= 0.9 * gs_scalar
        # additionally exit restoration when feasible to tolerance: an h=0
        # filter entry makes the beta tests above unsatisfiable (see
        # FeasibilityRestorationSQP.can_switch_back)
        inf_reduced = inf_reduced | (h_n <= opts.tolerance)
        back_ok = accepted & is_feas & inf_reduced
        # (b) optimality -> restoration: LS failure or unstable KKT
        to_feas = ls_failed & ~is_feas & ws.constrained
        hard_fail = ls_failed & (is_feas | (not ws.constrained))

        # apply (a): notify_switch_to_optimality — filter methods add the
        # current progress (FilterMethod.cpp:31-39); funnel shrinks its width
        # (Funnel::update_restoration); merit does nothing. Then restore mu.
        if gs in ("waechter_filter_method", "fletcher_filter_method"):
            filt_a = _flt_add(filt, h_cur, merit_cur)
            filt = jax.tree_util.tree_map(
                lambda a, b: jnp.where(back_ok, b, a), filt, filt_a)
        elif gs == "funnel_method":
            w_rest = opts.funnel_kappa * gs_scalar \
                + (1.0 - opts.funnel_kappa) * h_cur
            gs_scalar = jnp.where(back_ok, w_rest, gs_scalar)
        phase_n = jnp.where(back_ok, 0, s.phase)
        mu_n = jnp.where(back_ok, s.mu_backup, mu)

        # multiplier safeguard on restoration exit: a singular KKT system
        # (rank-deficient Jacobian + tiny dual regularization eps) can emit
        # enormous dual steps that poison the Lagrangian Hessian for the rest
        # of the run (observed: hs061 from x0=0).  The reference sketches an
        # LSQ refresh here but leaves it commented out
        # (PrimalDualInteriorPointMethod.cpp:183-191); we reset oversized
        # multipliers instead — zero extra factorizations, and the next
        # Newton solve re-estimates them from a sane Hessian.
        if m:
            y_over = jnp.max(jnp.abs(y_n), initial=0.0) > \
                opts.least_square_multiplier_max_norm
            y_n = jnp.where(back_ok & y_over, jnp.zeros_like(y_n), y_n)

        # apply (b): enter restoration at the (unchanged) current iterate
        mu_enter = jnp.maximum(mu, s.primal_feas)
        phase_n = jnp.where(to_feas, 1, phase_n)
        mu_backup_n = jnp.where(to_feas, mu, s.mu_backup)
        mu_n = jnp.where(to_feas, mu_enter, mu_n)
        x_ref_n = jnp.where(to_feas, x_n, s.x_ref)
        h_ref_n = jnp.where(to_feas, h_n, s.h_ref)
        if m:
            # elastic init p = q = mu/rho, duals = rho — matches the
            # reference's ACTUAL behavior (constraint value hardwired to 0
            # behind a TODO, PrimalDualInteriorPointMethod.cpp:211-214).
            # The "true" IPOPT formula with real constraint values
            # (q - p = c) was implemented and A/B-swept in round 2: it
            # trades hs013/hs116 for hs061 and the l1_merit-IPM combination
            # (the dual-consistent variants poison the first restoration
            # Hessian; the primal-consistent ones take an aggressive first
            # step the line search rejects on rank-deficient Jacobians).
            # Net sweep effect negative (98 vs 99 of 100) -> keep the
            # dual-consistent gentle-crawl init.
            p_init = jnp.full((m,), 1.0) * (mu_enter / nu)
            p_n = jnp.where(to_feas, p_init, p_n)
            q_n = jnp.where(to_feas, p_init, q_n)
            zp_n = jnp.where(to_feas, jnp.full((m,), nu), zp_n)
            zq_n = jnp.where(to_feas, jnp.full((m,), nu), zq_n)
        zl_f_n = jnp.where(to_feas, jnp.where(hlb, opts.barrier_default_multiplier, 0.0), zl_f_n)
        zu_f_n = jnp.where(to_feas, jnp.where(hub, -opts.barrier_default_multiplier, 0.0), zu_f_n)
        # notify_switch_to_feasibility: filter methods record the current
        # point; funnel and merit do nothing
        if gs in ("waechter_filter_method", "fletcher_filter_method"):
            filt_b = _flt_add(filt, h_cur, merit_cur)
            filt = jax.tree_util.tree_map(
                lambda a, b: jnp.where(to_feas, b, a), filt, filt_b)

        changed_next = back_ok | to_feas
        sigma_next = jnp.where(phase_n == 1, 0.0, 1.0)
        # On an optimality-phase LS failure the reference checks termination
        # BEFORE switching to restoration (BacktrackingLineSearch.cpp:91-99:
        # terminate_with_small_step_length precedes switch_to_feasibility
        # _problem), i.e. with the objective multiplier still 1 at the
        # (unchanged) iterate.  Checking with the new phase's sigma=0 instead
        # resets the loose-tolerance consecutive counter every time the
        # solver bounces through restoration at a near-KKT point — hs009
        # 2-cycles at its optimum for 2000 iterations (round-5 recorded
        # regression) because each restoration entry wiped the count the
        # reference would have kept.
        sigma_check = jnp.where(to_feas, 1.0, sigma_next)

        # -- residuals at the new iterate, with the new phase's multiplier --
        res = _residuals(prob, ws, opts, x_n, y_n, zl_n, zu_n,
                         y_f_n, zl_f_n, zu_f_n, p_n, q_n, zp_n, zq_n,
                         sigma_check, nu, s.params)

        # -- termination -----------------------------------------------------
        kkt_tight, infeas_tight = _first_order_status(
            ws, opts, res, sigma_check, y_f_n, zl_f_n, zu_f_n, opts.tolerance)
        kkt_loose, infeas_loose = _first_order_status(
            ws, opts, res, sigma_check, y_f_n, zl_f_n, zu_f_n, opts.loose_tolerance)

        status = jnp.asarray(RUNNING)
        unbounded = f_n < opts.unbounded_objective_threshold
        loose_any = (kkt_loose | infeas_loose) & (opts.loose_tolerance > opts.tolerance)
        loose_count = jnp.where(loose_any, s.loose_count + 1, 0)
        loose_hit = loose_count >= opts.loose_tolerance_consecutive_iteration_threshold

        status = jnp.where(loose_hit & kkt_loose, ALMOST_OPTIMAL, status)
        status = jnp.where(loose_hit & infeas_loose & ~kkt_loose, INFEASIBLE_STATIONARY, status)
        status = jnp.where(infeas_tight, INFEASIBLE_STATIONARY, status)
        status = jnp.where(kkt_tight, OPTIMAL, status)
        status = jnp.where(unbounded, UNBOUNDED, status)
        status = jnp.where(hard_fail, ALGORITHMIC_ERROR, status)
        iteration = s.iteration + 1
        status = jnp.where((status == RUNNING) & (iteration >= opts.max_iterations),
                           MAX_ITERATIONS, status)

        return IPMState(
            x=x_n, y=y_n, zl=zl_n, zu=zu_n,
            y_f=y_f_n, zl_f=zl_f_n, zu_f=zu_f_n,
            p=p_n, q=q_n, zp=zp_n, zq=zq_n,
            mu=mu_n, mu_backup=mu_backup_n, prev_delta=reg.prev_delta,
            phase=phase_n,
            skip_mu_update=to_feas,
            subproblem_changed=changed_next,
            filter=filt, gs_scalar=gs_scalar,
            x_ref=x_ref_n, h_ref=h_ref_n, h_initial=s.h_initial,
            h_cur=h_n, f_cur=f_n, aux_cur=aux_n,
            stat=res["stat"], stat_scaling=res["stat_scaling"],
            compl=res["compl"], compl_scaling=res["compl_scaling"],
            primal_feas=res["primal_feas"],
            feas_stat=res["feas_stat"], feas_stat_scaling=res["feas_stat_scaling"],
            feas_compl=res["feas_compl"], feas_compl_scaling=res["feas_compl_scaling"],
            loose_count=loose_count, iteration=iteration, status=status,
            step_norm=alpha * dir_norm,
            num_subproblems=s.num_subproblems + 1,
            num_factorizations=s.num_factorizations + reg.attempts,
            num_obj_evals=s.num_obj_evals + ls_iters + 1,
            num_con_evals=s.num_con_evals + ls_iters + 1,
            params=s.params,
        )

    return step


def make_initial_state(prob: NLP, ws: IPMWorkspace, opts: Options,
                       x0=None, params=None) -> IPMState:
    """generate_initial_iterate (PrimalDualInteriorPointMethod.cpp:64-108):
    interior push of primals, slack init from c(x), default bound duals,
    least-square constraint multipliers."""
    n, m = ws.n, ws.m
    lbj, ubj = jnp.asarray(ws.lb), jnp.asarray(ws.ub)
    hlb, hub = jnp.asarray(ws.has_lb), jnp.asarray(ws.has_ub)
    k1 = opts.barrier_push_variable_to_interior_k1
    k2 = opts.barrier_push_variable_to_interior_k2

    x0 = jnp.asarray(prob.x0) if x0 is None else jnp.asarray(x0)
    x = bar.push_to_interior(x0, lbj, ubj, k1, k2)

    # slacks <- interior push of the model constraint values c_i(x)
    if prob.slack_of_constraint is not None and m:
        cvals = prob.constraints(x, params)
        for ci, si in enumerate(prob.slack_of_constraint):
            if si >= 0:
                raw = cvals[ci] + x[si]   # c_tilde + s == c_model - shift
                x = x.at[si].set(bar.push_to_interior(raw, lbj[si], ubj[si], k1, k2))

    zl = jnp.where(hlb, opts.barrier_default_multiplier, 0.0)
    zu = jnp.where(hub, -opts.barrier_default_multiplier, 0.0)

    # least-square multipliers (Preprocessing.cpp:17-75):
    # solve [I J^T; J 0][r; y] = [g - zl - zu; 0], keep y if ||y||inf <= 1e3
    y = jnp.zeros((m,))
    if m:
        g = prob.objective_gradient(x, params)
        J = prob.constraint_jacobian(x, params)
        K = jnp.block([[jnp.eye(n), J.T], [J, jnp.zeros((m, m))]])
        rhs = jnp.concatenate([g - zl - zu, jnp.zeros((m,))])
        # factor+solve in the configured KKT dtype: the LSQ multipliers are
        # an initialization heuristic (discarded when ||y||inf > 1e3), so
        # f32 precision is ample under kkt_dtype=float32
        ls_dt = jnp.float32 if opts.kkt_dtype == "float32" else K.dtype
        fac = pick_factorizer(n + m, opts.ldlt_block_size)(K.astype(ls_dt))
        sol = ldlt_solve(fac, rhs.astype(ls_dt)).astype(rhs.dtype)
        y_try = sol[n:]
        ok = (jnp.max(jnp.abs(y_try), initial=0.0) <= opts.least_square_multiplier_max_norm) \
            & jnp.all(jnp.isfinite(y_try)) & (fac.num_zero == 0)
        y = jnp.where(ok, y_try, jnp.zeros((m,)))

    mu0 = jnp.asarray(opts.barrier_initial_parameter)
    ones_m = jnp.ones((m,))
    res = _residuals(prob, ws, opts, x, y, zl, zu,
                     jnp.zeros((m,)), jnp.zeros((n,)), jnp.zeros((n,)),
                     ones_m, ones_m, ones_m, ones_m,
                     jnp.asarray(1.0), opts.l1_constraint_violation_coefficient,
                     params)

    c = prob.constraints(x, params)
    h0 = prob.constraint_violation(c, opts.progress_norm)
    f0 = prob.objective(x, params)
    aux0 = bar.barrier_auxiliary_measure(x, lbj, ubj, hlb, hub, mu0,
                                         opts.barrier_damping_factor)

    filt = flt.filter_init(opts.filter_capacity)
    # FilterMethod::initialize: ub = max(filter_ubd, filter_fact * h0)
    filt = flt.filter_set_ub(filt, jnp.maximum(opts.filter_ubd, opts.filter_fact * h0))

    # strategy scalar: funnel width (FunnelMethod::initialize) or the merit
    # function's smallest known infeasibility (starts at +inf)
    if opts.globalization_strategy == "funnel_method":
        gs_scalar = jnp.maximum(opts.funnel_ubd, opts.funnel_fact * h0)
    elif opts.globalization_strategy == "l1_merit":
        gs_scalar = jnp.asarray(jnp.inf)
    else:
        gs_scalar = jnp.asarray(0.0)

    return IPMState(
        x=x, y=y, zl=zl, zu=zu,
        y_f=jnp.zeros((m,)), zl_f=jnp.zeros((n,)), zu_f=jnp.zeros((n,)),
        p=ones_m, q=ones_m, zp=ones_m, zq=ones_m,
        mu=mu0, mu_backup=mu0, prev_delta=jnp.asarray(0.0),
        phase=jnp.asarray(0),
        skip_mu_update=jnp.asarray(False), subproblem_changed=jnp.asarray(False),
        filter=filt, gs_scalar=gs_scalar, x_ref=x, h_ref=h0, h_initial=h0,
        h_cur=h0, f_cur=f0, aux_cur=aux0,
        stat=res["stat"], stat_scaling=res["stat_scaling"],
        compl=res["compl"], compl_scaling=res["compl_scaling"],
        primal_feas=res["primal_feas"],
        feas_stat=res["feas_stat"], feas_stat_scaling=res["feas_stat_scaling"],
        feas_compl=res["feas_compl"], feas_compl_scaling=res["feas_compl_scaling"],
        loose_count=jnp.asarray(0), iteration=jnp.asarray(0),
        status=jnp.asarray(RUNNING), step_norm=jnp.asarray(0.0),
        num_subproblems=jnp.asarray(0), num_factorizations=jnp.asarray(0),
        num_obj_evals=jnp.asarray(0), num_con_evals=jnp.asarray(0),
        params=params,
    )


@dataclass
class Result:
    """Reference Result (optimization/Result.hpp:11-29) analogue."""
    status: str
    x: np.ndarray
    y: np.ndarray
    zl: np.ndarray
    zu: np.ndarray
    objective: float
    iterations: int
    primal_feasibility: float
    stationarity: float
    complementarity: float
    cpu_time: float
    num_subproblems_solved: int
    num_factorizations: int
    num_objective_evaluations: int
    num_constraint_evaluations: int
    # per-iteration IPMState trace, populated by solve_ipm(history=True)
    history: list | None = None

    @property
    def success(self) -> bool:
        return self.status in ("optimal", "almost_optimal")

    def __repr__(self):
        return (f"Result(status={self.status}, f={self.objective:.8g}, "
                f"iters={self.iterations}, feas={self.primal_feasibility:.2e}, "
                f"stat={self.stationarity:.2e}, time={self.cpu_time:.3f}s)")


def canonicalize_state(state):
    """Force strong dtypes on every leaf: weakly-typed scalars from
    make_initial_state would otherwise trigger a re-jit on the second step
    call (the step's outputs are strongly typed)."""
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, dtype=jnp.asarray(a).dtype), state)


def build_ipm(nlp: NLP, opts: Options, mesh=None):
    """Compile-time setup: scaling, reformulation, workspace, jitted runner.

    With `ldlt_backend="distributed"` and a mesh, the KKT factorization and
    triangular solves are sharded over `mesh` (parallel/dist_ldlt.py) — the
    TPU analogue of the reference's MPI-parallel MUMPS inside a single
    solve (SURVEY.md §5.8)."""
    scaled = transforms.scale_model(nlp, opts.function_scaling_threshold) \
        if opts.scale_functions else nlp
    prob = transforms.reformulate_for_interior_point(scaled, opts.tolerance)
    ws = _build_workspace(prob)
    kkt_backend = None
    if opts.ldlt_backend == "distributed":
        if mesh is None:
            raise ValueError("ldlt_backend='distributed' requires a mesh")
        from uno_tpu.parallel.dist_ldlt import make_dist_kkt_backend
        kkt_backend = make_dist_kkt_backend(
            mesh, prob.n + ws.m, axis=mesh.axis_names[0],
            block=opts.dist_ldlt_block)
    elif opts.kkt_formulation == "lifted":
        from uno_tpu.linalg.condensed import make_lifted_kkt_backend
        kkt_backend = make_lifted_kkt_backend(
            prob.n, ws.m, tau=opts.lifted_kkt_relaxation)
    elif opts.kkt_formulation == "sparse" or (
            opts.kkt_formulation == "auto" and opts.auto_permute
            and prob.structure is None):
        # general static-sparsity supernodal LDL^T (linalg/sparse_ldlt.py):
        # the irregular-coupling class RCM/banded detection declines —
        # fill-reducing ordering + static supernodal schedule, the
        # MA57-symbolic-analysis equivalent (MA57Solver.cpp:40-90).
        # try_make... returns None (-> dense) when the probed pattern is
        # genuinely dense or the padded schedule loses to the dense path;
        # kkt_formulation="sparse" forces it.
        from uno_tpu.linalg.sparse_kkt import try_make_sparse_kkt_backend
        kkt_backend = try_make_sparse_kkt_backend(
            prob, ws.m, opts, force=(opts.kkt_formulation == "sparse"))
    elif opts.kkt_formulation == "banded" or (
            opts.kkt_formulation == "auto" and prob.structure is not None
            and (ws.m == 0 or prob.structure.jac_starts is not None)):
        # 'auto' only routes here when the declaration is complete: a
        # constrained model declaring hess_bandwidth but no jac_starts
        # falls back to the dense augmented backend (explicit 'banded'
        # still raises below — the user asked for it by name)
        if prob.structure is None:
            raise ValueError("kkt_formulation='banded' requires the model "
                             "to declare an NLPStructure")
        if ws.m and prob.structure.jac_starts is None:
            raise ValueError("kkt_formulation='banded' on a constrained "
                             "model requires NLPStructure.jac_starts")
        from uno_tpu.linalg.banded_kkt import make_banded_kkt_backend
        slack_cols = prob.slack_of_constraint \
            if prob.slack_of_constraint is not None \
            else np.full(ws.m, -1, dtype=np.int64)
        n0 = prob.n - int(np.sum(slack_cols >= 0))
        kkt_backend = make_banded_kkt_backend(
            prob.n, n0, ws.m,
            prob.structure.jac_starts if ws.m else np.zeros(0, dtype=np.int64),
            slack_cols, prob.structure.hess_bandwidth,
            prob.structure.jac_width, tau=opts.lifted_kkt_relaxation)
    step = make_ipm_step(prob, ws, opts, kkt_backend=kkt_backend)
    # in-loop wall-clock limit (reference checks the Timer every outer
    # iteration, Uno.cpp:61-78) through a pure_callback clock poll; with
    # the default time_limit=inf the HLO is unchanged (utils/timer.py)
    from uno_tpu.utils.timer import make_timed_runner
    step, run = make_timed_runner(step, opts.time_limit, RUNNING, TIME_LIMIT)
    return prob, ws, step, run


def map_fixed_bound_duals(nlp_orig, y_full_scaled, zl, zu):
    """FixedBoundsConstraintsModel::postprocess_solution parity
    (FixedBoundsConstraintsModel.cpp:168-181): the multipliers of the
    equality rows appended for fixed variables (l == u) move back to the
    BOUND duals of those variables — positive to zl, negative to zu.
    y_full_scaled is the full reformulated-problem multiplier vector in
    original-model scaling; rows nlp_orig.m.. are the fixed rows in
    np.nonzero(fixed_variables) order (transforms.fixed_bounds_to_constraints)."""
    fixed_idx = np.nonzero(nlp_orig.fixed_variables)[0]
    zl = np.asarray(zl).copy()
    zu = np.asarray(zu).copy()
    for k, vi in enumerate(fixed_idx):
        row = nlp_orig.m + k
        if row < y_full_scaled.shape[0]:
            ym = float(y_full_scaled[row])
            if ym > 0.0:
                zl[vi] = ym
            else:
                zu[vi] = ym
    return zl, zu


def solve_ipm(nlp: NLP, opts: Options, callbacks=None, history=False) -> Result:
    t0 = time.time()
    prob, ws, step, run = build_ipm(nlp, opts)
    # the instance's params ride in the state as an argument, so every
    # instance of one parametric NLP compiles to the same (cached) program
    state0 = canonicalize_state(make_initial_state(prob, ws, opts,
                                                   params=prob.params))

    from uno_tpu.utils.logger import Logger, LEVELS
    verbose = LEVELS.index(opts.logger) >= LEVELS.index("INFO")
    timed = np.isfinite(opts.time_limit)
    if callbacks is not None or history or verbose:
        # step-by-step driver: one jitted outer iteration per Python loop
        # pass, enabling the reference-style statistics table (Uno.cpp:115-127)
        # and per-iterate user callbacks
        from uno_tpu.utils.statistics import Statistics
        stats = Statistics()
        for name, w, order in (("iter", Statistics.INT_WIDTH, 1),
                               ("step norm", Statistics.DOUBLE_WIDTH - 5, 31),
                               ("objective", Statistics.DOUBLE_WIDTH - 5, 100),
                               ("primal feas", Statistics.DOUBLE_WIDTH - 4, 101),
                               ("stationarity", Statistics.DOUBLE_WIDTH - 3, 104),
                               ("complementarity", Statistics.DOUBLE_WIDTH, 105),
                               ("barrier", Statistics.DOUBLE_WIDTH - 5, 8),
                               ("phase", Statistics.INT_WIDTH, 20)):
            stats.add_column(name, w, order)
        stepj = jax.jit(step)
        s = state0
        trace = [s] if history else None
        while int(s.status) == RUNNING:
            s = stepj(s)
            if history:
                trace.append(s)
            if verbose:
                stats.start_new_line()
                stats.set("iter", int(s.iteration))
                stats.set("step norm", float(s.step_norm))
                stats.set("objective", float(s.f_cur) / prob.f_scale)
                stats.set("primal feas", float(s.primal_feas))
                stats.set("stationarity", float(s.stat / s.stat_scaling))
                stats.set("complementarity", float(s.compl / s.compl_scaling))
                stats.set("barrier", float(s.mu))
                stats.set("phase", "FEAS" if int(s.phase) else "OPT")
                stats.print_current_line()
            if callbacks is not None and hasattr(callbacks, "notify_new_primals"):
                callbacks.notify_new_primals(np.asarray(s.x)[: nlp.n])
            if callbacks is not None and hasattr(callbacks, "notify_new_multipliers"):
                # constraint duals in original-model scaling (reference calls
                # notify_new_multipliers alongside notify_new_primals per
                # accepted iterate, Uno.cpp:73-74)
                cs = prob.c_scale if prob.c_scale is not None else np.ones(max(ws.m, 1))
                callbacks.notify_new_multipliers(
                    np.asarray(s.y)[: nlp.m] * cs[: nlp.m] / prob.f_scale
                    if nlp.m else np.zeros(0))
            # wall-clock termination (reference Timer/time_limit, Uno.cpp:61);
            # the fused path enforces the same limit in-loop via
            # utils/timer.wrap_step_with_time_limit
            if timed and time.time() - t0 > opts.time_limit \
                    and int(s.status) == RUNNING:
                s = s._replace(status=jnp.asarray(TIME_LIMIT))
                break
        if verbose:
            stats.print_footer()
        final = s
    else:
        trace = None
        final = jax.block_until_ready(run(state0))
    elapsed = time.time() - t0

    x_full = np.asarray(final.x)
    x_orig = x_full[: nlp.n]
    f_scale = prob.f_scale
    c_scale = prob.c_scale if prob.c_scale is not None else np.ones(max(ws.m, 1))
    y_full = np.asarray(final.y) * c_scale[: np.asarray(final.y).shape[0]] / f_scale
    y = y_full[: nlp.m] if nlp.m else np.zeros(0)
    zl_out, zu_out = map_fixed_bound_duals(
        nlp, y_full, np.asarray(final.zl)[: nlp.n] / f_scale,
        np.asarray(final.zu)[: nlp.n] / f_scale)
    f_val = float(nlp.objective(jnp.asarray(x_orig)))
    if callbacks is not None and hasattr(callbacks, "notify_acceptable_iterate"):
        callbacks.notify_acceptable_iterate(x_orig, y, 1.0)
    return Result(
        status=STATUS_NAMES[int(final.status)],
        x=x_orig, y=y,
        zl=zl_out, zu=zu_out,
        objective=f_val,
        iterations=int(final.iteration),
        primal_feasibility=float(final.primal_feas),
        stationarity=float(final.stat / final.stat_scaling),
        complementarity=float(final.compl / final.compl_scaling),
        cpu_time=elapsed,
        num_subproblems_solved=int(final.num_subproblems),
        num_factorizations=int(final.num_factorizations),
        num_objective_evaluations=int(final.num_obj_evals),
        num_constraint_evaluations=int(final.num_con_evals),
        history=trace,
    )
