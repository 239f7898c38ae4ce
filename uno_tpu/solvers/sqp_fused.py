"""Fused SQP/SLP path: the TR + filter/funnel + feasibility-restoration
family as a single `lax.while_loop` state machine — jittable and vmappable,
like solvers/ipm.py (the host-orchestrated SQP path left
filtersqp/funnelsqp/filterslp off the batch axis).

Covers the reference semantics of:
  TrustRegionStrategy          (TrustRegionStrategy.cpp:40-190)
  FeasibilityRestoration       (FeasibilityRestoration.cpp:78-207)
  InequalityConstrainedMethod  (InequalityConstrainedMethod.cpp:26-98)
  FletcherFilterMethod / WaechterFilterMethod / FunnelMethod / l1MeritFunction
  ConstraintRelaxationStrategy residuals & first-order tests (.cpp:91-258)

Control-flow mapping (same discipline as solvers/ipm.py): the reference's
nested outer-iteration/TR-inner-loop becomes a FLAT loop of TR *attempts* —
each attempt solves one QP, builds one trial, and either commits it (radius
may grow) or shrinks the radius; phase switches (OPT <-> FEAS) take effect
on the next attempt (documented deviation, <= 1 extra cheap attempt per
switch, same convention as the IPM's phase machine).  `iteration` counts
accepted steps (the reference's outer iterations); `attempts` bounds the
loop.

QP subproblems use the convexifying interior-point kernel (solvers/qp.py)
with BQPD-parity dual purification — the BQPD replacement (documented
deviation: local steps of nonconvex QPs may differ).  byrd (l1 relaxation
steering + line search) is ALSO fused here (`make_byrd_step` /
`build_byrd_fused`, routed by default from api.py); the host drivers in
solvers/sqp.py remain available via `Options.sqp_driver="host"`.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from uno_tpu.ingredients import filters as flt
from uno_tpu.model import transforms
from uno_tpu.model.nlp import NLP, vector_norm
from uno_tpu.options import Options
from uno_tpu.solvers.ipm import (ALGORITHMIC_ERROR, ALMOST_OPTIMAL,
                                 INFEASIBLE_STATIONARY, LARGE_BOUND,
                                 MAX_ITERATIONS, OPTIMAL, RUNNING, UNBOUNDED,
                                 Result, _mtv, _mv, canonicalize_state)
from uno_tpu.solvers.qp import (QP_ERROR, QP_INFEASIBLE, QP_OPTIMAL,
                                QP_UNBOUNDED, QPStructure, build_qp_solver)

# extra terminal statuses of the TR mechanism (TrustRegionStrategy.cpp:150-166)
FEASIBLE_SMALL_STEP = 8
INFEASIBLE_SMALL_STEP = 9

SQP_STATUS_NAMES = {
    RUNNING: "running", OPTIMAL: "optimal", ALMOST_OPTIMAL: "almost_optimal",
    INFEASIBLE_STATIONARY: "infeasible_stationary_point",
    UNBOUNDED: "unbounded", ALGORITHMIC_ERROR: "algorithmic_error",
    MAX_ITERATIONS: "iteration_limit", 7: "time_limit",
    FEASIBLE_SMALL_STEP: "feasible_small_step",
    INFEASIBLE_SMALL_STEP: "infeasible_small_step",
}


class SQPFState(NamedTuple):
    # primal-dual iterate
    x: jnp.ndarray        # (n,)
    ev: jnp.ndarray       # (n_el,) elastic values (FEAS phase)
    y: jnp.ndarray        # (m,) optimality multipliers
    zl: jnp.ndarray       # (n,)
    zu: jnp.ndarray
    y_f: jnp.ndarray      # feasibility multipliers
    zl_f: jnp.ndarray
    zu_f: jnp.ndarray
    zl_el: jnp.ndarray    # (n_el,)
    # cached objective/constraints at x (refreshed on acceptance)
    f_cur: jnp.ndarray
    c_cur: jnp.ndarray    # (m,)
    # mechanism / strategy state
    radius: jnp.ndarray
    phase: jnp.ndarray        # 0 = OPT, 1 = FEAS
    filter: flt.FilterState
    gs_scalar: jnp.ndarray    # funnel width | merit smallest-known h
    h_initial: jnp.ndarray
    h_ref: jnp.ndarray        # restoration reference infeasibility
    # progress / termination
    status: jnp.ndarray
    iteration: jnp.ndarray    # accepted steps (reference outer iterations)
    attempts: jnp.ndarray
    loose_count: jnp.ndarray
    creep_count: jnp.ndarray  # consecutive accepted feasible roundoff-steps
    # reporting residuals (at the current iterate)
    stat: jnp.ndarray
    stat_scaling: jnp.ndarray
    compl: jnp.ndarray
    compl_scaling: jnp.ndarray
    primal_feas: jnp.ndarray
    # counters
    num_qp: jnp.ndarray
    num_obj_evals: jnp.ndarray
    num_con_evals: jnp.ndarray
    num_hess: jnp.ndarray
    params: object = None


class FusedSQPWorkspace(NamedTuple):
    n: int
    m: int
    n_el: int
    xl: np.ndarray
    xu: np.ndarray
    has_xl: np.ndarray
    has_xu: np.ndarray
    cl: np.ndarray
    cu: np.ndarray
    has_cl: np.ndarray
    has_cu: np.ndarray
    is_eq: np.ndarray
    E: np.ndarray          # (m, n_el) elastic signs
    nb: int                # number of finite variable bounds


def _build_workspace(nlp: NLP) -> FusedSQPWorkspace:
    n, m = nlp.n, nlp.m
    xl = np.asarray(nlp.x_lb, dtype=float)
    xu = np.asarray(nlp.x_ub, dtype=float)
    has_xl = np.asarray(nlp.has_x_lb)
    has_xu = np.asarray(nlp.has_x_ub)
    cl = np.asarray(nlp.c_lb, dtype=float)
    cu = np.asarray(nlp.c_ub, dtype=float)
    has_cl = np.isfinite(cl)
    has_cu = np.isfinite(cu)
    is_eq = has_cl & has_cu & (cl == cu)
    ineq_idx = np.nonzero(~is_eq)[0]
    eq_idx = np.nonzero(is_eq)[0]
    n_el = len(ineq_idx) + 2 * len(eq_idx)
    E = np.zeros((m, n_el))
    col = 0
    for j in ineq_idx:
        E[j, col] = 1.0 if has_cl[j] else -1.0
        col += 1
    for j in eq_idx:
        E[j, col] = 1.0
        E[j, col + 1] = -1.0
        col += 2
    nb = int(has_xl.sum() + has_xu.sum())
    return FusedSQPWorkspace(n=n, m=m, n_el=n_el, xl=xl, xu=xu,
                             has_xl=has_xl, has_xu=has_xu, cl=cl, cu=cu,
                             has_cl=has_cl, has_cu=has_cu, is_eq=is_eq, E=E,
                             nb=nb)


def make_sqp_step(nlp: NLP, ws: FusedSQPWorkspace, opts: Options):
    """One TR attempt; returns a pure state -> state function."""
    if opts.globalization_mechanism != "TR":
        raise ValueError("the fused SQP driver implements the TR mechanism; "
                         "use sqp_driver='host' for LS")
    n, m, n_el = ws.n, ws.m, ws.n_el
    xl, xu = jnp.asarray(ws.xl), jnp.asarray(ws.xu)
    has_xl, has_xu = jnp.asarray(ws.has_xl), jnp.asarray(ws.has_xu)
    cl, cu = jnp.asarray(ws.cl), jnp.asarray(ws.cu)
    has_cl, has_cu = jnp.asarray(ws.has_cl), jnp.asarray(ws.has_cu)
    is_eq = jnp.asarray(ws.is_eq)
    E = jnp.asarray(ws.E)
    # elastic stationarity signs: column col of E has a single +-1 at its row
    el_sign_y = jnp.asarray(ws.E.T)  # (n_el, m); el_stat = nu - E^T y_f - zl_el
    nu = opts.l1_constraint_violation_coefficient
    tol = opts.tolerance
    thr = opts.residual_scaling_threshold
    roundoff = (10.0 * np.finfo(np.float64).eps
                if opts.protect_actual_reduction_against_roundoff else 0.0)

    zero_hessian = opts.hessian_model == "zero"
    identity_hessian = opts.hessian_model == "identity"

    def hessian(x, y, sigma, params):
        if zero_hessian:
            return jnp.zeros((n, n))
        if identity_hessian:
            return jnp.eye(n)
        return nlp.lagrangian_hessian(x, y, sigma, params=params)

    def violation(c, kind):
        viol = jnp.where(has_cl, jnp.maximum(cl - c, 0.0), 0.0) + \
            jnp.where(has_cu, jnp.maximum(c - cu, 0.0), 0.0)
        return vector_norm(viol, kind)

    # ---- QP solvers (static structures) -----------------------------------
    struct_opt = QPStructure(
        n=n, m=m, has_dl=np.ones(n, bool), has_du=np.ones(n, bool),
        is_eq=ws.is_eq, has_rl=ws.has_cl, has_ru=ws.has_cu)
    struct_rel = QPStructure(
        n=n + n_el, m=m,
        has_dl=np.ones(n + n_el, bool),
        has_du=np.concatenate([np.ones(n, bool), np.zeros(n_el, bool)]),
        is_eq=ws.is_eq, has_rl=ws.has_cl, has_ru=ws.has_cu)
    solve_qp_opt = build_qp_solver(struct_opt, opts, tol=opts.tolerance * 1e-2)
    solve_qp_rel = build_qp_solver(struct_rel, opts, tol=opts.tolerance * 1e-2)

    # ---- globalization strategy dispatch (static) --------------------------
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

    def _actual_reduction(f, merit_cur, h_cur, merit_tri):
        if nonmono:
            return flt.nm_actual_objective_reduction(
                f, merit_cur, h_cur, merit_tri, opts.filter_gamma, max_dom) \
                + roundoff * jnp.abs(merit_cur)
        return merit_cur - merit_tri + roundoff * jnp.abs(merit_cur)

    # ---- residuals (ConstraintRelaxationStrategy.cpp:128-195) -------------
    rn = opts.residual_norm

    def residuals(x, ev, g, J, y, zl, zu, y_f, zl_f, zu_f, zl_el, sigma):
        grad_lag = sigma * g - (_mtv(J, y) if m else 0.0) - zl - zu
        stat = vector_norm(grad_lag, rn)
        bc = jnp.where(has_xl & (zl > 0), zl * (x - jnp.where(has_xl, xl, 0.0)), 0.0) \
            + jnp.where(has_xu & (zu < 0), zu * (x - jnp.where(has_xu, xu, 0.0)), 0.0)

        def con_compl(c, yv):
            lo = jnp.where(has_cl, cl, 0.0)
            hi = jnp.where(has_cu, cu, 0.0)
            out = jnp.where(~is_eq & (yv > 0) & has_cl, yv * (c - lo), 0.0)
            out = jnp.where(~is_eq & (yv < 0) & has_cu, yv * (c - hi), out)
            return out

        return stat, bc, con_compl

    def scalings(y, zl, zu):
        total = ws.nb + m
        ssc = jnp.maximum(1.0, (jnp.sum(jnp.abs(y)) + jnp.sum(jnp.abs(zl))
                                + jnp.sum(jnp.abs(zu))) / (thr * max(total, 1))) \
            if total else jnp.asarray(1.0)
        csc = jnp.maximum(1.0, (jnp.sum(jnp.abs(zl)) + jnp.sum(jnp.abs(zu)))
                          / (thr * max(ws.nb, 1))) if ws.nb else jnp.asarray(1.0)
        return ssc, csc

    act = opts.TR_activity_tolerance

    def step(s: SQPFState) -> SQPFState:
        params = s.params
        x = s.x
        f = s.f_cur
        c = s.c_cur
        g = nlp.objective_gradient(x, params=params)
        J = nlp.constraint_jacobian(x, params=params) if m else jnp.zeros((0, n))
        is_feas = s.phase == 1
        sigma = jnp.where(is_feas, 0.0, 1.0)
        h_cur = violation(c, opts.progress_norm)
        merit_cur = f  # strategies evaluate the objective measure at sigma=1

        # ---- termination at the current iterate ---------------------------
        stat, bc, con_compl = residuals(x, s.ev, g, J, s.y, s.zl, s.zu,
                                        s.y_f, s.zl_f, s.zu_f, s.zl_el, sigma)
        pf = violation(c, rn)
        compl = vector_norm(jnp.concatenate([bc, con_compl(c, s.y)])
                            if m else bc, rn)
        ssc, csc = scalings(s.y, s.zl, s.zu)
        # feasibility-problem residuals (l1 relaxed, rho = 0)
        grad_lag_f = -(_mtv(J, s.y_f) if m else 0.0) - s.zl_f - s.zu_f
        el_stat = nu - (_mv(el_sign_y, s.y_f) if m else 0.0) - s.zl_el \
            if n_el else jnp.zeros((0,))
        feas_stat = vector_norm(jnp.concatenate([grad_lag_f, el_stat]), rn)
        bc_f = jnp.where(has_xl & (s.zl_f > 0),
                         s.zl_f * (x - jnp.where(has_xl, xl, 0.0)), 0.0) \
            + jnp.where(has_xu & (s.zu_f < 0),
                        s.zu_f * (x - jnp.where(has_xu, xu, 0.0)), 0.0)
        el_compl = jnp.where(s.zl_el > 0, s.zl_el * s.ev, 0.0)
        # feasibility-problem complementarity uses the RELAXED constraints
        # c + E e (the l1RelaxedProblem view, l1RelaxedProblem.cpp:67-86)
        c_relaxed = c + (_mv(E, s.ev) if n_el else 0.0)
        feas_compl = vector_norm(jnp.concatenate(
            [bc_f, el_compl, con_compl(c_relaxed, s.y_f)]
            if m else [bc_f, el_compl]), rn)
        fssc, fcsc = scalings(s.y_f, s.zl_f, s.zu_f)

        # the reference never applies the first-order test to the INITIAL
        # iterate (Uno.cpp:61-78 tests after compute_next_iterate): bound-
        # constrained problems whose x0 is spuriously near-stationary (hs025)
        # must take at least one step
        tested = s.attempts > 0

        def kkt_ok(t):
            return ((stat / ssc <= t) & (pf <= t) & (compl / csc <= t)
                    & ~is_feas & tested)

        nontrivial = (jnp.max(jnp.abs(s.y_f), initial=0.0) > tol) | \
            (jnp.max(jnp.abs(s.zl_f + s.zu_f), initial=0.0) > tol)

        def fj_ok(t):
            return (m > 0) & (feas_stat / fssc <= t) & (pf > t) & \
                (feas_compl / fcsc <= t) & nontrivial & tested

        status = s.status
        loose = opts.loose_tolerance
        loose_hit_now = kkt_ok(loose) | fj_ok(loose)
        loose_count = jnp.where(loose_hit_now, s.loose_count + 1,
                                jnp.zeros_like(s.loose_count))
        loose_fire = loose_count >= opts.loose_tolerance_consecutive_iteration_threshold
        status = jnp.where(loose_fire & kkt_ok(loose), ALMOST_OPTIMAL, status)
        status = jnp.where(loose_fire & fj_ok(loose) & ~kkt_ok(loose),
                           INFEASIBLE_STATIONARY, status)
        status = jnp.where(fj_ok(tol), INFEASIBLE_STATIONARY, status)
        status = jnp.where(kkt_ok(tol), OPTIMAL, status)
        status = jnp.where(f < opts.unbounded_objective_threshold, UNBOUNDED,
                           status)
        # the reference bounds ACCEPTED (outer) iterations; TR rejections are
        # not counted (the inner loop is instead bounded by the min-radius
        # exit).  A hard attempts backstop guards accept/reject limit cycles.
        status = jnp.where((status == RUNNING)
                           & ((s.iteration >= opts.max_iterations)
                              | (s.attempts >= 20 * opts.max_iterations)),
                           MAX_ITERATIONS, status)

        # ---- direction: one QP solve for the current phase ----------------
        radius = s.radius
        dl = jnp.maximum(-radius, jnp.where(has_xl, xl - x, -LARGE_BOUND))
        du = jnp.minimum(radius, jnp.where(has_xu, xu - x, LARGE_BOUND))
        rl = jnp.where(has_cl, cl - c, -LARGE_BOUND)
        ru = jnp.where(has_cu, cu - c, LARGE_BOUND)

        def opt_branch(_):
            H = hessian(x, s.y, 1.0, params)
            res = solve_qp_opt(g, H, J, rl, ru, dl, du)
            return (jnp.concatenate([res.d, jnp.zeros((n_el,))]), res.y,
                    jnp.concatenate([res.zl, jnp.zeros((n_el,))]),
                    jnp.concatenate([res.zu, jnp.zeros((n_el,))]),
                    res.status, H)

        def feas_branch(_):
            H_f = hessian(x, s.y_f, 0.0, params)
            c_rel = c + (_mv(E, s.ev) if n_el else 0.0)
            rl_f = jnp.where(has_cl, cl - c_rel, -LARGE_BOUND)
            ru_f = jnp.where(has_cu, cu - c_rel, LARGE_BOUND)
            g_q = jnp.concatenate([jnp.zeros((n,)), jnp.full((n_el,), nu)])
            H_q = jnp.zeros((n + n_el, n + n_el)).at[:n, :n].set(H_f)
            J_q = jnp.concatenate([J, E], axis=1) if m else \
                jnp.zeros((0, n + n_el))
            dl_f = jnp.concatenate([dl, -s.ev])
            du_f = jnp.concatenate([du, jnp.full((n_el,), LARGE_BOUND)])
            res = solve_qp_rel(g_q, H_q, J_q, rl_f, ru_f, dl_f, du_f)
            return (res.d, res.y, res.zl, res.zu, res.status, H_f)

        d_full, y_new, zl_full, zu_full, qp_status, H_used = lax.cond(
            is_feas, feas_branch, opt_branch, operand=None)
        dx = d_full[:n]
        dev = d_full[n:]
        zl_new, zu_new = zl_full[:n], zu_full[:n]
        zl_el_new = zl_full[n:]
        dir_norm = jnp.max(jnp.abs(dx), initial=0.0)

        # infeasible optimality QP at an infeasible iterate -> restoration
        switch_to_feas = (~is_feas) & (qp_status == QP_INFEASIBLE) & \
            (h_cur > tol) & (m > 0)
        qp_err = ((qp_status == QP_ERROR)
                  | ((qp_status == QP_INFEASIBLE) & ~switch_to_feas))
        qp_unb = qp_status == QP_UNBOUNDED

        # ---- trial iterate (GlobalizationMechanism.cpp:11-31, alpha = 1) --
        x_t = jnp.clip(x + dx, jnp.where(has_xl, xl, -jnp.inf),
                       jnp.where(has_xu, xu, jnp.inf))
        ev_t = jnp.maximum(s.ev + dev, 0.0)
        # TR-active bound-dual reset (TrustRegionStrategy.cpp:115-130), with
        # the IP-QP dual-dust strip: zero duals whose box side came from the
        # TRUST REGION rather than the model bound
        tr_l = jnp.where(has_xl, xl - x, -LARGE_BOUND) < -radius
        tr_u = jnp.where(has_xu, xu - x, LARGE_BOUND) > radius
        zl_new = jnp.where(tr_l, 0.0, zl_new)
        zu_new = jnp.where(tr_u, 0.0, zu_new)
        f_t = nlp.objective(x_t, params=params)
        c_t = nlp.constraints(x_t, params=params) if m else jnp.zeros((0,))
        h_t = violation(c_t, opts.progress_norm)
        merit_t = f_t

        # predicted reductions (ConstraintRelaxationStrategy.cpp:91-98),
        # second-order objective model for TR
        c_lin = c + (_mv(J, dx) if m else 0.0)
        pred_h = h_cur - violation(c_lin, opts.progress_norm)
        quad = jnp.dot(dx, _mv(H_used, dx))
        pred_obj = -jnp.dot(g, dx) - 0.5 * quad
        merit_pred = pred_obj

        # ---- acceptance ----------------------------------------------------
        filt = s.filter
        merit_actual = _actual_reduction(filt, merit_cur, h_cur, merit_t)
        switching = (merit_pred > 0.0) & flt.switching_condition(
            merit_pred, h_cur, opts.switching_delta,
            opts.switching_infeasibility_exponent)
        sufficient = flt.armijo_sufficient_decrease(
            merit_pred, merit_actual, opts.armijo_decrease_fraction,
            opts.armijo_tolerance)
        if gs == "waechter_filter_method":
            filter_ok = _flt_acceptable(filt, h_t, merit_t)
            small_inf = h_cur <= 1e-4 * jnp.maximum(1.0, s.h_initial)
            f_type = small_inf & switching
            accept_h = (~f_type) & _flt_acceptable_wrt(
                filt, h_cur, merit_cur, h_t, merit_t)
            accept_reg = filter_ok & ((f_type & sufficient) | accept_h)
            augment_t = accept_reg & (~switching | ~sufficient)
        elif gs == "fletcher_filter_method":
            pair_ok = _flt_acceptable(filt, h_t, merit_t) & \
                _flt_acceptable_wrt(filt, h_cur, merit_cur, h_t, merit_t)
            accept_reg = pair_ok & jnp.where(switching, sufficient, True)
            augment_t = accept_reg & ~switching
        elif gs == "funnel_method":
            dec = flt.funnel_is_acceptable(
                s.gs_scalar, h_cur, merit_cur, h_t, merit_t, merit_pred, opts,
                roundoff * jnp.abs(merit_cur))
            accept_reg, augment_t = dec.accept, dec.h_type
        else:  # l1_merit
            accept_reg = flt.l1_merit_acceptable(
                h_cur, f, 0.0, h_t, f_t, 0.0, pred_h, pred_obj, 0.0, opts,
                roundoff * jnp.abs(merit_cur))
            augment_t = jnp.asarray(False)
        accept_feas = flt.feasibility_armijo_acceptable(
            h_cur, 0.0, h_t, 0.0, pred_h, 0.0, opts)
        finite = jnp.isfinite(f_t) & jnp.all(jnp.isfinite(c_t)) & \
            jnp.all(jnp.isfinite(x_t))
        accept = jnp.where(is_feas, accept_feas, accept_reg) & finite
        # zero primal step: accept and pick up the fresh multipliers
        # (ConstraintRelaxationStrategy.cpp:110-115)
        accept = accept | (dir_norm <= 1e-10)
        accept = accept & ~qp_err & ~qp_unb & ~switch_to_feas

        # ---- strategy state updates ---------------------------------------
        augment = augment_t & accept & ~is_feas
        new_filt = _flt_add(filt, h_cur, merit_cur)
        filt = flt.FilterState(
            jnp.where(augment, new_filt.h, filt.h),
            jnp.where(augment, new_filt.phi, filt.phi),
            jnp.where(augment, new_filt.ub, filt.ub))
        gs_scalar = s.gs_scalar
        if gs == "funnel_method":
            w_new = flt.funnel_update_width(
                s.gs_scalar, h_cur, h_t, opts.funnel_beta, opts.funnel_kappa,
                opts.funnel_update_strategy)
            gs_scalar = jnp.where(augment_t & accept & ~is_feas, w_new,
                                  gs_scalar)
        elif gs == "l1_merit":
            gs_scalar = jnp.where(accept & ~is_feas,
                                  jnp.minimum(gs_scalar, h_t), gs_scalar)

        # ---- phase transitions ---------------------------------------------
        # OPT -> FEAS: add current point to the filter, reset elastics/duals
        # (FeasibilityRestoration.cpp:126-143)
        sw_filt = _flt_add(filt, h_cur, merit_cur)
        filt = flt.FilterState(
            jnp.where(switch_to_feas, sw_filt.h, filt.h),
            jnp.where(switch_to_feas, sw_filt.phi, filt.phi),
            jnp.where(switch_to_feas, sw_filt.ub, filt.ub))
        h_ref = jnp.where(switch_to_feas, h_cur, s.h_ref)

        # FEAS -> OPT on accepted trial with sufficiently reduced
        # infeasibility (FeasibilityRestoration.cpp:156-162 + feasible exit)
        if gs == "fletcher_filter_method":
            smallest_h = jnp.min(filt.h)
            reduced = h_t < opts.filter_beta * jnp.minimum(smallest_h, filt.ub)
        elif gs == "waechter_filter_method":
            reduced = (h_t <= opts.filter_sufficient_infeasibility_decrease_factor
                       * s.h_ref) & _flt_acceptable(filt, h_t, merit_t)
        elif gs == "funnel_method":
            reduced = (h_t <= gs_scalar) & \
                (h_t <= opts.funnel_beta * s.h_ref)
        else:
            reduced = h_t <= 0.9 * s.h_ref
        # optional gate: the LINEARIZED residual along the accepted step must
        # also be feasible (FeasibilityRestoration.cpp:156-162; filtersqp
        # sets switch_to_optimality_requires_linearized_feasibility)
        if opts.switch_to_optimality_requires_linearized_feasibility:
            lin_ok = violation(c_lin, rn) <= tol
        else:
            lin_ok = jnp.asarray(True)
        switch_back = is_feas & accept & (reduced | (h_t <= tol)) & lin_ok
        sw2_filt = _flt_add(filt, h_t, merit_t)
        filt = flt.FilterState(
            jnp.where(switch_back, sw2_filt.h, filt.h),
            jnp.where(switch_back, sw2_filt.phi, filt.phi),
            jnp.where(switch_back, sw2_filt.ub, filt.ub))
        if gs == "funnel_method":
            # Funnel::update_restoration on leaving restoration
            gs_scalar = jnp.where(
                switch_back,
                opts.funnel_kappa * gs_scalar + (1 - opts.funnel_kappa) * h_t,
                gs_scalar)
        phase = jnp.where(switch_to_feas, 1, s.phase)
        phase = jnp.where(switch_back, 0, phase)

        # ---- radius update (TrustRegionStrategy.cpp:168-190) ---------------
        grow = accept & (dir_norm >= radius - act)
        radius_new = jnp.where(grow, radius * opts.TR_increase_factor, radius)
        shrink = ~accept & ~qp_err & ~qp_unb & ~switch_to_feas
        radius_new = jnp.where(
            shrink, jnp.minimum(radius, jnp.maximum(dir_norm, 1e-16))
            / opts.TR_decrease_factor, radius_new)
        radius_new = jnp.where(qp_unb,
                               radius / opts.TR_aggressive_decrease_factor,
                               radius_new)
        radius_new = jnp.where(qp_err, radius / opts.TR_decrease_factor,
                               radius_new)

        # radius reset happens once per OUTER iteration in the reference
        # (TrustRegionStrategy.cpp:43): apply it on acceptance only, so
        # rejection streaks can shrink below the reset threshold
        radius_new = jnp.where(
            accept, jnp.maximum(radius_new, opts.TR_radius_reset_threshold),
            radius_new)

        # small-radius termination (TrustRegionStrategy.cpp:150-166); a
        # feasible small step that passes the first-order test at the LOOSE
        # tolerance terminates as optimal (host driver convention for
        # check_termination_with_small_step)
        small = (radius_new < opts.TR_min_radius) & ~accept
        status = jnp.where(
            small & (h_cur <= tol),
            jnp.where(kkt_ok(loose) | kkt_ok(tol), OPTIMAL,
                      FEASIBLE_SMALL_STEP), status)
        status = jnp.where(small & (h_cur > tol) & is_feas,
                           INFEASIBLE_SMALL_STEP, status)
        # breakdown at an infeasible point that satisfies the FJ conditions
        # at the loose tolerance IS the infeasibility certificate — report
        # it instead of an algorithmic error (the acceptable-level exit)
        status = jnp.where(small & (h_cur > tol) & ~is_feas & fj_ok(loose),
                           INFEASIBLE_STATIONARY, status)
        status = jnp.where(small & (h_cur > tol) & ~is_feas & ~fj_ok(loose),
                           ALGORITHMIC_ERROR, status)

        # accepted-creep termination: a degenerate (singular-Hessian) valley
        # can produce an infinite stream of ACCEPTED steps whose objective
        # progress is at roundoff scale (polak5's quartic active manifold:
        # each convexified QP step moves ~1e-6 and gains ~1e-11 in f) — the
        # small-radius exit above never fires because nothing is rejected.
        # 15 consecutive such steps at a feasible iterate terminate
        # FEASIBLE_SMALL_STEP, the same honest status the TR small-step
        # exit reports (threshold mirrors the reference's loose-tolerance
        # consecutive-iteration mechanism, DefaultOptions.cpp:22-23)
        creeping = accept & (h_t <= tol) & ~is_feas \
            & (dir_norm <= jnp.sqrt(tol) * (1.0 + jnp.max(jnp.abs(x), initial=0.0))) \
            & (jnp.abs(merit_actual) <= 1e-11 * jnp.maximum(1.0, jnp.abs(merit_cur)))
        creep_count = jnp.where(creeping, s.creep_count + 1,
                                jnp.zeros_like(s.creep_count))
        status = jnp.where(
            (status == RUNNING) & (creep_count
                                   >= opts.loose_tolerance_consecutive_iteration_threshold),
            jnp.where(kkt_ok(loose), OPTIMAL, FEASIBLE_SMALL_STEP), status)

        # ---- commit ---------------------------------------------------------
        running = status == RUNNING
        com = accept & running

        def sel(new, old):
            return jnp.where(com, new, old)

        # dual bookkeeping per phase (same conventions as the host driver)
        y_c = jnp.where(is_feas, s.y, sel(y_new, s.y))
        zl_c = jnp.where(is_feas, s.zl, sel(zl_new, s.zl))
        zu_c = jnp.where(is_feas, s.zu, sel(zu_new, s.zu))
        y_f_c = jnp.where(is_feas, sel(y_new, s.y_f), s.y_f)
        zl_f_c = jnp.where(is_feas, sel(zl_new, s.zl_f), s.zl_f)
        zu_f_c = jnp.where(is_feas, sel(zu_new, s.zu_f), s.zu_f)
        # entering restoration: reset elastic duals/values
        # (l1RelaxedProblem::set_elastic_variable_values)
        ev_c = sel(ev_t, s.ev)
        zl_el_c = sel(zl_el_new, s.zl_el)
        ev_c = jnp.where(switch_to_feas, jnp.zeros_like(ev_c), ev_c)
        zl_el_c = jnp.where(switch_to_feas, jnp.ones_like(zl_el_c), zl_el_c)
        y_f_c = jnp.where(switch_to_feas, jnp.zeros_like(y_f_c), y_f_c)
        zl_f_c = jnp.where(switch_to_feas,
                           jnp.where(has_xl, 1.0, 0.0), zl_f_c)
        zu_f_c = jnp.where(switch_to_feas,
                           jnp.where(has_xu, -1.0, 0.0), zu_f_c)

        return SQPFState(
            x=sel(x_t, x), ev=ev_c, y=y_c, zl=zl_c, zu=zu_c,
            y_f=y_f_c, zl_f=zl_f_c, zu_f=zu_f_c, zl_el=zl_el_c,
            f_cur=sel(f_t, f), c_cur=sel(c_t, c),
            radius=jnp.where(running, radius_new, s.radius),
            phase=jnp.where(running, phase, s.phase),
            filter=filt, gs_scalar=gs_scalar, h_initial=s.h_initial,
            h_ref=h_ref, status=status,
            iteration=s.iteration + jnp.where(com, 1, 0),
            attempts=s.attempts + jnp.where(running, 1, 0),
            loose_count=loose_count, creep_count=creep_count,
            stat=stat, stat_scaling=ssc, compl=compl, compl_scaling=csc,
            primal_feas=pf,
            num_qp=s.num_qp + jnp.where(running, 1, 0),
            num_obj_evals=s.num_obj_evals + jnp.where(running, 2, 0),
            num_con_evals=s.num_con_evals + jnp.where(running, 2, 0),
            num_hess=s.num_hess + jnp.where(running, 1, 0),
            params=params,
        )

    return step


# ===========================================================================
# Fused byrd (LS + l1 merit + Sl1QP penalty steering), the l1Relaxation.cpp
# path as a flat jittable/vmappable state machine.  One while_loop trip = one
# OUTER iteration: a bounded steering sub-loop (one relaxed-QP solve per
# trip, stages a/c/d/e/f of l1Relaxation.cpp:105-263) followed by a bounded
# backtracking-line-search sub-loop (BacktrackingLineSearch.cpp:51-113) and
# the commit.  The HLO contains exactly ONE relaxed-QP instance.
# ===========================================================================

class ByrdFState(NamedTuple):
    x: jnp.ndarray
    ev: jnp.ndarray
    y: jnp.ndarray
    zl: jnp.ndarray
    zu: jnp.ndarray
    y_f: jnp.ndarray
    zl_f: jnp.ndarray
    zu_f: jnp.ndarray
    zl_el: jnp.ndarray
    f_cur: jnp.ndarray
    c_cur: jnp.ndarray
    rho: jnp.ndarray          # l1 penalty (steered down across iterations)
    status: jnp.ndarray
    iteration: jnp.ndarray
    loose_count: jnp.ndarray
    stat: jnp.ndarray
    stat_scaling: jnp.ndarray
    compl: jnp.ndarray
    compl_scaling: jnp.ndarray
    primal_feas: jnp.ndarray
    num_qp: jnp.ndarray
    num_obj_evals: jnp.ndarray
    num_con_evals: jnp.ndarray
    num_hess: jnp.ndarray
    params: object = None


def make_byrd_step(nlp: NLP, ws: FusedSQPWorkspace, opts: Options):
    """One byrd outer iteration; returns a pure state -> state function."""
    n, m, n_el = ws.n, ws.m, ws.n_el
    xl, xu = jnp.asarray(ws.xl), jnp.asarray(ws.xu)
    has_xl, has_xu = jnp.asarray(ws.has_xl), jnp.asarray(ws.has_xu)
    cl, cu = jnp.asarray(ws.cl), jnp.asarray(ws.cu)
    has_cl, has_cu = jnp.asarray(ws.has_cl), jnp.asarray(ws.has_cu)
    is_eq = jnp.asarray(ws.is_eq)
    E = jnp.asarray(ws.E)
    el_sign_y = jnp.asarray(ws.E.T)
    nu = opts.l1_constraint_violation_coefficient
    tol = opts.tolerance
    thr = opts.residual_scaling_threshold
    rn = opts.residual_norm
    roundoff = (10.0 * np.finfo(np.float64).eps
                if opts.protect_actual_reduction_against_roundoff else 0.0)
    zero_hessian = opts.hessian_model == "zero"
    identity_hessian = opts.hessian_model == "identity"

    def hessian(x, y, sigma, params):
        if zero_hessian:
            return jnp.zeros((n, n))
        if identity_hessian:
            return jnp.eye(n)
        return nlp.lagrangian_hessian(x, y, sigma, params=params)

    def violation(c, kind):
        viol = jnp.where(has_cl, jnp.maximum(cl - c, 0.0), 0.0) + \
            jnp.where(has_cu, jnp.maximum(c - cu, 0.0), 0.0)
        return vector_norm(viol, kind)

    # NO trust region (LS mechanism): the QP box is the MODEL bound
    # structure, not all-finite like the fused TR driver's
    struct_rel = QPStructure(
        n=n + n_el, m=m,
        has_dl=np.concatenate([np.asarray(ws.has_xl, bool),
                               np.ones(n_el, bool)]),
        has_du=np.concatenate([np.asarray(ws.has_xu, bool),
                               np.zeros(n_el, bool)]),
        is_eq=ws.is_eq, has_rl=ws.has_cl, has_ru=ws.has_cu)
    solve_qp_rel = build_qp_solver(struct_rel, opts, tol=opts.tolerance * 1e-2)

    def con_compl(c, yv):
        lo = jnp.where(has_cl, cl, 0.0)
        hi = jnp.where(has_cu, cu, 0.0)
        out = jnp.where(~is_eq & (yv > 0) & has_cl, yv * (c - lo), 0.0)
        out = jnp.where(~is_eq & (yv < 0) & has_cu, yv * (c - hi), out)
        return out

    def scalings(y, zl, zu):
        total = ws.nb + m
        ssc = jnp.maximum(1.0, (jnp.sum(jnp.abs(y)) + jnp.sum(jnp.abs(zl))
                                + jnp.sum(jnp.abs(zu))) / (thr * max(total, 1))) \
            if total else jnp.asarray(1.0)
        csc = jnp.maximum(1.0, (jnp.sum(jnp.abs(zl)) + jnp.sum(jnp.abs(zu)))
                          / (thr * max(ws.nb, 1))) if ws.nb else jnp.asarray(1.0)
        return ssc, csc

    # PrimalRegularization (reference PrimalRegularization.hpp:80-140; the
    # byrd preset sets regularization_strategy="primal"): H + delta*I until
    # positive definite.  PD-ness is checked via Cholesky (finite L with
    # strictly positive diagonal <=> inertia (n, 0, 0), the host driver's
    # LDL^T inertia test), as a bounded while_loop under jit.
    use_primal_reg = opts.regularization_strategy == "primal"
    eye_n = jnp.eye(n)

    def _pd_ok(Hd):
        L = jnp.linalg.cholesky(Hd)
        return jnp.all(jnp.isfinite(L)) & jnp.all(jnp.diag(L) > 0.0)

    def primal_reg(H):
        ok0 = _pd_ok(H)
        min_diag = jnp.min(jnp.diag(H))
        d0 = jnp.maximum(opts.regularization_initial_value,
                         opts.regularization_initial_value - min_diag)

        def cond(cr):
            _, ok, k = cr
            return ~ok & (k < 80)

        def body(cr):
            d, _, k = cr
            ok = _pd_ok(H + d * eye_n)
            return (jnp.where(ok, d, d * opts.regularization_increase_factor),
                    ok, k + 1)

        delta, ok, _ = lax.while_loop(cond, body, (d0, ok0, jnp.asarray(0)))
        return H + jnp.where(ok0, 0.0, delta) * eye_n

    # steering constants (l1Relaxation.cpp / Presets.cpp byrd)
    fixed_rho = opts.l1_relaxation_fixed_parameter
    eps1 = opts.l1_relaxation_epsilon1
    eps2 = opts.l1_relaxation_epsilon2
    small_thr = opts.l1_relaxation_residual_small_threshold
    dec = opts.l1_relaxation_decrease_factor
    # reference threshold (DefaultOptions.cpp:157); the QP kernel's dual
    # purification (qp.py, BQPD-parity multiplier extraction) removes the
    # IP dual dust that used to require a 1e-3 floor here
    dust = opts.l1_small_duals_threshold
    MAXD = 60  # stage-d/e decrease caps (host driver bound)

    # LS trip bound: alpha = ratio^k until < min_step
    ls_max = int(np.ceil(np.log(opts.LS_min_step_length)
                         / np.log(opts.LS_backtracking_ratio))) + 2

    def step(s: ByrdFState) -> ByrdFState:
        params = s.params
        x, f, c = s.x, s.f_cur, s.c_cur
        g = nlp.objective_gradient(x, params=params)
        J = nlp.constraint_jacobian(x, params=params) if m else jnp.zeros((0, n))
        rho0 = s.rho
        h_cur = violation(c, opts.progress_norm)
        pf = violation(c, rn)

        # ---- termination at the current iterate (sigma = rho) --------------
        grad_lag = rho0 * g - (_mtv(J, s.y) if m else 0.0) - s.zl - s.zu
        stat = vector_norm(grad_lag, rn)
        bc = jnp.where(has_xl & (s.zl > 0), s.zl * (x - jnp.where(has_xl, xl, 0.0)), 0.0) \
            + jnp.where(has_xu & (s.zu < 0), s.zu * (x - jnp.where(has_xu, xu, 0.0)), 0.0)
        compl = vector_norm(jnp.concatenate([bc, con_compl(c, s.y)])
                            if m else bc, rn)
        ssc, csc = scalings(s.y, s.zl, s.zu)
        grad_lag_f = -(_mtv(J, s.y_f) if m else 0.0) - s.zl_f - s.zu_f
        el_stat = nu - (_mv(el_sign_y, s.y_f) if m else 0.0) - s.zl_el \
            if n_el else jnp.zeros((0,))
        feas_stat = vector_norm(jnp.concatenate([grad_lag_f, el_stat]), rn)
        bc_f = jnp.where(has_xl & (s.zl_f > 0),
                         s.zl_f * (x - jnp.where(has_xl, xl, 0.0)), 0.0) \
            + jnp.where(has_xu & (s.zu_f < 0),
                        s.zu_f * (x - jnp.where(has_xu, xu, 0.0)), 0.0)
        el_compl = jnp.where(s.zl_el > 0, s.zl_el * s.ev, 0.0)
        c_relaxed = c + (_mv(E, s.ev) if n_el else 0.0)
        feas_compl = vector_norm(jnp.concatenate(
            [bc_f, el_compl, con_compl(c_relaxed, s.y_f)]
            if m else [bc_f, el_compl]), rn)
        fssc, fcsc = scalings(s.y_f, s.zl_f, s.zu_f)
        # intentional parity bookkeeping (advisor round-2): the reference
        # never applies the first-order test to the raw initial iterate —
        # Uno.cpp:61-78 checks termination only after compute_next_iterate —
        # so a KKT x0 costs one outer iteration there too; testing at
        # iteration 0 with uninitialized duals would also fire spuriously
        # on near-stationary starts (hs025-class)
        tested = s.iteration > 0

        def kkt_ok(t):
            return ((stat / ssc <= t) & (pf <= t) & (compl / csc <= t)
                    & (rho0 > 0) & tested)

        nontrivial_f = (jnp.max(jnp.abs(s.y_f), initial=0.0) > tol) | \
            (jnp.max(jnp.abs(s.zl_f + s.zu_f), initial=0.0) > tol)

        def fj_ok(t):
            return (m > 0) & (feas_stat / fssc <= t) & (pf > t) & \
                (feas_compl / fcsc <= t) & nontrivial_f & tested

        status = s.status
        loose = opts.loose_tolerance
        loose_hit = kkt_ok(loose) | fj_ok(loose)
        loose_count = jnp.where(loose_hit, s.loose_count + 1,
                                jnp.zeros_like(s.loose_count))
        loose_fire = loose_count >= opts.loose_tolerance_consecutive_iteration_threshold
        status = jnp.where(loose_fire & kkt_ok(loose), ALMOST_OPTIMAL, status)
        status = jnp.where(loose_fire & fj_ok(loose) & ~kkt_ok(loose),
                           INFEASIBLE_STATIONARY, status)
        status = jnp.where(fj_ok(tol), INFEASIBLE_STATIONARY, status)
        status = jnp.where(kkt_ok(tol), OPTIMAL, status)
        status = jnp.where(f < opts.unbounded_objective_threshold, UNBOUNDED,
                           status)
        status = jnp.where((status == RUNNING)
                           & (s.iteration >= opts.max_iterations),
                           MAX_ITERATIONS, status)
        # terminal at the top of the trip (converged / iteration limit):
        # the remaining work this trip is discarded, like the reference's
        # while-condition check before each pass (Uno.cpp:61-78)
        alive = status == RUNNING

        # ---- steering sub-loop: one relaxed-QP solve per trip ---------------
        # stage 0: solve at rho, decide whether to steer (linearized residual
        #          > tol, l1Relaxation.cpp:105-155)
        # stage 1: feasibility solve at rho = 0 (stage c) + aggressive cut
        #          from the FJ dual error (stage f)
        # stage 2: refresh at current rho, then run the stage-d (linearized
        #          sufficient decrease) and stage-e (l1-merit descent) checks;
        #          on failure divide rho and refresh again
        dl = jnp.where(has_xl, xl - x, -LARGE_BOUND)
        du = jnp.where(has_xu, xu - x, LARGE_BOUND)
        c_rel = c + (_mv(E, s.ev) if n_el else 0.0)
        rl = jnp.where(has_cl, cl - c_rel, -LARGE_BOUND)
        ru = jnp.where(has_cu, cu - c_rel, LARGE_BOUND)
        dl_q = jnp.concatenate([dl, -s.ev])
        du_q = jnp.concatenate([du, jnp.full((n_el,), LARGE_BOUND)])
        J_q = jnp.concatenate([J, E], axis=1) if m else jnp.zeros((0, n + n_el))

        def solve_at(r):
            H0 = hessian(x, s.y, r, params)
            H = primal_reg(H0) if use_primal_reg else H0
            g_q = jnp.concatenate([r * g, jnp.full((n_el,), nu)])
            H_q = jnp.zeros((n + n_el, n + n_el)).at[:n, :n].set(H)
            # purification extracts multipliers against the UNREGULARIZED
            # Hessian (BQPD parity; see qp.py H_purify)
            Hp_q = jnp.zeros((n + n_el, n + n_el)).at[:n, :n].set(H0)
            return solve_qp_rel(g_q, H_q, J_q, rl, ru, dl_q, du_q,
                                H_purify=Hp_q)

        def lin_res_of(d_full, kerr):
            """Linearized l1 infeasibility of the step, with per-row
            violations at or below the QP's own primal residual zeroed —
            BQPD returns exactly-feasible subproblem solutions (active-set
            on linear constraints), so the reference's steering gates
            (l1Relaxation.cpp:117-118) compare true zeros; the IP-QP leaves
            O(kkt_error) primal dust per row that would falsely engage
            steering at feasible points (the primal analogue of the dual
            purification in qp.py)."""
            cl_lin = c + (_mv(J, d_full[:n]) if m else 0.0)
            viol = jnp.where(has_cl, jnp.maximum(cl - cl_lin, 0.0), 0.0) + \
                jnp.where(has_cu, jnp.maximum(cl_lin - cu, 0.0), 0.0)
            viol = jnp.where(viol <= 10.0 * kerr, 0.0, viol)
            return vector_norm(viol, "L1")

        zvec = jnp.zeros((n + n_el,))
        st0 = dict(
            stage=jnp.asarray(0), rho=rho0,
            d=zvec, y_q=jnp.zeros((m,)), zl_q=zvec, zu_q=zvec,
            qp_status=jnp.asarray(QP_OPTIMAL), qp_obj=jnp.asarray(0.0),
            lin=jnp.asarray(jnp.inf),
            lowest=jnp.asarray(0.0), lowest_obj=jnp.asarray(0.0),
            y_f=s.y_f, zl_f=s.zl_f, zu_f=s.zu_f, zl_el_f=s.zl_el,
            have_f=jnp.asarray(False),
            cd=jnp.asarray(0), ce=jnp.asarray(0),
            d_done=jnp.asarray(False),
            nqp=jnp.asarray(0), done=jnp.asarray(False))

        def steer_cond(t):
            return ~t["done"] & (t["nqp"] < 3 + 2 * MAXD)

        def steer_body(t):
            stage = t["stage"]
            r_solve = jnp.where(stage == 1, 0.0, t["rho"])
            res = solve_at(r_solve)
            lin = lin_res_of(res.d, res.kkt_error)
            out = dict(t)
            out["nqp"] = t["nqp"] + 1

            is0, is1 = stage == 0, stage == 1
            refresh = is0 | (stage == 2)
            # stage 0 / stage 2 refresh the CURRENT direction
            for k, v in (("d", res.d), ("y_q", res.y), ("zl_q", res.zl),
                         ("zu_q", res.zu), ("qp_status", res.status),
                         ("qp_obj", res.objective), ("lin", lin)):
                out[k] = jnp.where(refresh, v, t[k])

            # stage 0 -> steer or exit (stage a: linearized residual small)
            need = (t["rho"] > 0) & (not fixed_rho) & (lin > tol) & (m > 0) & \
                (res.status == QP_OPTIMAL)
            out["stage"] = jnp.where(is0, jnp.where(need, 1, 0), out["stage"])
            out["done"] = jnp.where(is0, ~need, out["done"])

            # stage 1: record feasibility result (duals feed the FJ test,
            # l1Relaxation.cpp:130-131), aggressive cut (stage f)
            zl_t, zu_t = res.zl[:n], res.zu[:n]
            # error-proportional trivial-duals gate: the reference compares
            # BQPD's exact multipliers against 1e-10
            # (l1Relaxation.cpp:190); the IP-QP's duals are only reliable
            # to O(kkt_error) (active-bound duals absorb the solver's own
            # residual in the purification fit), so the gate scales with
            # the solve's exit error
            dust_k = jnp.maximum(dust, 1e3 * res.kkt_error)
            nontrivial = (jnp.max(jnp.abs(res.y), initial=0.0) > dust_k) | \
                (jnp.max(jnp.abs(zl_t + zu_t), initial=0.0) > dust_k)
            grad_f = -(_mtv(J, res.y) if m else 0.0) - zl_t - zu_t
            err = jnp.sum(jnp.abs(grad_f))
            bct = jnp.where(has_xl & (zl_t > 0), zl_t * (x - jnp.where(has_xl, xl, 0.0)), 0.0) \
                + jnp.where(has_xu & (zu_t < 0), zu_t * (x - jnp.where(has_xu, xu, 0.0)), 0.0)
            err = err + jnp.sum(jnp.abs(bct)) \
                + jnp.sum(jnp.abs(con_compl(c, res.y)))
            scaled = err / jnp.maximum(1.0, pf)
            # the aggressive cut detects proximity to an INFEASIBLE
            # stationary point; when the feasibility QP fully restores
            # linearized feasibility (lin <= small_thr) the point is not
            # near one, and BQPD would return the exact-zero multipliers of
            # the degenerate vertex solution (our IP returns the interior
            # solution of the same degenerate QP, whose fitted multipliers
            # are tiny but nonzero) — gate the cut on non-achievability,
            # reproducing the reference's effective behavior
            rho_cut = jnp.where(nontrivial & (lin > small_thr),
                                jnp.minimum(t["rho"], scaled * scaled),
                                t["rho"])
            out["rho"] = jnp.where(is1, rho_cut, out["rho"])
            out["lowest"] = jnp.where(is1, lin, t["lowest"])
            # objective purification: the IP-QP's objective value is only
            # reliable to O(kkt_error); predicted-decrease dust with the
            # wrong sign would flip the stage-e descent test forever
            # (reference compares exact BQPD objectives)
            lo_obj = pf - res.objective
            lo_obj = jnp.where(jnp.abs(lo_obj)
                               <= 100.0 * res.kkt_error * jnp.maximum(1.0, pf),
                               0.0, lo_obj)
            out["lowest_obj"] = jnp.where(is1, lo_obj, t["lowest_obj"])
            for k, v in (("y_f", res.y), ("zl_f", zl_t), ("zu_f", zu_t),
                         ("zl_el_f", res.zl[n:])):
                out[k] = jnp.where(is1, v, t[k])
            out["have_f"] = t["have_f"] | is1
            out["stage"] = jnp.where(is1, 2, out["stage"])

            # stage 2 (after refresh): stage-d to exhaustion, THEN stage-e
            # without re-checking d — matching the host driver and the
            # reference's two sequential while-loops
            # (l1Relaxation.cpp:217-263; advisor round-2 finding).  Once
            # stage d passes (or caps out) it is latched done; subsequent
            # passes only run the stage-e check.  Accepted deviation: when
            # stage f leaves rho unchanged, the reference skips the
            # re-solve (l1Relaxation.cpp:137-142) while this loop re-solves
            # at the same rho — the deterministic kernel returns the
            # identical direction, costing one extra QP on that edge.
            h_l1 = violation(c, "L1")
            d_ok = jnp.where(out["lowest"] <= small_thr,
                             out["lin"] <= small_thr,
                             (h_l1 - out["lin"])
                             >= eps1 * (h_l1 - out["lowest"]))
            pred = pf - out["qp_obj"]
            # same objective purification as lowest_obj above
            pred = jnp.where(jnp.abs(pred)
                             <= 100.0 * res.kkt_error * jnp.maximum(1.0, pf),
                             0.0, pred)
            e_ok = pred >= eps2 * out["lowest_obj"]
            rho_pos = out["rho"] > 0
            in2 = stage == 2
            d_phase = in2 & ~t["d_done"]
            dec_d = d_phase & ~d_ok & (t["cd"] < MAXD) & rho_pos
            # d latches done when it passes or can no longer decrease
            out["d_done"] = t["d_done"] | (d_phase & ~dec_d)
            e_phase = in2 & out["d_done"]
            dec_e = e_phase & ~e_ok & (t["ce"] < MAXD) & rho_pos
            out["cd"] = t["cd"] + jnp.where(dec_d, 1, 0)
            out["ce"] = t["ce"] + jnp.where(dec_e, 1, 0)
            out["rho"] = jnp.where(dec_d | dec_e, out["rho"] / dec,
                                   out["rho"])
            out["done"] = jnp.where(in2, ~(dec_d | dec_e), out["done"])
            return out

        st = lax.while_loop(steer_cond, steer_body, st0)
        rho = st["rho"]
        dx, dev = st["d"][:n], st["d"][n:]
        y_new = st["y_q"]
        zl_new, zu_new = st["zl_q"][:n], st["zu_q"][:n]
        zl_el_new = st["zl_q"][n:]
        dir_norm = jnp.max(jnp.abs(dx), initial=0.0)
        qp_bad = (st["qp_status"] == QP_ERROR) | (st["qp_status"] == QP_UNBOUNDED)

        # ---- backtracking line search on the l1 merit (sigma = rho) ---------
        dual_alpha_scaled = opts.LS_scale_duals_with_step_length
        gdx = jnp.dot(g, dx)

        def ls_trial(alpha):
            x_t = jnp.clip(x + alpha * dx, jnp.where(has_xl, xl, -jnp.inf),
                           jnp.where(has_xu, xu, jnp.inf))
            ev_t = jnp.maximum(s.ev + alpha * dev, 0.0)
            f_t = nlp.objective(x_t, params=params)
            c_t = nlp.constraints(x_t, params=params) if m else jnp.zeros((0,))
            return x_t, ev_t, f_t, c_t

        ls0 = dict(alpha=jnp.asarray(1.0), trips=jnp.asarray(0),
                   accepted=jnp.asarray(False), failed=jnp.asarray(False),
                   x_t=x, ev_t=s.ev, f_t=f, c_t=c)

        def ls_cond(t):
            return ~t["accepted"] & ~t["failed"] & (t["trips"] < ls_max)

        def ls_body(t):
            alpha = t["alpha"]
            x_t, ev_t, f_t, c_t = ls_trial(alpha)
            h_t = violation(c_t, opts.progress_norm)
            c_lin = c + alpha * (_mv(J, dx) if m else jnp.zeros((0,)))
            pred_h = h_cur - violation(c_lin, opts.progress_norm)
            pred_obj = alpha * (-gdx)   # first-order model (host driver)
            acc = flt.l1_merit_acceptable(
                h_cur, rho * f, 0.0, h_t, rho * f_t, 0.0,
                pred_h, rho * pred_obj, 0.0, opts,
                roundoff * jnp.abs(rho * f + h_cur))
            finite = jnp.isfinite(f_t) & jnp.all(jnp.isfinite(c_t))
            acc = (acc & finite) | (dir_norm <= 1e-10)
            small = alpha < opts.LS_min_step_length
            return dict(alpha=jnp.where(acc | small, alpha,
                                        alpha * opts.LS_backtracking_ratio),
                        trips=t["trips"] + 1,
                        accepted=acc, failed=small & ~acc,
                        x_t=x_t, ev_t=ev_t, f_t=f_t, c_t=c_t)

        ls = lax.while_loop(ls_cond, ls_body, ls0)
        alpha = ls["alpha"]
        accepted = ls["accepted"] & ~qp_bad
        ls_failed = (ls["failed"] | (~ls["accepted"] & ~qp_bad
                                     & (ls["trips"] >= ls_max)))

        # trial duals (GlobalizationMechanism.cpp:11-31: bound duals full
        # step, constraint duals scaled when LS_scale_duals_with_step_length)
        da = alpha if dual_alpha_scaled else 1.0
        y_t = s.y + da * (y_new - s.y)

        # small-step termination at the failed-LS trial (BacktrackingLineSearch
        # .cpp:91-95,115-124), evaluated once per outer iteration
        x_t, ev_t, f_t, c_t = ls["x_t"], ls["ev_t"], ls["f_t"], ls["c_t"]
        g_t = nlp.objective_gradient(x_t, params=params)
        J_t = nlp.constraint_jacobian(x_t, params=params) if m else J
        pf_t = violation(c_t, rn)
        grad_lag_t = rho * g_t - (_mtv(J_t, y_t) if m else 0.0) - zl_new - zu_new
        stat_t = vector_norm(grad_lag_t, rn)
        bc_t = jnp.where(has_xl & (zl_new > 0),
                         zl_new * (x_t - jnp.where(has_xl, xl, 0.0)), 0.0) \
            + jnp.where(has_xu & (zu_new < 0),
                        zu_new * (x_t - jnp.where(has_xu, xu, 0.0)), 0.0)
        compl_t = vector_norm(jnp.concatenate([bc_t, con_compl(c_t, y_t)])
                              if m else bc_t, rn)
        ssc_t, csc_t = scalings(y_t, zl_new, zu_new)

        def kkt_t_ok(t):
            return ((stat_t / ssc_t <= t) & (pf_t <= t)
                    & (compl_t / csc_t <= t) & (rho > 0))

        small_opt = ls_failed & kkt_t_ok(tol)
        small_almost = ls_failed & ~small_opt & kkt_t_ok(loose)
        accepted = accepted | small_opt | small_almost
        status = jnp.where((status == RUNNING) & small_opt, OPTIMAL, status)
        status = jnp.where((status == RUNNING) & small_almost, ALMOST_OPTIMAL,
                           status)
        # solver breakdown (QP error / exhausted LS) AT a loose-KKT point is
        # the loose-tolerance exit, not an algorithmic error — the analogue
        # of the reference's "solved to acceptable level" path when the
        # subproblem solver cannot refine a degenerate vertex further
        breakdown = qp_bad | (ls_failed & ~small_opt & ~small_almost)
        status = jnp.where((status == RUNNING) & breakdown & kkt_ok(loose),
                           ALMOST_OPTIMAL, status)
        status = jnp.where((status == RUNNING) & breakdown & ~kkt_ok(loose),
                           ALGORITHMIC_ERROR, status)

        # ---- commit ---------------------------------------------------------
        running = s.status == RUNNING
        com = accepted & running & alive

        def sel(new, old):
            return jnp.where(com, new, old)

        return ByrdFState(
            x=sel(x_t, x), ev=sel(ev_t, s.ev),
            y=sel(y_t, s.y), zl=sel(zl_new, s.zl), zu=sel(zu_new, s.zu),
            # feasibility duals refresh whenever the steering solved the
            # feasibility QP (the host driver mutates the iterate in place)
            y_f=jnp.where(st["have_f"] & running & alive, st["y_f"], s.y_f),
            zl_f=jnp.where(st["have_f"] & running & alive, st["zl_f"], s.zl_f),
            zu_f=jnp.where(st["have_f"] & running & alive, st["zu_f"], s.zu_f),
            zl_el=sel(zl_el_new, s.zl_el),
            f_cur=sel(f_t, f), c_cur=sel(c_t, c),
            rho=jnp.where(running & alive, rho, s.rho),
            status=jnp.where(running, status, s.status),
            # count outer iterations that did work; the trip that merely
            # flags a terminal status at its top is bookkeeping, not an
            # iteration (keeps counts aligned with the host driver)
            iteration=s.iteration + jnp.where(running
                                              & ((status == RUNNING) | com),
                                              1, 0),
            loose_count=loose_count,
            stat=stat, stat_scaling=ssc, compl=compl, compl_scaling=csc,
            primal_feas=pf,
            num_qp=s.num_qp + jnp.where(running & alive, st["nqp"], 0),
            num_obj_evals=s.num_obj_evals
            + jnp.where(running & alive, ls["trips"] + 1, 0),
            num_con_evals=s.num_con_evals
            + jnp.where(running & alive, ls["trips"] + 1, 0),
            num_hess=s.num_hess + jnp.where(running & alive, st["nqp"], 0),
            params=params,
        )

    return step


def make_initial_byrd_state(nlp: NLP, ws: FusedSQPWorkspace, opts: Options,
                            x0=None, params=None) -> ByrdFState:
    n, m, n_el = ws.n, ws.m, ws.n_el
    if params is None:
        params = nlp.params
    x = jnp.clip(jnp.asarray(nlp.x0 if x0 is None else x0, dtype=jnp.float64),
                 jnp.asarray(ws.xl), jnp.asarray(ws.xu))
    f = nlp.objective(x, params=params)
    c = nlp.constraints(x, params=params) if m else jnp.zeros((0,))
    y0 = jnp.asarray(np.asarray(nlp.y0, dtype=float)) if nlp.y0 is not None \
        else jnp.zeros((m,))
    z = jnp.zeros((n,))
    return ByrdFState(
        x=x, ev=jnp.zeros((n_el,)), y=y0, zl=z, zu=z,
        y_f=jnp.zeros((m,)), zl_f=z, zu_f=z, zl_el=jnp.ones((n_el,)),
        f_cur=f, c_cur=c,
        rho=jnp.asarray(float(opts.l1_relaxation_initial_parameter)),
        status=jnp.asarray(RUNNING), iteration=jnp.asarray(0),
        loose_count=jnp.asarray(0),
        stat=jnp.asarray(jnp.inf), stat_scaling=jnp.asarray(1.0),
        compl=jnp.asarray(jnp.inf), compl_scaling=jnp.asarray(1.0),
        primal_feas=jnp.asarray(jnp.inf),
        num_qp=jnp.asarray(0), num_obj_evals=jnp.asarray(1),
        num_con_evals=jnp.asarray(1), num_hess=jnp.asarray(0),
        params=params,
    )


def _finalize_fused(step, opts):
    """Shared tail of the fused builders: optional in-loop wall-clock limit
    (reference checks the Timer every outer iteration, Uno.cpp:61-78,
    through a pure_callback clock poll; with the default time_limit=inf
    the HLO is unchanged) + the jitted while_loop runner
    (utils/timer.make_timed_runner)."""
    from uno_tpu.utils.timer import make_timed_runner
    return make_timed_runner(step, opts.time_limit, RUNNING, 7)  # 7=TIME_LIMIT


def build_byrd_fused(nlp: NLP, opts: Options):
    """Compile-time setup; returns (nlp_transformed, ws, step, jitted run)."""
    scaled = transforms.scale_model(nlp, opts.function_scaling_threshold) \
        if opts.scale_functions else nlp
    prob = transforms.fixed_bounds_to_constraints(scaled)
    ws = _build_workspace(prob)
    step = make_byrd_step(prob, ws, opts)
    step, run = _finalize_fused(step, opts)
    return prob, ws, step, run


def solve_byrd_fused(nlp: NLP, opts: Options, callbacks=None,
                     history=False) -> Result:
    t0 = time.time()
    prob, ws, step, run = build_byrd_fused(nlp, opts)
    # the instance's params ride in the state as an argument, so every
    # instance of one parametric NLP compiles to the same (cached) program
    state0 = canonicalize_state(make_initial_byrd_state(prob, ws, opts,
                                                        params=prob.params))
    trace = None
    if history or callbacks is not None:
        stepj = jax.jit(step)
        s = state0
        trace = [s] if history else None
        while int(s.status) == RUNNING:
            s = stepj(s)
            if history:
                trace.append(s)
            if callbacks is not None and hasattr(callbacks, "notify_new_primals"):
                callbacks.notify_new_primals(np.asarray(s.x)[: nlp.n])
            if callbacks is not None and hasattr(callbacks, "notify_new_multipliers"):
                callbacks.notify_new_multipliers(np.asarray(s.y)[: nlp.m])
        final = s
    else:
        final = jax.block_until_ready(run(state0))
    elapsed = time.time() - t0

    f_scale = prob.f_scale
    c_scale = prob.c_scale if prob.c_scale is not None else np.ones(max(ws.m, 1))
    m0 = nlp.m
    x_orig = np.asarray(final.x)[: nlp.n]
    from uno_tpu.solvers.ipm import map_fixed_bound_duals
    y_all = np.asarray(final.y)
    y_full = y_all * c_scale[: y_all.shape[0]] / f_scale
    y = y_full[:m0] if m0 else np.zeros(0)
    zl_out, zu_out = map_fixed_bound_duals(
        nlp, y_full, np.asarray(final.zl)[: nlp.n] / f_scale,
        np.asarray(final.zu)[: nlp.n] / f_scale)
    if callbacks is not None and hasattr(callbacks, "notify_acceptable_iterate"):
        callbacks.notify_acceptable_iterate(x_orig, y, float(final.rho))
    return Result(
        status=SQP_STATUS_NAMES[int(final.status)],
        x=x_orig, y=y,
        zl=zl_out, zu=zu_out,
        objective=float(nlp.objective(jnp.asarray(x_orig))),
        iterations=int(final.iteration),
        primal_feasibility=float(final.primal_feas),
        stationarity=float(final.stat / final.stat_scaling),
        complementarity=float(final.compl / final.compl_scaling),
        cpu_time=elapsed,
        num_subproblems_solved=int(final.num_qp),
        num_factorizations=int(final.num_hess),
        num_objective_evaluations=int(final.num_obj_evals),
        num_constraint_evaluations=int(final.num_con_evals),
        history=trace,
    )


def make_initial_sqp_state(nlp: NLP, ws: FusedSQPWorkspace, opts: Options,
                           x0=None, params=None) -> SQPFState:
    n, m, n_el = ws.n, ws.m, ws.n_el
    if params is None:
        params = nlp.params
    x = jnp.clip(jnp.asarray(nlp.x0 if x0 is None else x0, dtype=jnp.float64),
                 jnp.asarray(ws.xl), jnp.asarray(ws.xu))
    f = nlp.objective(x, params=params)
    c = nlp.constraints(x, params=params) if m else jnp.zeros((0,))
    viol = jnp.where(jnp.asarray(ws.has_cl), jnp.maximum(jnp.asarray(ws.cl) - c, 0.0), 0.0) \
        + jnp.where(jnp.asarray(ws.has_cu), jnp.maximum(c - jnp.asarray(ws.cu), 0.0), 0.0)
    h0 = vector_norm(viol, opts.progress_norm)
    filt = flt.filter_init(opts.filter_capacity)
    filt = flt.filter_set_ub(filt, jnp.maximum(opts.filter_ubd,
                                               opts.filter_fact * h0))
    if opts.globalization_strategy == "funnel_method":
        gs_scalar = jnp.maximum(opts.funnel_ubd, opts.funnel_fact * h0)
    else:
        gs_scalar = jnp.asarray(jnp.inf)
    y0 = jnp.asarray(np.asarray(nlp.y0, dtype=float)) if nlp.y0 is not None \
        else jnp.zeros((m,))
    z = jnp.zeros((n,))
    return SQPFState(
        x=x, ev=jnp.zeros((n_el,)), y=y0, zl=z, zu=z,
        y_f=jnp.zeros((m,)), zl_f=z, zu_f=z, zl_el=jnp.ones((n_el,)),
        f_cur=f, c_cur=c,
        radius=jnp.asarray(float(opts.TR_radius)),
        phase=jnp.asarray(0),
        filter=filt, gs_scalar=gs_scalar, h_initial=h0, h_ref=h0,
        status=jnp.asarray(RUNNING), iteration=jnp.asarray(0),
        attempts=jnp.asarray(0), loose_count=jnp.asarray(0),
        creep_count=jnp.asarray(0),
        stat=jnp.asarray(jnp.inf), stat_scaling=jnp.asarray(1.0),
        compl=jnp.asarray(jnp.inf), compl_scaling=jnp.asarray(1.0),
        primal_feas=h0,
        num_qp=jnp.asarray(0), num_obj_evals=jnp.asarray(1),
        num_con_evals=jnp.asarray(1), num_hess=jnp.asarray(0),
        params=params,
    )


def build_sqp_fused(nlp: NLP, opts: Options):
    """Compile-time setup; returns (nlp_transformed, ws, step, jitted run)."""
    scaled = transforms.scale_model(nlp, opts.function_scaling_threshold) \
        if opts.scale_functions else nlp
    prob = transforms.fixed_bounds_to_constraints(scaled)
    ws = _build_workspace(prob)
    step = make_sqp_step(prob, ws, opts)
    step, run = _finalize_fused(step, opts)
    return prob, ws, step, run


def solve_sqp_fused(nlp: NLP, opts: Options, callbacks=None,
                    history=False) -> Result:
    t0 = time.time()
    prob, ws, step, run = build_sqp_fused(nlp, opts)
    # the instance's params ride in the state as an argument, so every
    # instance of one parametric NLP compiles to the same (cached) program
    state0 = canonicalize_state(make_initial_sqp_state(prob, ws, opts,
                                                       params=prob.params))
    trace = None
    if history or callbacks is not None:
        stepj = jax.jit(step)
        s = state0
        trace = [s] if history else None
        while int(s.status) == RUNNING:
            s = stepj(s)
            if history:
                trace.append(s)
            if callbacks is not None and hasattr(callbacks, "notify_new_primals"):
                callbacks.notify_new_primals(np.asarray(s.x)[: nlp.n])
            if callbacks is not None and hasattr(callbacks, "notify_new_multipliers"):
                callbacks.notify_new_multipliers(np.asarray(s.y)[: nlp.m])
        final = s
    else:
        final = jax.block_until_ready(run(state0))
    elapsed = time.time() - t0

    f_scale = prob.f_scale
    c_scale = prob.c_scale if prob.c_scale is not None else np.ones(max(ws.m, 1))
    m0 = nlp.m
    x_orig = np.asarray(final.x)[: nlp.n]
    from uno_tpu.solvers.ipm import map_fixed_bound_duals
    y_all = np.asarray(final.y)
    y_full = y_all * c_scale[: y_all.shape[0]] / f_scale
    y = y_full[:m0] if m0 else np.zeros(0)
    zl_out, zu_out = map_fixed_bound_duals(
        nlp, y_full, np.asarray(final.zl)[: nlp.n] / f_scale,
        np.asarray(final.zu)[: nlp.n] / f_scale)
    if callbacks is not None and hasattr(callbacks, "notify_acceptable_iterate"):
        callbacks.notify_acceptable_iterate(x_orig, y, 1.0)
    return Result(
        status=SQP_STATUS_NAMES[int(final.status)],
        x=x_orig, y=y,
        zl=zl_out, zu=zu_out,
        objective=float(nlp.objective(jnp.asarray(x_orig))),
        iterations=int(final.iteration),
        primal_feasibility=float(final.primal_feas),
        stationarity=float(final.stat / final.stat_scaling),
        complementarity=float(final.compl / final.compl_scaling),
        cpu_time=elapsed,
        num_subproblems_solved=int(final.num_qp),
        num_factorizations=int(final.num_hess),
        num_objective_evaluations=int(final.num_obj_evals),
        num_constraint_evaluations=int(final.num_con_evals),
        history=trace,
    )
