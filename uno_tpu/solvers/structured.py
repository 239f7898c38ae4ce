"""Structured IPM for two-stage scenario NLPs over the distributed Schur KKT.

BASELINE.md config 5: "block-arrow structured NLP (multi-scenario stochastic
NLP) with distributed Schur-complement KKT".  Problems of the form

    min  f0(x0) + sum_s fs(x0, x_s, p_s)
    s.t. cs(x0, x_s, p_s) = 0          (m per scenario, equalities)
         lb <= (x0, x_s) <= ub

The KKT system of the barrier subproblem is block-arrow: one
(ns+m) x (ns+m) saddle block per scenario coupled through the n0 first-stage
variables — exactly the structure `parallel/schur.py` factorizes with one
scenario block per device and a psum'ed Schur complement over ICI.

Algorithm (a deliberately lean structured member of the ingredient family):
monotone Fiacco-McCormick barrier, primal-dual Newton steps through the
Schur-complement KKT with Haynsworth-inertia delta-correction, fraction-to-
boundary steps, residual-based backtracking (reject steps whose true KKT
error explodes), and a two-phase feasibility restoration mirroring the
reference's FeasibilityRestoration (reference
uno/ingredients/constraint_relaxation_strategies/FeasibilityRestoration.cpp:
78-143): when the line search or inertia correction fails, switch to
minimizing sum_s 0.5*||c_s||^2 under the same barrier.  The restoration
phase reuses the identical block-arrow structure by writing the
Gauss-Newton least-squares step in saddle form with an elastic -I (2,2)
block ([[H_curv+Sigma, J^T],[J, -I]] condenses to
H_curv+Sigma+J^T J = exact Hessian of 0.5||c||^2 plus barrier), so one jit
program serves both phases via (rho, sigma) objective weights — the
functional-state-machine analogue of the reference's dual ingredient sets
(FeasibilityRestoration.cpp:26-37).  Convergence of the restoration phase at
a point that is still infeasible is reported as status "infeasible"
(local infeasibility certificate, as in the reference's restoration failure).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh

from uno_tpu.ingredients import barrier as bar
from uno_tpu.model.nlp import vector_norm
from uno_tpu.options import Options
from uno_tpu.parallel.schur import (make_sharded_schur_solver, schur_factor,
                                    schur_solve)

LARGE = 1e25


@dataclass(frozen=True)
class ScenarioNLP:
    """Two-stage stochastic NLP specification (all callables pure JAX)."""
    name: str
    n0: int                  # first-stage variables
    ns: int                  # second-stage variables per scenario
    m: int                   # equality constraints per scenario
    S: int                   # number of scenarios
    f0: Callable             # f0(x0) -> scalar
    fs: Callable             # fs(x0, xs, p_s) -> scalar
    cs: Callable             # cs(x0, xs, p_s) -> (m,)
    x0_lb: np.ndarray
    x0_ub: np.ndarray
    xs_lb: np.ndarray        # (ns,), shared across scenarios
    xs_ub: np.ndarray
    x0_init: np.ndarray
    xs_init: np.ndarray      # (S, ns)
    params: Any              # pytree with leading scenario axis (S, ...)

    def objective(self, x0, xs):
        per = jax.vmap(lambda x, p: self.fs(x0, x, p))(xs, self.params)
        return self.f0(x0) + jnp.sum(per)

    def constraints(self, x0, xs):
        return jax.vmap(lambda x, p: self.cs(x0, x, p))(xs, self.params)  # (S, m)


class StructuredResult(NamedTuple):
    status: str
    x0: np.ndarray
    xs: np.ndarray
    y: np.ndarray
    objective: float
    iterations: int
    kkt_error: float
    cpu_time: float


def solve_structured_ipm(snlp: ScenarioNLP, opts: Optional[Options] = None,
                         tol: float = 1e-8, max_iterations: int = 200,
                         mesh: Optional[Mesh] = None):
    """Jitted structured barrier solver.  The Schur reduction runs as
    batched (vmapped) block algebra on one device, or — given a 1-D `mesh`
    whose axis is named "scenario" — as the shard_map'ed solver of
    parallel/schur.py with the scenario blocks split over the devices
    (S must be a multiple of the mesh size)."""
    opts = opts or Options()
    t_start = time.time()
    n0, ns, m, S = snlp.n0, snlp.ns, snlp.m, snlp.S
    nb = ns + m

    if mesh is None:
        def schur_factor_solve(Ks, Bs, K0, rhs_s, rhs0):
            fac = schur_factor(Ks, Bs, K0)
            xs, x0 = schur_solve(fac, Bs, rhs_s, rhs0)
            return xs, x0, fac.num_pos, fac.num_neg, fac.num_zero
    else:
        schur_factor_solve = make_sharded_schur_solver(mesh, nb, n0)

    lb0 = jnp.asarray(np.where(np.isfinite(snlp.x0_lb), snlp.x0_lb, -LARGE))
    ub0 = jnp.asarray(np.where(np.isfinite(snlp.x0_ub), snlp.x0_ub, LARGE))
    lbs = jnp.asarray(np.where(np.isfinite(snlp.xs_lb), snlp.xs_lb, -LARGE))
    ubs = jnp.asarray(np.where(np.isfinite(snlp.xs_ub), snlp.xs_ub, LARGE))
    h0l = jnp.asarray(np.isfinite(snlp.x0_lb))
    h0u = jnp.asarray(np.isfinite(snlp.x0_ub))
    hsl = jnp.asarray(np.isfinite(snlp.xs_lb))
    hsu = jnp.asarray(np.isfinite(snlp.xs_ub))

    def lag_s(x0, xs, y, p, rho, sigma):
        # phase-weighted scenario Lagrangian (sign convention: L = f - y^T c).
        # sigma*dot(stop_grad(c), c) contributes exactly J^T c to the gradient
        # and sum_j c_j * hess(c_j) (the LS curvature term) to the Hessian —
        # the Gauss-Newton J^T J part comes from the -sigma*I elastic block.
        c = snlp.cs(x0, xs, p)
        return rho * (snlp.fs(x0, xs, p) - jnp.dot(y, c)) \
            + sigma * jnp.dot(lax.stop_gradient(c), c)

    # per-scenario derivative bundles
    def scenario_derivs(x0, xs, y, p, rho, sigma):
        g_xs = jax.grad(lag_s, argnums=1)(x0, xs, y, p, rho, sigma)
        g_x0 = jax.grad(lag_s, argnums=0)(x0, xs, y, p, rho, sigma)
        c = snlp.cs(x0, xs, p)
        J_s = jax.jacfwd(snlp.cs, argnums=1)(x0, xs, p)      # (m, ns)
        J_0 = jax.jacfwd(snlp.cs, argnums=0)(x0, xs, p)      # (m, n0)
        H_ss = jax.hessian(lag_s, argnums=1)(x0, xs, y, p, rho, sigma)
        H_s0 = jax.jacfwd(jax.grad(lag_s, argnums=1), argnums=0)(
            x0, xs, y, p, rho, sigma)                        # (ns, n0)
        H_00 = jax.hessian(lambda z: lag_s(z, xs, y, p, rho, sigma))(x0)
        return g_xs, g_x0, c, J_s, J_0, H_ss, H_s0, H_00

    def step(carry):
        (x0, xs, y, z0l, z0u, zsl, zsu, mu, delta, it, err, phase, h_switch,
         infeasible, done) = carry
        rho = 1.0 - phase
        sigma = phase
        # barrier quantities
        Sig0 = bar.barrier_hessian_diag(x0, z0l, z0u, lb0, ub0, h0l, h0u)
        gbar0 = bar.barrier_gradient(x0, lb0, ub0, h0l, h0u, mu, 0.0)
        Sigs = jax.vmap(lambda x, zl, zu: bar.barrier_hessian_diag(
            x, zl, zu, lbs, ubs, hsl, hsu))(xs, zsl, zsu)
        gbars = jax.vmap(lambda x: bar.barrier_gradient(
            x, lbs, ubs, hsl, hsu, mu, 0.0))(xs)

        g_xs, g_x0, c, J_s, J_0, H_ss, H_s0, H_00 = jax.vmap(
            lambda xsi, yi, pi: scenario_derivs(x0, xsi, yi, pi, rho, sigma)
        )(xs, y, snlp.params)

        gf0 = jax.grad(snlp.f0)(x0)
        # rhs gradients must EXCLUDE the sigma*J^T c term (the -sigma*I
        # elastic block regenerates it in the condensed system)
        g_xs_rhs = g_xs - sigma * jnp.einsum("smn,sm->sn", J_s, c)
        g_x0_rhs = g_x0 - sigma * jnp.einsum("smn,sm->sn", J_0, c)

        def assemble_and_solve(dlt):
            # scenario blocks [[H_ss+Sig+dlt, J_s^T],[J_s, -sigma I]],
            # coupling [[H_s0],[J_0]], first-stage H_00 total
            Ks = jnp.concatenate([
                jnp.concatenate([H_ss + jax.vmap(jnp.diag)(Sigs)
                                 + dlt * jnp.eye(ns)[None], jnp.swapaxes(J_s, 1, 2)], axis=2),
                jnp.concatenate([J_s, -sigma * jnp.eye(m)[None]
                                 * jnp.ones((S, 1, 1))], axis=2),
            ], axis=1)                                        # (S, nb, nb)
            Bs = jnp.concatenate([H_s0, J_0], axis=1)          # (S, nb, n0)
            K0 = jnp.sum(H_00, axis=0) + rho * jax.hessian(snlp.f0)(x0) \
                + jnp.diag(Sig0) + dlt * jnp.eye(n0)
            # rhs: -(grad Lagrangian + barrier) per block, -(c) for duals;
            # g_xs_rhs already contains -rho J_s^T y (gradient of rho(fs - y^T cs))
            r_xs = g_xs_rhs + gbars
            rhs_s = jnp.concatenate([-(r_xs), -c], axis=1)     # (S, nb)
            r_x0 = rho * gf0 + jnp.sum(g_x0_rhs, axis=0) + gbar0
            rhs_0 = -r_x0
            # Schur-complement factor+solve (parallel/schur.py): vmapped
            # block algebra on one device, or one scenario slice per device
            dblk, dx0, pos, neg, zero = schur_factor_solve(
                Ks, Bs, K0, rhs_s, rhs_0)
            good = (pos == n0 + S * ns) & (neg == S * m) & (zero == 0)
            return dx0, dblk, good

        # Haynsworth-inertia delta correction (bounded fan like the IPM loop)
        def reg_cond(c2):
            _, _, _, good, k = c2
            return (~good) & (k < 12)

        def reg_body(c2):
            dlt, dx0, dblk, good, k = c2
            dx0, dblk, good = assemble_and_solve(dlt)
            next_dlt = jnp.where(good, dlt, jnp.maximum(dlt * 10.0, 1e-6))
            return next_dlt, dx0, dblk, good, k + 1

        dx0_z = jnp.zeros((n0,))
        dblk_z = jnp.zeros((S, nb))
        dlt, dx0, dblk, reg_ok, _ = lax.while_loop(
            reg_cond, reg_body,
            (jnp.maximum(delta / 3.0, 0.0), dx0_z, dblk_z, jnp.asarray(False),
             jnp.asarray(0)))

        dxs = dblk[:, :ns]
        # restoration phase freezes the equality multipliers (the dual block
        # solves for the elastic w, not a y-step)
        dy = -rho * dblk[:, ns:]
        dz0l, dz0u = bar.bound_dual_direction(x0, dx0, z0l, z0u, lb0, ub0, h0l, h0u, mu)
        dzsl, dzsu = jax.vmap(lambda x, dx, zl, zu: bar.bound_dual_direction(
            x, dx, zl, zu, lbs, ubs, hsl, hsu, mu))(xs, dxs, zsl, zsu)

        tau = jnp.maximum(0.99, 1.0 - mu)
        a_p = bar.primal_fraction_to_boundary(x0, dx0, lb0, ub0, h0l, h0u, tau)
        a_p = jnp.minimum(a_p, jnp.min(jax.vmap(
            lambda x, dx: bar.primal_fraction_to_boundary(
                x, dx, lbs, ubs, hsl, hsu, tau))(xs, dxs)))
        a_z = bar.dual_fraction_to_boundary(z0l, z0u, dz0l, dz0u, h0l, h0u, tau)
        a_z = jnp.minimum(a_z, jnp.min(jax.vmap(
            lambda zl, zu, dzl, dzu: bar.dual_fraction_to_boundary(
                zl, zu, dzl, dzu, hsl, hsu, tau))(zsl, zsu, dzsl, dzsu)))

        def trial_error(alpha):
            """phase-aware KKT error at the trial point: optimality phase
            measures the TRUE problem (stationarity, feasibility,
            complementarity); restoration phase measures stationarity of
            min 0.5||c||^2 + barrier (feasibility NOT included — a feasibility
            stationary point with c != 0 is an infeasibility certificate)."""
            x0_t = jnp.clip(x0 + alpha * a_p * dx0, lb0, ub0)
            xs_t = jnp.clip(xs + alpha * a_p * dxs, lbs, ubs)
            y_t = y + alpha * a_p * dy
            z0l_t, z0u_t = z0l + alpha * a_z * dz0l, z0u + alpha * a_z * dz0u
            zsl_t, zsu_t = zsl + alpha * a_z * dzsl, zsu + alpha * a_z * dzsu
            g_xs2, g_x02, c2, *_ = jax.vmap(
                lambda xsi, yi, pi: scenario_derivs(x0_t, xsi, yi, pi, rho, sigma)
            )(xs_t, y_t, snlp.params)
            stat_s = g_xs2 - zsl_t - zsu_t
            stat_0 = rho * jax.grad(snlp.f0)(x0_t) + jnp.sum(g_x02, axis=0) \
                - z0l_t - z0u_t
            compl0 = bar.bound_complementarity_error(
                x0_t, z0l_t, z0u_t, lb0, ub0, h0l, h0u)
            compls = jax.vmap(lambda x, zl, zu: bar.bound_complementarity_error(
                x, zl, zu, lbs, ubs, hsl, hsu))(xs_t, zsl_t, zsu_t)
            h_t = jnp.max(jnp.abs(c2), initial=0.0)
            e = jnp.max(jnp.array([
                jnp.max(jnp.abs(stat_s), initial=0.0),
                jnp.max(jnp.abs(stat_0), initial=0.0),
                rho * h_t,
                jnp.max(jnp.abs(compl0), initial=0.0),
                jnp.max(jnp.abs(compls), initial=0.0),
            ]))
            return e, h_t, (x0_t, xs_t, y_t, z0l_t, z0u_t, zsl_t, zsu_t)

        # residual-based backtracking (the globalization of this lean path):
        # accept alpha when the phase KKT error does not blow past the current
        # one (Newton steps on barrier subproblems transiently raise the
        # unscaled error when mu drops, so a sufficient-decrease test on err
        # alone would reject good steps — gate on non-explosion instead);
        # halve up to 5 times, keep the last trial as the safeguard step
        def ls_cond(c3):
            alpha, e, _, _, k, acc = c3
            return (~acc) & (k < 5)

        def ls_body(c3):
            alpha, _, _, _, k, _ = c3
            e, h_t, tr = trial_error(alpha)
            acc = e <= 10.0 * jnp.maximum(err, 10.0 * mu) + 10.0 * mu
            alpha_next = jnp.where(acc, alpha, alpha * 0.5)
            return alpha_next, e, h_t, tr, k + 1, acc

        e0, h0_t, tr0 = trial_error(1.0)
        acc0 = e0 <= 10.0 * jnp.maximum(err, 10.0 * mu) + 10.0 * mu
        _, err_n, h_n, tr, _, ls_ok = lax.while_loop(
            ls_cond, ls_body,
            (jnp.asarray(0.5), e0, h0_t, tr0, jnp.asarray(0), acc0))
        x0_n, xs_n, y_n, z0l_n, z0u_n, zsl_n, zsu_n = tr

        # ---- phase transitions (functional FeasibilityRestoration) ----
        h_cur = jnp.max(jnp.abs(c), initial=0.0)   # infeasibility at x
        # optimality -> restoration: step computation failed (inertia
        # correction exhausted or line search rejected everything) while
        # still infeasible (reference FeasibilityRestoration.cpp:91-105)
        enter_feas = (phase == 0.0) & ((~reg_ok) | (~ls_ok)) & (h_cur > tol)
        # restoration -> optimality: infeasibility sufficiently reduced
        # (reference can_switch_to_optimality_phase, .cpp:156-162)
        exit_feas = (phase == 1.0) & (h_n <= jnp.maximum(10.0 * tol,
                                                         0.1 * h_switch))
        # restoration converged while infeasible: local infeasibility
        infeasible_n = (phase == 1.0) & (err_n <= jnp.maximum(tol, 1e-8)) \
            & (h_n > 100.0 * tol)

        phase_n = jnp.where(enter_feas, 1.0, jnp.where(exit_feas, 0.0, phase))
        h_switch_n = jnp.where(enter_feas, h_cur, h_switch)
        # on entering restoration: discard the failed trial, keep x, raise mu
        # to the infeasibility level (PrimalDualInteriorPointMethod.cpp:161-181)
        keep = enter_feas
        x0_n = jnp.where(keep, x0, x0_n)
        xs_n = jnp.where(keep, xs, xs_n)
        y_n = jnp.where(keep, y, y_n)
        z0l_n = jnp.where(keep, z0l, z0l_n)
        z0u_n = jnp.where(keep, z0u, z0u_n)
        zsl_n = jnp.where(keep, zsl, zsl_n)
        zsu_n = jnp.where(keep, zsu, zsu_n)
        mu_after = jnp.where(enter_feas,
                             jnp.clip(jnp.maximum(mu, h_cur), mu, 10.0), mu)
        # phase switches reset the error reference (errors of the two phases
        # are not comparable)
        err_n = jnp.where(enter_feas | exit_feas, jnp.asarray(jnp.inf), err_n)

        mu_n = jnp.where((~enter_feas) & (err_n <= 10.0 * mu_after),
                         jnp.maximum(tol / 10.0,
                                     jnp.minimum(0.2 * mu_after,
                                                 jnp.power(mu_after, 1.5))),
                         mu_after)
        done = ((phase_n == 0.0) & (err_n <= tol)) | infeasible_n
        return (x0_n, xs_n, y_n, z0l_n, z0u_n, zsl_n, zsu_n, mu_n, dlt,
                it + 1, err_n, phase_n, h_switch_n, infeasible_n, done)

    # initial point
    k1 = opts.barrier_push_variable_to_interior_k1
    k2 = opts.barrier_push_variable_to_interior_k2
    x0_0 = bar.push_to_interior(jnp.asarray(snlp.x0_init, dtype=jnp.float64),
                                lb0, ub0, k1, k2)
    xs_0 = jax.vmap(lambda x: bar.push_to_interior(
        jnp.asarray(x, dtype=jnp.float64), lbs, ubs, k1, k2))(
            jnp.asarray(snlp.xs_init, dtype=jnp.float64))
    init = (x0_0, xs_0, jnp.zeros((S, m)),
            jnp.where(h0l, 1.0, 0.0), jnp.where(h0u, -1.0, 0.0),
            jnp.broadcast_to(jnp.where(hsl, 1.0, 0.0), (S, ns)),
            jnp.broadcast_to(jnp.where(hsu, -1.0, 0.0), (S, ns)),
            jnp.asarray(0.1), jnp.asarray(0.0), jnp.asarray(0),
            jnp.asarray(jnp.inf), jnp.asarray(0.0), jnp.asarray(0.0),
            jnp.asarray(False), jnp.asarray(False))

    @jax.jit
    def run(carry):
        return lax.while_loop(
            lambda c: (~c[-1]) & (c[9] < max_iterations), step, carry)

    final = jax.block_until_ready(run(init))
    x0_f, xs_f, y_f = final[0], final[1], final[2]
    err = float(final[10])
    iters = int(final[9])
    infeasible = bool(final[13])
    obj = float(snlp.objective(x0_f, xs_f))
    if infeasible:
        status = "infeasible"
    elif err <= tol:
        status = "optimal"
    else:
        status = "iteration_limit"
    return StructuredResult(
        status=status,
        x0=np.asarray(x0_f), xs=np.asarray(xs_f), y=np.asarray(y_f),
        objective=obj, iterations=iters, kkt_error=err,
        cpu_time=time.time() - t_start)
