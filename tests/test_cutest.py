"""Scalable CUTEst-family tier (model/library_cutest.py).

Mirrors the reference's external CUTEst benchmark role (SURVEY.md §4,
/root/reference/README.md:82-89): every family is checked for well-formedness
at its smallest size; a representative core solves end-to-end through the
fused IPM at n≈10 in the default run; the full (family × size) matrix up to
n=1000 runs under --runslow and in tools/sweep.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import uno_tpu
from uno_tpu.model import library_cutest as lc
from uno_tpu.model.library import acceptable_optima, get_problem

FAMILIES = lc.family_names()

# fast-tier end-to-end core: one family per structural class
E2E_CORE = ["srosenbr", "tridia", "lukvle1", "lukvli1", "sphere_proj",
            "structqp", "hager1", "biggsb1", "catena", "chainrosen_ineq"]


@pytest.mark.parametrize("name", FAMILIES)
def test_family_wellformed(name):
    builder, f_star, sizes, min_n, _locs = lc._FAMILIES[name]
    nlp = builder(max(10, min_n))
    assert nlp.n >= 1 and nlp.m >= 0
    x0 = jnp.asarray(np.clip(
        nlp.x0, np.where(np.isfinite(nlp.x_lb), nlp.x_lb, -1e20),
        np.where(np.isfinite(nlp.x_ub), nlp.x_ub, 1e20)))
    assert np.isfinite(float(nlp.objective(x0)))
    assert np.all(np.isfinite(np.asarray(nlp.objective_gradient(x0))))
    if nlp.m:
        assert np.asarray(nlp.constraints(x0)).shape == (nlp.m,)
        assert np.all(np.isfinite(np.asarray(nlp.constraint_jacobian(x0))))


def _solve_and_check(name, n, preset="ipopt", rtol=1e-4):
    builder, f_star, sizes, min_n, _locs = lc._FAMILIES[name]
    nlp = builder(n)
    res = uno_tpu.solve(nlp, preset=preset)
    ok = res.success or (res.status == "feasible_small_step"
                         and res.primal_feasibility <= 1e-5)
    assert ok, f"{name}_n{n}: {res.status}"
    fs = f_star(n) if callable(f_star) else f_star
    if fs is not None:
        err = abs(res.objective - fs) / max(1.0, abs(fs))
        assert err <= rtol, f"{name}_n{n}: f={res.objective} vs {fs}"
    return res


@pytest.mark.parametrize("name", E2E_CORE)
def test_e2e_ipopt_small(name):
    _solve_and_check(name, max(10, lc._FAMILIES[name][3]))


@pytest.mark.slow
@pytest.mark.parametrize("name", [n for n in FAMILIES if n not in E2E_CORE])
def test_e2e_ipopt_small_rest(name):
    _solve_and_check(name, max(10, lc._FAMILIES[name][3]))


@pytest.mark.slow
@pytest.mark.parametrize("name", FAMILIES)
def test_e2e_ipopt_n100(name):
    _solve_and_check(name, 100)


def test_scalable_instances_registered():
    """Every (family, size) pair is reachable through the main registry."""
    from uno_tpu.model.library import problem_names
    names = set(problem_names())
    count = 0
    for fam in FAMILIES:
        sizes = lc._FAMILIES[fam][2]
        for n in sizes:
            if n >= lc._FAMILIES[fam][3]:
                # registry keys use the ACTUAL built size (builders snap
                # grids to g*g, control families to stage counts — advisor
                # round-2 finding)
                actual = lc.cutest_problem(fam, n).n
                assert f"{fam}_n{actual}" in names, (fam, n, actual)
                count += 1
    assert count >= 100  # corpus width guarantee
    nlp = get_problem("srosenbr_n100")
    assert nlp.n == 100


def test_sphere_proj_analytic_optimum():
    """sphere_proj has an exact analytic optimum: f* = (||a||-1)^2/2."""
    res = _solve_and_check("sphere_proj", 100, rtol=1e-6)
    a = np.random.default_rng(100).standard_normal(100)
    fs = 0.5 * (np.linalg.norm(a) - 1.0) ** 2
    assert abs(res.objective - fs) <= 1e-6 * max(1.0, fs)


@pytest.mark.parametrize("name", ["lukvle1", "structqp"])
def test_cross_validate_scipy(name):
    """Cross-validate a constrained family against scipy SLSQP: both must be
    feasible; on the CONVEX family (structqp) the objectives must agree
    (nonconvex lukvle1 may legitimately reach a different local minimum)."""
    from scipy.optimize import NonlinearConstraint, minimize

    nlp = lc._FAMILIES[name][0](12)
    res = uno_tpu.solve(nlp, preset="ipopt")
    assert res.success

    cons = [NonlinearConstraint(
        lambda x: np.asarray(nlp.constraints(jnp.asarray(x))),
        np.asarray(nlp.c_lb), np.asarray(nlp.c_ub),
        jac=lambda x: np.asarray(nlp.constraint_jacobian(jnp.asarray(x))))]
    bounds = [(None if lb < -1e19 else lb, None if ub > 1e19 else ub)
              for lb, ub in zip(nlp.x_lb, nlp.x_ub)]
    r = minimize(lambda x: float(nlp.objective(jnp.asarray(x))), nlp.x0,
                 jac=lambda x: np.asarray(nlp.objective_gradient(jnp.asarray(x))),
                 method="SLSQP", constraints=cons, bounds=bounds,
                 options={"maxiter": 300, "ftol": 1e-12})
    assert res.primal_feasibility <= 1e-6
    if r.success:
        cvals = np.asarray(nlp.constraints(jnp.asarray(r.x)))
        viol = np.max(np.maximum(cvals - nlp.c_ub, 0.0)
                      + np.maximum(nlp.c_lb - cvals, 0.0))
        assert viol <= 1e-5
        if name == "structqp":  # convex: unique optimum, objectives agree
            assert abs(res.objective - r.fun) <= 1e-5 * max(1.0, abs(r.fun))
