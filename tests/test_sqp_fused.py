"""Fused (jittable/vmappable) SQP driver tests (solvers/sqp_fused.py).

The round-1 gap: filtersqp/funnelsqp/filterslp ran as host-orchestrated
Python loops and could not ride the batch axis.  These
tests pin (a) correctness vs known optima, (b) agreement with the host
driver, (c) the batched path via solve_batch(preset="filtersqp")."""

import jax.numpy as jnp
import numpy as np
import pytest

import uno_tpu
from uno_tpu.model.library import acceptable_optima, get_problem
from uno_tpu.options import preset
from uno_tpu.solvers.sqp_fused import solve_sqp_fused

CORE = ["hs014", "hs015", "hs016", "hs035", "hs071", "hs100", "polak5"]


@pytest.mark.parametrize("name", CORE)
def test_fused_filtersqp_core(name):
    r = solve_sqp_fused(get_problem(name), preset("filtersqp"))
    assert r.success or r.status == "feasible_small_step", (name, r.status)
    optima = acceptable_optima(name)
    if optima:
        err = min(abs(r.objective - f) / max(1.0, abs(f)) for f in optima)
        assert err <= 1e-4, (name, r.objective, optima)


@pytest.mark.parametrize("pname", ["funnelsqp", "filterslp"])
def test_fused_other_presets(pname):
    tol = 1e-4 if pname == "funnelsqp" else 1e-3  # filterslp: tol 1e-5 preset
    r = uno_tpu.solve(get_problem("hs015"), preset=pname, sqp_driver="fused")
    assert r.success or r.status == "feasible_small_step", r.status
    assert abs(r.objective - 306.5) <= 306.5 * tol


def test_fused_matches_host_driver():
    """Same preset through both drivers lands on the same optimum."""
    nlp = get_problem("hs071")
    r_f = uno_tpu.solve(nlp, preset="filtersqp", sqp_driver="fused")
    r_h = uno_tpu.solve(nlp, preset="filtersqp", sqp_driver="host")
    assert r_f.success and r_h.success
    np.testing.assert_allclose(r_f.objective, r_h.objective, rtol=1e-6)
    np.testing.assert_allclose(r_f.x, r_h.x, atol=1e-4)


def test_fused_restoration_recovers():
    """An infeasible linearization (QP infeasible at the start) enters the
    feasibility phase and recovers (FeasibilityRestoration.cpp:78-119)."""
    from uno_tpu.model.nlp import nlp_from_functions

    # x0 deep inside the excluded disk: the linearized constraint with a
    # small TR is infeasible at x0 (J = 0 there), forcing restoration.
    # NOTE the constraint must be one-sided: the reference relaxes each
    # inequality with ONE elastic on its lower-bound side
    # (l1RelaxedProblem.cpp:72-79), so a range constraint violated on the
    # other side is unrepairable by restoration — reference-faithful.
    def f(x):
        return (x[0] - 2.0) ** 2 + (x[1] - 2.0) ** 2

    def c(x):
        return jnp.array([x[0] ** 2 + x[1] ** 2])

    # start near (not at) the disk center: at the exact center grad(c) = 0
    # and the center is a genuine stationary point of the infeasibility
    nlp = nlp_from_functions(
        "ring", f, c, x0=[0.1, 0.0], c_lb=[1.0], c_ub=[jnp.inf])
    r = solve_sqp_fused(nlp, preset("filtersqp", TR_radius=0.5))
    assert r.success, r.status
    assert r.primal_feasibility <= 1e-6


def test_fused_unconstrained():
    r = solve_sqp_fused(get_problem("hs038"), preset("filtersqp"))
    assert r.success
    assert r.objective <= 1e-6


def test_fused_infeasible_detected():
    from uno_tpu.model.nlp import nlp_from_functions

    def f(x):
        return x[0]

    def c(x):
        return jnp.array([x[0] ** 2 + 1.0])  # >= 0 always; c <= 0 impossible

    nlp = nlp_from_functions("infeas", f, c, x0=[1.0],
                             c_lb=[-jnp.inf], c_ub=[0.0])
    r = solve_sqp_fused(nlp, preset("filtersqp", max_iterations=200))
    assert r.status in ("infeasible_stationary_point",
                        "infeasible_small_step"), r.status


def test_batched_filtersqp():
    """solve_batch(preset='filtersqp') works
    and matches per-instance solves."""
    from uno_tpu.solvers.batch import solve_batch
    from uno_tpu.model.nlp import nlp_from_functions, INF

    def f(x, p):
        return jnp.sum((x - p) ** 2)

    def c(x, p):
        return jnp.array([jnp.sum(x) - 1.0])

    nlp = nlp_from_functions(
        "batchfam", f, c, x0=np.full(4, 0.5),
        x_lb=np.zeros(4), x_ub=np.full(4, INF),
        c_lb=[0.0], c_ub=[INF], params=np.zeros(4))
    rng = np.random.default_rng(3)
    B = 16
    params = rng.uniform(-0.5, 1.0, (B, 4))
    x0 = np.tile(np.full(4, 0.5), (B, 1))
    res = solve_batch(nlp, x0_batch=x0, params_batch=jnp.asarray(params),
                      preset="filtersqp")
    assert res.num_solved == B, res.status_names()
    # spot-check three instances against single solves
    import dataclasses
    for i in (0, 7, 15):
        single = uno_tpu.solve(
            dataclasses.replace(nlp, params=jnp.asarray(params[i])),
            preset="filtersqp")
        np.testing.assert_allclose(res.objective[i], single.objective,
                                   rtol=1e-5, atol=1e-8)


def test_batched_funnelsqp():
    from uno_tpu.solvers.batch import solve_batch
    from uno_tpu.model.nlp import nlp_from_functions, INF

    def f(x, p):
        return jnp.sum((x - p) ** 2) + 0.1 * x[0] * x[1]

    def c(x, p):
        return jnp.array([jnp.sum(x * x) - 1.0])

    nlp = nlp_from_functions(
        "batchfam2", f, c, x0=np.full(3, 0.5),
        c_lb=[-INF], c_ub=[0.0], params=np.zeros(3))
    rng = np.random.default_rng(5)
    B = 8
    params = rng.uniform(-0.5, 1.0, (B, 3))
    res = solve_batch(nlp, x0_batch=np.tile(np.full(3, 0.5), (B, 1)),
                      params_batch=jnp.asarray(params), preset="funnelsqp")
    assert res.num_solved == B, res.status_names()


# ---------------------------------------------------------------------------
# fused byrd (LS + l1 merit + Sl1QP steering), round 2: the last
# host-driven preset joins the batch axis
# ---------------------------------------------------------------------------

BYRD_CORE = ["hs014", "hs015", "hs021", "hs035", "hs071", "hs100", "polak5"]


@pytest.mark.parametrize("name", BYRD_CORE)
def test_fused_byrd_core(name):
    from uno_tpu.solvers.sqp_fused import solve_byrd_fused
    r = solve_byrd_fused(get_problem(name), preset("byrd", max_iterations=500))
    assert r.success, (name, r.status)
    optima = acceptable_optima(name)
    if optima:
        err = min(abs(r.objective - f) / max(1.0, abs(f)) for f in optima)
        assert err <= 1e-4, (name, r.objective, optima)


def test_fused_byrd_routed_by_default():
    """preset='byrd' routes to the fused driver (sqp_driver='auto')."""
    r = uno_tpu.solve(get_problem("hs035"), preset="byrd")
    assert r.success
    # the fused driver counts steering QPs in num_subproblems_solved
    assert r.num_subproblems_solved >= r.iterations


def test_fused_byrd_matches_host_driver():
    nlp = get_problem("hs071")
    r_f = uno_tpu.solve(nlp, preset="byrd", sqp_driver="fused")
    r_h = uno_tpu.solve(nlp, preset="byrd", sqp_driver="host")
    assert r_f.success and r_h.success
    np.testing.assert_allclose(r_f.objective, r_h.objective, rtol=1e-5)
    np.testing.assert_allclose(r_f.x, r_h.x, atol=1e-3)


def test_fused_byrd_unconstrained():
    r = uno_tpu.solve(get_problem("hs038"), preset="byrd", max_iterations=500)
    assert r.success
    assert r.objective <= 1e-6


def test_fused_byrd_infeasible_detected():
    from uno_tpu.model.nlp import nlp_from_functions

    def f(x):
        return x[0]

    def c(x):
        return jnp.array([x[0] ** 2 + 1.0])  # c <= 0 impossible

    nlp = nlp_from_functions("infeas_b", f, c, x0=[1.0],
                             c_lb=[-jnp.inf], c_ub=[0.0])
    r = uno_tpu.solve(nlp, preset="byrd", max_iterations=200)
    assert r.status in ("infeasible_stationary_point",
                        "infeasible_small_step"), r.status


def test_batched_byrd():
    """byrd rides the batch axis: solve_batch(preset='byrd') matches
    per-instance solves."""
    from uno_tpu.solvers.batch import solve_batch
    from uno_tpu.model.nlp import nlp_from_functions, INF

    def f(x, p):
        return jnp.sum((x - p) ** 2)

    def c(x, p):
        return jnp.array([jnp.sum(x) - 1.0])

    nlp = nlp_from_functions(
        "batchfam_b", f, c, x0=np.full(4, 0.5),
        x_lb=np.zeros(4), x_ub=np.full(4, INF),
        c_lb=[0.0], c_ub=[INF], params=np.zeros(4))
    rng = np.random.default_rng(11)
    B = 8
    params = rng.uniform(-0.5, 1.0, (B, 4))
    res = solve_batch(nlp, x0_batch=np.tile(np.full(4, 0.5), (B, 1)),
                      params_batch=jnp.asarray(params), preset="byrd")
    assert res.num_solved == B, res.status_names()
    import dataclasses
    for i in (0, 5):
        single = uno_tpu.solve(
            dataclasses.replace(nlp, params=jnp.asarray(params[i])),
            preset="byrd")
        np.testing.assert_allclose(res.objective[i], single.objective,
                                   rtol=1e-5, atol=1e-8)
