"""Batched + sharded solver tests (8 virtual CPU devices, conftest)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import uno_tpu
from uno_tpu.model.nlp import nlp_from_functions, INF
from uno_tpu.model.library import get_problem
from uno_tpu.options import preset
from uno_tpu.solvers.batch import solve_batch
from uno_tpu.parallel import make_mesh, solve_batch_sharded


def batched_qp_nlp():
    """Parametrized constrained problem: min (x1-a)^2 + (x2-b)^2
    s.t. x1 + x2 >= 1, x >= 0.  Closed-form-checkable."""
    def f(x, p):
        return (x[0] - p[0]) ** 2 + (x[1] - p[1]) ** 2

    def c(x, p):
        return jnp.array([x[0] + x[1]])

    return nlp_from_functions(
        "param_qp", f, c, x0=[0.5, 0.5],
        x_lb=[0.0, 0.0], x_ub=[INF, INF],
        c_lb=[1.0], c_ub=[INF], params=jnp.zeros(2))


def reference_solution(a, b):
    # projection of (a, b) onto {x >= 0, x1 + x2 >= 1} via scipy
    from scipy.optimize import minimize
    r = minimize(lambda x: (x[0] - a) ** 2 + (x[1] - b) ** 2, [0.5, 0.5],
                 method="SLSQP", bounds=[(0, None), (0, None)],
                 constraints=[{"type": "ineq", "fun": lambda x: x[0] + x[1] - 1}],
                 options={"ftol": 1e-12})
    return r.x


def test_vmapped_batch_different_instances():
    nlp = batched_qp_nlp()
    opts = preset("ipopt", scale_functions=False)
    rng = np.random.default_rng(0)
    B = 16
    ab = rng.uniform(-1.0, 2.0, (B, 2))
    x0 = np.tile([0.5, 0.5], (B, 1))
    res = solve_batch(nlp, opts, x0, jnp.asarray(ab))
    assert res.num_solved == B, res.status_names()
    for i in range(B):
        x_ref = reference_solution(*ab[i])
        assert np.allclose(res.x[i], x_ref, atol=1e-5), (i, res.x[i], x_ref)


def test_batch_mixed_convergence_iterations():
    """Instances take different iteration counts; all must converge with
    per-instance masks (vmapped while_loop)."""
    nlp = batched_qp_nlp()
    opts = preset("ipopt", scale_functions=False)
    ab = np.array([[0.0, 0.0], [5.0, 5.0], [-3.0, 0.2], [0.9, 0.9]])
    x0 = np.tile([0.5, 0.5], (4, 1))
    res = solve_batch(nlp, opts, x0, jnp.asarray(ab))
    assert res.num_solved == 4
    assert len(set(res.iterations.tolist())) > 1  # genuinely different counts


def test_batch_same_as_single():
    nlp = batched_qp_nlp()
    opts = preset("ipopt", scale_functions=False)
    ab = np.array([[1.5, -0.5]])
    res_b = solve_batch(nlp, opts, np.array([[0.5, 0.5]]), jnp.asarray(ab))
    import dataclasses
    nlp1 = dataclasses.replace(nlp, params=jnp.asarray(ab[0]))
    res_s = uno_tpu.solve(nlp1, options=opts)
    assert np.allclose(res_b.x[0], res_s.x, atol=1e-8)


def test_sharded_batch_over_mesh():
    assert jax.device_count() >= 8, "conftest should provide 8 virtual devices"
    nlp = batched_qp_nlp()
    opts = preset("ipopt", scale_functions=False)
    rng = np.random.default_rng(1)
    B = 32  # 4 per device
    ab = rng.uniform(-1.0, 2.0, (B, 2))
    x0 = np.tile([0.5, 0.5], (B, 1))
    mesh = make_mesh()
    res = solve_batch_sharded(nlp, opts, x0, jnp.asarray(ab), mesh=mesh)
    assert res.num_solved == B
    for i in range(0, B, 7):
        assert np.allclose(res.x[i], reference_solution(*ab[i]), atol=1e-5)


def test_batch_x0_only():
    """Batch over starting points of a fixed nonconvex instance (hs016):
    different basins, all KKT."""
    nlp = get_problem("hs006")
    opts = preset("ipopt", scale_functions=False)
    x0 = np.array([[-1.2, 1.0], [2.0, 2.0], [0.0, 0.0], [5.0, -3.0]])
    res = solve_batch(nlp, opts, x0)
    assert res.num_solved == 4
    assert np.all(np.abs(res.objective) < 1e-6)


def test_bucketed_matches_plain_batch():
    """Iteration-count bucketing must produce the same solutions as the
    plain vmapped driver (it runs the identical step program, only compacting
    converged lanes away between segments)."""
    from uno_tpu.solvers.batch import build_batch_ipm, build_bucketed_batch_ipm
    nlp = batched_qp_nlp()
    opts = preset("ipopt", scale_functions=False)
    rng = np.random.default_rng(7)
    B = 32
    ab = jnp.asarray(rng.uniform(-2.0, 3.0, (B, 2)))
    x0 = jnp.tile(jnp.asarray([0.5, 0.5]), (B, 1))

    _, run_plain = build_batch_ipm(nlp, opts, params_example=ab[0])
    _, run_buck = build_bucketed_batch_ipm(nlp, opts, params_example=ab[0],
                                           segment=3, min_bucket=4)
    fp = jax.block_until_ready(run_plain(x0, ab))
    fb = jax.block_until_ready(run_buck(x0, ab))
    assert np.array_equal(np.asarray(fp.status), np.asarray(fb.status))
    assert np.array_equal(np.asarray(fp.iteration), np.asarray(fb.iteration))
    np.testing.assert_allclose(np.asarray(fp.x), np.asarray(fb.x),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("preset_name", ["filtersqp", "byrd"])
def test_bucketed_sqp_matches_plain_batch(preset_name):
    """SQP-axis retirement (round-4): the bucketed fused-SQP driver must
    reproduce the plain vmapped driver exactly — identical step program,
    converged lanes merely compacted away between segments."""
    from uno_tpu.solvers.batch import build_batch_sqp, build_bucketed_batch_sqp
    nlp = batched_qp_nlp()
    opts = preset(preset_name, scale_functions=False)
    rng = np.random.default_rng(3)
    B = 24
    ab = jnp.asarray(rng.uniform(-2.0, 3.0, (B, 2)))
    x0 = jnp.tile(jnp.asarray([0.5, 0.5]), (B, 1))

    _, run_plain = build_batch_sqp(nlp, opts, params_example=ab[0])
    _, run_buck = build_bucketed_batch_sqp(nlp, opts, params_example=ab[0],
                                           segment=5, min_bucket=4)
    fp = jax.block_until_ready(run_plain(x0, ab))
    fb = jax.block_until_ready(run_buck(x0, ab))
    assert np.array_equal(np.asarray(fp.status), np.asarray(fb.status))
    assert np.array_equal(np.asarray(fp.iteration), np.asarray(fb.iteration))
    np.testing.assert_allclose(np.asarray(fp.x), np.asarray(fb.x),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("pname,module,builder", [
    ("ipopt", "uno_tpu.solvers.ipm", "build_ipm"),
    ("filtersqp", "uno_tpu.solvers.sqp_fused", "build_sqp_fused"),
    ("byrd", "uno_tpu.solvers.sqp_fused", "build_byrd_fused"),
])
def test_solve_lowers_one_program_per_parametric_nlp(monkeypatch, pname,
                                                     module, builder):
    """Instances of one parametric NLP differ only in their params, which
    ride in the solver state as an argument: uno_tpu.solve lowers the same
    program for each, so the compile cache serves every instance after the
    first."""
    import dataclasses
    import importlib

    mod = importlib.import_module(module)
    orig = getattr(mod, builder)
    lowered = []

    def spy(*args, **kwargs):
        prob, ws, step, run = orig(*args, **kwargs)

        def run_spy(state):
            lowered.append(run.lower(state).as_text())
            return run(state)

        return prob, ws, step, run_spy

    monkeypatch.setattr(mod, builder, spy)
    nlp = batched_qp_nlp()
    for a, b in ((0.2, 0.3), (1.5, -0.4)):
        inst = dataclasses.replace(nlp, params=jnp.asarray([a, b]))
        r = uno_tpu.solve(inst, preset=pname, scale_functions=False)
        assert r.success or r.status == "feasible_small_step", r.status
    assert len(lowered) == 2 and lowered[0] == lowered[1]
