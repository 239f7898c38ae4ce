"""Model layer tests: derivatives, masks, reformulations.

Mirrors the role of the reference's unit tests over the numerics core
(SURVEY.md §4) — here the AD layer replaces hand-built sparse structures.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from uno_tpu.model.library import get_problem
from uno_tpu.model import transforms
from uno_tpu.model.nlp import INF, nlp_from_functions, vector_norm


def test_hs015_evaluations():
    nlp = get_problem("hs015")
    x = jnp.array([-2.0, 1.0])
    assert np.isclose(float(nlp.objective(x)), 100.0 * (1 - 4) ** 2 + 9)
    c = nlp.constraints(x)
    assert np.allclose(np.asarray(c), [-2.0, -1.0])
    g = nlp.objective_gradient(x)
    # f = 100(x2-x1^2)^2 + (1-x1)^2 ; df/dx1 = -400 x1 (x2-x1^2) - 2(1-x1)
    assert np.isclose(float(g[0]), -400 * (-2) * (1 - 4) - 2 * 3)
    J = nlp.constraint_jacobian(x)
    assert np.allclose(np.asarray(J), [[1.0, -2.0], [1.0, 2.0]])


def test_lagrangian_hessian_sign_convention():
    # L = sigma f - y^T c (reference AMPLModel.cpp:38-40)
    nlp = get_problem("hs015")
    x = jnp.array([1.0, 2.0])
    y = jnp.array([3.0, 0.5])
    H = np.asarray(nlp.lagrangian_hessian(x, y, sigma=2.0))
    # d2f = [[1200 x1^2-400 x2+2, -400 x1], [-400 x1, 200]]
    d2f = np.array([[1200 * 1 - 800 + 2, -400.0], [-400.0, 200.0]])
    d2c1 = np.array([[0.0, 1.0], [1.0, 0.0]])
    d2c2 = np.array([[0.0, 0.0], [0.0, 2.0]])
    assert np.allclose(H, 2.0 * d2f - 3.0 * d2c1 - 0.5 * d2c2)


def test_hessian_vector_product_matches_dense():
    nlp = get_problem("hs100")
    x = jnp.asarray(nlp.x0) + 0.3
    y = jnp.arange(1.0, 5.0)
    v = jnp.linspace(-1, 1, nlp.n)
    H = nlp.lagrangian_hessian(x, y)
    hv = nlp.lagrangian_hessian_vp(x, y, v)
    assert np.allclose(np.asarray(H @ v), np.asarray(hv), atol=1e-10)


def test_masks():
    nlp = get_problem("hs015")
    assert nlp.has_x_ub.tolist() == [True, False]
    assert nlp.has_x_lb.tolist() == [False, False]
    assert nlp.is_equality.tolist() == [False, False]
    eqp = get_problem("hs006")
    assert eqp.is_equality.tolist() == [True]


def test_constraint_violation_norms():
    nlp = get_problem("hs015")  # c_lb = [1, 0], c_ub = [inf, inf]
    cx = jnp.array([0.5, -2.0])
    assert np.isclose(float(nlp.constraint_violation(cx, "L1")), 0.5 + 2.0)
    assert np.isclose(float(nlp.constraint_violation(cx, "INF")), 2.0)


def test_homogenize():
    nlp = get_problem("hs014")  # one equality (== -1), one inequality (>= 0)
    h = transforms.homogenize(nlp)
    assert h.n == nlp.n + 1  # one slack for the inequality
    assert h.m == 2
    assert h.is_equality.all()
    x = jnp.array([2.0, 2.0, 0.7])
    c = np.asarray(h.constraints(x))
    # eq: (x1 - 2 x2) - (-1) ; ineq: c2(x) - s
    assert np.isclose(c[0], (2 - 4) + 1)
    assert np.isclose(c[1], (-0.25 * 4 - 4 + 1) - 0.7)
    # slack bounds = original constraint bounds
    assert h.x_lb[2] == 0.0 and h.x_ub[2] == INF
    assert h.slack_of_constraint.tolist() == [-1, 2]


def test_fixed_bounds_to_constraints():
    nlp = nlp_from_functions(
        "fx", lambda x: jnp.sum(x ** 2), None,
        x0=[1.0, 2.0], x_lb=[0.5, -1.0], x_ub=[0.5, 1.0],
    )
    t = transforms.fixed_bounds_to_constraints(nlp)
    assert t.m == 1
    assert np.isinf(t.x_lb[0]) and np.isinf(t.x_ub[0])
    assert t.c_lb[0] == 0.5 == t.c_ub[0]
    assert np.isclose(float(t.constraints(jnp.array([0.7, 0.0]))[0]), 0.7)


def test_relax_bounds():
    nlp = get_problem("hs071")
    r = transforms.relax_bounds(nlp, 1e-8)
    assert np.allclose(r.x_lb, nlp.x_lb - 1e-8 * np.maximum(1, np.abs(nlp.x_lb)))
    assert np.allclose(r.x_ub, nlp.x_ub + 1e-8 * np.maximum(1, np.abs(nlp.x_ub)))


def test_scale_model():
    nlp = get_problem("hs015")  # grad f at x0 has inf-norm 2406
    s = transforms.scale_model(nlp, threshold=100.0)
    g = np.asarray(nlp.objective_gradient(jnp.asarray(nlp.x0)))
    expected = min(1.0, 100.0 / np.max(np.abs(g)))
    assert np.isclose(s.f_scale, expected)
    x = jnp.asarray(nlp.x0)
    assert np.isclose(float(s.objective(x)), expected * float(nlp.objective(x)))


def test_ipm_reformulation_chain():
    nlp = get_problem("hs015")
    h = transforms.reformulate_for_interior_point(nlp, 1e-8)
    assert h.m == 2 and h.n == 4  # 2 slacks for 2 inequalities
    assert h.is_equality.all()
    # through-AD Jacobian of the composite: d(c - s)/ds = -1
    J = np.asarray(h.constraint_jacobian(jnp.array([1.0, 1.0, 0.3, 0.4])))
    assert np.isclose(J[0, 2], -1.0) and np.isclose(J[1, 3], -1.0)
    assert np.isclose(J[0, 3], 0.0) and np.isclose(J[1, 2], 0.0)


def test_vmap_over_params():
    # same structure, batched instance data: the batch axis
    def f(x, p):
        return jnp.sum((x - p) ** 2)

    nlp = nlp_from_functions("batched", f, None, x0=[0.0, 0.0],
                             params=jnp.zeros(2))
    xs = jnp.zeros((5, 2))
    ps = jnp.arange(10.0).reshape(5, 2)
    vals = jax.vmap(lambda x, p: nlp.objective(x, p))(xs, ps)
    assert np.allclose(np.asarray(vals), np.sum(ps ** 2, axis=1))
