"""NLP model specification with exact derivatives via JAX AD.

This is the TPU-native replacement for the reference's model layer
(/root/reference/uno/model/Model.hpp:36-98) and its ASL bindings
(/root/reference/bindings/AMPL/AMPLModel.cpp): instead of a C library
evaluating `.nl` expression graphs, the user provides pure JAX callables
`f(x, params)` and `c(x, params)`; gradients, Jacobians and the Lagrangian
Hessian come from jax.grad / jax.jacfwd / jax.hessian and fuse into the
solver's jitted program.

The reference's index-set Collections (lower/upper/single-bounded variables,
equality/inequality constraints, Model.hpp:60-75) become static boolean masks
computed from the bound arrays — XLA-friendly, vmappable.

Sign convention (matches reference AMPLModel.cpp:38-40, lagscale_ASL(-1)):
    L(x, y, z) = sigma * f(x) - y^T c(x) - zL^T (x - xL) - zU^T (x - xU)
so stationarity reads  sigma*grad f - J^T y - zL - zU = 0  with zL >= 0, zU <= 0.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

INF = np.inf
# |bound| at or above this value is "infinite" (mirrors ASL convention of 1e20)
DEFAULT_BOUND_INFINITY = 1e20


@dataclass(frozen=True)
class NLPStructure:
    """Static sparsity structure declared on the model — the TPU-native
    analogue of the symbolic information ASL gives the reference's sparse
    solvers (AMPLModel.cpp:151-177 Hessian sparsity; MA57Solver.cpp:40-90
    symbolic analysis).  Declares a BANDED Lagrangian Hessian and WINDOWED
    Jacobian rows, which cover the dominant large-CUTEst structure (chained
    sums, discretized 1-D/2-D operators, control staircases) and let the
    solver assemble O(n) and factorize O(n*b^2) (linalg/banded_kkt.py).

    hess_bandwidth: half-bandwidth b of grad^2_xx L (entries (i,j) with
        |i-j| > b are identically zero for every (x, y)).
    jac_starts: (m,) first column possibly touched by constraint row i; the
        row's nonzeros must lie within [jac_starts[i], jac_starts[i]+jac_width).
    jac_width: uniform window width (0 when m == 0).
    jac_col_limit: columns >= this index are NOT probed during windowed
        extraction (set by the homogenize transform to exclude analytic
        slack columns).  None = all columns.
    """
    hess_bandwidth: int
    jac_starts: Optional[np.ndarray] = None
    jac_width: int = 0
    jac_col_limit: Optional[int] = None


@dataclass(frozen=True)
class NLP:
    """A smooth NLP:  min f(x)  s.t.  c_lb <= c(x) <= c_ub,  x_lb <= x <= x_ub.

    `f` and `c` are pure JAX functions of (x, params); `params` is an arbitrary
    pytree of arrays, which is the batch axis for vmapped multi-instance
    solves (same structure, different data).  m == 0 is allowed (c returns a
    (0,) array).
    """

    name: str
    n: int
    m: int
    f: Callable[[jnp.ndarray, Any], jnp.ndarray]
    c: Callable[[jnp.ndarray, Any], jnp.ndarray]
    x_lb: np.ndarray
    x_ub: np.ndarray
    c_lb: np.ndarray
    c_ub: np.ndarray
    x0: np.ndarray
    y0: Optional[np.ndarray] = None
    params: Any = None
    # number of "original" variables (before slack/elastic augmentation);
    # reformulations set this (reference OptimizationProblem.cpp:52-54)
    n_orig: Optional[int] = None
    # indices into x of slack variables per constraint, -1 if none
    # (reference Model::get_slacks(); used for slack initialization)
    slack_of_constraint: Optional[np.ndarray] = None
    # objective/constraint scaling factors applied by scale transform
    f_scale: float = 1.0
    c_scale: Optional[np.ndarray] = None
    # static sparsity declaration (banded Hessian / windowed Jacobian);
    # None = dense.  Propagated by the model transforms.
    structure: Optional[NLPStructure] = None

    # ------------------------------------------------------------------ masks
    @property
    def num_original_variables(self) -> int:
        return self.n if self.n_orig is None else self.n_orig

    @property
    def has_x_lb(self) -> np.ndarray:
        return np.isfinite(self.x_lb) & (self.x_lb > -DEFAULT_BOUND_INFINITY)

    @property
    def has_x_ub(self) -> np.ndarray:
        return np.isfinite(self.x_ub) & (self.x_ub < DEFAULT_BOUND_INFINITY)

    @property
    def single_lower_bounded(self) -> np.ndarray:
        return self.has_x_lb & ~self.has_x_ub

    @property
    def single_upper_bounded(self) -> np.ndarray:
        return self.has_x_ub & ~self.has_x_lb

    @property
    def fixed_variables(self) -> np.ndarray:
        return np.asarray(self.x_lb == self.x_ub) & self.has_x_lb

    @property
    def is_equality(self) -> np.ndarray:
        """Mask of equality constraints (c_lb == c_ub)."""
        if self.m == 0:
            return np.zeros(0, dtype=bool)
        return np.asarray(self.c_lb == self.c_ub) & np.isfinite(self.c_lb)

    @property
    def is_inequality(self) -> np.ndarray:
        return ~self.is_equality

    @property
    def is_constrained(self) -> bool:
        return self.m > 0

    # ------------------------------------------------------------- evaluation
    def objective(self, x, params=None):
        return self.f(x, self.params if params is None else params)

    def constraints(self, x, params=None):
        if self.m == 0:
            return jnp.zeros((0,), dtype=x.dtype)
        return self.c(x, self.params if params is None else params)

    def objective_gradient(self, x, params=None):
        p = self.params if params is None else params
        return jax.grad(self.f)(x, p)

    def constraint_jacobian(self, x, params=None):
        """Dense (m, n) Jacobian.  Dense is deliberate: CUTEst-scale problems
        map onto matrix units better dense than scatter/gather sparse."""
        p = self.params if params is None else params
        if self.m == 0:
            return jnp.zeros((0, self.n), dtype=x.dtype)
        return jax.jacfwd(self.c)(x, p)

    def lagrangian_hessian(self, x, y, sigma=1.0, params=None):
        """Hessian of sigma*f(x) - y^T c(x)  (reference Model.hpp:47-50 with
        the AMPL sign convention)."""
        p = self.params if params is None else params

        def lag(x_):
            val = sigma * self.f(x_, p)
            if self.m > 0:
                val = val - jnp.dot(y, self.c(x_, p))
            return val

        return jax.hessian(lag)(x)

    def lagrangian_hessian_vp(self, x, y, v, sigma=1.0, params=None):
        """Hessian-vector product via forward-over-reverse AD (implicit
        representation, reference HessianModel.hpp:19-37)."""
        p = self.params if params is None else params

        def lag_grad(x_):
            g = sigma * jax.grad(self.f)(x_, p)
            if self.m > 0:
                g = g - jax.vjp(lambda z: self.c(z, p), x_)[1](y)[0]
            return g

        return jax.jvp(lag_grad, (x,), (v,))[1]

    def lagrangian_hessian_band(self, x, y, sigma=1.0, params=None):
        """Banded Lagrangian Hessian in lower band storage (b+1, n):
        band[d, j] = H[j+d, j].  Extracted with ncolors = min(n, 2b+1)
        Hessian-vector probes (strided coloring: columns j = k mod ncolors
        share probe k; their images cannot collide within the band), i.e.
        O(b) gradient evaluations instead of the O(n) of jax.hessian —
        the structured analogue of ASL's sparse Sphes (AMPLModel.cpp:357-367).
        Requires `structure`."""
        b = self.structure.hess_bandwidth
        n = self.n
        ncolors = min(n, 2 * b + 1)
        cols = np.arange(n)
        V = jnp.asarray((cols[None, :] % ncolors) == np.arange(ncolors)[:, None],
                        dtype=x.dtype)
        Hv = jax.vmap(
            lambda v: self.lagrangian_hessian_vp(x, y, v, sigma, params))(V)
        # band[d, j] = H[j+d, j] = Hv[j % ncolors, j+d]
        d_idx = np.arange(b + 1)[:, None]
        j_idx = cols[None, :]
        row = j_idx + d_idx
        ok = row < n
        band = Hv[jnp.asarray(j_idx % ncolors).repeat(b + 1, axis=0),
                  jnp.asarray(np.where(ok, row, 0))]
        return band * jnp.asarray(ok, dtype=x.dtype)

    def constraint_jacobian_windows(self, x, params=None):
        """Windowed Jacobian rows (m, w): entry [i, t] = J[i, starts_i + t].
        Extracted with min(w, limit) strided jvp probes (columns with equal
        color cannot share a window).  Columns >= structure.jac_col_limit
        (analytic slack columns) are excluded from the probes.  Requires
        `structure` with jac_starts."""
        st = self.structure
        p = self.params if params is None else params
        starts = st.jac_starts
        w = st.jac_width
        limit = self.n if st.jac_col_limit is None else st.jac_col_limit
        ncolors = min(limit, max(w, 1))
        cols = np.arange(self.n)
        probe_ok = cols < limit
        V = jnp.asarray(((cols[None, :] % ncolors) == np.arange(ncolors)[:, None])
                        & probe_ok[None, :], dtype=x.dtype)
        c_fn = self.c
        Jv = jax.vmap(lambda v: jax.jvp(lambda z: c_fn(z, p), (x,), (v,))[1])(V)
        # J_local[i, t] = Jv[(starts_i + t) % ncolors, i]
        tcol = (starts[:, None] + np.arange(w)[None, :])
        ok = tcol < limit
        J_local = Jv[jnp.asarray(np.where(ok, tcol, 0) % ncolors),
                     jnp.asarray(np.arange(self.m))[:, None]]
        return J_local * jnp.asarray(ok, dtype=x.dtype)

    def constraint_violation(self, cx, norm: str = "L1"):
        """Norm of violation of c_lb <= cx <= c_ub
        (reference Model::constraint_violation)."""
        lb = jnp.asarray(self.c_lb, dtype=cx.dtype)
        ub = jnp.asarray(self.c_ub, dtype=cx.dtype)
        viol = jnp.maximum(lb - cx, 0.0) + jnp.maximum(cx - ub, 0.0)
        return vector_norm(viol, norm)

    def project_onto_bounds(self, x):
        lb = jnp.asarray(self.x_lb, dtype=x.dtype)
        ub = jnp.asarray(self.x_ub, dtype=x.dtype)
        return jnp.clip(x, lb, ub)


def vector_norm(v, norm: str):
    if v.shape[-1] == 0:
        return jnp.zeros((), dtype=v.dtype if hasattr(v, "dtype") else jnp.float64)
    if norm == "L1":
        return jnp.sum(jnp.abs(v), axis=-1)
    if norm == "L2":
        return jnp.sqrt(jnp.sum(v * v, axis=-1))
    if norm == "L2_squared":
        return jnp.sum(v * v, axis=-1)
    if norm == "INF":
        return jnp.max(jnp.abs(v), axis=-1)
    raise ValueError(f"unknown norm {norm!r}")


def nlp_from_functions(
    name: str,
    f: Callable,
    c: Optional[Callable],
    x0,
    x_lb=None,
    x_ub=None,
    c_lb=None,
    c_ub=None,
    y0=None,
    params=None,
    structure=None,
) -> NLP:
    """Convenience constructor.  `f`/`c` may take (x,) or (x, params).

    Validates user data at the API boundary (the reference's AMPL layer can
    never produce NaN bounds or mismatched shapes, so the solvers assume
    clean data): NaN in x0 or any bound raises ValueError, as do
    inconsistent bound-array lengths."""
    x0 = np.asarray(x0, dtype=np.float64)
    n = x0.shape[0]
    if np.isnan(x0).any():
        raise ValueError(f"{name}: initial point x0 contains NaN")

    def wrap(fn):
        if fn is None:
            return None
        import inspect

        try:
            n_args = len(inspect.signature(fn).parameters)
        except (TypeError, ValueError):
            n_args = 2
        if n_args == 1:
            return lambda x, p: fn(x)
        return fn

    fw = wrap(f)
    cw = wrap(c)
    if cw is None:
        m = 0
        cw = lambda x, p: jnp.zeros((0,), dtype=x.dtype)
        c_lb = np.zeros(0)
        c_ub = np.zeros(0)
    else:
        c_lb = np.asarray(c_lb, dtype=np.float64)
        c_ub = np.asarray(c_ub, dtype=np.float64)
        if c_lb.shape != c_ub.shape:
            raise ValueError(
                f"{name}: c_lb shape {c_lb.shape} != c_ub shape {c_ub.shape}")
        m = c_lb.shape[0]

    x_lb = np.full(n, -INF) if x_lb is None else np.asarray(x_lb, dtype=np.float64)
    x_ub = np.full(n, INF) if x_ub is None else np.asarray(x_ub, dtype=np.float64)
    if x_lb.shape != (n,) or x_ub.shape != (n,):
        raise ValueError(
            f"{name}: bound shapes {x_lb.shape}/{x_ub.shape} != x0 shape ({n},)")
    for tag, arr in (("x_lb", x_lb), ("x_ub", x_ub),
                     ("c_lb", c_lb), ("c_ub", c_ub)):
        if np.isnan(arr).any():
            raise ValueError(f"{name}: {tag} contains NaN")
    y0 = np.zeros(m) if y0 is None else np.asarray(y0, dtype=np.float64)
    return NLP(
        name=name, n=n, m=m, f=fw, c=cw, x_lb=x_lb, x_ub=x_ub,
        c_lb=c_lb, c_ub=c_ub, x0=x0, y0=y0, params=params,
        structure=structure,
    )
