"""Scalable CUTEst-style problem families, to widen the validation corpus
toward the reference's CUTEst-429 benchmark surface (its README.md:82-89).

Each family is a classic scalable test problem from the public literature
(Moré-Garbow-Hillstrom 1981; Conn-Gould-Toint CUTE(st); Lukšan-Vlček 1999
sparse equality-constrained set; COPS 3.0), encoded from its published
mathematical formulation with vectorized jnp expressions (vectorization-friendly:
shifted-slice sums, no Python-level per-element loops).

Instances register into the main library registry as "<family>_n<N>" for
N in SIZES, so tools/sweep.py and the e2e test tiers pick them up.
`f_star` is registered only where it is analytically exact; otherwise the
sweep asserts solver-internal KKT criteria.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from uno_tpu.model.library import register
import dataclasses

from uno_tpu.model import transforms
from uno_tpu.model.nlp import NLPStructure, NLP, nlp_from_functions, INF

SIZES = (10, 100, 1000)

_FAMILIES: dict = {}


def family(name, f_star=None, sizes=SIZES, min_n=2, local_optima=()):
    """f_star / local_optima entries: None, a constant, or a callable
    n -> value (documented secondary first-order points, e.g. MGH's
    BROWNAL local minimum f = 1)."""
    def deco(builder):
        _FAMILIES[name] = (builder, f_star, sizes, min_n, local_optima)
        return builder
    return deco


def family_names():
    return sorted(_FAMILIES)


def cutest_problem(name: str, n: int) -> NLP:
    builder = _FAMILIES[name][0]
    return builder(n)


def _reg_all():
    """Register every (family, size) instance into the main registry.

    Builders snap the requested size to their structure (grids use
    g = isqrt(n) so n -> g*g; control families use N = n//3 stages), so the
    registry key is derived from the ACTUAL built dimension, keeping key,
    inner NLP name, and size filters consistent (advisor round-2 finding).
    Building every instance once costs <1 s total."""
    seen = set()
    for name, (builder, f_star, sizes, min_n, locs) in _FAMILIES.items():
        for n in sizes:
            if n < min_n:
                continue
            actual_n = builder(n).n
            key = f"{name}_n{actual_n}"
            if key in seen:
                continue
            seen.add(key)
            fs = f_star(n) if callable(f_star) else f_star
            lo = tuple(l(n) if callable(l) else l for l in locs)
            register(key, f_star=fs, local_optima=lo)(
                lambda name=name, n=n: cutest_problem(name, n))


# ===========================================================================
# unconstrained / bound-constrained (classic sparse sums)
# ===========================================================================

@family("srosenbr", f_star=0.0)
def srosenbr(n):
    """Extended Rosenbrock (separable pairs), MGH #21 / CUTEst SROSENBR."""
    n -= n % 2

    def f(x):
        xo, xe = x[0::2], x[1::2]
        return jnp.sum(100.0 * (xe - xo ** 2) ** 2 + (1.0 - xo) ** 2)

    x0 = np.tile([-1.2, 1.0], n // 2)
    return nlp_from_functions(f"srosenbr_n{n}", f, None, x0=x0,
                              structure=NLPStructure(hess_bandwidth=1))


@family("arwhead", f_star=0.0)
def arwhead(n):
    """CUTEst ARWHEAD: sum_{i<n} ((x_i^2+x_n^2)^2 - 4x_i + 3)."""
    def f(x):
        head = x[:-1]
        return jnp.sum((head ** 2 + x[-1] ** 2) ** 2 - 4.0 * head + 3.0)

    return nlp_from_functions(f"arwhead_n{n}", f, None, x0=np.ones(n))


@family("liarwhd", f_star=0.0)
def liarwhd(n):
    """CUTEst LIARWHD: sum 4(x_i^2 - x_1)^2 + (x_i - 1)^2; min at x=1."""
    def f(x):
        return jnp.sum(4.0 * (x ** 2 - x[0]) ** 2 + (x - 1.0) ** 2)

    return nlp_from_functions(f"liarwhd_n{n}", f, None, x0=np.full(n, 4.0))


@family("nondquar", f_star=0.0, min_n=3)
def nondquar(n):
    """CUTEst NONDQUAR: (x1-x2)^2 + (x_{n-1}+x_n)^2
    + sum_{i<=n-2} (x_i + x_{i+1} + x_n)^4."""
    def f(x):
        mid = (x[:-2] + x[1:-1] + x[-1]) ** 4
        return (x[0] - x[1]) ** 2 + (x[-2] + x[-1]) ** 2 + jnp.sum(mid)

    x0 = np.ones(n)
    x0[1::2] = -1.0
    return nlp_from_functions(f"nondquar_n{n}", f, None, x0=x0)


@family("engval1")
def engval1(n):
    """CUTEst ENGVAL1: sum (x_i^2 + x_{i+1}^2)^2 - 4 x_i + 3."""
    def f(x):
        return jnp.sum((x[:-1] ** 2 + x[1:] ** 2) ** 2 - 4.0 * x[:-1] + 3.0)

    return nlp_from_functions(f"engval1_n{n}", f, None, x0=np.full(n, 2.0),
                              structure=NLPStructure(hess_bandwidth=1))


@family("edensch")
def edensch(n):
    """CUTEst EDENSCH: 16 + sum (x_i-2)^4 + (x_i x_{i+1} - 2 x_{i+1})^2
    + (x_{i+1}+1)^2."""
    def f(x):
        a, b = x[:-1], x[1:]
        return 16.0 + jnp.sum((a - 2.0) ** 4 + (a * b - 2.0 * b) ** 2
                              + (b + 1.0) ** 2)

    return nlp_from_functions(f"edensch_n{n}", f, None, x0=np.zeros(n),
                              structure=NLPStructure(hess_bandwidth=1))


@family("cragglvy", min_n=4)
def cragglvy(n):
    """CUTEst CRAGGLVY (chained Cragg-Levy):
    sum over odd i of (exp(x_i)-x_{i+1})^4 + 100(x_{i+1}-x_{i+2})^6
    + tan^4(x_{i+2}-x_{i+3}) + x_i^8 + (x_{i+3}-1)^2."""
    n -= n % 2

    def f(x):
        a, b, c, d = x[0:-3:2], x[1:-2:2], x[2:-1:2], x[3::2]
        return jnp.sum((jnp.exp(a) - b) ** 4 + 100.0 * (b - c) ** 6
                       + jnp.tan(c - d) ** 4 + a ** 8 + (d - 1.0) ** 2)

    x0 = np.full(n, 2.0)
    x0[0] = 1.0
    return nlp_from_functions(f"cragglvy_n{n}", f, None, x0=x0,
                              structure=NLPStructure(hess_bandwidth=3))


@family("freuroth", min_n=2)
def freuroth(n):
    """Extended Freudenstein & Roth (CUTEst FREUROTH)."""
    def f(x):
        a, b = x[:-1], x[1:]
        r1 = -13.0 + a + ((5.0 - b) * b - 2.0) * b
        r2 = -29.0 + a + ((b + 1.0) * b - 14.0) * b
        return jnp.sum(r1 ** 2 + r2 ** 2)

    x0 = np.zeros(n)
    x0[0], x0[1] = 0.5, -2.0
    return nlp_from_functions(f"freuroth_n{n}", f, None, x0=x0,
                              structure=NLPStructure(hess_bandwidth=1))


@family("tridia", f_star=0.0)
def tridia(n):
    """CUTEst TRIDIA (alpha=2, beta=1, gamma=1, delta=1):
    (x_1-1)^2 + sum_{i=2}^n i (2x_i - x_{i-1})^2."""
    def f(x):
        i = jnp.arange(2, x.shape[0] + 1, dtype=x.dtype)
        return (x[0] - 1.0) ** 2 + jnp.sum(i * (2.0 * x[1:] - x[:-1]) ** 2)

    return nlp_from_functions(f"tridia_n{n}", f, None, x0=np.ones(n),
                              structure=NLPStructure(hess_bandwidth=1))


@family("dqrtic", f_star=0.0)
def dqrtic(n):
    """CUTEst DQRTIC: sum (x_i - i)^4."""
    def f(x):
        i = jnp.arange(1, x.shape[0] + 1, dtype=x.dtype)
        return jnp.sum((x - i) ** 4)

    return nlp_from_functions(f"dqrtic_n{n}", f, None, x0=np.full(n, 2.0),
                              structure=NLPStructure(hess_bandwidth=0))


@family("woods", f_star=0.0, min_n=4)
def woods(n):
    """Extended Wood function (MGH #14 chained in 4-blocks, CUTEst WOODS)."""
    n -= n % 4

    def f(x):
        x1, x2, x3, x4 = x[0::4], x[1::4], x[2::4], x[3::4]
        return jnp.sum(100.0 * (x2 - x1 ** 2) ** 2 + (1.0 - x1) ** 2
                       + 90.0 * (x4 - x3 ** 2) ** 2 + (1.0 - x3) ** 2
                       + 10.0 * (x2 + x4 - 2.0) ** 2
                       + 0.1 * (x2 - x4) ** 2)

    x0 = np.tile([-3.0, -1.0, -3.0, -1.0], n // 4)
    return nlp_from_functions(f"woods_n{n}", f, None, x0=x0,
                              structure=NLPStructure(hess_bandwidth=3))


@family("powellsg", f_star=0.0, min_n=4)
def powellsg(n):
    """Extended Powell singular (MGH #13, CUTEst POWELLSG); singular Hessian
    at the solution."""
    n -= n % 4

    def f(x):
        x1, x2, x3, x4 = x[0::4], x[1::4], x[2::4], x[3::4]
        return jnp.sum((x1 + 10.0 * x2) ** 2 + 5.0 * (x3 - x4) ** 2
                       + (x2 - 2.0 * x3) ** 4 + 10.0 * (x1 - x4) ** 4)

    x0 = np.tile([3.0, -1.0, 0.0, 1.0], n // 4)
    return nlp_from_functions(f"powellsg_n{n}", f, None, x0=x0,
                              structure=NLPStructure(hess_bandwidth=3))


@family("vardim", f_star=0.0)
def vardim(n):
    """MGH #25 VARDIM: sum(x_i-1)^2 + (sum i x_i - K)^2 + (...)^4,
    K = n(n+1)/2; min at x=1."""
    K = n * (n + 1) / 2.0

    def f(x):
        i = jnp.arange(1, x.shape[0] + 1, dtype=x.dtype)
        t = jnp.dot(i, x) - K
        return jnp.sum((x - 1.0) ** 2) + t ** 2 + t ** 4

    x0 = 1.0 - np.arange(1, n + 1) / n
    return nlp_from_functions(f"vardim_n{n}", f, None, x0=x0)


@family("brownal", f_star=0.0, local_optima=(1.0,))
def brownal(n):
    """MGH #27 Brown almost-linear: sum_{i<n} (x_i + sum x - (n+1))^2
    + (prod x - 1)^2; min 0 at x=1; documented local minimum f = 1 at
    x = (0, ..., 0, n+1) (MGH 1981)."""
    def f(x):
        s = jnp.sum(x)
        r = x[:-1] + s - (x.shape[0] + 1.0)
        # product via exp-sum-log is invalid for negative x; direct prod
        return jnp.sum(r ** 2) + (jnp.prod(x) - 1.0) ** 2

    return nlp_from_functions(f"brownal_n{n}", f, None, x0=np.full(n, 0.5))


@family("penalty1")
def penalty1(n):
    """MGH #23 PENALTY1: 1e-5 sum (x_i-1)^2 + (sum x_i^2 - 0.25)^2."""
    def f(x):
        return 1e-5 * jnp.sum((x - 1.0) ** 2) + (jnp.sum(x ** 2) - 0.25) ** 2

    return nlp_from_functions(f"penalty1_n{n}", f, None,
                              x0=np.arange(1.0, n + 1.0))


@family("bdqrtic", min_n=5)
def bdqrtic(n):
    """CUTEst BDQRTIC: sum_{i<=n-4} (-4x_i+3)^2
    + (x_i^2 + 2x_{i+1}^2 + 3x_{i+2}^2 + 4x_{i+3}^2 + 5x_n^2)^2."""
    def f(x):
        a = x[:-4]
        q = (a ** 2 + 2.0 * x[1:-3] ** 2 + 3.0 * x[2:-2] ** 2
             + 4.0 * x[3:-1] ** 2 + 5.0 * x[-1] ** 2)
        return jnp.sum((-4.0 * a + 3.0) ** 2 + q ** 2)

    return nlp_from_functions(f"bdqrtic_n{n}", f, None, x0=np.ones(n))


@family("cosine", f_star=lambda n: -(n - 1.0))
def cosine(n):
    """CUTEst COSINE: sum cos(x_i^2 - 0.5 x_{i+1}); min -(n-1)."""
    def f(x):
        return jnp.sum(jnp.cos(x[:-1] ** 2 - 0.5 * x[1:]))

    return nlp_from_functions(f"cosine_n{n}", f, None, x0=np.ones(n),
                              structure=NLPStructure(hess_bandwidth=1))


@family("sinquad", f_star=0.0, min_n=3)
def sinquad(n):
    """CUTEst SINQUAD: (x1-1)^4 + (x_n^2 - x_1^2)^2
    + sum_mid (sin(x_i - x_n) - x_1^2 + x_i^2)^2."""
    def f(x):
        mid = x[1:-1]
        return ((x[0] - 1.0) ** 4 + (x[-1] ** 2 - x[0] ** 2) ** 2
                + jnp.sum((jnp.sin(mid - x[-1]) - x[0] ** 2 + mid ** 2) ** 2))

    return nlp_from_functions(f"sinquad_n{n}", f, None, x0=np.full(n, 0.1))


@family("broydn3d_ls", f_star=0.0)
def broydn3d_ls(n):
    """Broyden tridiagonal equations (MGH #30) as least squares."""
    def F(x):
        xm = jnp.pad(x, (1, 1))  # x_0 = x_{n+1} = 0
        return (3.0 - 2.0 * xm[1:-1]) * xm[1:-1] - xm[:-2] - 2.0 * xm[2:] + 1.0

    def f(x):
        return jnp.sum(F(x) ** 2)

    return nlp_from_functions(f"broydn3d_ls_n{n}", f, None, x0=np.full(n, -1.0),
                              structure=NLPStructure(hess_bandwidth=2))


@family("broydnbd_ls", f_star=0.0, min_n=7)
def broydnbd_ls(n):
    """Broyden banded equations (MGH #31, lower bandwidth 5, upper 1) as
    least squares; banded sums via stacked shifted slices (static shapes)."""
    def F(x):
        xp = jnp.pad(x, (5, 1))
        # neighbors j != i with max(0, i-5) <= j <= min(n-1, i+1)
        neigh = jnp.stack([xp[k:k + n] for k in range(7)], axis=0)  # offsets -5..+1
        nb = neigh.at[5].set(0.0)  # offset 0 is x_i itself: excluded
        s = jnp.sum(nb * (1.0 + nb), axis=0)
        return x * (2.0 + 5.0 * x ** 2) + 1.0 - s

    def f(x):
        return jnp.sum(F(x) ** 2)

    return nlp_from_functions(f"broydnbd_ls_n{n}", f, None, x0=np.full(n, -1.0),
                              structure=NLPStructure(hess_bandwidth=6))


@family("genhumps", f_star=0.0)
def genhumps(n):
    """CUTEst GENHUMPS: sum sin(2x_i)^2 sin(2x_{i+1})^2
    + 0.05(x_i^2 + x_{i+1}^2); min 0 at x=0."""
    def f(x):
        a, b = x[:-1], x[1:]
        return jnp.sum(jnp.sin(2.0 * a) ** 2 * jnp.sin(2.0 * b) ** 2
                       + 0.05 * (a ** 2 + b ** 2))

    x0 = np.full(n, 2.0)
    x0[0] = -2.0
    return nlp_from_functions(f"genhumps_n{n}", f, None, x0=x0,
                              structure=NLPStructure(hess_bandwidth=1))


# ---------------------------------------------------------------------------
# bound-constrained
# ---------------------------------------------------------------------------

@family("biggsb1")
def biggsb1(n):
    """CUTEst BIGGSB1: tridiagonal convex QP with active interior bounds:
    (x1-1)^2 + sum (x_{i+1}-x_i)^2 + (1-x_n)^2, 0 <= x_i <= 0.9."""
    def f(x):
        return ((x[0] - 1.0) ** 2 + jnp.sum((x[1:] - x[:-1]) ** 2)
                + (1.0 - x[-1]) ** 2)

    return nlp_from_functions(
        f"biggsb1_n{n}", f, None, x0=np.zeros(n),
        x_lb=np.zeros(n), x_ub=np.full(n, 0.9),
        structure=NLPStructure(hess_bandwidth=1))


@family("obstacle", min_n=16)
def obstacle(n):
    """Obstacle problem (CUTEst OBSTCLAE-style): min 1/2 u^T K u - f^T u on a
    sqrt(n) x sqrt(n) interior grid (5-point Laplacian), u >= obstacle (a
    centered plateau), u = 0 on the boundary."""
    g = int(np.sqrt(n))
    h = 1.0 / (g + 1)

    def f(u):
        U = u.reshape(g, g)
        Up = jnp.pad(U, 1)
        lap = 4.0 * U - Up[:-2, 1:-1] - Up[2:, 1:-1] - Up[1:-1, :-2] - Up[1:-1, 2:]
        return 0.5 * jnp.sum(U * lap) - h * h * jnp.sum(U)

    lb = np.zeros((g, g))
    q = max(1, g // 4)
    lb[q:g - q, q:g - q] = 0.3  # plateau obstacle
    return nlp_from_functions(
        f"obstacle_n{g * g}", f, None, x0=np.zeros(g * g),
        x_lb=lb.ravel(), x_ub=np.full(g * g, INF),
        structure=NLPStructure(hess_bandwidth=g))


# ===========================================================================
# constrained scalable families (the KKT-relevant tier)
# ===========================================================================

@family("lukvle1", min_n=3)
def lukvle1(n):
    """Lukšan-Vlček problem 5.1 (CUTEst LUKVLE1): chained Rosenbrock
    objective with n-2 trigonometric-exponential equality constraints."""
    def f(x):
        return jnp.sum(100.0 * (x[:-1] ** 2 - x[1:]) ** 2 + (x[:-1] - 1.0) ** 2)

    def c(x):
        a, b, d = x[:-2], x[1:-1], x[2:]
        return (3.0 * b ** 3 + 2.0 * d - 5.0
                + jnp.sin(b - d) * jnp.sin(b + d)
                + 4.0 * b - a * jnp.exp(a - b) - 3.0)

    m = n - 2
    x0 = np.full(n, -1.2)
    x0[1::2] = 1.0
    return nlp_from_functions(
        f"lukvle1_n{n}", f, c, x0=x0,
        c_lb=np.zeros(m), c_ub=np.zeros(m),
        structure=NLPStructure(hess_bandwidth=2,
                               jac_starts=np.arange(m, dtype=np.int64),
                               jac_width=3))


@family("lukvli1", min_n=3)
def lukvli1(n):
    """LUKVLI1: same as LUKVLE1 with the constraints relaxed to <= 0."""
    base = _FAMILIES["lukvle1"][0](n)
    m = n - 2
    return nlp_from_functions(
        f"lukvli1_n{n}", base.objective, base.constraints, x0=np.asarray(base.x0),
        c_lb=np.full(m, -INF), c_ub=np.zeros(m),
        structure=base.structure)


@family("hager1", min_n=4)
def hager1(n):
    """Hager optimal-control family (CUTEst HAGER1-style): discretized
    min 1/2 int_0^1 (x(t)^2 + u(t)^2) dt, x' = 0.5 x + u, x(0) = 1.
    Variables: states x_0..x_N and controls u_1..u_N (n ~ 2N+1)."""
    N = max(2, (n - 1) // 2)
    h = 1.0 / N

    def f(z):
        x, u = z[: N + 1], z[N + 1:]
        xm = 0.5 * (x[1:] ** 2 + x[:-1] ** 2)
        return 0.5 * h * jnp.sum(xm + u ** 2)

    def c(z):
        x, u = z[: N + 1], z[N + 1:]
        # trapezoidal dynamics: x_k - x_{k-1} = h/2 (0.5(x_k + x_{k-1})) + h u_k
        return (x[1:] - x[:-1]
                - 0.25 * h * (x[1:] + x[:-1]) - h * u)

    nv = 2 * N + 1
    x0 = np.zeros(nv)
    x0[0] = 1.0
    xl = np.full(nv, -INF)
    xu = np.full(nv, INF)
    xl[0] = xu[0] = 1.0  # x(0) = 1 as a fixed variable
    nlp = nlp_from_functions(
        f"hager1_n{nv}", f, c, x0=x0, x_lb=xl, x_ub=xu,
        c_lb=np.zeros(N), c_ub=np.zeros(N))
    # stage interleave [x_0, (x_1,u_1), (x_2,u_2), ...] makes the KKT banded
    # (the fill-reducing ordering a sparse solver would compute): row k
    # touches x_{k-1}, x_k, u_k -> a width-4 window
    perm = np.concatenate([[0], np.stack([np.arange(1, N + 1),
                                          N + np.arange(1, N + 1)], 1).ravel()])
    starts = np.concatenate([[0], 2 * np.arange(1, N, dtype=np.int64) - 1])
    nlp = transforms.permute_variables(nlp, perm)
    return dataclasses.replace(nlp, structure=NLPStructure(
        hess_bandwidth=0, jac_starts=np.minimum(starts, nv - 4),
        jac_width=4))


@family("dtoc1", min_n=6)
def dtoc1(n):
    """Discrete-time optimal control (CUTEst DTOC1L-style, 2 states /
    1 control): min sum (y_t + 0.25)^4 + (u_t + 0.25)^4-like smooth costs
    with coupled linear dynamics."""
    T = max(2, n // 3)

    def split(z):
        u = z[:T]
        y = z[T:].reshape(T + 1, 2)
        return u, y

    def f(z):
        u, y = split(z)
        return jnp.sum((u + 0.25) ** 4) + jnp.sum((y + 0.25) ** 4)

    def c(z):
        u, y = split(z)
        y1, y2 = y[:, 0], y[:, 1]
        r1 = y1[1:] - (0.5 * y1[:-1] + 0.25 * y2[:-1] + 0.5 * u)
        r2 = y2[1:] - (0.25 * y1[:-1] + 0.5 * y2[:-1] - 0.25 * u ** 2)
        return jnp.concatenate([r1, r2])

    nv = T + 2 * (T + 1)
    x0 = np.zeros(nv)
    xl = np.full(nv, -INF)
    xu = np.full(nv, INF)
    # initial state fixed at (1, -1)
    xl[T] = xu[T] = 1.0
    x0[T] = 1.0
    xl[T + 1] = xu[T + 1] = -1.0
    x0[T + 1] = -1.0
    nlp = nlp_from_functions(
        f"dtoc1_n{nv}", f, c, x0=x0, x_lb=xl, x_ub=xu,
        c_lb=np.zeros(2 * T), c_ub=np.zeros(2 * T))
    # stage interleave (y_t1, y_t2, u_t): dynamics rows become width-5
    # windows (banded KKT)
    perm = np.empty(nv, dtype=np.int64)
    t_idx = np.arange(T + 1)
    perm[3 * t_idx] = T + 2 * t_idx          # y_t1
    perm[3 * t_idx + 1] = T + 1 + 2 * t_idx  # y_t2
    perm[3 * np.arange(T) + 2] = np.arange(T)  # u_t
    starts = np.concatenate([3 * np.arange(T, dtype=np.int64)] * 2)
    nlp = transforms.permute_variables(nlp, perm)
    return dataclasses.replace(nlp, structure=NLPStructure(
        hess_bandwidth=0, jac_starts=np.minimum(starts, nv - 5),
        jac_width=5))


@family("catena", min_n=9)
def catena(n):
    """Hanging chain (COPS 3 'chain' / CUTEst CATENA): minimize potential
    energy of K links of fixed length, endpoints pinned."""
    K = max(3, n // 2)  # number of free joints ~ K-1; vars (x_i, y_i)
    L = 2.0 / K  # total length 2 spanning [0,1]: slack chain

    def split(z):
        pts = z.reshape(K - 1, 2)
        x = jnp.concatenate([jnp.zeros(1), pts[:, 0], jnp.ones(1)])
        y = jnp.concatenate([jnp.zeros(1), pts[:, 1], jnp.zeros(1)])
        return x, y

    def f(z):
        _, y = split(z)
        return jnp.sum(0.5 * (y[1:] + y[:-1]))  # potential energy (up to g*rho*L)

    def c(z):
        x, y = split(z)
        return (x[1:] - x[:-1]) ** 2 + (y[1:] - y[:-1]) ** 2 - L ** 2

    nv = 2 * (K - 1)
    x0 = np.zeros(nv)
    x0[0::2] = np.linspace(0, 1, K + 1)[1:-1]  # x spread
    x0[1::2] = -0.1
    starts = np.clip(2 * np.arange(K, dtype=np.int64) - 2, 0, max(nv - 4, 0))
    return nlp_from_functions(
        f"catena_n{nv}", f, c, x0=x0,
        c_lb=np.zeros(K), c_ub=np.zeros(K),
        structure=NLPStructure(hess_bandwidth=3, jac_starts=starts,
                               jac_width=min(4, nv)))


@family("sphere_proj", f_star=None)
def sphere_proj(n):
    """Projection onto the unit sphere: min 1/2||x - a||^2 s.t. ||x||^2 = 1.
    Analytic optimum f* = (||a|| - 1)^2 / 2."""
    rng = np.random.default_rng(n)
    a = rng.standard_normal(n)
    aj = jnp.asarray(a)

    def f(x):
        return 0.5 * jnp.sum((x - aj) ** 2)

    def c(x):
        return jnp.array([jnp.sum(x ** 2) - 1.0])

    nlp = nlp_from_functions(
        f"sphere_proj_n{n}", f, c, x0=np.full(n, 1.0 / np.sqrt(n)),
        c_lb=[0.0], c_ub=[0.0])
    return nlp


# analytic optimum for sphere_proj: register with exact f*
_FAMILIES["sphere_proj"] = (
    _FAMILIES["sphere_proj"][0],
    lambda n: 0.5 * (float(np.linalg.norm(
        np.random.default_rng(n).standard_normal(n))) - 1.0) ** 2,
    _FAMILIES["sphere_proj"][2], _FAMILIES["sphere_proj"][3],
    _FAMILIES["sphere_proj"][4])


@family("structqp", min_n=8)
def structqp(n):
    """Block-structured convex QP with linear equality constraints
    (CVXQP-class): banded SPD Hessian, sparse equality rows, box bounds."""
    rng = np.random.default_rng(7 + n)
    m = n // 4
    d = jnp.asarray(1.0 + rng.uniform(0, 9, n))
    off = jnp.asarray(rng.uniform(-0.5, 0.5, n - 1))
    rows = rng.integers(0, n, (m, 3))
    coef = rng.uniform(0.5, 2.0, (m, 3))
    b = rng.uniform(0.5, 1.5, m)
    rj, cj, bj = jnp.asarray(rows), jnp.asarray(coef), jnp.asarray(b)

    def f(x):
        return 0.5 * (jnp.sum(d * x ** 2)
                      + 2.0 * jnp.sum(off * x[:-1] * x[1:])) + jnp.sum(x)

    def c(x):
        return jnp.sum(x[rj] * cj, axis=1) - bj

    return nlp_from_functions(
        f"structqp_n{n}", f, c, x0=np.full(n, 0.5),
        x_lb=np.full(n, -2.0), x_ub=np.full(n, 2.0),
        c_lb=np.zeros(m), c_ub=np.zeros(m))


@family("orthreg", min_n=6)
def orthreg(n):
    """Orthogonal regression onto an ellipse (CUTEst ORTHREGA-style):
    min sum ((xi-ai)^2 + (yi-bi)^2) s.t. each (xi, yi) on x^2 + 4 y^2 = 4."""
    K = max(2, (n + 1) // 2)
    rng = np.random.default_rng(n)
    t = rng.uniform(0, 2 * np.pi, K)
    a = 2.2 * np.cos(t) + 0.1 * rng.standard_normal(K)
    b = 1.1 * np.sin(t) + 0.1 * rng.standard_normal(K)
    aj, bj = jnp.asarray(a), jnp.asarray(b)

    def f(z):
        p = z.reshape(K, 2)
        return jnp.sum((p[:, 0] - aj) ** 2 + (p[:, 1] - bj) ** 2)

    def c(z):
        p = z.reshape(K, 2)
        return p[:, 0] ** 2 + 4.0 * p[:, 1] ** 2 - 4.0

    x0 = np.stack([2.0 * np.cos(t), np.sin(t)], axis=1).ravel()
    return nlp_from_functions(
        f"orthreg_n{2 * K}", f, c, x0=x0,
        c_lb=np.zeros(K), c_ub=np.zeros(K),
        structure=NLPStructure(hess_bandwidth=1,
                               jac_starts=2 * np.arange(K, dtype=np.int64),
                               jac_width=2))


@family("elec", min_n=9)
def elec(n):
    """COPS 3 'elec': K point charges on the unit sphere minimizing Coulomb
    energy (pairwise O(K^2)); K = n//3."""
    K = max(3, n // 3)

    # masked full-matrix form instead of d2[triu_indices]: the gather's
    # gradient is a scatter-add, which another machine's compiler could not
    # fit in its on-chip memory at K=33; the static mask computes the
    # identical value with elementwise ops and a dense reduce.  Not yet
    # re-decided on the H100: revert to the gather if it compiles and
    # solves there (ROADMAP C8).
    triu_mask = np.triu(np.ones((K, K), dtype=bool), 1)

    def f(z):
        p = z.reshape(K, 3)
        d2 = jnp.sum((p[:, None, :] - p[None, :, :]) ** 2, axis=-1)
        inv = 1.0 / jnp.sqrt(jnp.where(triu_mask, d2, 1.0) + 1e-12)
        return jnp.sum(jnp.where(triu_mask, inv, 0.0))

    def c(z):
        p = z.reshape(K, 3)
        return jnp.sum(p ** 2, axis=1) - 1.0

    rng = np.random.default_rng(K)
    p0 = rng.standard_normal((K, 3))
    p0 /= np.linalg.norm(p0, axis=1, keepdims=True)
    return nlp_from_functions(
        f"elec_n{3 * K}", f, c, x0=p0.ravel(),
        c_lb=np.zeros(K), c_ub=np.zeros(K))


@family("gridpde", min_n=16)
def gridpde(n):
    """PDE-constrained-style grid QP (AUG2D-class): min 1/2||u - t||^2 +
    alpha/2||w||^2 s.t. 5-point Laplacian(u) = w + source on a g x g grid."""
    g = int(np.sqrt(n / 2))
    g = max(3, g)
    N = g * g
    h = 1.0 / (g + 1)
    ii, jj = np.meshgrid(np.arange(1, g + 1), np.arange(1, g + 1), indexing="ij")
    target = np.sin(np.pi * ii * h) * np.sin(np.pi * jj * h)
    tj = jnp.asarray(target.ravel())

    def f(z):
        u, w = z[:N], z[N:]
        return 0.5 * jnp.sum((u - tj) ** 2) + 0.005 * jnp.sum(w ** 2)

    def c(z):
        u, w = z[:N], z[N:]
        U = u.reshape(g, g)
        Up = jnp.pad(U, 1)
        lap = (4.0 * U - Up[:-2, 1:-1] - Up[2:, 1:-1]
               - Up[1:-1, :-2] - Up[1:-1, 2:]) / (h * h)
        return lap.ravel() - w

    nlp = nlp_from_functions(
        f"gridpde_n{2 * N}", f, c, x0=np.zeros(2 * N),
        c_lb=np.zeros(N), c_ub=np.zeros(N))
    # interleave (u_i, w_i); Laplacian rows span u_{i-g}..u_{i+g} plus w_i
    # -> width 4g+2 windows
    nv = 2 * N
    perm = np.empty(nv, dtype=np.int64)
    i_idx = np.arange(N)
    perm[2 * i_idx] = i_idx          # u_i
    perm[2 * i_idx + 1] = N + i_idx  # w_i
    w_win = min(4 * g + 2, nv)
    starts = np.clip(2 * (i_idx - g), 0, nv - w_win).astype(np.int64)
    nlp = transforms.permute_variables(nlp, perm)
    return dataclasses.replace(nlp, structure=NLPStructure(
        hess_bandwidth=0, jac_starts=starts, jac_width=w_win))


@family("chainrosen_ineq", min_n=3)
def chainrosen_ineq(n):
    """Chained Rosenbrock with coupled inequality constraints and bounds
    (a nonconvex inequality-constrained stress family)."""
    def f(x):
        return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)

    def c(x):
        # x_i^2 + x_{i+1}^2 <= 4 on a strided subset
        a, b = x[:-1:2], x[1::2]
        return a ** 2 + b ** 2

    m = len(np.zeros(n)[:-1:2])
    return nlp_from_functions(
        f"chainrosen_ineq_n{n}", f, c, x0=np.full(n, 0.0),
        x_lb=np.full(n, -5.0), x_ub=np.full(n, 5.0),
        c_lb=np.full(m, -INF), c_ub=np.full(m, 4.0),
        structure=NLPStructure(hess_bandwidth=1,
                               jac_starts=2 * np.arange(m, dtype=np.int64),
                               jac_width=2))


@family("dblintegrator", min_n=9)
def dblintegrator(n):
    """Bounded-control double integrator to the origin (OPTCNTRL-class):
    min sum u^2 + 10 (p_T^2 + v_T^2), dynamics p' = v, v' = u, |u| <= 1,
    p(0)=1, v(0)=0."""
    T = max(3, n // 3)
    h = 1.0 / T

    def split(z):
        u = z[:T]
        p = z[T: 2 * T + 1]
        v = z[2 * T + 1:]
        return u, p, v

    def f(z):
        u, p, v = split(z)
        return h * jnp.sum(u ** 2) + 10.0 * (p[-1] ** 2 + v[-1] ** 2)

    def c(z):
        u, p, v = split(z)
        r1 = p[1:] - p[:-1] - h * v[:-1]
        r2 = v[1:] - v[:-1] - h * u
        return jnp.concatenate([r1, r2])

    nv = 3 * T + 2
    x0 = np.zeros(nv)
    xl = np.full(nv, -INF)
    xu = np.full(nv, INF)
    xl[:T] = -1.0
    xu[:T] = 1.0
    xl[T] = xu[T] = 1.0  # p(0) = 1
    x0[T] = 1.0
    xl[2 * T + 1] = xu[2 * T + 1] = 0.0  # v(0) = 0
    nlp = nlp_from_functions(
        f"dblintegrator_n{nv}", f, c, x0=x0, x_lb=xl, x_ub=xu,
        c_lb=np.zeros(2 * T), c_ub=np.zeros(2 * T))
    # stage interleave (p_t, v_t, u_t) -> width-4 dynamics windows
    perm = np.empty(nv, dtype=np.int64)
    t_idx = np.arange(T + 1)
    perm[3 * t_idx] = T + t_idx              # p_t
    perm[3 * t_idx + 1] = 2 * T + 1 + t_idx  # v_t
    perm[3 * np.arange(T) + 2] = np.arange(T)  # u_t
    starts = np.concatenate([3 * np.arange(T, dtype=np.int64),
                             3 * np.arange(T, dtype=np.int64) + 1])
    nlp = transforms.permute_variables(nlp, perm)
    return dataclasses.replace(nlp, structure=NLPStructure(
        hess_bandwidth=0, jac_starts=np.minimum(starts, nv - 4),
        jac_width=4))


# ===========================================================================
# round-2 widening toward the CUTEst-429 surface:
# 16 further classic families from MGH-1981 / CUTE(st) / COPS 3.0,
# encoded from the published formulations with vectorized jnp expressions.
# ===========================================================================

@family("fletchcr", f_star=0.0)
def fletchcr(n):
    """CUTEst FLETCHCR (Fletcher's chained Rosenbrock variant):
    sum 100 (x_{i+1} - x_i + 1 - x_i^2)^2; f* = 0 at x = 1."""
    def f(x):
        return jnp.sum(100.0 * (x[1:] - x[:-1] + 1.0 - x[:-1] ** 2) ** 2)

    return nlp_from_functions(f"fletchcr_n{n}", f, None, x0=np.zeros(n),
                              structure=NLPStructure(hess_bandwidth=1))


@family("genrose", f_star=1.0)
def genrose(n):
    """CUTEst GENROSE (generalized Rosenbrock): 1 + sum 100(x_i - x_{i-1}^2)^2
    + (x_i - 1)^2; f* = 1 at x = 1; x0_i = i/(n+1)."""
    def f(x):
        return (1.0 + jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                              + (x[1:] - 1.0) ** 2))

    x0 = np.arange(1, n + 1) / (n + 1.0)
    return nlp_from_functions(f"genrose_n{n}", f, None, x0=x0,
                              structure=NLPStructure(hess_bandwidth=1))


@family("dqdrtic", f_star=0.0, min_n=3)
def dqdrtic(n):
    """CUTEst DQDRTIC: sum_{i<=n-2} (x_i^2 + 100 x_{i+1}^2 + 100 x_{i+2}^2);
    separable convex quadratic, f* = 0; x0 = 3."""
    def f(x):
        return jnp.sum(x[:-2] ** 2 + 100.0 * x[1:-1] ** 2 + 100.0 * x[2:] ** 2)

    return nlp_from_functions(f"dqdrtic_n{n}", f, None, x0=np.full(n, 3.0),
                              structure=NLPStructure(hess_bandwidth=2))


@family("nondia")
def nondia(n):
    """CUTEst NONDIA (Shanno's nondiagonal Rosenbrock variant):
    (x_1-1)^2 + sum_{i>=2} 100 (x_1 - x_i^2)^2; global f* = 0 at x = 1, but
    from the published start x0 = -1 a local method may stop at another
    first-order point (x ~ 0), so no f* is asserted."""
    def f(x):
        return (x[0] - 1.0) ** 2 + jnp.sum(100.0 * (x[0] - x[1:] ** 2) ** 2)

    return nlp_from_functions(f"nondia_n{n}", f, None, x0=np.full(n, -1.0))


@family("denschnb", f_star=0.0, min_n=2)
def denschnb(n):
    """CUTEst DENSCHNB (extended Dennis-Schnabel B): pairwise separable
    sum (a-2)^2 + ((a-2) b)^2 + (b+1)^2 over pairs (a,b); f* = 0 at
    (2, -1)."""
    n -= n % 2

    def f(x):
        a, b = x[0::2], x[1::2]
        return jnp.sum((a - 2.0) ** 2 + ((a - 2.0) * b) ** 2 + (b + 1.0) ** 2)

    return nlp_from_functions(f"denschnb_n{n}", f, None, x0=np.ones(n))


@family("powergq", f_star=0.0)
def powergq(n):
    """POWER-style graded convex quadratic: sum (i * x_i)^2; f* = 0.
    Condition number n^2 — stresses termination scaling."""
    w = jnp.asarray(np.arange(1, n + 1, dtype=float))

    def f(x):
        return jnp.sum((w * x) ** 2)

    return nlp_from_functions(f"powergq_n{n}", f, None, x0=np.ones(n),
                              structure=NLPStructure(hess_bandwidth=0))


@family("dixmaana", f_star=1.0, min_n=6)
def dixmaana(n):
    """CUTEst DIXMAANA (Dixon-Maany, variant A: alpha=1, beta=0, gamma=1/8,
    delta=1/8, all exponents 0): f* = 1 at x = 0; x0 = 2."""
    m = n // 3

    def f(x):
        t1 = jnp.sum(x ** 2)
        t3 = jnp.sum(x[: 2 * m] ** 2 * x[m: 3 * m] ** 4)
        t4 = jnp.sum(x[:m] * x[2 * m: 3 * m])
        return 1.0 + t1 + 0.125 * t3 + 0.125 * t4

    return nlp_from_functions(f"dixmaana_n{n}", f, None, x0=np.full(n, 2.0))


@family("morebv", f_star=0.0)
def morebv(n):
    """MGH #28 / CUTEst MOREBV: discretized two-point boundary value problem
    (least squares), f* = 0; x0_i = t_i (t_i - 1)."""
    h = 1.0 / (n + 1)
    t = jnp.asarray(np.arange(1, n + 1) * h)

    def f(x):
        xp = jnp.concatenate([jnp.zeros(1), x, jnp.zeros(1)])
        r = (2.0 * x - xp[:-2] - xp[2:]
             + 0.5 * h * h * (x + t + 1.0) ** 3)
        return jnp.sum(r ** 2)

    x0 = np.arange(1, n + 1) * h
    x0 = x0 * (x0 - 1.0)
    return nlp_from_functions(f"morebv_n{n}", f, None, x0=x0,
                              structure=NLPStructure(hess_bandwidth=2))


@family("trigmgh", f_star=0.0)
def trigmgh(n):
    """MGH #26 trigonometric function (least squares): f_i = n - sum_j cos x_j
    + i (1 - cos x_i) - sin x_i; f* = 0; x0 = 1/n."""
    idx = jnp.asarray(np.arange(1, n + 1, dtype=float))

    def f(x):
        s = jnp.sum(jnp.cos(x))
        r = n - s + idx * (1.0 - jnp.cos(x)) - jnp.sin(x)
        return jnp.sum(r ** 2)

    return nlp_from_functions(f"trigmgh_n{n}", f, None, x0=np.full(n, 1.0 / n))


@family("eg2")
def eg2(n):
    """CUTEst EG2: sum_{i<n} sin(x_1 + x_i^2 - 1) + 0.5 sin(x_n^2);
    highly nonconvex, no exact f* (≈ -(n-1))."""
    def f(x):
        return (jnp.sum(jnp.sin(x[0] + x[:-1] ** 2 - 1.0))
                + 0.5 * jnp.sin(x[-1] ** 2))

    return nlp_from_functions(f"eg2_n{n}", f, None, x0=np.zeros(n))


@family("curly10", min_n=11)
def curly10(n):
    """CUTEst CURLY10: q_i = sum_{j=i}^{min(i+10,n)} x_j,
    f = sum q_i (q_i^2 (q_i^2 - 20) - 0.1); banded nonconvex."""
    K = 10
    hi = np.minimum(np.arange(n) + K + 1, n)

    def f(x):
        S0 = jnp.concatenate([jnp.zeros(1), jnp.cumsum(x)])
        q = S0[hi] - S0[:n]
        return jnp.sum(q * (q ** 2 * (q ** 2 - 20.0) - 0.1))

    x0 = 1e-4 * np.arange(1, n + 1) / (n + 1)
    return nlp_from_functions(f"curly10_n{n}", f, None, x0=x0,
                              structure=NLPStructure(hess_bandwidth=10))


@family("penalty2", min_n=2)
def penalty2(n):
    """MGH #24 / CUTEst PENALTY2: a = 1e-5, exponential residuals plus the
    weighted-norm penalty ((sum (n-j+1) x_j^2) - 1)^2; x0 = 0.5."""
    a = 1e-5
    i2 = np.arange(2, n + 1)
    y = np.exp(i2 / 10.0) + np.exp((i2 - 1) / 10.0)
    yj = jnp.asarray(y)
    w = jnp.asarray(np.arange(n, 0, -1, dtype=float))
    em = float(np.exp(-0.1))

    def f(x):
        e = jnp.exp(x / 10.0)
        r1 = a * jnp.sum((e[1:] + e[:-1] - yj) ** 2)
        r2 = a * jnp.sum((e[1:] - em) ** 2)
        r3 = (jnp.sum(w * x ** 2) - 1.0) ** 2
        return (x[0] - 0.2) ** 2 + r1 + r2 + r3

    return nlp_from_functions(f"penalty2_n{n}", f, None, x0=np.full(n, 0.5))


@family("noncvxun", min_n=4)
def noncvxun(n):
    """CUTEst NONCVXUN: f = sum g(x_i + x_{p_i} + x_{q_i}) with
    g(t) = t^2 + 4 cos(t), p_i = 2i mod n, q_i = 3i mod n; nonconvex
    with many local minima."""
    p = (2 * (np.arange(n) + 1)) % n
    q = (3 * (np.arange(n) + 1)) % n

    def f(x):
        t = x + x[p] + x[q]
        return jnp.sum(t ** 2 + 4.0 * jnp.cos(t))

    x0 = np.arange(1, n + 1, dtype=float)
    return nlp_from_functions(f"noncvxun_n{n}", f, None, x0=x0)


@family("chandheq_ls", f_star=0.0)
def chandheq_ls(n):
    """Chandrasekhar H-equation (CUTEst CHANDHEQ), c = 0.9, as least squares:
    r_i = x_i - 1 - (c/2) x_i sum_j w mu_i/(mu_i+mu_j) x_j; f* = 0."""
    mu = (np.arange(1, n + 1) - 0.5) / n
    A = (mu[:, None] / (mu[:, None] + mu[None, :])) / n
    Aj = jnp.asarray(A)

    def f(x):
        r = x - 1.0 - 0.45 * x * (Aj @ x)
        return jnp.sum(r ** 2)

    return nlp_from_functions(f"chandheq_ls_n{n}", f, None, x0=np.ones(n))


@family("torsion", min_n=16, sizes=(100, 1000))
def torsion(n):
    """Elastic-plastic torsion (CUTEst TORSION1-style): min 1/2 u^T K u
    - c h^2 sum u on a g x g interior grid, |u_ij| <= dist(ij, boundary);
    c = 5."""
    g = int(np.sqrt(n))
    h = 1.0 / (g + 1)

    def f(u):
        U = u.reshape(g, g)
        Up = jnp.pad(U, 1)
        lap = 4.0 * U - Up[:-2, 1:-1] - Up[2:, 1:-1] - Up[1:-1, :-2] - Up[1:-1, 2:]
        return 0.5 * jnp.sum(U * lap) - 5.0 * h * h * jnp.sum(U)

    ii, jj = np.meshgrid(np.arange(1, g + 1), np.arange(1, g + 1), indexing="ij")
    dist = h * np.minimum(np.minimum(ii, jj), np.minimum(g + 1 - ii, g + 1 - jj))
    return nlp_from_functions(
        f"torsion_n{g * g}", f, None, x0=np.zeros(g * g),
        x_lb=-dist.ravel(), x_ub=dist.ravel(),
        structure=NLPStructure(hess_bandwidth=g))


@family("minsurf", min_n=16, sizes=(100, 1000))
def minsurf(n):
    """Minimal surface (COPS 3.0 / CUTEst MINSURF-class): min sum h^2
    sqrt(1 + |forward-difference gradient|^2) over a g x g grid of free
    heights; boundary fixed to sin(pi s) on two opposite edges."""
    g = int(np.sqrt(n))
    h = 1.0 / (g + 1)
    s = np.arange(0, g + 2) * h
    bnd = jnp.asarray(np.sin(np.pi * s))

    def f(u):
        U = u.reshape(g, g)
        Up = jnp.pad(U, 1)
        Up = Up.at[0, :].set(bnd)
        Up = Up.at[-1, :].set(bnd)
        dx = (Up[1:, :] - Up[:-1, :]) / h
        dy = (Up[:, 1:] - Up[:, :-1]) / h
        area = jnp.sqrt(1.0 + dx[:, :-1] ** 2 + dy[:-1, :] ** 2)
        return h * h * jnp.sum(area)

    return nlp_from_functions(
        f"minsurf_n{g * g}", f, None, x0=np.full(g * g, 0.5),
        structure=NLPStructure(hess_bandwidth=g))


@family("bratu2d_ls", f_star=0.0, min_n=16, sizes=(100, 1000))
def bratu2d_ls(n):
    """2-D Bratu problem -lap(u) = lam e^u (lam = 4 < critical 6.81), as a
    least-squares nonlinear system on a g x g interior grid; f* = 0."""
    g = int(np.sqrt(n))
    h = 1.0 / (g + 1)
    lam = 4.0

    def f(u):
        U = u.reshape(g, g)
        Up = jnp.pad(U, 1)
        lap = 4.0 * U - Up[:-2, 1:-1] - Up[2:, 1:-1] - Up[1:-1, :-2] - Up[1:-1, 2:]
        r = lap - h * h * lam * jnp.exp(U)
        return jnp.sum(r ** 2)

    return nlp_from_functions(f"bratu2d_ls_n{g * g}", f, None,
                              x0=np.zeros(g * g),
                              structure=NLPStructure(hess_bandwidth=2 * g))


@family("clnlbeam", min_n=9)
def clnlbeam(n):
    """COPS 3.0 / CUTEst CLNLBEAM: nonlinear beam optimal control,
    min sum h/2 (u_i^2 + u_{i+1}^2) + alpha h/2 (cos t_i + cos t_{i+1}),
    s.t. trapezoidal dynamics x' = sin t, t' = u; |t| <= 1,
    |x| <= 0.05, endpoints pinned at 0; alpha = 350."""
    N = max(2, n // 3)
    h = 1.0 / N
    alpha = 350.0

    def split(z):
        t = z[: N + 1]
        x = z[N + 1: 2 * (N + 1)]
        u = z[2 * (N + 1):]
        return t, x, u

    def f(z):
        t, x, u = split(z)
        return jnp.sum(0.5 * h * (u[1:] ** 2 + u[:-1] ** 2)
                       + 0.5 * alpha * h * (jnp.cos(t[1:]) + jnp.cos(t[:-1])))

    def c(z):
        t, x, u = split(z)
        r1 = x[1:] - x[:-1] - 0.5 * h * (jnp.sin(t[1:]) + jnp.sin(t[:-1]))
        r2 = t[1:] - t[:-1] - 0.5 * h * (u[1:] + u[:-1])
        return jnp.concatenate([r1, r2])

    nv = 3 * (N + 1)
    ih = np.arange(N + 1) * h
    x0 = np.concatenate([0.05 * np.cos(np.pi * ih),        # t init
                         0.025 * np.sin(np.pi * ih),       # x init
                         np.zeros(N + 1)])                 # u init
    xl = np.concatenate([np.full(N + 1, -1.0), np.full(N + 1, -0.05),
                         np.full(N + 1, -INF)])
    xu = np.concatenate([np.full(N + 1, 1.0), np.full(N + 1, 0.05),
                         np.full(N + 1, INF)])
    for k in (0, N, N + 1, 2 * N + 1):  # t and x endpoints pinned
        xl[k] = xu[k] = 0.0
        x0[k] = 0.0
    nlp = nlp_from_functions(
        f"clnlbeam_n{nv}", f, c, x0=x0, x_lb=xl, x_ub=xu,
        c_lb=np.zeros(2 * N), c_ub=np.zeros(2 * N))
    # stage interleave (t_k, x_k, u_k) -> width-6 dynamics windows
    perm = np.empty(nv, dtype=np.int64)
    k_idx = np.arange(N + 1)
    perm[3 * k_idx] = k_idx                  # t_k
    perm[3 * k_idx + 1] = (N + 1) + k_idx    # x_k
    perm[3 * k_idx + 2] = 2 * (N + 1) + k_idx  # u_k
    starts = np.concatenate([3 * np.arange(N, dtype=np.int64)] * 2)
    nlp = transforms.permute_variables(nlp, perm)
    return dataclasses.replace(nlp, structure=NLPStructure(
        hess_bandwidth=0, jac_starts=np.minimum(starts, nv - 6),
        jac_width=6))


_reg_all()
