"""LDL^T kernel tests: factorization accuracy, inertia, singularity, batching.

Direct analogue of the reference's functional solver tests on fixed small
systems with known solutions and inertia (SURVEY.md §4,
unotest/functional_tests/MA57SolverTests.cpp style).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from uno_tpu.linalg import (ldlt_factor, ldlt_factor_blocked, ldlt_factor_unrolled,
                            ldlt_solve, ldlt_refine)
from uno_tpu.linalg.ldlt import barrier_kkt_like as _barrier_kkt_like


def fixed_system():
    # a fixed 5x5 symmetric-indefinite system with known solution;
    # true inertia (2, 3, 0) (verified against eigvalsh)
    A = np.array([
        [2.0, 3.0, 0.0, 3.0, 0.0],
        [3.0, 0.0, 4.0, 6.0, 1.0],
        [0.0, 4.0, 1.0, 0.0, 5.0],
        [3.0, 6.0, 0.0, 0.0, 0.0],
        [0.0, 1.0, 5.0, 0.0, 0.0],
    ])
    rhs = np.array([8.0, 45.0, 31.0, 15.0, 17.0])
    return A, rhs


@pytest.mark.parametrize("factor", [ldlt_factor, ldlt_factor_blocked, ldlt_factor_unrolled])
def test_factor_solve_fixed_system(factor):
    A, rhs = fixed_system()
    fac = factor(jnp.asarray(A))
    x = ldlt_solve(fac, jnp.asarray(rhs))
    assert np.allclose(np.asarray(A @ x), rhs, atol=1e-8)
    # reconstruction
    L, d = np.asarray(fac.L), np.asarray(fac.d)
    assert np.allclose(L @ np.diag(d) @ L.T, A, atol=1e-8)


@pytest.mark.parametrize("factor", [ldlt_factor, ldlt_factor_blocked, ldlt_factor_unrolled])
def test_inertia_saddle_point(factor):
    A, _ = fixed_system()
    fac = factor(jnp.asarray(A))
    assert (int(fac.num_pos), int(fac.num_neg), int(fac.num_zero)) == (2, 3, 0)


@pytest.mark.parametrize("factor", [ldlt_factor, ldlt_factor_blocked, ldlt_factor_unrolled])
def test_inertia_definite(factor):
    rng = np.random.default_rng(0)
    B = rng.standard_normal((12, 12))
    spd = B @ B.T + 12 * np.eye(12)
    fac = factor(jnp.asarray(spd))
    assert (int(fac.num_pos), int(fac.num_neg), int(fac.num_zero)) == (12, 0, 0)
    fac = factor(jnp.asarray(-spd))
    assert (int(fac.num_pos), int(fac.num_neg), int(fac.num_zero)) == (0, 12, 0)


@pytest.mark.parametrize("factor", [ldlt_factor, ldlt_factor_blocked, ldlt_factor_unrolled])
def test_singular_detection(factor):
    # rank-deficient matrix: diag(1, 1, 0) in a rotated basis would pivot to
    # zero; use a plainly singular arrowhead
    A = np.array([
        [1.0, 0.0, 1.0],
        [0.0, 1.0, 1.0],
        [1.0, 1.0, 2.0],
    ])  # third row = row1 + row2 -> singular
    fac = factor(jnp.asarray(A))
    assert int(fac.num_zero) >= 1


@pytest.mark.parametrize("n", [1, 2, 7, 33, 64, 101])
def test_random_sizes_blocked_vs_plain(n):
    rng = np.random.default_rng(n)
    B = rng.standard_normal((n, n))
    A = (B + B.T) / 2 + np.diag(rng.uniform(1, 2, n)) * n  # diag dominant-ish
    rhs = rng.standard_normal(n)
    f1 = ldlt_factor(jnp.asarray(A))
    f2 = ldlt_factor_blocked(jnp.asarray(A), block=16)
    x1 = np.asarray(ldlt_solve(f1, jnp.asarray(rhs)))
    x2 = np.asarray(ldlt_solve(f2, jnp.asarray(rhs)))
    assert np.allclose(A @ x1, rhs, atol=1e-7)
    assert np.allclose(x1, x2, atol=1e-7)
    assert int(f1.num_pos) == int(f2.num_pos)
    assert int(f1.num_neg) == int(f2.num_neg)


def test_vmap_batched_factorization():
    rng = np.random.default_rng(3)
    n, batch = 16, 8
    Bs = rng.standard_normal((batch, n, n))
    As = (Bs + np.transpose(Bs, (0, 2, 1))) / 2 + 20 * np.eye(n)
    rhs = rng.standard_normal((batch, n))
    facs = jax.vmap(lambda A: ldlt_factor_blocked(A, block=8))(jnp.asarray(As))
    xs = jax.vmap(ldlt_solve)(facs, jnp.asarray(rhs))
    assert np.allclose(np.einsum("bij,bj->bi", As, np.asarray(xs)), rhs, atol=1e-7)


def test_f32_with_refinement():
    A, rhs = fixed_system()
    A32 = jnp.asarray(A, dtype=jnp.float32)
    rhs32 = jnp.asarray(rhs, dtype=jnp.float32)
    fac = ldlt_factor(A32)
    x = ldlt_solve(fac, rhs32)
    x = ldlt_refine(A32, fac, rhs32, x)
    assert np.allclose(np.asarray(A @ np.asarray(x, dtype=np.float64)), rhs, atol=1e-3)


@pytest.mark.parametrize("dim", [8, 32, 33, 64, 65, 256, 1280, 2000])
def test_pick_factorizer_routing(dim):
    """Unrolled up to 32, column variant up to 64, XLA blocked above — and
    no Pallas kernel on any route."""
    from uno_tpu.ingredients.regularization import pick_factorizer
    fn = pick_factorizer(dim, 32)
    if dim <= 32:
        assert fn is ldlt_factor_unrolled
    elif dim <= 64:
        assert fn is ldlt_factor
    else:
        assert fn.func is ldlt_factor_blocked
        assert fn.keywords == {"block": 32}
    jaxpr = str(jax.make_jaxpr(fn)(jax.ShapeDtypeStruct((dim, dim),
                                                        jnp.float32)))
    assert "pallas" not in jaxpr


def test_pick_factorizer_block_clamped_to_dim():
    from uno_tpu.ingredients.regularization import pick_factorizer
    assert pick_factorizer(70, 128).keywords == {"block": 72}


@pytest.mark.parametrize("dim", [40, 640])
def test_f32_blocked_highest_matches_f64_reference(dim):
    """The f32 blocked factorization, at the precision it sets (HIGHEST),
    against numpy f64: exact inertia, reconstruction to 1e-4 of ||K||."""
    from chip_smoke import ldlt_vs_reference
    from uno_tpu.linalg.ldlt import FACTOR_PRECISION
    assert FACTOR_PRECISION == jax.lax.Precision.HIGHEST
    m = dim // 5
    K = _barrier_kkt_like(dim - m, m, 1)
    fac = ldlt_factor_blocked(jnp.asarray(K, dtype=jnp.float32), block=32)
    cmp = ldlt_vs_reference(K, fac)
    assert not cmp["mismatch"], cmp["inertia"]
    assert cmp["recon"] <= 1e-4


def test_ldlt_backend_pallas_rejected():
    """The Pallas LDL^T backend is gone: naming it is a clean error."""
    from uno_tpu.options import preset
    import uno_tpu
    from uno_tpu.model.library import get_problem
    with pytest.raises(ValueError, match="ldlt_backend"):
        preset("ipopt", ldlt_backend="pallas")
    with pytest.raises(ValueError, match="ldlt_backend"):
        uno_tpu.solve(get_problem("hs015"), preset="ipopt",
                      ldlt_backend="pallas")


# ---------------------------------------------------------------------------
# f32 inertia stress: the bench default is
# kkt_dtype="float32"; wrong inertia silently mis-drives the regularization
# loop.  Property-test num_pos/num_neg of the shipped factorizers in f32
# against an f64 oracle on barrier-KKT-like spectra (diagonal spreads 1e+-9).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [256, 512, 1024])
def test_f32_inertia_matches_f64_oracle(n):
    from uno_tpu.ingredients.regularization import pick_factorizer

    m = n // 4
    dim = n + m
    fac_fn = pick_factorizer(dim, 32)
    mismatches = 0
    trials = 4 if n < 1024 else 2
    for seed in range(trials):
        K = _barrier_kkt_like(n, m, seed)
        # f64 oracle: numpy eigvalsh signs (exact inertia)
        eigs = np.linalg.eigvalsh(K)
        # the f32 factorization cannot resolve |lambda| below ~eps*||K||;
        # exclude near-singular draws from the strict comparison
        scale = np.max(np.abs(eigs))
        if np.min(np.abs(eigs)) < 1e-5 * scale:
            continue
        n_pos64 = int(np.sum(eigs > 0))
        n_neg64 = int(np.sum(eigs < 0))
        fac32 = jax.jit(fac_fn)(jnp.asarray(K, dtype=jnp.float32))
        if (int(fac32.num_pos) != n_pos64 or int(fac32.num_neg) != n_neg64
                or int(fac32.num_zero) != 0):
            mismatches += 1
    # documented tolerance: f32 inertia must be exact on well-separated
    # barrier spectra (the regularization loop depends on it)
    assert mismatches == 0, f"n={n}: {mismatches}/{trials} inertia mismatches"


def test_f32_inertia_after_regularization_is_corrected():
    """Even when raw f32 inertia is wrong on a near-singular K, the
    inertia-correction loop (regularize_and_factor) must reach the target
    saddle inertia (n, m, 0) — the property the IPM actually relies on."""
    from uno_tpu.ingredients.regularization import regularize_and_factor
    from uno_tpu.options import preset

    n, m = 128, 32
    K = _barrier_kkt_like(n, m, 123)
    K[0, 0] = 0.0  # make the (1,1) block singular
    opts = preset("ipopt", kkt_dtype="float32")

    def assemble(delta, eps):
        Kd = jnp.asarray(K, dtype=jnp.float32)
        Kd = Kd + jnp.diag(jnp.concatenate([
            jnp.full((n,), delta, jnp.float32),
            jnp.full((m,), -eps, jnp.float32)]))
        return Kd

    reg = jax.jit(lambda: regularize_and_factor(
        assemble, n, m, jnp.asarray(1e-8), jnp.asarray(0.0), opts, block=32))()
    assert not bool(reg.failed)
    assert int(reg.fac.num_pos) == n
    assert int(reg.fac.num_neg) == m
    assert int(reg.fac.num_zero) == 0
