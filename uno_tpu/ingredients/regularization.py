"""Inertia-correcting regularization of the augmented KKT system.

Functional port-free equivalent of the reference's PrimalDualRegularization
loop (/root/reference/uno/ingredients/regularization_strategies/
PrimalDualRegularization.hpp:133-226): factorize [H + delta*I, J^T; J, -eps*I],
compare the pivot-sign inertia against the expected (n, m, 0), and escalate
delta on Uno's warm-started schedule (start at 1e-4 or prev/3; x100 fast when
cold or after 8 attempts, x8 slow otherwise; failure above 1e40).

Exceptions become flags in the carried state: UnstableRegularization -> the
`failed` output (the IPM then enters feasibility restoration).

The data-dependent refactorization count becomes a bounded `lax.while_loop`
— each iteration is one dense blocked LDL^T.  jit/vmap safe.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax.numpy as jnp
from jax import lax

from uno_tpu.linalg.ldlt import (LDLT, ldlt_factor, ldlt_factor_blocked,
                                 ldlt_factor_unrolled)


def pick_factorizer(dim: int, block: int):
    """Small KKT systems (CUTEst-class) are fully unrolled: static slices
    only, so vmapped batches compile to fused elementwise kernels with no
    dynamic-update-slice traffic.  Mid-size systems use the fori_loop column
    variant; large systems the blocked panel variant, whose trailing update
    is one matrix product per panel.

    The thresholds (32, 64) and the default panel width
    (`Options.ldlt_block_size` = 32) were chosen on another machine and are
    not yet measured on the H100 (ROADMAP C7, A7)."""
    if dim <= 32:
        return ldlt_factor_unrolled
    if dim <= 64:
        return ldlt_factor
    return partial(ldlt_factor_blocked, block=min(block, -(-dim // 8) * 8))


class RegularizedFactorization(NamedTuple):
    fac: LDLT
    delta: jnp.ndarray          # primal regularization actually used
    eps: jnp.ndarray            # dual regularization actually used
    prev_delta: jnp.ndarray     # warm-start value for the next KKT solve
    failed: jnp.ndarray         # bool: UnstableRegularization
    singular: jnp.ndarray       # bool: first factorization was singular
    attempts: jnp.ndarray       # int: number of factorizations performed


def regularize_and_factor(
    assemble: Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray],
    expected_pos: int,
    expected_neg: int,
    dual_reg_parameter,          # mu^0.25 for the barrier problem
    prev_delta,
    opts,
    block: int = 32,
    factorizer=None,
) -> RegularizedFactorization:
    """assemble(delta, eps) must build the full augmented matrix with the
    regularization applied (+delta on primal diagonal slots, -eps on dual).

    `factorizer` overrides the backend choice — e.g. the mesh-distributed
    KKT backend (parallel/dist_ldlt.py); it only needs to return an object
    with num_pos/num_neg/num_zero fields (inertia) as a pytree of arrays."""

    factorize = factorizer if factorizer is not None else pick_factorizer(
        expected_pos + expected_neg, block)
    # mixed precision (MA57-style, MA57Solver.cpp:137-145): factor in f32,
    # refine the solve in f64 (kkt_dtype option)
    factor_dtype = jnp.dtype(getattr(opts, "kkt_dtype", "float64"))

    def factor(delta, eps):
        # assemble may return a dense matrix OR a structured pytree (e.g.
        # BandedKKT); cast every float leaf to the factor dtype either way
        import jax
        assembled = assemble(delta, eps)
        assembled = jax.tree_util.tree_map(
            lambda a: a.astype(factor_dtype), assembled)
        return factorize(assembled)

    def inertia_ok(fac):
        return (fac.num_pos == expected_pos) & (fac.num_neg == expected_neg) \
            & (fac.num_zero == 0)

    zero = jnp.asarray(0.0)
    fac0 = factor(zero, zero)
    ok0 = inertia_ok(fac0)
    singular0 = fac0.num_zero > 0

    # initial regularization factors (PrimalDualRegularization.hpp:166-186).
    # Deviation: the reference applies the dual regularization eps only when
    # the factorization reports singularity; an unpivoted LDL^T cannot detect
    # near-singularity reliably (pivot magnitudes legitimately span ~18 orders
    # of magnitude in a barrier KKT), so we apply the (tiny, 1e-8*mu^0.25)
    # eps on ANY failed first attempt — it is negligible for well-posed
    # systems and repairs rank-deficient Jacobians.
    eps1 = jnp.where(~ok0, opts.dual_regularization_fraction * dual_reg_parameter, 0.0)
    delta1 = jnp.where(
        prev_delta == 0.0,
        opts.primal_regularization_initial_factor,
        jnp.maximum(opts.primal_regularization_lb,
                    prev_delta / opts.primal_regularization_decrease_factor),
    )

    def cond(carry):
        _, _, _, attempts, done, failed = carry
        return ~done & ~failed & (attempts < opts.max_regularization_attempts)

    def body(carry):
        delta, eps, fac, attempts, done, failed = carry
        fac = factor(delta, eps)
        attempts = attempts + 1
        good = inertia_ok(fac)
        # escalation factor (.hpp:203-209)
        fast = (prev_delta == 0.0) | (attempts > opts.threshold_unsuccessful_attempts)
        grow = jnp.where(fast, opts.primal_regularization_fast_increase_factor,
                         opts.primal_regularization_slow_increase_factor)
        next_delta = jnp.where(good, delta, delta * grow)
        failed = ~good & (next_delta > opts.regularization_failure_threshold)
        return next_delta, eps, fac, attempts, good, failed

    init = (delta1, eps1, fac0, jnp.asarray(1), ok0, jnp.asarray(False))
    delta, eps, fac, attempts, done, failed = lax.while_loop(cond, body, init)

    used_delta = jnp.where(ok0, 0.0, delta)
    used_eps = jnp.where(ok0, 0.0, eps)
    # previous_primal_regularization is only updated on a successful
    # *regularized* factorization (.hpp:199-201)
    new_prev = jnp.where(ok0, prev_delta, jnp.where(done, delta, prev_delta))
    return RegularizedFactorization(
        fac=fac, delta=used_delta, eps=used_eps, prev_delta=new_prev,
        failed=failed | (~done), singular=singular0, attempts=attempts,
    )
