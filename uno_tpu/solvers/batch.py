"""Batched (vmapped) IPM driver with per-instance convergence masks.

The reference is strictly single-instance single-core; the accelerator scale
axis (SURVEY.md §2.15, BASELINE.md) is a vmapped batch of independent NLP
instances of the same structure (same functions/shapes, different x0/params),
optionally sharded across chips.

Per-instance convergence: `jax.vmap` of the solver's `lax.while_loop` lowers
to a single loop that runs until ALL instances terminate, with converged
instances' states frozen by select — exactly the per-instance convergence
mask semantics, for free.

Limitation (documented): gradient-based function scaling (scale_functions)
uses the template instance's scaling for the whole batch, since per-instance
scaling would make constraint bounds instance-dependent (non-static).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from uno_tpu.model.nlp import NLP
from uno_tpu.options import Options
from uno_tpu.solvers import ipm as ipm_mod
from uno_tpu.solvers.ipm import (IPMState, RUNNING, STATUS_NAMES, build_ipm,
                                 make_initial_state)


@dataclass
class BatchResult:
    status: np.ndarray        # (B,) int status codes
    x: np.ndarray             # (B, n_orig)
    objective: np.ndarray     # (B,)
    iterations: np.ndarray    # (B,)
    primal_feasibility: np.ndarray
    stationarity: np.ndarray
    cpu_time: float

    @property
    def num_solved(self) -> int:
        return int(np.sum((self.status == ipm_mod.OPTIMAL)
                          | (self.status == ipm_mod.ALMOST_OPTIMAL)))

    def status_names(self):
        from uno_tpu.solvers.sqp_fused import SQP_STATUS_NAMES
        return [SQP_STATUS_NAMES[int(s)] for s in self.status]


def build_batch_ipm(nlp: NLP, opts: Options, params_example=None,
                    batch_last: bool = True):
    """Returns (prob, solve_batch) where solve_batch(x0_batch, params_batch)
    -> final IPMState batch.  x0_batch is in ORIGINAL variable space (B, n);
    slacks are initialized internally.

    batch_last (default): map the batch over the TRAILING axis of every
    array, so the batch is the contiguous minor dimension and each tiny
    solver dimension (n ~ 10..100) is not padded to a vector tile.  This
    default was chosen on another machine and is not yet measured on the
    H100 (ROADMAP C7).  The wrapper transposes at the boundary, so callers
    still pass/receive batch-first."""
    prob, ws, step, _ = build_ipm(nlp, opts)
    n_slack = prob.n - nlp.n

    from uno_tpu.solvers.ipm import canonicalize_state

    def solve_one(x0, params):
        x0_full = jnp.concatenate([x0, jnp.zeros((n_slack,), dtype=x0.dtype)]) \
            if n_slack else x0
        s0 = canonicalize_state(make_initial_state(prob, ws, opts, x0=x0_full, params=params))
        return lax.while_loop(lambda s: s.status == RUNNING, step, s0)

    return prob, _vmap_solver(solve_one, nlp.n, params_example, batch_last,
                              clock=getattr(step, "run_clock", None))


def _vmap_solver(solve_one, n, params_example, batch_last, clock=None):
    """vmap solve_one(x0, params) with the batch over the TRAILING axis of
    every leaf (see build_batch_ipm layout rationale); callers still pass and
    receive batch-first."""
    if not batch_last:
        mapped_bf = jax.jit(jax.vmap(solve_one))
        if clock is None:
            return mapped_bf

        def run_bf(x0_batch, params_batch=None):
            clock.restart()
            return mapped_bf(x0_batch, params_batch)

        return run_bf

    x0_spec = jax.ShapeDtypeStruct((n,), jnp.float64)
    p_spec = None if params_example is None else jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(jnp.asarray(a).shape, jnp.asarray(a).dtype),
        params_example)
    out_shapes = jax.eval_shape(solve_one, x0_spec, p_spec)
    out_axes = jax.tree_util.tree_map(lambda s: s.ndim, out_shapes)
    in_axes = (1, None if params_example is None else
               jax.tree_util.tree_map(lambda s: s.ndim, p_spec))
    mapped = jax.jit(jax.vmap(solve_one, in_axes=in_axes, out_axes=out_axes))

    def run(x0_batch, params_batch=None):
        if clock is not None:
            # arm the in-loop wall-clock limit at dispatch (one shared host
            # clock per batched run; see utils/timer.py)
            clock.restart()
        x0_t = jnp.moveaxis(jnp.asarray(x0_batch), 0, -1)
        p_t = None if params_batch is None else jax.tree_util.tree_map(
            lambda a: jnp.moveaxis(jnp.asarray(a), 0, -1), params_batch)
        final = mapped(x0_t, p_t)
        # transpose back to batch-first for callers
        return jax.tree_util.tree_map(
            lambda a: jnp.moveaxis(a, -1, 0) if hasattr(a, "ndim") and a.ndim else a,
            final)

    return run


def build_batch_sqp(nlp: NLP, opts: Options, params_example=None,
                    batch_last: bool = True):
    """Batched (vmapped) fused SQP: every TR+filter/funnel preset
    (filtersqp, funnelsqp, filterslp) rides the same batch axis as the
    IPM.  Returns (prob, run) like build_batch_ipm."""
    from uno_tpu.solvers.sqp_fused import (build_byrd_fused, build_sqp_fused,
                                           make_initial_byrd_state,
                                           make_initial_sqp_state)
    from uno_tpu.solvers.ipm import canonicalize_state

    from uno_tpu.api import is_byrd_family
    if is_byrd_family(opts):
        prob, ws, step, _ = build_byrd_fused(nlp, opts)
        make_init = make_initial_byrd_state
    else:
        prob, ws, step, _ = build_sqp_fused(nlp, opts)
        make_init = make_initial_sqp_state

    def solve_one(x0, params):
        s0 = canonicalize_state(
            make_init(prob, ws, opts, x0=x0, params=params))
        return lax.while_loop(lambda s: s.status == RUNNING, step, s0)

    return prob, _vmap_solver(solve_one, nlp.n, params_example, batch_last,
                              clock=getattr(step, "run_clock", None))


def solve_batch(nlp: NLP, opts: Optional[Options] = None, x0_batch=None,
                params_batch=None, preset: Optional[str] = None,
                **overrides) -> BatchResult:
    """Solve a batch of instances; returns aggregated results.

    Accepts either an Options object or a preset name with overrides —
    `solve_batch(nlp, x0_batch=..., preset="filtersqp")` batches the fused
    SQP path exactly like the ipopt preset batches the IPM."""
    if opts is None:
        from uno_tpu.options import preset as _preset
        opts = _preset(preset or "ipopt", **overrides)
    elif overrides:
        opts = opts.replace(**overrides)
    t0 = time.time()
    x0_batch = jnp.asarray(x0_batch)
    B = x0_batch.shape[0]
    if params_batch is None and nlp.params is not None:
        params_batch = jax.tree_util.tree_map(
            lambda a: jnp.broadcast_to(a, (B,) + jnp.asarray(a).shape), nlp.params)
    p_ex = None if params_batch is None else \
        jax.tree_util.tree_map(lambda a: a[0], params_batch)
    if opts.inequality_handling_method == "inequality_constrained":
        prob, run = build_batch_sqp(nlp, opts, params_example=p_ex)
    else:
        prob, run = build_batch_ipm(nlp, opts, params_example=p_ex)
    final = jax.block_until_ready(run(x0_batch, params_batch))
    elapsed = time.time() - t0

    x_orig = np.asarray(final.x)[:, : nlp.n]
    if params_batch is not None:
        fvals = np.asarray(jax.vmap(nlp.objective)(jnp.asarray(x_orig),
                                                   params_batch))
    else:
        fvals = np.asarray(jax.vmap(lambda xv: nlp.objective(xv))(
            jnp.asarray(x_orig)))
    return BatchResult(
        status=np.asarray(final.status),
        x=x_orig,
        objective=fvals,
        iterations=np.asarray(final.iteration),
        primal_feasibility=np.asarray(final.primal_feas),
        stationarity=np.asarray(final.stat / final.stat_scaling),
        cpu_time=elapsed,
    )


def _bucketed_runner(init_one, step, n, params_example,
                     segment, min_bucket):
    """Shared machinery of the bucketed batch drivers: run the fused step
    in `segment`-iteration slices and, between slices, compact the
    still-running instances into a power-of-two bucket HALF (or less) the
    current size — a device-side gather over the trailing batch axis, so
    no state ever leaves the chip; only the running-count scalar syncs to
    host to pick the bucket size.  One extra XLA program compiles per
    visited bucket size (bounded by log2(B/min_bucket))."""

    def seg_one(state, limit):
        return lax.while_loop(
            lambda s: (s.status == RUNNING) & (s.iteration < limit),
            step, state)

    # batch-last axes (see build_batch_ipm for the layout rationale)
    x0_spec = jax.ShapeDtypeStruct((n,), jnp.float64)
    p_spec = None if params_example is None else jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(jnp.asarray(a).shape, jnp.asarray(a).dtype),
        params_example)
    state_shapes = jax.eval_shape(init_one, x0_spec, p_spec)
    state_axes = jax.tree_util.tree_map(lambda s: s.ndim, state_shapes)
    p_axes = None if params_example is None else \
        jax.tree_util.tree_map(lambda s: s.ndim, p_spec)
    init_m = jax.jit(jax.vmap(init_one, in_axes=(1, p_axes), out_axes=state_axes))
    seg_m = jax.jit(jax.vmap(seg_one, in_axes=(state_axes, None),
                             out_axes=state_axes))

    @jax.jit
    def running_count(state):
        return jnp.sum(state.status == RUNNING)

    def compact(state, bucket):
        """Gather the running lanes (stable order) into the first `bucket`
        slots; returns (small_state, sel) with sel the source lane of each
        slot.  Trailing slots replay already-converged lanes — harmless:
        seg_one freezes them, and the scatter writes them back unchanged."""
        order = jnp.argsort(jnp.where(state.status == RUNNING, 0, 1),
                            stable=True)
        sel = order[:bucket]
        small = jax.tree_util.tree_map(
            lambda a: jnp.take(a, sel, axis=-1), state)
        return small, sel

    compact_j = jax.jit(compact, static_argnums=1)

    @jax.jit
    def scatter(result, small, idx):
        return jax.tree_util.tree_map(
            lambda r, s: r.at[..., idx].set(s), result, small)

    @jax.jit
    def take_idx(cur_idx, sel):
        return jnp.take(cur_idx, sel)

    def run(x0_batch, params_batch=None):
        B = int(jnp.asarray(x0_batch).shape[0])
        x0_t = jnp.moveaxis(jnp.asarray(x0_batch), 0, -1)
        p_t = None if params_batch is None else jax.tree_util.tree_map(
            lambda a: jnp.moveaxis(jnp.asarray(a), 0, -1), params_batch)
        cur = init_m(x0_t, p_t)
        result = cur
        cur_idx = None            # None == identity (bucket == B)
        bucket = B
        limit = segment
        while True:
            cur = seg_m(cur, limit)
            if cur_idx is None:
                result = cur
            else:
                result = scatter(result, cur, cur_idx)
            cnt = int(running_count(cur))   # the only host sync per slice
            if cnt == 0:
                break
            limit += segment
            new_bucket = bucket
            while new_bucket // 2 >= max(min_bucket, cnt, 1):
                new_bucket //= 2
            if new_bucket < bucket:
                cur, sel = compact_j(cur, new_bucket)
                cur_idx = sel if cur_idx is None else take_idx(cur_idx, sel)
                bucket = new_bucket
        return jax.tree_util.tree_map(
            lambda a: jnp.moveaxis(a, -1, 0) if hasattr(a, "ndim") and a.ndim else a,
            result)

    return run


def build_bucketed_batch_ipm(nlp: NLP, opts: Options, params_example=None,
                             segment: int = 4, min_bucket: int = 1024):
    """Iteration-count bucketing for the batched IPM: a vmapped
    `lax.while_loop` runs every instance for max-over-batch iterations
    (converged lanes are frozen by select but still occupy batch lanes).
    With a long-tailed iteration distribution (e.g. mean 9.3 / max 16 on
    the bench family) that wastes ~40% of the lanes; the bucketed driver
    retires them (see _bucketed_runner).

    Returns (prob, run) with run(x0_batch, params_batch) -> final state
    (batch-first), like build_batch_ipm."""
    prob, ws, step, _ = build_ipm(nlp, opts)
    n_slack = prob.n - nlp.n

    from uno_tpu.solvers.ipm import canonicalize_state

    def init_one(x0, params):
        x0_full = jnp.concatenate([x0, jnp.zeros((n_slack,), dtype=x0.dtype)]) \
            if n_slack else x0
        return canonicalize_state(make_initial_state(prob, ws, opts,
                                                     x0=x0_full, params=params))

    return prob, _bucketed_runner(init_one, step, nlp.n, params_example,
                                  segment, min_bucket)


def build_bucketed_batch_sqp(nlp: NLP, opts: Options, params_example=None,
                             segment: int = 8, min_bucket: int = 64):
    """Iteration-count bucketing for the batched fused SQP (round-4 verdict
    item 3a): the SQP analogue of build_bucketed_batch_ipm, so a handful of
    stalled instances cannot hold a whole vmapped TR loop hostage — the
    batch compacts as instances converge, and the long tail runs at a
    fraction of the lane cost.  Matches the retirement economics of the
    reference's sequential per-instance BQPD loop
    (BQPDSolver.cpp:212-244), which never pays for finished instances."""
    from uno_tpu.solvers.sqp_fused import (build_byrd_fused, build_sqp_fused,
                                           make_initial_byrd_state,
                                           make_initial_sqp_state)
    from uno_tpu.solvers.ipm import canonicalize_state

    from uno_tpu.api import is_byrd_family
    if is_byrd_family(opts):
        prob, ws, step, _ = build_byrd_fused(nlp, opts)
        make_init = make_initial_byrd_state
    else:
        prob, ws, step, _ = build_sqp_fused(nlp, opts)
        make_init = make_initial_sqp_state

    def init_one(x0, params):
        return canonicalize_state(
            make_init(prob, ws, opts, x0=x0, params=params))

    return prob, _bucketed_runner(init_one, step, nlp.n, params_example,
                                  segment, min_bucket)
