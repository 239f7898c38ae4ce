"""Globalization strategies as pure functions over fixed-shape state.

The reference's Filter (/root/reference/uno/ingredients/globalization_strategies/
switching_methods/filter_methods/filters/Filter.cpp) is a capacity-bounded
sorted Pareto front of (infeasibility h, objective phi) pairs with margins
beta/gamma.  Here it is a pair of fixed-size arrays (+inf padding) sorted by
h ascending — all operations are vectorized, jit/vmap-compatible.

Acceptance logic:
  * Fletcher filter method   <- FletcherFilterMethod.cpp:15-66
  * Waechter filter method   <- WaechterFilterMethod.cpp:25-90
  * switching/armijo helpers <- SwitchingMethod.cpp, GlobalizationStrategy.cpp
  * l1 merit                 <- l1MeritFunction.cpp
  * funnel                   <- FunnelMethod.cpp / Funnel.cpp
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import lax

BIG = jnp.inf


def _compact(h, phi, keep):
    """Stable partition: move `keep` entries to the front (relative order
    preserved), +inf padding behind.  Because the kept entries are already in
    relative sorted order, this replaces a full `lax.sort` — which lowers to
    ~log^2(capacity) serial bitonic passes over the (batch, capacity) arrays
    under vmap (profiled at ~0.75 ms each at B=4096) — with a one-hot
    min-contraction over a (capacity, capacity) broadcast that XLA fuses
    into a single reduce kernel."""
    cap = h.shape[-1]
    iota = lax.iota(jnp.int32, cap)
    pos = jnp.cumsum(keep.astype(jnp.int32), axis=-1) - 1   # target slot
    onehot = (pos[..., :, None] == iota) & keep[..., :, None]
    h_c = jnp.min(jnp.where(onehot, h[..., :, None], BIG), axis=-2)
    phi_c = jnp.min(jnp.where(onehot, phi[..., :, None], BIG), axis=-2)
    return h_c, phi_c


def _sorted_insert(h, phi, h_new, phi_new):
    """Insert (h_new, phi_new) into h-ascending arrays whose last slot is
    free (+inf), keeping the sort: a shift-by-one select instead of a
    re-sort.  Ties insert after equal-h entries (matching the stable sort
    with the new entry appended at the back)."""
    cap = h.shape[-1]
    iota = lax.iota(jnp.int32, cap)
    pos = jnp.sum(h <= h_new, axis=-1, keepdims=True)  # insertion index
    h_prev = jnp.concatenate([h[..., :1], h[..., :-1]], axis=-1)   # h[i-1]
    phi_prev = jnp.concatenate([phi[..., :1], phi[..., :-1]], axis=-1)
    h_out = jnp.where(iota < pos, h, jnp.where(iota == pos, h_new, h_prev))
    phi_out = jnp.where(iota < pos, phi,
                        jnp.where(iota == pos, phi_new, phi_prev))
    return h_out, phi_out


def _at_index(arr, idx):
    """arr[idx] for a traced scalar idx without a gather: one-hot contraction
    over the (tiny, static) capacity axis — elementwise under vmap."""
    iota = lax.iota(jnp.int32, arr.shape[-1])
    return jnp.sum(jnp.where(iota == idx, arr, 0.0), axis=-1)


class FilterState(NamedTuple):
    h: jnp.ndarray    # (capacity,) infeasibility, +inf for empty slots, sorted
    phi: jnp.ndarray  # (capacity,) objective measure (+inf for empty slots)
    ub: jnp.ndarray   # scalar infeasibility upper bound


def filter_init(capacity: int, dtype=jnp.float64) -> FilterState:
    return FilterState(
        h=jnp.full((capacity,), BIG, dtype=dtype),
        phi=jnp.full((capacity,), BIG, dtype=dtype),
        ub=jnp.asarray(BIG, dtype=dtype),
    )


def filter_reset(f: FilterState) -> FilterState:
    """Clear entries, keep the upper bound (reference Filter::reset)."""
    return FilterState(jnp.full_like(f.h, BIG), jnp.full_like(f.phi, BIG), f.ub)


def filter_set_ub(f: FilterState, ub) -> FilterState:
    return f._replace(ub=jnp.asarray(ub, dtype=f.h.dtype))


def filter_acceptable(f: FilterState, h_t, phi_t, beta, gamma):
    """Acceptability wrt the filter (Filter::acceptable):
    h_t < beta*ub, and either dominates-in-h the whole front (position 0) or
    phi_t <= phi[position-1] - gamma*h_t, where position is the first entry
    with sufficient h-reduction (entries sorted by h ascending)."""
    ub_ok = h_t < beta * f.ub
    suff = h_t < beta * f.h            # suffix of True (h sorted ascending)
    position = jnp.sum(~suff)          # empty slots have h=+inf -> True
    phi_prev = _at_index(f.phi, jnp.maximum(position - 1, 0))
    dominated_ok = (position == 0) | (phi_t <= phi_prev - gamma * h_t)
    return ub_ok & dominated_ok


def filter_acceptable_wrt(h_c, phi_c, h_t, phi_t, beta, gamma):
    """Acceptability wrt a single (current) point
    (Filter::acceptable_wrt_current_iterate)."""
    return (h_t < beta * h_c) | (phi_t <= phi_c - gamma * h_t)


def filter_add(f: FilterState, h_c, phi_c, beta) -> FilterState:
    """Add (h_c, phi_c): drop dominated entries (h_i >= h_c and phi_i >= phi_c),
    make room if full (shrink ub to beta*max(ub, largest h), drop last),
    insert keeping h-ascending order (Filter::add)."""
    cap = f.h.shape[0]
    keep = (f.h < h_c) | (f.phi < phi_c)
    # kept entries stay in relative sorted order -> stable partition, no sort
    h, phi = _compact(f.h, f.phi, keep)
    n = jnp.sum(keep)

    # if full after removal: shrink upper bound and drop the largest-h entry
    # (slot cap-1 after compaction)
    full = n >= cap
    iota = lax.iota(jnp.int32, cap)
    largest = jnp.where(full, jnp.maximum(f.ub, h[cap - 1]), -BIG)
    ub = jnp.where(full, beta * largest, f.ub)
    h = jnp.where(full & (iota == cap - 1), BIG, h)
    phi = jnp.where(full & (iota == cap - 1), BIG, phi)

    # shift-insert the new entry at its sorted position (last slot is free)
    h, phi = _sorted_insert(h, phi, h_c, phi_c)
    return FilterState(h, phi, ub)


def armijo_sufficient_decrease(predicted, actual, fraction, tolerance):
    """actual >= fraction * max(0, predicted - tolerance)
    (GlobalizationStrategy::armijo_sufficient_decrease)."""
    return actual >= fraction * jnp.maximum(0.0, predicted - tolerance)


def switching_condition(predicted, h_current, delta, exponent):
    """predicted > delta * h^exponent (SwitchingMethod::switching_condition)."""
    return predicted > delta * jnp.power(h_current, exponent)


class WaechterDecision(NamedTuple):
    accept: jnp.ndarray
    new_filter: FilterState


class WaechterDecisionLazy(NamedTuple):
    accept: jnp.ndarray
    augment: jnp.ndarray   # caller applies filter_add(h_cur, merit_cur) iff set


def waechter_is_acceptable(
    f: FilterState,
    h_cur, merit_cur,          # current (infeasibility, phi(1)+aux)
    h_tri, merit_tri,          # trial
    merit_pred,                # unconstrained predicted reduction
    h_initial,                 # infeasibility at the initial iterate
    opts,
    roundoff_protect_scale,
) -> WaechterDecision:
    """WaechterFilterMethod::is_regular_iterate_acceptable (.cpp:25-90)."""
    merit_actual = merit_cur - merit_tri + roundoff_protect_scale
    filter_ok = filter_acceptable(f, h_tri, merit_tri, opts.filter_beta, opts.filter_gamma)
    small_inf = h_cur <= 1e-4 * jnp.maximum(1.0, h_initial)
    switching = (merit_pred > 0.0) & switching_condition(
        merit_pred, h_cur, opts.switching_delta, opts.switching_infeasibility_exponent)
    sufficient = armijo_sufficient_decrease(
        merit_pred, merit_actual, opts.armijo_decrease_fraction, opts.armijo_tolerance)

    f_type = small_inf & switching
    accept_f = f_type & sufficient
    accept_h = (~f_type) & filter_acceptable_wrt(
        h_cur, merit_cur, h_tri, merit_tri, opts.filter_beta, opts.filter_gamma)
    accept = filter_ok & (accept_f | accept_h)

    # augment the filter when accepting without (switching and armijo).
    # NOTE: the add is returned as a flag, not applied: an accepted trial ends
    # the line search, so the filter never changes mid-LS and the (sorting)
    # filter_add can run once after the loop instead of per trial.
    augment = accept & (~switching | ~sufficient)
    return WaechterDecisionLazy(accept, augment)


def fletcher_is_acceptable(
    f: FilterState,
    h_cur, merit_cur,
    h_tri, merit_tri,
    merit_pred,
    opts,
    roundoff_protect_scale,
) -> WaechterDecision:
    """FletcherFilterMethod::is_regular_iterate_acceptable (.cpp:15-66):
    acceptable to filter AND wrt current iterate; f-type needs switching +
    Armijo; h-type adds the current point to the filter."""
    merit_actual = merit_cur - merit_tri + roundoff_protect_scale
    acceptable_pair = filter_acceptable(
        f, h_tri, merit_tri, opts.filter_beta, opts.filter_gamma
    ) & filter_acceptable_wrt(h_cur, merit_cur, h_tri, merit_tri,
                              opts.filter_beta, opts.filter_gamma)
    switching = (merit_pred > 0.0) & switching_condition(
        merit_pred, h_cur, opts.switching_delta, opts.switching_infeasibility_exponent)
    sufficient = armijo_sufficient_decrease(
        merit_pred, merit_actual, opts.armijo_decrease_fraction, opts.armijo_tolerance)
    accept = acceptable_pair & jnp.where(switching, sufficient, True)
    # h-type (no switching): add current point to filter
    augment = accept & ~switching
    new_filter = filter_add(f, h_cur, merit_cur, opts.filter_beta)
    new_filter = FilterState(
        jnp.where(augment, new_filter.h, f.h),
        jnp.where(augment, new_filter.phi, f.phi),
        jnp.where(augment, new_filter.ub, f.ub),
    )
    return WaechterDecision(accept, new_filter)


def feasibility_armijo_acceptable(h_cur, aux_cur, h_tri, aux_tri,
                                  pred_h, pred_aux, opts):
    """Feasibility-phase (objective multiplier 0) acceptance: Armijo on
    infeasibility + auxiliary (SwitchingMethod::is_feasibility_iterate_acceptable)."""
    predicted = pred_h + pred_aux
    actual = (h_cur + aux_cur) - (h_tri + aux_tri)
    return armijo_sufficient_decrease(predicted, actual,
                                      opts.armijo_decrease_fraction,
                                      opts.armijo_tolerance)


def l1_merit_acceptable(h_cur, obj_cur, aux_cur, h_tri, obj_tri, aux_tri,
                        pred_h, pred_obj, pred_aux, opts, roundoff_protect_scale):
    """l1MeritFunction::is_iterate_acceptable: Armijo on
    objective(rho) + auxiliary + infeasibility."""
    predicted = pred_obj + pred_aux + pred_h
    cur = obj_cur + aux_cur + h_cur
    tri = obj_tri + aux_tri + h_tri
    actual = cur - tri + roundoff_protect_scale
    return armijo_sufficient_decrease(predicted, actual,
                                      opts.armijo_decrease_fraction,
                                      opts.armijo_tolerance)


# --------------------------------------------------------------------------
# nonmonotone filter (reference NonmonotoneFilter.cpp) — vectorized over a
# fixed-capacity INSERTION-ordered front (the nonmonotone filter is not
# sorted: eviction is oldest-first and the nonmonotone Armijo test looks at
# the most recent entries)
# --------------------------------------------------------------------------

def nm_count_dominated(f: FilterState, h_t, phi_t, beta, gamma):
    """NonmonotoneFilter::compute_number_dominated_entries (.cpp:49-63):
    entry i counts against the trial if neither the objective nor the
    infeasibility sufficient-reduction margin holds."""
    valid = jnp.isfinite(f.h)
    obj_suff = phi_t <= f.phi - gamma * h_t
    inf_suff = h_t < beta * f.h
    dom = (~obj_suff & ~inf_suff) | ((phi_t >= f.phi - gamma * h_t)
                                     & (h_t > beta * f.h))
    return jnp.sum(dom & valid)


def nm_filter_acceptable(f: FilterState, h_t, phi_t, beta, gamma, max_dom):
    """NonmonotoneFilter::acceptable: upper bound, then tolerate up to
    max_dom dominating entries."""
    ub_ok = h_t < beta * f.ub
    return ub_ok & (nm_count_dominated(f, h_t, phi_t, beta, gamma) <= max_dom)


def nm_filter_acceptable_wrt(f: FilterState, h_c, phi_c, h_t, phi_t,
                             beta, gamma, max_dom):
    """NonmonotoneFilter::acceptable_wrt_current_iterate: the current point
    counts as one more potential dominator."""
    count = nm_count_dominated(f, h_t, phi_t, beta, gamma)
    cur_dom = (~(phi_t <= phi_c - gamma * h_t)) & (h_t > beta * h_c)
    return (count + cur_dom) <= max_dom


def nm_filter_add(f: FilterState, h_c, phi_c, max_dom) -> FilterState:
    """NonmonotoneFilter::add (.cpp:15-47): drop entries dominated by more
    than max_dom others (the new point included), evict the second-oldest
    entry when full, append at the end (insertion order kept)."""
    cap = f.h.shape[0]
    valid = jnp.isfinite(f.h)
    # pairwise dominator counts among entries + the incoming point
    dom_pair = (f.phi[:, None] > f.phi[None, :]) & (f.h[:, None] > f.h[None, :])
    ndom = jnp.sum(dom_pair & valid[None, :], axis=1) \
        + ((f.phi > phi_c) & (f.h > h_c))
    keep = valid & (ndom <= max_dom)
    # compact preserving insertion order: stable partition, no sort
    h, phi = _compact(f.h, f.phi, keep)
    n = jnp.sum(keep)

    # full -> evict entry 1 (left_shift(1, 1): keeps the oldest, drops next)
    full = n >= cap
    h_shift = jnp.concatenate([h[:1], h[2:], jnp.full((1,), BIG, h.dtype)])
    phi_shift = jnp.concatenate([phi[:1], phi[2:], jnp.full((1,), BIG, phi.dtype)])
    h = jnp.where(full, h_shift, h)
    phi = jnp.where(full, phi_shift, phi)
    n = jnp.where(full, n - 1, n)

    iota = lax.iota(jnp.int32, cap)
    h = jnp.where(iota == n, h_c, h)
    phi = jnp.where(iota == n, phi_c, phi)
    return FilterState(h, phi, f.ub)


def nm_actual_objective_reduction(f: FilterState, merit_cur, h_cur, merit_tri,
                                  gamma, max_dom):
    """NonmonotoneFilter::compute_actual_objective_reduction: nonmonotone
    actual reduction against the max 'dash objective' over the most recent
    max_dom entries (the reference indexes one past the newest entry, which
    reads an empty slot; we take the newest max_dom VALID entries)."""
    cap = f.h.shape[0]
    valid = jnp.isfinite(f.h)
    n = jnp.sum(valid)
    iota = lax.iota(jnp.int32, cap)
    recent = valid & (iota >= n - max_dom)
    gam = jnp.where(h_cur < f.h, 1.0 / gamma, gamma)
    dash = f.phi + gam * (f.h - h_cur)
    max_obj = jnp.maximum(merit_cur,
                          jnp.max(jnp.where(recent, dash, -BIG), initial=-BIG))
    return max_obj - merit_tri


def nm_smallest_infeasibility(f: FilterState):
    return jnp.min(f.h, initial=BIG)


# --------------------------------------------------------------------------
# funnel (reference FunnelMethod.cpp / Funnel.cpp) — width as a carried scalar
# --------------------------------------------------------------------------

def funnel_update_width(width, h_cur, h_tri, margin, kappa, strategy: int):
    """Funnel::update (.cpp:33-55), strategy in {1,2,3} (static)."""
    if strategy == 1:
        return jnp.where(h_tri <= h_cur,
                         jnp.maximum(margin * width,
                                     kappa * h_cur + (1.0 - kappa) * h_tri),
                         margin * width)
    if strategy == 2:
        return kappa * width + (1.0 - kappa) * h_tri
    return margin * width


class FunnelDecisionLazy(NamedTuple):
    accept: jnp.ndarray
    h_type: jnp.ndarray   # caller applies funnel_update_width iff set


def funnel_is_acceptable(width, h_cur, merit_cur, h_tri, merit_tri,
                         merit_pred, opts, roundoff_protect_scale):
    """FunnelMethod::is_regular_iterate_acceptable (.cpp:33-95).  The width
    update on an h-type acceptance is deferred to the caller (accepted trial
    ends the line search, so at most one update applies per iteration)."""
    in_funnel = h_tri <= width
    ok_wrt = (h_tri < opts.funnel_beta * h_cur) | \
        (merit_tri <= merit_cur - opts.funnel_gamma * h_tri)
    if not opts.funnel_require_acceptance_wrt_current_iterate:
        ok_wrt = jnp.asarray(True)
    switching = (merit_pred > 0.0) & switching_condition(
        merit_pred, h_cur, opts.switching_delta,
        opts.switching_infeasibility_exponent)
    sufficient = armijo_sufficient_decrease(
        merit_pred, merit_cur - merit_tri + roundoff_protect_scale,
        opts.armijo_decrease_fraction, opts.armijo_tolerance)
    f_accept = switching & sufficient
    h_accept = ~switching & (h_tri <= opts.funnel_beta * width)
    accept = in_funnel & ok_wrt & (f_accept | h_accept)
    return FunnelDecisionLazy(accept, accept & h_accept & ~switching)
