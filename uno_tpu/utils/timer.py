"""Wall-clock time limit inside fused (lax.while_loop) drivers.

The reference checks ``timer.get_duration()`` against ``time_limit`` on
every outer iteration (Uno.cpp:61-78, tools/Timer.cpp).  A fused driver
runs the whole outer loop inside one traced ``lax.while_loop``, which
cannot read the host clock — previously a finite ``time_limit`` required
the stepwise Python driver.  This wrapper closes that gap: when (and only
when) ``time_limit`` is finite, each fused step asks the HOST for the
elapsed time through ``jax.pure_callback`` and overwrites ``status`` with
``TIME_LIMIT`` once the budget is exhausted, so the while_loop exits on
its normal ``status == RUNNING`` condition.

The default (``time_limit = inf``) adds nothing to the HLO — the wrapper
is bypassed entirely, so batch throughput paths are unchanged.

Under ``vmap`` (batched drivers) the callback uses
``vmap_method="broadcast_all"``: one clock read per batched step, shared
by every instance — the per-instance status update stays element-wise.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np


class RunClock:
    """Mutable start-time box shared between the host driver and the traced
    callback.  Drivers call ``restart()`` immediately before launching a
    fused run (the reference starts its Timer at Uno::solve entry); if a
    caller invokes the jitted run directly, the first callback arms the
    clock itself."""

    def __init__(self):
        self.t0 = None

    def restart(self):
        self.t0 = time.monotonic()

    def elapsed(self):
        if self.t0 is None:
            self.t0 = time.monotonic()
        return np.float64(time.monotonic() - self.t0)


def wrap_step_with_time_limit(step, time_limit, clock, running_status,
                              time_limit_status):
    """Wrap a fused step: after the step, poll the host clock and force
    ``status = TIME_LIMIT`` for still-running state once the wall-clock
    budget is spent.  Callers must gate on ``np.isfinite(time_limit)``."""
    limit = float(time_limit)

    def timed_step(state):
        out = step(state)
        elapsed = jax.pure_callback(
            clock.elapsed, jax.ShapeDtypeStruct((), np.float64),
            vmap_method="broadcast_all")
        over = elapsed > limit
        new_status = jnp.where(
            over & (out.status == running_status),
            jnp.asarray(time_limit_status, dtype=out.status.dtype),
            out.status)
        return out._replace(status=new_status)

    # exposed so batch drivers can restart the clock per run invocation
    timed_step.run_clock = clock
    return timed_step


def make_timed_runner(step, time_limit, running_status, time_limit_status):
    """The shared tail of the fused solver builders: a jitted
    ``lax.while_loop`` runner with the reference's wall-clock limit
    semantics (Timer checked every outer iteration, Uno.cpp:61-78).

    Returns ``(step, run)``.  Two regimes:

    - ``time_limit`` infinite (the default): plain jitted while_loop —
      the HLO carries no clock machinery at all.
    - ``time_limit`` finite: the ``wrap_step_with_time_limit``
      pure_callback poll, checked every iteration exactly like the
      reference."""
    from jax import lax

    def cond_running(s):
        return s.status == running_status

    if not np.isfinite(float(time_limit)):
        return step, jax.jit(
            lambda state: lax.while_loop(cond_running, step, state))

    clock = RunClock()
    tstep = wrap_step_with_time_limit(step, time_limit, clock,
                                      running_status, time_limit_status)
    runj = jax.jit(lambda state: lax.while_loop(cond_running, tstep, state))

    def run_timed(state):
        clock.restart()
        return runj(state)

    return tstep, run_timed
