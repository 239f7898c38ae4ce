#!/usr/bin/env python
"""Multi-device scaling benchmark: the BASELINE.md multi-host row.

Measures (a) the batch-sharded vmapped IPM and (b) the distributed
Schur-complement scenario solve at mesh sizes P in {1, 2, 4, 8} on one
fixed workload, and reports throughput + parallel efficiency vs P=1.

On accelerators this runs over the device interconnect; on the CPU it
runs on the 8-virtual-device mesh (JAX_PLATFORMS=cpu + xla_force_host_platform_
device_count), which exercises the identical SPMD programs/collectives —
absolute numbers are CPU-bound, efficiencies are indicative.

Usage:  JAX_PLATFORMS=cpu python tools/bench_scaling.py
Prints one JSON line per axis.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if os.environ.get("JAX_PLATFORMS") == "cpu":
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402


def bench_batch_sharded(sizes=(1, 2, 4, 8), B=512):
    from uno_tpu.options import preset
    from uno_tpu.solvers.batch import build_batch_ipm
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from __graft_entry__ import _flagship

    opts = preset("ipopt", scale_functions=False)
    nlp, x0, params = _flagship(B)
    prob, run = build_batch_ipm(nlp, opts, params_example=jnp.asarray(params[0]))

    out = {}
    for nd in sizes:
        if nd > len(jax.devices()):
            break
        mesh = Mesh(np.array(jax.devices()[:nd]), ("batch",))
        # batch-last layout inside run(): shard the LAST axis
        shard2 = NamedSharding(mesh, P("batch", None))
        x0_s = jax.device_put(jnp.asarray(x0), shard2)
        p_s = jax.device_put(jnp.asarray(params), shard2)
        final = jax.block_until_ready(run(x0_s, p_s))     # compile + 1st
        t0 = time.perf_counter()
        for _ in range(3):
            final = run(x0_s, p_s)
        jax.block_until_ready(final)
        dt = (time.perf_counter() - t0) / 3
        out[nd] = B / dt
    base = out.get(1)
    return {
        "metric": "batch_sharded_scaling",
        "unit": "solves/s",
        "points": {str(k): round(v, 1) for k, v in out.items()},
        "efficiency": {str(k): round(v / (base * k), 3)
                       for k, v in out.items()} if base else {},
    }


def _two_stage(S, ns, n0, seed=0):
    from uno_tpu.model.nlp import INF
    from uno_tpu.solvers.structured import ScenarioNLP
    rng = np.random.default_rng(seed)
    a = rng.uniform(-0.5, 1.5, (S, ns))
    b = rng.uniform(1.0, 2.0, (S, 1))

    def f0(x0):
        return jnp.sum((x0 - 1.0) ** 2)

    def fs(x0, xs, p):
        return jnp.sum((xs - p["a"]) ** 2)

    def cs(x0, xs, p):
        return jnp.array([jnp.sum(xs) + 0.1 * x0[0] ** 2 - p["b"][0]])

    return ScenarioNLP(
        name="two_stage_bench", n0=n0, ns=ns, m=1, S=S,
        f0=f0, fs=fs, cs=cs,
        x0_lb=np.full(n0, -INF), x0_ub=np.full(n0, INF),
        xs_lb=np.zeros(ns), xs_ub=np.full(ns, INF),
        x0_init=np.full(n0, 0.5), xs_init=np.full((S, ns), 0.5),
        params={"a": jnp.asarray(a), "b": jnp.asarray(b)})


def bench_structured(sizes=(1, 2, 4, 8), S=256, ns=48, n0=8):
    """The scenario axis is vmapped block algebra inside the solver; a mesh
    sharding on the scenario-indexed inputs lets GSPMD partition every
    per-scenario factor/solve and turn the Schur reduction into a psum."""
    from uno_tpu.solvers.structured import solve_structured_ipm

    out = {}
    iters = None
    for nd in sizes:
        if nd > len(jax.devices()):
            break
        mesh = Mesh(np.array(jax.devices()[:nd]), ("scenario",))
        shard = NamedSharding(mesh, P("scenario"))
        import dataclasses
        snlp = _two_stage(S, ns, n0)
        snlp = dataclasses.replace(
            snlp,
            xs_init=jax.device_put(jnp.asarray(snlp.xs_init), shard),
            params=jax.tree_util.tree_map(
                lambda v: jax.device_put(v, shard), snlp.params))
        res = solve_structured_ipm(snlp, tol=1e-8)       # compile + solve
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            res = solve_structured_ipm(snlp, tol=1e-8)
        dt = (time.perf_counter() - t0) / reps
        iters = int(res.iterations)
        out[nd] = iters / dt
    base = out.get(1)
    return {
        "metric": "structured_schur_scaling",
        "unit": "iterations/s",
        "detail": {"S": S, "ns": ns, "n0": n0, "iterations": iters,
                   "status": str(res.status)},
        "points": {str(k): round(v, 2) for k, v in out.items()},
        "efficiency": {str(k): round(v / (base * k), 3)
                       for k, v in out.items()} if base else {},
    }


def main():
    note = None
    if jax.default_backend() == "cpu":
        note = (f"{os.cpu_count()} physical cores shared by "
                f"{len(jax.devices())} virtual devices: total compute is "
                "fixed, so efficiency-vs-P is NOT measurable on this host; "
                "run on a real multi-chip mesh for the BASELINE.md metric")
    for r in (bench_batch_sharded(), bench_structured()):
        if note:
            r["note"] = note
        print(json.dumps(r))


if __name__ == "__main__":
    main()
