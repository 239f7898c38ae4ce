"""Instance sharding across a device mesh.

TPU-native analogue of the reference's only distributed component (MPI-
parallel MUMPS, SURVEY.md §2.15/§5.8), redesigned for the actual scale axis
of this workload: a batch of independent NLP instances laid out over a
1-D `jax.sharding.Mesh` axis ("batch").  Each instance's KKT factorization
stays on one chip (no cross-chip linear algebra needed at CUTEst scale);
convergence reductions (`num_solved`) are XLA collectives over the devices.

The distributed Schur-complement KKT for block-structured NLPs (scale axis 2
of BASELINE.md) builds on the same mesh; see uno_tpu/parallel/schur.py.
"""

from __future__ import annotations

import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from uno_tpu.model.nlp import NLP
from uno_tpu.options import Options
from uno_tpu.solvers.batch import BatchResult, build_batch_ipm
from uno_tpu.solvers import ipm as ipm_mod


def make_mesh(devices=None, axis_name: str = "batch") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def build_sharded_batch_ipm(nlp: NLP, opts: Options, mesh: Mesh,
                            axis_name: str = "batch"):
    """Returns solve(x0_batch, params_batch) with inputs/outputs sharded over
    the mesh's batch axis.  Batch size must be a multiple of the mesh size."""
    prob, run = build_batch_ipm(nlp, opts, params_example=None, batch_last=False)
    batch_sharding = NamedSharding(mesh, P(axis_name))
    replicated = NamedSharding(mesh, P())

    def solve(x0_batch, params_batch=None):
        x0_batch = jax.device_put(jnp.asarray(x0_batch), batch_sharding)
        if params_batch is not None:
            params_batch = jax.tree_util.tree_map(
                lambda a: jax.device_put(jnp.asarray(a), batch_sharding), params_batch)
        return run(x0_batch, params_batch)

    return prob, solve


def solve_batch_sharded(nlp: NLP, opts: Options, x0_batch, params_batch=None,
                        mesh: Optional[Mesh] = None) -> BatchResult:
    t0 = time.time()
    mesh = mesh if mesh is not None else make_mesh()
    prob, solve = build_sharded_batch_ipm(nlp, opts, mesh)
    final = jax.block_until_ready(solve(x0_batch, params_batch))
    elapsed = time.time() - t0
    x_orig = np.asarray(final.x)[:, : nlp.n]
    fvals = np.asarray(jax.vmap(nlp.objective)(jnp.asarray(x_orig))) \
        if params_batch is None else \
        np.asarray(jax.vmap(lambda x, p: nlp.objective(x, p))(jnp.asarray(x_orig), params_batch))
    return BatchResult(
        status=np.asarray(final.status),
        x=x_orig,
        objective=fvals,
        iterations=np.asarray(final.iteration),
        primal_feasibility=np.asarray(final.primal_feas),
        stationarity=np.asarray(final.stat / final.stat_scaling),
        cpu_time=elapsed,
    )
