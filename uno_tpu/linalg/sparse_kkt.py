"""Sparse-KKT backend: wires the general supernodal LDL^T
(linalg/sparse_ldlt.py) into the IPM's kkt_backend seam.

This is the auto-detection layer that corresponds to MA57's "analyze the
pattern you are given" contract (MA57Solver.cpp:40-90): probe the
REFORMULATED problem's Lagrangian-Hessian / Jacobian sparsity at a couple
of random points (structural with probability 1 — the same argument as
transforms.detect_structure), assemble the augmented-KKT pattern, run the
symbolic analysis, and decide sparse-vs-dense from the *scheduled* (padded)
flop count — the honest cost model of a dense-panel factorization, since
padding is executed work.

Routing outcomes (recorded in `last_detection_report` for diagnosability):
  * "sparse"  — plan built, padded flops beat dense by the margin; the
                backend replaces the dense LDL^T inside
                regularize_and_factor (same inertia contract).
  * "dense"   — the pattern is genuinely dense (elec/chandheq-class
                all-pairs coupling) or the schedule does not beat the
                dense path at this size; dense IS what MA57's fronts
                degenerate to on such problems, so this is the honest
                equivalent, now *measured* rather than assumed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax.numpy as jnp
import numpy as np

from uno_tpu.linalg.sparse_ldlt import SparsePlan, build_plan, make_sparse_ldlt


@dataclass
class SparseDetectionReport:
    """Why the last solve did or did not take the sparse-KKT path."""
    route: str              # "sparse" | "dense"
    reason: str
    N: int = 0
    density: float = 0.0
    nnz_factor: int = 0
    padded_flops: float = 0.0
    dense_flops: float = 0.0
    num_supernodes: int = 0


# inspected by tests and the structure diagnostics; overwritten per call
last_detection_report: Optional[SparseDetectionReport] = None


def probe_kkt_pattern(prob, m: int, samples: int = 2, seed: int = 0):
    """(N, N) bool pattern of the augmented KKT [H+Sigma, J^T; J, -C] of the
    reformulated problem, plus the is_dual mask.  Diagonals are structural
    (Sigma/delta on the primal block, -(D_e+eps) on the dual block)."""
    import jax

    rng = np.random.default_rng(seed)
    n = prob.n
    x0 = np.asarray(prob.x0, dtype=np.float64)
    xs = jnp.asarray(x0[None] + 0.37 * rng.standard_normal((samples, n)))
    ys = jnp.asarray(rng.standard_normal((samples, m)))

    # one jit + vmap over the sample axis: probing cost is dominated by
    # tracing/compiling the Hessian program, so compile once, not 2x
    @jax.jit
    def _probe(xs, ys):
        def one(x, y):
            H = prob.lagrangian_hessian(x, y, 1.0, prob.params)
            hp = (H != 0.0) & jnp.isfinite(H)
            if m:
                J = prob.constraint_jacobian(x, prob.params)
                jp = (J != 0.0) & jnp.isfinite(J)
            else:
                jp = jnp.zeros((0, n), dtype=bool)
            return hp, jp
        hps, jps = jax.vmap(one)(xs, ys)
        return jnp.any(hps, 0), jnp.any(jps, 0)

    hp, jp = _probe(xs, ys)
    hpat = np.array(hp)
    jpat = np.array(jp)
    hpat |= hpat.T
    N = n + m
    pat = np.zeros((N, N), dtype=bool)
    pat[:n, :n] = hpat
    if m:
        pat[n:, :n] = jpat
        pat[:n, n:] = jpat.T
    np.fill_diagonal(pat, True)
    is_dual = np.zeros(N, dtype=bool)
    is_dual[n:] = True
    return pat, is_dual


def make_sparse_kkt_backend(plan: SparsePlan):
    """(factorize, solve) pair over DENSE-assembled augmented matrices —
    the IPM keeps its dense assemble()/refinement code; only the
    factorization/solve go through the static supernodal schedule."""
    factorize, solve = make_sparse_ldlt(plan)
    return factorize, solve


def try_make_sparse_kkt_backend(prob, m: int, opts, force: bool = False,
                                max_n: int = 8192,
                                density_cutoff: float = 0.25,
                                flop_margin: float = 0.6,
                                min_n_auto: int = 3072):
    """Probe + analyze + decide.  Returns (factorize, solve) or None.

    force=True (kkt_formulation="sparse") skips the economics and builds
    the backend whenever a plan exists (the user asked for it by name).

    min_n_auto: both the dense blocked LDL^T and the supernodal scan are
    bound by ~N sequential rank-1 micro-steps, so below a crossover N the
    dense path wins regardless of the flop count; sparse overtakes where
    dense's O(N^3) flops dominate its latency.  The value 3072 was chosen
    on another machine and is not yet measured on the H100 (ROADMAP A8)."""
    global last_detection_report
    N = prob.n + m
    if N > max_n:
        last_detection_report = SparseDetectionReport(
            route="dense", reason=f"N={N} above sparse-analysis probe "
            f"range (dense O(N^2) probing)", N=N)
        if force:
            raise ValueError(
                f"kkt_formulation='sparse': KKT dimension {N} above the "
                f"supported probe range (<= {max_n})")
        return None
    if N < min_n_auto and not force:
        last_detection_report = SparseDetectionReport(
            route="dense",
            reason=(f"N={N} below the sparse crossover ({min_n_auto}): "
                    "the dense path is faster at this size"),
            N=N)
        return None
    pat, is_dual = probe_kkt_pattern(prob, m)
    density = float(pat.sum()) / float(N * N)
    if density > density_cutoff and not force:
        last_detection_report = SparseDetectionReport(
            route="dense",
            reason=(f"pattern density {density:.2f} > {density_cutoff}: "
                    "genuinely dense coupling (elec/chandheq class) — "
                    "MA57's fronts are dense here too"),
            N=N, density=density)
        return None
    plan = build_plan(pat, is_dual)
    padded = plan.padded_flops()
    dense = plan.dense_flops()
    if padded > flop_margin * dense and not force:
        last_detection_report = SparseDetectionReport(
            route="dense",
            reason=(f"scheduled flops {padded:.3g} vs dense {dense:.3g}: "
                    "the padded supernodal schedule does not beat the "
                    "dense path at this size"),
            N=N, density=density, nnz_factor=plan.nnz_factor,
            padded_flops=padded, dense_flops=dense,
            num_supernodes=plan.num_supernodes)
        return None
    last_detection_report = SparseDetectionReport(
        route="sparse",
        reason=f"padded/dense flop ratio {padded / dense:.3f}",
        N=N, density=density, nnz_factor=plan.nnz_factor,
        padded_flops=padded, dense_flops=dense,
        num_supernodes=plan.num_supernodes)
    return make_sparse_kkt_backend(plan)
