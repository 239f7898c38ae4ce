"""Measure sparse-vs-dense KKT factorize+solve on real irregular patterns.

Measures the general supernodal LDL^T (linalg/sparse_ldlt.py) against the
dense path: per-iteration latency of (factorize + solve) chains, long/short
differencing with a value fetch.  Prints one JSON line per case and a
summary line that names the device.

On the GPU:  python tools/bench_sparse_kkt.py
On CPU:      JAX_PLATFORMS=cpu python tools/bench_sparse_kkt.py
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def kkt_matrix_from_pattern(pat, is_dual, rng):
    N = pat.shape[0]
    A = np.where(pat, rng.standard_normal((N, N)), 0.0)
    A = (A + A.T) / 2
    d = np.where(is_dual, -(1.0 + rng.random(N)), 10.0 + rng.random(N))
    A[np.diag_indices(N)] = d
    return A


def problem_pattern(name):
    from uno_tpu.model.library import get_problem
    from uno_tpu.model import transforms
    from uno_tpu.options import preset
    from uno_tpu.linalg.sparse_kkt import probe_kkt_pattern

    nlp = get_problem(name)
    opts = preset("ipopt")
    scaled = transforms.scale_model(nlp)
    prob = transforms.reformulate_for_interior_point(scaled, opts.tolerance)
    return probe_kkt_pattern(prob, prob.m)


def synthetic_band_arrow(N, bw=4, spikes=2, seed=0):
    rng = np.random.default_rng(seed)
    pat = np.zeros((N, N), dtype=bool)
    for o in range(bw + 1):
        idx = np.arange(N - o)
        pat[idx, idx + o] = True
        pat[idx + o, idx] = True
    pat[-spikes:, :] = True
    pat[:, -spikes:] = True
    is_dual = np.zeros(N, dtype=bool)
    return pat, is_dual, rng


def main():
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_enable_x64", True)
    from uno_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from uno_tpu.linalg.sparse_ldlt import build_plan, make_sparse_ldlt
    from uno_tpu.ingredients.regularization import pick_factorizer
    from uno_tpu.linalg.ldlt import ldlt_solve

    def chain_ms(make_cycles, rhs, Aj, K1=10, K2=110, repeats=3):
        K1, K2 = int(K1), int(K2)
        f1, f2 = make_cycles(K1), make_cycles(K2)
        float(jnp.sum(f1(rhs, Aj)[0]))
        float(jnp.sum(f2(rhs, Aj)[0]))
        diffs = []
        for _ in range(repeats):
            t0 = time.time()
            float(jnp.sum(f1(rhs, Aj)[0]))
            ts = time.time() - t0
            t0 = time.time()
            float(jnp.sum(f2(rhs, Aj)[0]))
            tl = time.time() - t0
            diffs.append(tl - ts)
        return max(float(np.median(diffs)), 1e-9) / (K2 - K1) * 1e3

    dt = jnp.float32
    out = {}
    cases = []
    for name in ("steering_n306", "polygon_k25", "vanderpol_ctrl_n183"):
        pat, is_dual = problem_pattern(name)
        rng = np.random.default_rng(0)
        cases.append((name, pat, is_dual, rng))
    for N in (2048, 4096, 8192):
        pat, is_dual, rng = synthetic_band_arrow(N)
        cases.append((f"band_arrow_n{N}", pat, is_dual, rng))

    for name, pat, is_dual, rng in cases:
        N = pat.shape[0]
        A = kkt_matrix_from_pattern(pat, is_dual, rng)
        Aj = jnp.asarray(A, dtype=dt)
        rhs = jnp.asarray(rng.standard_normal(N), dtype=dt)

        plan = build_plan(pat, is_dual)
        sp_fac, sp_solve = make_sparse_ldlt(plan)
        de_fac = pick_factorizer(N, 32)

        def make_sparse_cycles(K):
            @jax.jit
            def cycles(b, Amat):
                def body(_, carry):
                    bk, acc = carry
                    fac = sp_fac(Amat)
                    sol = sp_solve(fac, bk)
                    acc = acc + jnp.asarray(fac.num_neg, acc.dtype)
                    nrm = jnp.maximum(jnp.linalg.norm(sol), 1e-30)
                    return sol / nrm, acc
                return jax.lax.fori_loop(0, K, body,
                                         (b, jnp.zeros((), jnp.int64)))
            return cycles

        def make_dense_cycles(K):
            @jax.jit
            def cycles(b, Amat):
                def body(_, carry):
                    bk, acc = carry
                    fac = de_fac(Amat)
                    sol = ldlt_solve(fac, bk)
                    acc = acc + jnp.asarray(fac.num_neg, acc.dtype)
                    nrm = jnp.maximum(jnp.linalg.norm(sol), 1e-30)
                    return sol / nrm, acc
                return jax.lax.fori_loop(0, K, body,
                                         (b, jnp.zeros((), jnp.int64)))
            return cycles

        # keep chain wall time bounded at large dims (dense is O(N^3))
        k2 = 110 if N <= 2048 else (30 if N <= 4096 else 12)
        k1 = 10 if N <= 2048 else 2
        ms_sparse = chain_ms(make_sparse_cycles, rhs, Aj, K1=k1, K2=k2)
        ms_dense = chain_ms(make_dense_cycles, rhs, Aj, K1=k1, K2=k2)
        row = {
            "N": N,
            "density": float(pat.sum()) / (N * N),
            "num_supernodes": plan.num_supernodes,
            "nnz_factor": plan.nnz_factor,
            "padded_flops": plan.padded_flops(),
            "dense_flops": plan.dense_flops(),
            "sparse_ms_per_iter": ms_sparse,
            "dense_ms_per_iter": ms_dense,
            "speedup": ms_dense / ms_sparse,
        }
        out[name] = row
        print(json.dumps({name: row}), flush=True)

    dev = jax.devices()[0]
    print(json.dumps({"platform": dev.platform, "kind": dev.device_kind,
                      "count": jax.device_count(), "dtype": "float32",
                      "timing": "chained factorize+solve, long/short "
                                "differencing with value fetch",
                      "cases": out}))


if __name__ == "__main__":
    sys.exit(main())
