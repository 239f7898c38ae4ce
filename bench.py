"""Benchmark: batched IPM solve throughput on one GPU (+ size curve,
fused-SQP presets, KKT factorization latency, banded-vs-dense).

Prints ONE JSON line:
  {"metric": "batched_ipm_solves_per_sec", "value": N, "unit": "solves/s",
   "vs_baseline": R, "detail": {...}}

Workload (headline): B independent instances of an 8-variable,
2-constraint nonconvex NLP family (random quadratic objectives, one linear
+ one quadratic constraint, variable bounds), solved to the ipopt preset's
1e-8 KKT tolerance by the fully-jitted vmapped IPM (per-instance
convergence masks).

Baseline: MEASURED in-container — the reference Uno 2.0.0 built from
/root/reference and run through its own driver on the SAME flagship family
(tools/baseline/: analytic models + LAPACK dense LDL^T behind the
DirectSymmetricIndefiniteLinearSolver seam, ipopt preset):
  BENCH instances=2000 solved=2000 solves_per_sec=3241 mean_iterations=9.57
vs_baseline = value / 3241.  BASELINE.md target: >= 50x single-core.

TIMING: every measurement (a) forces a VALUE TRANSFER (np.asarray of a
result) inside the timed region, and (b) reports the DIFFERENCE between a
long and a short run of the same executable, which cancels the per-call
dispatch overhead.

The run names its device (platform, device_kind, count) and fails when JAX
finds no GPU: a CPU run measures nothing this benchmark reports.
"""

import json
import sys
import time

import numpy as np


def _flagship_n(batch: int, n: int):
    """The flagship family generalized to n variables (m=2)."""
    import jax.numpy as jnp
    from uno_tpu.model.nlp import nlp_from_functions, INF

    def f(x, p):
        return jnp.sum((x - p) ** 2) + 0.1 * jnp.sum(x[:-1] * x[1:])

    def c(x, p):
        return jnp.array([jnp.sum(x) - 1.0, jnp.sum(x * x) - 2.0])

    nlp = nlp_from_functions(
        f"flagship_n{n}", f, c,
        x0=np.full(n, 0.5),
        x_lb=np.zeros(n), x_ub=np.full(n, INF),
        c_lb=[0.0, -INF], c_ub=[INF, 0.0],
        params=np.zeros(n),
    )
    rng = np.random.default_rng(0)
    params = rng.uniform(-0.5, 1.0, (batch, n))
    x0 = np.tile(np.full(n, 0.5), (batch, 1))
    return nlp, x0, params


def _timed_batch(jax, run, x0j, pj, reps_long=5, reps_short=1):
    """Per-batch wall seconds via long/short differencing with value fetch."""
    def once(reps):
        t0 = time.time()
        outs = [run(x0j, pj) for _ in range(reps)]
        # force materialization of every run's status (value transfer)
        for o in outs:
            np.asarray(o.status)
        return time.time() - t0, outs[-1]

    once(1)  # warm dispatch path
    t_short, _ = once(reps_short)
    t_long, final = once(reps_long)
    per_batch = (t_long - t_short) / (reps_long - reps_short)
    return max(per_batch, 1e-9), t_long / reps_long, final


def flagship_ipm_options(kkt_dtype: str):
    """The flagship cell's ipopt options.  Verified lossless on this family
    (identical per-instance iteration counts, 100% solved at 1e-8):
    filter_capacity=8 (the vectorized Waechter filter resets at each mu
    change), LS_batch_candidates=1 (alpha=1 usually accepts here)."""
    from uno_tpu.options import preset
    return preset("ipopt", scale_functions=False, kkt_dtype=kkt_dtype,
                  LS_batch_candidates=1, filter_capacity=8)


def build_fused_sqp_cell(preset_name: str, b_sz: int, kkt_dtype: str):
    """The fused-SQP throughput cell: `preset_name` (filtersqp or byrd) on
    the n=8 flagship family at batch `b_sz`, through the BUCKETED driver —
    converged lanes retire between segments instead of holding the vmapped
    TR loop at full lane cost, and the rare stalled lane runs at min-bucket
    cost.  max_iterations=60 bounds the stalled tail (the solved population
    needs ~10-20).  segment=5 and min_bucket=64 were tuned on another
    machine and are not yet re-tuned on the H100 (ROADMAP A6).

    Returns (opts, nlp, x0, params, run)."""
    import jax.numpy as jnp
    from uno_tpu.options import preset
    from uno_tpu.solvers.batch import build_bucketed_batch_sqp

    p_opts = preset(preset_name, scale_functions=False,
                    kkt_dtype=kkt_dtype, max_iterations=60)
    nlp_s, x0s, ps = _flagship_n(b_sz, 8)
    _, run_s = build_bucketed_batch_sqp(nlp_s, p_opts,
                                        params_example=jnp.asarray(ps[0]),
                                        segment=5, min_bucket=64)
    return p_opts, nlp_s, x0s, ps, run_s


def _fused_sqp(preset_name: str, b_sz: int, kkt_dtype: str):
    """Measure one fused-SQP preset's batched throughput."""
    import time as _t
    import jax.numpy as jnp

    _, _, x0s, ps, run_s = build_fused_sqp_cell(preset_name, b_sz, kkt_dtype)
    x0j, pj = jnp.asarray(x0s), jnp.asarray(ps)
    fin = run_s(x0j, pj)                      # warm (compiles all buckets)
    np.asarray(fin.status)
    t0 = _t.time()
    fin = run_s(x0j, pj)
    st = np.asarray(fin.status)               # scatter already synced host-side
    pb = _t.time() - t0
    # strict-tolerance solves (1=KKT, 2=small-step) reported apart from the
    # loose-tolerance ALMOST_OPTIMAL exits (8) so claims distinguish
    # converged from acceptable-level (advisor round-3)
    sv_strict = int(np.sum((st == 1) | (st == 2)))
    sv_loose = int(np.sum(st == 8))
    sv = sv_strict + sv_loose
    return {"batch": b_sz, "solved": sv_strict, "solved_loose": sv_loose,
            "solves_per_sec": round(sv / pb, 1)}


def main():
    from uno_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    import uno_tpu  # noqa: F401  (enables x64)
    from uno_tpu.solvers.batch import build_batch_ipm

    dev = jax.devices()[0]
    print(f"device: platform={dev.platform} kind={dev.device_kind} "
          f"count={jax.device_count()}", file=sys.stderr)
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {dev.platform}")

    B = int(sys.argv[1]) if len(sys.argv) > 1 else 65536
    kkt_dtype = sys.argv[2] if len(sys.argv) > 2 else "float32"
    quick = "--quick" in sys.argv

    fused_sqp_stats = {}
    if not quick:
        for preset_name, b_sz in (("filtersqp", 8192), ("byrd", 8192)):
            fused_sqp_stats[preset_name] = _fused_sqp(preset_name, b_sz,
                                                      kkt_dtype)
    opts = flagship_ipm_options(kkt_dtype)
    nlp, x0, params = _flagship_n(B, 8)

    t0 = time.time()
    prob, run = build_batch_ipm(nlp, opts, params_example=jnp.asarray(params[0]))
    x0j, pj = jnp.asarray(x0), jnp.asarray(params)
    final = run(x0j, pj)
    np.asarray(final.status)
    compile_and_first = time.time() - t0

    # warm-rebuild (jit-cache hit) cost: the whole build+first-run again
    t0 = time.time()
    prob2, run2 = build_batch_ipm(nlp, opts, params_example=jnp.asarray(params[0]))
    np.asarray(run2(x0j, pj).status)
    warm_rebuild_s = time.time() - t0

    # headline measurement: the solved count reduces ON DEVICE and only the
    # scalar crosses to the host; production consumers reduce on device
    # too.  N repetitions give a spread.
    @jax.jit
    def _reduce_fin(fin):
        st = fin.status
        return (jnp.sum((st == 1) | (st == 2)).astype(jnp.float64),
                jnp.mean(fin.iteration.astype(jnp.float64)),
                jnp.max(fin.iteration))

    def _run_scalar(x, p):
        return _reduce_fin(run(x, p))

    def _timed_scalar(reps_long=5, reps_short=1):
        def once(reps):
            t0 = time.time()
            outs = [_run_scalar(x0j, pj) for _ in range(reps)]
            for o in outs:
                float(o[0])   # scalar value fetch waits for the device
            return time.time() - t0, outs[-1]
        once(1)
        t_s, _ = once(reps_short)
        t_l, last = once(reps_long)
        return max((t_l - t_s) / (reps_long - reps_short), 1e-9), last

    samples = []
    for _ in range(5):
        pb_i, (sv_i, mi_i, mx_i) = _timed_scalar()
        samples.append((pb_i, float(sv_i)))
    per_batch = float(np.median([s[0] for s in samples]))
    solved = int(samples[-1][1])
    per_batch_incl_dispatch = per_batch  # scalar fetch leaves no dispatch gap
    final = run(x0j, pj)
    status = np.asarray(final.status)
    iters = np.asarray(final.iteration)
    throughput = solved / per_batch
    spread = {
        "runs": len(samples),
        "solves_per_sec_min": round(min(s[1] / s[0] for s in samples), 1),
        "solves_per_sec_median": round(float(np.median(
            [s[1] / s[0] for s in samples])), 1),
        "solves_per_sec_max": round(max(s[1] / s[0] for s in samples), 1),
    }

    detail = {
        "batch": B,
        "spread": spread,
        "solved": solved,
        "wall_s_per_batch": round(per_batch, 4),
        "wall_s_incl_dispatch": round(per_batch_incl_dispatch, 4),
        "compile_and_first_s": round(compile_and_first, 1),
        "warm_rebuild_s": round(warm_rebuild_s, 2),
        "mean_iterations": round(float(iters.mean()), 2),
        "max_iterations": int(iters.max()),
        "tolerance": 1e-8,
        "kkt_dtype": kkt_dtype,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": jax.device_count()},
        "baseline_solves_per_sec": 3241.0,
        "baseline_provenance":
            "measured: reference Uno built+run in-container, tools/baseline",
        "timing": "long/short differencing with value fetch",
    }

    # ------------------------------------------------------------------
    # throughput vs n (ipopt)
    # ------------------------------------------------------------------
    if not quick:
        # measured single-core reference at each n (uno_baseline
        # flagship_bench vars=N, ipopt preset, tol 1e-8; round 4)
        curve = {}
        # measured single-core reference (BASELINE.md): uno_baseline
        # flagship_bench vars=N; round-5 adds the n=32 denominator
        baseline_n = {32: 2804.0, 128: 48.4, 512: 0.93}
        for n_sz, b_sz in ((32, 8192), (128, 2048), (512, 256)):
            nlp_n, x0n, pn = _flagship_n(b_sz, n_sz)
            _, run_n = build_batch_ipm(nlp_n, opts,
                                       params_example=jnp.asarray(pn[0]))
            x0nj, pnj = jnp.asarray(x0n), jnp.asarray(pn)
            pb, _, fin = _timed_batch(jax, run_n, x0nj, pnj, reps_long=3)
            st = np.asarray(fin.status)
            sv = int(np.sum((st == 1) | (st == 2)))
            row = {"batch": b_sz, "solved": sv,
                   "solves_per_sec": round(sv / pb, 1)}
            if baseline_n.get(n_sz):
                row["single_core_baseline"] = baseline_n[n_sz]
                row["vs_single_core"] = round(sv / pb / baseline_n[n_sz], 1)
            curve[f"n{n_sz}"] = row
        detail["ipopt_throughput_vs_n"] = curve
        detail["fused_sqp_solves_per_sec"] = fused_sqp_stats

    # ------------------------------------------------------------------
    # KKT factorize+solve ms/iter (BASELINE.md row 2): chained on-device
    # cycles, two chain lengths, slope = per-iteration latency
    # ------------------------------------------------------------------
    from uno_tpu.ingredients.regularization import pick_factorizer
    from uno_tpu.linalg.ldlt import ldlt_solve

    def chain_ms(make_cycles, *args, K1=10, K2=110, repeats=3):
        """Per-cycle ms from the slope between a K1- and a K2-cycle chain:
        (K2-K1) extra cycles must dominate the per-call dispatch jitter;
        median of `repeats`."""
        f1, f2 = make_cycles(K1), make_cycles(K2)
        float(jnp.sum(f1(*args)[0]))  # compile+warm short
        float(jnp.sum(f2(*args)[0]))  # compile+warm long
        diffs = []
        for _ in range(repeats):
            t0 = time.time()
            float(jnp.sum(f1(*args)[0]))
            t_short = time.time() - t0
            t0 = time.time()
            float(jnp.sum(f2(*args)[0]))
            t_long = time.time() - t0
            diffs.append(t_long - t_short)
        return max(float(np.median(diffs)), 1e-9) / (K2 - K1) * 1e3

    kkt_stats = {}
    rng = np.random.default_rng(1)
    dt = jnp.float32 if kkt_dtype == "float32" else jnp.float64
    dims = (32, 128, 512, 1024, 2048) if not quick else (128,)
    for n_sz in dims:
        m_sz = n_sz // 4
        dim = n_sz + m_sz
        Q = rng.standard_normal((dim, dim))
        A = (Q + Q.T) / 2
        A[np.diag_indices(dim)] = np.concatenate([
            10.0 ** rng.uniform(-6, 6, n_sz),
            -(10.0 ** rng.uniform(-6, 0, m_sz))])
        Aj = jnp.asarray(A, dtype=dt)
        rhs = jnp.asarray(rng.standard_normal(dim), dtype=dt)
        fac_fn = pick_factorizer(dim, opts.ldlt_block_size)

        def make_cycles(K, fac_fn=fac_fn, Aj=Aj):
            @jax.jit
            def cycles(b):
                def body(_, carry):
                    bk, acc = carry
                    fac = fac_fn(Aj)
                    sol = ldlt_solve(fac, bk)
                    acc = acc + jnp.asarray(fac.num_neg, acc.dtype)
                    return sol / jnp.maximum(jnp.linalg.norm(sol), 1e-30), acc
                return jax.lax.fori_loop(0, K, body,
                                         (b, jnp.zeros((), jnp.int64)))
            return cycles

        ms = chain_ms(make_cycles, rhs)
        flops = dim ** 3 / 3 + 2 * dim ** 2
        kkt_stats[f"n{n_sz}"] = {"dim": dim, "ms": round(ms, 3),
                                 "gflops": round(flops / (ms * 1e-3) / 1e9, 1)}
    detail["kkt_ms_per_iter"] = kkt_stats

    # ------------------------------------------------------------------
    # structured (banded) vs dense factorize+solve at n=4096
    # (the structured-KKT path)
    # ------------------------------------------------------------------
    if not quick:
        from uno_tpu.linalg.banded import (band_to_blocks, btd_cholesky_cr,
                                           btd_solve_cr, pick_block_size)
        nb_dim, bw = 4096, 31
        band = np.zeros((bw + 1, nb_dim), dtype=np.float32)
        for d in range(bw + 1):
            band[d, : nb_dim - d] = rng.standard_normal(nb_dim - d) * 0.1
        band[0] = np.abs(band).sum(0) * 2 + 2.0
        nb = pick_block_size(bw)
        bj = jnp.asarray(band, dtype=dt)
        rhs = jnp.asarray(rng.standard_normal(nb_dim), dtype=dt)

        def make_banded(K):
            @jax.jit
            def cycles(b):
                def body(_, carry):
                    bk, acc = carry
                    D, E = band_to_blocks(bj, nb)
                    # CR depth-reduction (the backend's selector choice
                    # at this block count)
                    fac = btd_cholesky_cr(D, E)
                    sol = btd_solve_cr(fac, bk)
                    acc = acc + jnp.asarray(fac.num_pos, acc.dtype)
                    return sol / jnp.maximum(jnp.linalg.norm(sol), 1e-30), acc
                return jax.lax.fori_loop(0, K, body,
                                         (b, jnp.zeros((), jnp.int64)))
            return cycles

        banded_ms = chain_ms(make_banded, rhs)

        # dense comparison at the same dimension
        Q = rng.standard_normal((nb_dim, nb_dim)).astype(np.float32)
        Ad = (Q + Q.T) * 0.05
        Ad[np.diag_indices(nb_dim)] = np.abs(Ad).sum(1) + 1.0
        Adj = jnp.asarray(Ad, dtype=dt)
        fac_fn = pick_factorizer(nb_dim, opts.ldlt_block_size)

        def make_dense(K):
            @jax.jit
            def cycles(b):
                def body(_, carry):
                    bk, acc = carry
                    fac = fac_fn(Adj)
                    sol = ldlt_solve(fac, bk)
                    acc = acc + jnp.asarray(fac.num_neg, acc.dtype)
                    return sol / jnp.maximum(jnp.linalg.norm(sol), 1e-30), acc
                return jax.lax.fori_loop(0, K, body,
                                         (b, jnp.zeros((), jnp.int64)))
            return cycles

        dense_ms = chain_ms(make_dense, rhs, K1=2, K2=8)
        detail["banded_n4096_b31"] = {
            "banded_ms": round(banded_ms, 3),
            "dense_ms": round(dense_ms, 3),
            "speedup": round(dense_ms / max(banded_ms, 1e-9), 1)}

    # ------------------------------------------------------------------
    # general-sparse supernodal LDL^T vs dense (full sweep incl. real
    # irregular patterns: tools/bench_sparse_kkt.py).
    # ------------------------------------------------------------------
    if not quick:
        from uno_tpu.linalg.sparse_ldlt import build_plan, make_sparse_ldlt
        Nsp, bw_sp = 8192, 4
        pat = np.zeros((Nsp, Nsp), dtype=bool)
        for o in range(bw_sp + 1):
            idx = np.arange(Nsp - o)
            pat[idx, idx + o] = True
            pat[idx + o, idx] = True
        pat[-2:, :] = True
        pat[:, -2:] = True
        Asp = np.where(pat, rng.standard_normal((Nsp, Nsp)), 0.0)
        Asp = ((Asp + Asp.T) / 2).astype(np.float32)
        Asp[np.diag_indices(Nsp)] = 10.0 + rng.random(Nsp)
        plan = build_plan(pat, np.zeros(Nsp, dtype=bool))
        sp_fac, sp_solve = make_sparse_ldlt(plan)
        Aspj = jnp.asarray(Asp, dtype=jnp.float32)
        rhs_sp = jnp.asarray(rng.standard_normal(Nsp), dtype=jnp.float32)

        def make_sparse(K):
            @jax.jit
            def cycles(b, Am):
                def body(_, carry):
                    bk, acc = carry
                    fac = sp_fac(Am)
                    sol = sp_solve(fac, bk)
                    acc = acc + jnp.asarray(fac.num_neg, acc.dtype)
                    return sol / jnp.maximum(jnp.linalg.norm(sol), 1e-30), acc
                return jax.lax.fori_loop(0, K, body,
                                         (b, jnp.zeros((), jnp.int64)))
            return lambda b: cycles(b, Aspj)

        fac_sp_dense = pick_factorizer(Nsp, opts.ldlt_block_size)

        def make_sparse_dense(K):
            @jax.jit
            def cycles(b, Am):
                def body(_, carry):
                    bk, acc = carry
                    fac = fac_sp_dense(Am)
                    sol = ldlt_solve(fac, bk)
                    acc = acc + jnp.asarray(fac.num_neg, acc.dtype)
                    return sol / jnp.maximum(jnp.linalg.norm(sol), 1e-30), acc
                return jax.lax.fori_loop(0, K, body,
                                         (b, jnp.zeros((), jnp.int64)))
            return lambda b: cycles(b, Aspj)

        sp_ms = chain_ms(make_sparse, rhs_sp, K1=2, K2=8)
        spd_ms = chain_ms(make_sparse_dense, rhs_sp, K1=2, K2=6)
        detail["sparse_supernodal_n8192"] = {
            "sparse_ms": round(sp_ms, 3), "dense_ms": round(spd_ms, 3),
            "speedup": round(spd_ms / max(sp_ms, 1e-9), 2),
            "num_supernodes": plan.num_supernodes,
            "nnz_factor": plan.nnz_factor}

    result = {
        "metric": "batched_ipm_solves_per_sec",
        "value": round(throughput, 2),
        "unit": "solves/s",
        "vs_baseline": round(throughput / 3241.0, 3),
        "detail": detail,
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
