#!/usr/bin/env python
"""Smoke test of the solver on an NVIDIA GPU, through the user entry points.

    python chip_smoke.py          # one card: phases 0-3
    python chip_smoke.py --four   # four cards: only the cross-card paths,
                                  # each against its one-card counterpart

Phase 0 names the device and refuses anything but a GPU.  Phase 1 checks
the factorization kernels against numpy f64 (eigvalsh inertia,
reconstruction error, dense solves) and times XLA's blocked LDL^T.  Phase 2
runs single solves through `uno_tpu.solve`.  Phase 3 runs the batched main
path at the benchmark's sizes and compares the first instances with serial
f64 solves on the same card.  `--four` runs the sharded batch, the
distributed KKT and the Schur-complement structured IPM over four GPUs.

A failed check fails its phase.  The remaining phases still run, so one
run shows every failure, and the script then exits 1 without a result
line.  The last stdout line of a passing run is
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
The script is one JAX process; its only child is `nvidia-smi`.
"""

from __future__ import annotations

import dataclasses
import json
from functools import partial
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# Factorization tolerances, relative to ||A||_F (reconstruction) or to
# ||x_ref|| (solves).  f64: the backward error of these factorizations is
# ~1e-16; 1e-10 leaves room for summation order and growth.  f32 with
# HIGHEST products: ~1e-7 on these matrices; 1e-4 keeps three digits of
# margin, while TF32 products (10-bit mantissa) would sit near 1e-3.
RTOL = {"float64": 1e-10, "float32": 1e-4}
# Barrier-KKT spectra of the factorization checks (diagonal 1e-s..1e+s).
# Spread 9 is what the inertia-correction loop sees; its smallest
# eigenvalues sit ~1e-11 below the largest, below what any f32
# factorization can resolve, so f32 inertia is checked only on draws with
# min|eig| >= F32_RESOLVABLE * max|eig| (the rule of
# tests/test_ldlt.py::test_f32_inertia_matches_f64_oracle) — the spread-2
# draws.  Reconstruction is checked on spread 9, whose norm the barrier
# diagonal sets; at spread 2 unpivoted growth dominates it and it is only
# reported.
BARRIER_SPREADS = (9, 2)
F32_RESOLVABLE = 1e-5
# batch vs serial: the batch factors in f32 (refined in f64), the serial
# reference factors in f64; both stop at the preset tolerance, so their
# optima agree to about that tolerance
BATCH_VS_SERIAL_RTOL = 1e-6
# the same program on one card and on four: only reduction order differs
FOUR_VS_ONE_RTOL = 1e-10
SOLVED_NAMES = ("optimal", "almost_optimal", "feasible_small_step")
# solved share below which a batched cell fails (every instance of the
# flagship family is solvable; a stray stall is tolerated)
MIN_SOLVED_SHARE = 0.99


class CheckFailed(AssertionError):
    pass


def expect(ok, what: str):
    if not ok:
        raise CheckFailed(what)


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b)),
                        initial=0.0))


def log(msg: str):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# comparison helpers (also exercised by tests/test_chip_smoke.py on the CPU)
# ---------------------------------------------------------------------------

def reference_spectrum(K) -> tuple:
    """((pos, neg, zero), min|eig| / max|eig|) of a symmetric matrix from
    numpy f64 eigvalsh."""
    eig = np.linalg.eigvalsh(np.asarray(K, np.float64))
    sep = float(np.min(np.abs(eig)) / np.max(np.abs(eig)))
    return (int(np.sum(eig > 0)), int(np.sum(eig < 0)), 0), sep


def reference_inertia(K) -> tuple:
    """(pos, neg, zero) of a symmetric matrix from numpy f64 eigvalsh."""
    return reference_spectrum(K)[0]


def ldlt_vs_reference(K, fac, inertia=None) -> dict:
    """Compare an LDLT factorization of K with the numpy f64 reference:
    inertia mismatch (bool) and ||L D L^T - K||_F / ||K||_F."""
    K = np.asarray(K, np.float64)
    want = inertia if inertia is not None else reference_inertia(K)
    got = (int(fac.num_pos), int(fac.num_neg), int(fac.num_zero))
    L = np.asarray(fac.L, np.float64)
    d = np.asarray(fac.d, np.float64)
    recon = np.linalg.norm((L * d[None, :]) @ L.T - K) / np.linalg.norm(K)
    return {"mismatch": got != tuple(want), "inertia": got,
            "recon": float(recon)}


def solve_vs_reference(A, rhs, x) -> float:
    """||x - A^{-1} rhs|| / ||A^{-1} rhs|| with numpy's f64 dense solve."""
    x_ref = np.linalg.solve(np.asarray(A, np.float64),
                            np.asarray(rhs, np.float64))
    return float(np.linalg.norm(np.asarray(x, np.float64) - x_ref)
                 / np.linalg.norm(x_ref))


def batch_vs_serial(batch_status, batch_obj, serial, rtol) -> list:
    """Mismatches between the first len(serial) batch instances and serial
    solves: `batch_status` are status names, `serial` Result objects.
    Returns a list of (i, why) for every instance that disagrees."""
    bad = []
    for i, r in enumerate(serial):
        if batch_status[i] != r.status:
            bad.append((i, f"status {batch_status[i]} vs {r.status}"))
        elif rel_err(batch_obj[i], r.objective) > rtol:
            bad.append((i, f"objective {batch_obj[i]!r} vs {r.objective!r}"))
    return bad


def band_matrix(n: int, bw: int, seed: int):
    """Diagonally dominant SPD band (lower storage band[d, i] = A[i+d, i])
    and its dense f64 matrix."""
    rng = np.random.default_rng(seed)
    band = np.zeros((bw + 1, n))
    for d in range(bw + 1):
        band[d, : n - d] = rng.standard_normal(n - d) * 0.1
    band[0] = np.abs(band).sum(0) * 2 + 2.0
    A = np.diag(band[0])
    for d in range(1, bw + 1):
        A += np.diag(band[d, : n - d], -d) + np.diag(band[d, : n - d], d)
    return band, A


def arrow_sparse_matrix(N: int, bw: int, seed: int):
    """Band-plus-spikes symmetric matrix (the sparse bench pattern): the
    boolean pattern and the dense f64 matrix."""
    rng = np.random.default_rng(seed)
    pat = np.zeros((N, N), dtype=bool)
    for o in range(bw + 1):
        idx = np.arange(N - o)
        pat[idx, idx + o] = True
        pat[idx + o, idx] = True
    pat[-2:, :] = True
    pat[:, -2:] = True
    A = np.where(pat, rng.standard_normal((N, N)), 0.0)
    A = (A + A.T) / 2
    A[np.diag_indices(N)] = 10.0 + rng.random(N)
    return pat, A


def scenario_nlp(S: int, n0: int, ns: int, m: int, seed: int):
    """Two-stage scenario NLP (solvers/structured.py) and its monolithic
    twin for the dense IPM:

        min ||x0 - 1||^2 + sum_s ||xs - a_s||^2 + 0.1 x0[:m].(G_s xs[:m])
        s.t. per scenario  C_s xs + 0.1 x0[:m]^2 = b_s,   xs >= 0."""
    import jax.numpy as jnp
    from uno_tpu.model.nlp import INF, nlp_from_functions
    from uno_tpu.solvers.structured import ScenarioNLP

    rng = np.random.default_rng(seed)
    a = rng.uniform(-0.5, 1.5, (S, ns))
    C = np.abs(rng.standard_normal((S, m, ns))) / np.sqrt(ns)
    G = rng.standard_normal((S, m, m)) * 0.1
    b = rng.uniform(1.0, 2.0, (S, m))

    def f0(x0):
        return jnp.sum((x0 - 1.0) ** 2)

    def fs(x0, xs, p):
        return jnp.sum((xs - p["a"]) ** 2) \
            + 0.1 * x0[:m] @ (p["G"] @ xs[:m])

    def cs(x0, xs, p):
        return p["C"] @ xs + 0.1 * x0[:m] ** 2 - p["b"]

    params = {"a": jnp.asarray(a), "C": jnp.asarray(C),
              "G": jnp.asarray(G), "b": jnp.asarray(b)}
    snlp = ScenarioNLP(
        name=f"scenario_S{S}", n0=n0, ns=ns, m=m, S=S, f0=f0, fs=fs, cs=cs,
        x0_lb=np.full(n0, -INF), x0_ub=np.full(n0, INF),
        xs_lb=np.zeros(ns), xs_ub=np.full(ns, INF),
        x0_init=np.full(n0, 0.5), xs_init=np.full((S, ns), 0.5),
        params=params)

    def f(z):
        x0, xs = z[:n0], z[n0:].reshape(S, ns)
        return f0(x0) + jnp.sum((xs - params["a"]) ** 2) + 0.1 * jnp.einsum(
            "i,sij,sj->", x0[:m], params["G"], xs[:, :m])

    def c(z):
        x0, xs = z[:n0], z[n0:].reshape(S, ns)
        return (jnp.einsum("sij,sj->si", params["C"], xs)
                + 0.1 * x0[:m] ** 2 - params["b"]).reshape(-1)

    mono = nlp_from_functions(
        f"scenario_S{S}_monolithic", f, c, x0=np.full(n0 + S * ns, 0.5),
        x_lb=np.concatenate([np.full(n0, -INF), np.zeros(S * ns)]),
        x_ub=np.full(n0 + S * ns, INF),
        c_lb=np.zeros(S * m), c_ub=np.zeros(S * m))
    return snlp, mono


def _peak_bytes(dev):
    stats = dev.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _instance(nlp, x0, params):
    return dataclasses.replace(nlp, x0=np.asarray(x0), params=params)


# ---------------------------------------------------------------------------
# phase 0: device
# ---------------------------------------------------------------------------

def phase_device(want_count: int):
    import jax
    dev = jax.devices()[0]
    log(f"device: platform={dev.platform} kind={dev.device_kind} "
        f"count={jax.device_count()}")
    if dev.platform != "gpu":
        return None, (f"JAX found no GPU (platform {dev.platform!r}); this "
                      "smoke test checks the GPU build and does not run "
                      "on the CPU")
    if jax.device_count() < want_count:
        return None, (f"needs {want_count} GPUs, JAX found "
                      f"{jax.device_count()}")
    # the card's name and power limit, from a child that stays off JAX
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    for line in smi.stdout.strip().splitlines():
        log(f"nvidia-smi: {line.strip()}")
    return dev, None


# ---------------------------------------------------------------------------
# phase 1: kernels against the plain reference
# ---------------------------------------------------------------------------

def phase_kernels(kkt_dims=(40, 160, 640, 1280, 2560), seeds=(0, 1),
                  band_n=4096, band_bw=31, sparse_n=4096,
                  time_dims=(256, 640, 1280), time_reps=10):
    import jax
    import jax.numpy as jnp
    from jax import lax
    from uno_tpu.ingredients.regularization import pick_factorizer
    from uno_tpu.linalg.ldlt import (FACTOR_PRECISION, barrier_kkt_like,
                                     ldlt_factor_blocked)

    log(f"f32 factorization products run at precision={FACTOR_PRECISION.name}")
    for dim in kkt_dims:
        m = dim // 5
        fac_fn = jax.jit(pick_factorizer(dim, 32))
        fac_default = jax.jit(partial(ldlt_factor_blocked, block=32,
                                      precision=lax.Precision.DEFAULT))
        variants = [("float64", fac_fn), ("float32", fac_fn)]
        if dim > 64:   # only the blocked variant has matrix products
            variants.append(("float32 DEFAULT", fac_default))
            hlo = fac_fn.lower(jnp.zeros((dim, dim), "float32")).as_text()
            log(f"  dim {dim}: lowered f32 factorization names HIGHEST: "
                f"{'HIGHEST' in hlo}")
        for spread in BARRIER_SPREADS:
            rows = {name: [] for name, _ in variants}
            resolvable = 0
            for seed in seeds:
                K = barrier_kkt_like(dim - m, m, seed, spread=spread)
                want, sep = reference_spectrum(K)
                ok32 = sep >= F32_RESOLVABLE
                resolvable += ok32
                for name, fn in variants:
                    r = ldlt_vs_reference(
                        K, fn(jnp.asarray(K, name.split()[0])), want)
                    r["checked"] = name == "float64" or ok32
                    rows[name].append(r)
            for name, rs in rows.items():
                mis = sum(r["mismatch"] for r in rs if r["checked"])
                mis_u = sum(r["mismatch"] for r in rs if not r["checked"])
                rec = max(r["recon"] for r in rs)
                n_chk = sum(r["checked"] for r in rs)
                log(f"  ldlt dim {dim} spread 1e+-{spread} {name}: inertia "
                    f"mismatches {mis}/{n_chk} checked draws ({mis_u}/"
                    f"{len(rs) - n_chk} on draws f32 cannot resolve), max "
                    f"recon {rec:.3e}")
                if name in RTOL:
                    expect(mis == 0, f"dim {dim} spread {spread} {name}: "
                           f"{mis} inertia mismatches")
                if name in RTOL and spread == BARRIER_SPREADS[0]:
                    expect(rec <= RTOL[name], f"dim {dim} {name}: recon "
                           f"{rec:.3e} > {RTOL[name]}")

    # banded block-tridiagonal cyclic reduction vs a dense f64 solve
    from uno_tpu.linalg.banded import (band_to_blocks, btd_cholesky_cr,
                                       btd_solve_cr, pick_block_size)
    band, A = band_matrix(band_n, band_bw, seed=3)
    rhs = np.random.default_rng(4).standard_normal(band_n)
    nb = pick_block_size(band_bw)

    @jax.jit
    def banded_solve(bj, r):
        D, E = band_to_blocks(bj, nb)
        fac = btd_cholesky_cr(D, E)
        return btd_solve_cr(fac, r), fac.num_pos

    for dt in ("float64", "float32"):
        x, npos = banded_solve(jnp.asarray(band, dt), jnp.asarray(rhs, dt))
        err = solve_vs_reference(A, rhs, x)
        log(f"  banded n={band_n} bw={band_bw} {dt}: solve rel err "
            f"{err:.3e}, num_pos {int(npos)}")
        expect(err <= RTOL[dt], f"banded {dt}: err {err:.3e}")
        expect(int(npos) == band_n, f"banded {dt}: num_pos {int(npos)}")

    # supernodal sparse LDL^T vs a dense f64 solve
    from uno_tpu.linalg.sparse_ldlt import build_plan, make_sparse_ldlt
    pat, A = arrow_sparse_matrix(sparse_n, 4, seed=5)
    rhs = np.random.default_rng(6).standard_normal(sparse_n)
    want = reference_inertia(A)
    plan = build_plan(pat, np.zeros(sparse_n, dtype=bool))
    sp_fac, sp_solve = make_sparse_ldlt(plan)

    @jax.jit
    def sparse_solve(Aj, r):
        fac = sp_fac(Aj)
        return sp_solve(fac, r), (fac.num_pos, fac.num_neg, fac.num_zero)

    for dt in ("float64", "float32"):
        x, inertia = sparse_solve(jnp.asarray(A, dt), jnp.asarray(rhs, dt))
        inertia = tuple(int(v) for v in inertia)
        err = solve_vs_reference(A, rhs, x)
        log(f"  sparse N={sparse_n} ({plan.num_supernodes} supernodes) "
            f"{dt}: solve rel err {err:.3e}, inertia {inertia} vs {want}")
        expect(err <= RTOL[dt], f"sparse {dt}: err {err:.3e}")
        expect(inertia == want, f"sparse {dt}: inertia {inertia} vs {want}")

    # XLA's blocked LDL^T, single instance: the route every dense KKT
    # above dim 64 takes, timed at these dims
    for dim in time_dims:
        K = barrier_kkt_like(dim - dim // 5, dim // 5, 7)
        for dt in ("float32", "float64"):
            f = jax.jit(lambda A: ldlt_factor_blocked(A, block=32))
            Kj = jnp.asarray(K, dt)
            jax.block_until_ready(f(Kj))
            ts = []
            for _ in range(time_reps):
                t0 = time.perf_counter()
                jax.block_until_ready(f(Kj))
                ts.append(time.perf_counter() - t0)
            t = float(np.median(ts))
            log(f"  time ldlt_factor_blocked dim {dim} {dt}: "
                f"{t * 1e3:.4f} ms (median of {time_reps}), "
                f"{dim ** 3 / 3 / t / 1e9:.2f} GFLOP/s")


# ---------------------------------------------------------------------------
# phase 2: single solves through uno_tpu.solve
# ---------------------------------------------------------------------------

# (problem, preset, relative objective tolerance, overrides) — the problems
# and tolerances of tests/test_sqp_fused.py and tests/test_ipm.py
SINGLE_SOLVES = (
    ("hs015", "ipopt", 1e-4, {}),
    ("hs015", "filtersqp", 1e-4, {}),
    ("hs015", "byrd", 1e-4, {"max_iterations": 500}),
    ("hs015", "funnelsqp", 1e-4, {}),
    ("hs015", "filterslp", 1e-3, {}),
    ("hs071", "ipopt", 1e-4, {}),
    ("hs071", "filtersqp", 1e-4, {}),
    ("hs071", "byrd", 1e-4, {"max_iterations": 500}),
)


def phase_single(rosen="srosenbr_n1000",
                 nl_fixture="chained_rosenbrock_n10"):
    import uno_tpu
    from uno_tpu.model.library import (acceptable_optima, chained_rosenbrock,
                                       get_problem)

    for name, pname, tol, over in SINGLE_SOLVES:
        t0 = time.perf_counter()
        r = uno_tpu.solve(get_problem(name), preset=pname, **over)
        optima = acceptable_optima(name)
        err = min(rel_err(r.objective, f) for f in optima)
        log(f"  {name} {pname}: {r.status} f={r.objective!r} "
            f"iters={r.iterations} rel err {err:.2e} "
            f"({time.perf_counter() - t0:.1f} s)")
        expect(r.status in SOLVED_NAMES, f"{name} {pname}: {r.status}")
        expect(err <= tol, f"{name} {pname}: objective rel err {err:.2e}")

    nlp = get_problem(rosen)
    res = {}
    for form in ("banded", "augmented"):
        t0 = time.perf_counter()
        res[form] = r = uno_tpu.solve(nlp, preset="ipopt",
                                      kkt_formulation=form)
        log(f"  {rosen} ipopt kkt_formulation={form}: {r.status} "
            f"f={r.objective!r} iters={r.iterations} "
            f"({time.perf_counter() - t0:.1f} s)")
        expect(r.success, f"{rosen} {form}: {r.status}")
    b, a = res["banded"], res["augmented"]
    expect(b.iterations == a.iterations,
           f"{rosen}: iterations banded {b.iterations} vs augmented "
           f"{a.iterations}")
    expect(rel_err(b.objective, a.objective) <= 1e-8,
           f"{rosen}: objectives {b.objective!r} vs {a.objective!r}")

    from uno_tpu.io import nl as nl_mod
    so = Path(nl_mod.__file__).with_name("libnlread.so")
    existed = so.exists()
    path = ROOT / "tests" / "fixtures" / "nl" / f"{nl_fixture}.nl"
    nl = nl_mod.read_nl(path)
    r = uno_tpu.solve(nl, preset="ipopt")
    log(f"  .nl {path.name}: libnlread.so "
        f"{'reused' if existed else 'built by g++ in this run'}; "
        f"{r.status} f={r.objective!r} iters={r.iterations}")
    expect(r.success and r.objective < 1e-8, f".nl solve: {r}")

    r = uno_tpu.solve(chained_rosenbrock(40), preset="filtersqp",
                      time_limit=1e-9, sqp_driver="fused")
    log(f"  fused filtersqp with time_limit=1e-9: {r.status}")
    expect(r.status == "time_limit", f"time limit: {r.status}")


# ---------------------------------------------------------------------------
# phase 3: the batched main path at the benchmark's sizes
# ---------------------------------------------------------------------------

def batched_cell(label, opts, nlp, x0, params, run, n_compare, dev):
    """Run one batched cell twice (compile + first, then one timed run),
    report it, and compare its first `n_compare` instances with serial
    uno_tpu.solve runs in f64 on the same card."""
    import jax
    import jax.numpy as jnp
    import uno_tpu
    from uno_tpu.solvers.sqp_fused import SQP_STATUS_NAMES

    x0j, pj = jnp.asarray(x0), jnp.asarray(params)
    t0 = time.perf_counter()
    final = jax.block_until_ready(run(x0j, pj))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    final = jax.block_until_ready(run(x0j, pj))
    wall = time.perf_counter() - t0
    B = x0.shape[0]
    names = [SQP_STATUS_NAMES[int(s)] for s in np.asarray(final.status)]
    x = np.asarray(final.x)[:, : nlp.n]
    obj = np.asarray(jax.vmap(nlp.objective)(jnp.asarray(x), pj))
    solved = sum(n in SOLVED_NAMES for n in names)
    strict = sum(n == "optimal" for n in names)
    iters = np.asarray(final.iteration)
    log(f"  {label} B={B}: solved {solved}/{B} (optimal {strict}), mean "
        f"iterations {iters.mean():.3f}, max {int(iters.max())}, compile+first "
        f"{compile_s:.1f} s, one run {wall:.4f} s (block_until_ready), "
        f"peak_bytes_in_use {_peak_bytes(dev)}")
    expect(solved >= MIN_SOLVED_SHARE * B, f"{label}: solved {solved}/{B}")

    serial_opts = opts.replace(kkt_dtype="float64")
    serial, secs = [], []
    for i in range(n_compare):
        t0 = time.perf_counter()
        serial.append(uno_tpu.solve(_instance(nlp, x0[i], params[i]),
                                    options=serial_opts))
        secs.append(time.perf_counter() - t0)
    bad = batch_vs_serial(names, obj, serial, BATCH_VS_SERIAL_RTOL)
    log(f"  {label}: first {n_compare} vs serial f64 uno_tpu.solve: "
        f"{n_compare - len(bad)}/{n_compare} match, max objective rel diff "
        f"{max(rel_err(obj[i], r.objective) for i, r in enumerate(serial)):.2e}"
        f" (first solve {secs[0]:.1f} s, median of the rest "
        f"{np.median(secs[1:] or secs):.1f} s)")
    expect(not bad, f"{label}: batch vs serial mismatches {bad}")


def phase_batched(dev, flagship_B=65536, sqp_B=8192, n_compare=16):
    import jax.numpy as jnp
    import bench
    from uno_tpu.solvers.batch import build_batch_ipm

    opts = bench.flagship_ipm_options("float32")
    nlp, x0, params = bench._flagship_n(flagship_B, 8)
    _, run = build_batch_ipm(nlp, opts, params_example=jnp.asarray(params[0]))
    batched_cell("flagship ipopt f32", opts, nlp, x0, params, run,
                 n_compare, dev)
    for pname in ("filtersqp", "byrd"):
        p_opts, nlp_s, x0s, ps, run_s = bench.build_fused_sqp_cell(
            pname, sqp_B, "float32")
        batched_cell(f"bucketed {pname} f32", p_opts, nlp_s, x0s, ps, run_s,
                     n_compare, dev)


# ---------------------------------------------------------------------------
# --four: the cross-card paths, each against its one-card counterpart
# ---------------------------------------------------------------------------

def phase_four_sharded(devs, B=65536):
    import jax
    import bench
    from uno_tpu.parallel import build_sharded_batch_ipm, make_mesh

    opts = bench.flagship_ipm_options("float32")
    nlp, x0, params = bench._flagship_n(B, 8)
    out = {}
    for k in (len(devs), 1):
        _, solve = build_sharded_batch_ipm(nlp, opts, make_mesh(devs[:k]))
        t0 = time.perf_counter()
        final = jax.block_until_ready(solve(x0, params))
        compile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        final = jax.block_until_ready(solve(x0, params))
        wall = time.perf_counter() - t0
        x = np.asarray(final.x)[:, : nlp.n]
        obj = np.asarray(jax.vmap(nlp.objective)(x, params))
        out[k] = (np.asarray(final.status), np.asarray(final.iteration), obj)
        log(f"  sharded batch B={B} on {k} card(s): solved "
            f"{int(np.sum(np.isin(out[k][0], (1, 2))))}/{B}, compile+first "
            f"{compile_s:.1f} s, one run {wall:.4f} s")
    (s4, i4, o4), (s1, i1, o1) = out[len(devs)], out[1]
    log(f"  sharded vs one card: statuses equal {np.array_equal(s4, s1)}, "
        f"iterations equal {np.array_equal(i4, i1)}, max objective rel diff "
        f"{rel_err(o4, o1):.2e}")
    expect(np.array_equal(s4, s1), "sharded batch: statuses differ")
    expect(np.array_equal(i4, i1), "sharded batch: iterations differ")
    expect(rel_err(o4, o1) <= FOUR_VS_ONE_RTOL, "sharded batch: objectives")


def phase_four_dist_kkt(devs, n=1408, m=320, min_dim=2048):
    import jax
    import uno_tpu
    from jax.sharding import Mesh
    from uno_tpu.model.library import scalable_quadratic
    from uno_tpu.options import preset
    from uno_tpu.solvers.ipm import (STATUS_NAMES, build_ipm,
                                     canonicalize_state, make_initial_state)

    nlp = scalable_quadratic(n, m, seed=2)
    opts = preset("ipopt", scale_functions=False, ldlt_backend="distributed")
    prob, ws, _, run = build_ipm(nlp, opts, mesh=Mesh(np.asarray(devs),
                                                      ("kkt",)))
    t0 = time.perf_counter()
    final = jax.block_until_ready(
        run(canonicalize_state(make_initial_state(prob, ws, opts))))
    t_d = time.perf_counter() - t0
    status = STATUS_NAMES[int(final.status)]
    xd = np.asarray(final.x)[: nlp.n]
    fd = float(nlp.objective(xd))
    t0 = time.perf_counter()
    ref = uno_tpu.solve(nlp, preset="ipopt", scale_functions=False)
    t_1 = time.perf_counter() - t0
    log(f"  distributed KKT (dim {prob.n + ws.m}) on {len(devs)} cards: "
        f"{status} f={fd!r} iters={int(final.iteration)} ({t_d:.1f} s incl. "
        f"compile); one-card dense: {ref.status} f={ref.objective!r} "
        f"iters={ref.iterations} ({t_1:.1f} s incl. compile); max |x| diff "
        f"{np.max(np.abs(xd - ref.x)):.2e}")
    expect(prob.n + ws.m >= min_dim, f"distributed KKT below dim {min_dim}")
    expect(status in ("optimal", "almost_optimal") and ref.success,
           f"distributed KKT: {status} / {ref.status}")
    expect(np.max(np.abs(xd - ref.x)) <= 1e-6, "distributed KKT: x differs")
    expect(rel_err(fd, ref.objective) <= 1e-8, "distributed KKT: objective")


def phase_four_schur(devs, S=64, n0=8, ns=24, m=4):
    import uno_tpu
    from uno_tpu.parallel import make_mesh
    from uno_tpu.solvers.structured import solve_structured_ipm

    snlp, mono = scenario_nlp(S, n0, ns, m, seed=11)
    r4 = solve_structured_ipm(snlp, tol=1e-8,
                              mesh=make_mesh(devs, axis_name="scenario"))
    r1 = solve_structured_ipm(snlp, tol=1e-8)
    rd = uno_tpu.solve(mono, preset="ipopt", scale_functions=False)
    log(f"  Schur structured IPM S={S}: {len(devs)} cards {r4.status} "
        f"f={r4.objective!r} iters={r4.iterations} ({r4.cpu_time:.1f} s); "
        f"one card {r1.status} f={r1.objective!r} iters={r1.iterations} "
        f"({r1.cpu_time:.1f} s); one-card dense IPM {rd.status} "
        f"f={rd.objective!r} iters={rd.iterations}")
    expect(r4.status == "optimal" and r1.status == "optimal" and rd.success,
           f"Schur: {r4.status} / {r1.status} / {rd.status}")
    expect(r4.iterations == r1.iterations, "Schur: iterations differ")
    expect(rel_err(r4.objective, r1.objective) <= FOUR_VS_ONE_RTOL,
           "Schur: four cards vs one card objective")
    expect(rel_err(r4.objective, rd.objective) <= 1e-6,
           "Schur: structured vs dense objective")
    expect(np.max(np.abs(r4.x0 - rd.x[:n0])) <= 1e-5, "Schur: x0 differs")


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    four = "--four" in argv
    import jax

    dev, why = phase_device(4 if four else 1)
    if dev is None:
        print(f"chip_smoke: {why}", file=sys.stderr)
        return 2
    try:
        from uno_tpu.utils.compile_cache import enable_compile_cache
    except ImportError as exc:
        print(f"chip_smoke: run from the repository root ({exc})",
              file=sys.stderr)
        return 2
    log(f"compile cache: {enable_compile_cache()}")
    import uno_tpu  # noqa: F401  (enables x64)

    if four:
        devs = jax.devices()[:4]
        phases = (("four: sharded batch", lambda: phase_four_sharded(devs)),
                  ("four: Schur structured IPM",
                   lambda: phase_four_schur(devs)),
                  ("four: distributed KKT", lambda: phase_four_dist_kkt(devs)))
    else:
        phases = (("1: kernels", phase_kernels),
                  ("2: single solves", phase_single),
                  ("3: batched", lambda: phase_batched(dev)))
    failed = []
    for name, fn in phases:
        log(f"phase {name}")
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # noqa: BLE001 — report, fail the run at the end
            traceback.print_exc()
            failed.append(name)
            log(f"phase {name}: FAILED ({time.perf_counter() - t0:.1f} s)")
        else:
            log(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)")
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": jax.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
