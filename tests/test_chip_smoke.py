"""chip_smoke.py's comparison helpers and refusals at tiny sizes on the CPU,
the compile-cache helper, and the GPU-only checks (marked `gpu`; they skip
without a card)."""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as cs
from uno_tpu.linalg.ldlt import barrier_kkt_like, ldlt_factor_blocked


def test_main_refuses_cpu(capsys):
    """No GPU: a non-zero exit, the reason on stderr, no result line."""
    assert jax.devices()[0].platform == "cpu"
    assert cs.main([]) != 0
    out = capsys.readouterr()
    assert "no GPU" in out.err
    assert '"ok"' not in out.out


def test_ldlt_vs_reference_catches_wrong_inertia():
    K = barrier_kkt_like(24, 6, 0)
    fac = ldlt_factor_blocked(jnp.asarray(K), block=8)
    good = cs.ldlt_vs_reference(K, fac)
    assert not good["mismatch"] and good["recon"] <= cs.RTOL["float64"]
    wrong = fac._replace(num_pos=fac.num_pos - 1, num_neg=fac.num_neg + 1)
    assert cs.ldlt_vs_reference(K, wrong)["mismatch"]
    scaled = fac._replace(d=fac.d * 1.01)
    assert cs.ldlt_vs_reference(K, scaled)["recon"] > cs.RTOL["float32"]


def test_solve_vs_reference_on_banded_and_sparse():
    import jax
    from uno_tpu.linalg.banded import (band_to_blocks, btd_cholesky_cr,
                                       btd_solve_cr, pick_block_size)
    from uno_tpu.linalg.sparse_ldlt import build_plan, make_sparse_ldlt

    band, A = cs.band_matrix(64, 3, seed=0)
    rhs = np.arange(64.0)
    D, E = band_to_blocks(jnp.asarray(band), pick_block_size(3))
    x = btd_solve_cr(btd_cholesky_cr(D, E), jnp.asarray(rhs))
    assert cs.solve_vs_reference(A, rhs, x) <= cs.RTOL["float64"]

    pat, A = cs.arrow_sparse_matrix(48, 2, seed=1)
    fac, solve = make_sparse_ldlt(build_plan(pat, np.zeros(48, dtype=bool)))
    x = jax.jit(lambda M, r: solve(fac(M), r))(jnp.asarray(A),
                                                jnp.asarray(rhs[:48]))
    assert cs.solve_vs_reference(A, rhs[:48], x) <= cs.RTOL["float64"]
    assert cs.solve_vs_reference(A, rhs[:48], np.asarray(x) * 1.1) > 1e-2


def test_batch_vs_serial_flags_disagreements():
    serial = [SimpleNamespace(status="optimal", objective=1.0),
              SimpleNamespace(status="optimal", objective=2.0),
              SimpleNamespace(status="optimal", objective=3.0)]
    assert cs.batch_vs_serial(["optimal"] * 3, [1.0, 2.0, 3.0 + 1e-9],
                              serial, 1e-6) == []
    bad = cs.batch_vs_serial(["optimal", "iteration_limit", "optimal"],
                             [1.0, 2.0, 3.1], serial, 1e-6)
    assert [i for i, _ in bad] == [1, 2]


def test_batched_cell_matches_serial_at_tiny_batch():
    """The phase-3 cell (bench's flagship builder, f32 KKT) against serial
    f64 uno_tpu.solve runs, at B=4 on the CPU."""
    import bench
    from uno_tpu.solvers.batch import build_batch_ipm

    opts = bench.flagship_ipm_options("float32")
    nlp, x0, params = bench._flagship_n(4, 8)
    _, run = build_batch_ipm(nlp, opts, params_example=jnp.asarray(params[0]))
    cs.batched_cell("flagship", opts, nlp, x0, params, run, n_compare=2,
                    dev=jax.devices()[0])


def test_scenario_nlp_structured_matches_monolithic():
    import uno_tpu
    from uno_tpu.solvers.structured import solve_structured_ipm

    snlp, mono = cs.scenario_nlp(S=4, n0=3, ns=4, m=2, seed=0)
    r = solve_structured_ipm(snlp, tol=1e-8)
    rd = uno_tpu.solve(mono, preset="ipopt", scale_functions=False)
    assert r.status == "optimal" and rd.success
    assert cs.rel_err(r.objective, rd.objective) <= 1e-6


def test_structured_ipm_over_mesh_matches_single_device():
    """The --four Schur path on four virtual CPU devices."""
    from uno_tpu.parallel import make_mesh
    from uno_tpu.solvers.structured import solve_structured_ipm

    snlp, _ = cs.scenario_nlp(S=8, n0=3, ns=4, m=2, seed=1)
    mesh = make_mesh(jax.devices()[:4], axis_name="scenario")
    r4 = solve_structured_ipm(snlp, tol=1e-8, mesh=mesh)
    r1 = solve_structured_ipm(snlp, tol=1e-8)
    assert r4.status == r1.status == "optimal"
    assert r4.iterations == r1.iterations
    assert cs.rel_err(r4.objective, r1.objective) <= cs.FOUR_VS_ONE_RTOL


# ---------------------------------------------------------------------------
# compile cache placement (uno_tpu/utils/compile_cache.py)
# ---------------------------------------------------------------------------

@pytest.fixture
def restore_cache_config():
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])


def test_compile_cache_follows_env(monkeypatch, tmp_path, restore_cache_config):
    from uno_tpu.utils.compile_cache import enable_compile_cache
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_compile_cache_defaults_to_checkout(monkeypatch, restore_cache_config):
    from uno_tpu.utils.compile_cache import enable_compile_cache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    assert enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


# ---------------------------------------------------------------------------
# GPU only: the chip_smoke phases at small sizes on the card
# (`JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_kernels_on_gpu(gpu):
    with jax.default_device(gpu):
        cs.phase_kernels(kkt_dims=(40, 160, 640), seeds=(0,), band_n=512,
                         sparse_n=512, time_dims=(256,), time_reps=2)


@pytest.mark.gpu
def test_batched_cell_on_gpu(gpu):
    import bench
    from uno_tpu.solvers.batch import build_batch_ipm

    with jax.default_device(gpu):
        opts = bench.flagship_ipm_options("float32")
        nlp, x0, params = bench._flagship_n(256, 8)
        _, run = build_batch_ipm(nlp, opts,
                                 params_example=jnp.asarray(params[0]))
        cs.batched_cell("flagship", opts, nlp, x0, params, run, n_compare=2,
                        dev=gpu)
