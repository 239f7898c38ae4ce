import os

# Tests run on the CPU with a virtual 8-device mesh, so the sharding paths
# are exercised without accelerators (SURVEY.md §4: multi-host tests
# simulated on CPU).  Code that needs a GPU is checked by chip_smoke.py
# and by tests marked `gpu`, which skip here.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# CPU unless the caller names platforms: on the card,
# `JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/` runs the GPU tests
jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: the end-to-end preset sweeps re-jit one
# solver per problem shape; caching cuts repeat suite runs to seconds of
# compile time.  JAX_COMPILATION_CACHE_DIR places it, else <checkout>/.jax_cache.
from uno_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


# ---------------------------------------------------------------------------
# slow tier: full-library sweeps (97-problem e2e, scipy cross-validation)
# run with `pytest --runslow`; the default run keeps a representative core
# subset so the suite stays under ~5 minutes (tools/sweep.py still covers
# the full library out-of-band).
# ---------------------------------------------------------------------------
import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption("--runslow", action="store_true", default=False,
                     help="run slow full-library tests")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: full-library sweep tests (deselected by default)")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips elsewhere (the `gpu` "
        "fixture decides at run time)")


@pytest.fixture
def gpu():
    """The first GPU device, or a skip.  Decided inside the fixture, never
    at import or collection time, so every xdist worker collects the same
    tests.  `python chip_smoke.py` on the card runs the same checks end to
    end at full size."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs an NVIDIA GPU (run `python chip_smoke.py` on the card)")
    return devices[0]


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow") or os.environ.get("RUN_SLOW"):
        return
    skip_slow = pytest.mark.skip(reason="slow tier: run with --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)
