"""Persistent XLA compilation cache, placed by the entry points.

The library sets no cache when it is imported.  Entry points (`bench.py`,
`chip_smoke.py`, `python -m uno_tpu`, the tools and the test suite) call
`enable_compile_cache()`:

- if `JAX_COMPILATION_CACHE_DIR` is set, the cache lives there and no other
  directory is set in code;
- otherwise it lives at `<checkout>/.jax_cache` (listed in `.gitignore`), a
  fixed path, since the path is part of what keys a cache hit.
"""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at the directory above and
    cache every program that takes at least a second to compile.  Returns
    the directory."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(CHECKOUT_CACHE)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
