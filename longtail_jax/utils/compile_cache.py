"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (the CLI, bench.py, chip_smoke.py and the
test suite): if ``JAX_COMPILATION_CACHE_DIR`` is set, JAX uses it and
nothing here overrides it; otherwise the cache lives in ``.jax_cache`` at
the root of the checkout (listed in ``.gitignore``).
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT, ".jax_cache"))


def enable() -> str:
    """Point JAX's persistent compilation cache at cache_dir(); returns
    it.  With JAX_COMPILATION_CACHE_DIR set, JAX already reads it."""
    import jax

    path = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
