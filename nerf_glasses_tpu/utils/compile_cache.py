"""Where JAX keeps its persistent compilation cache.

`JAX_COMPILATION_CACHE_DIR`, when set, wins: JAX reads it on its own and
nothing here overrides it. Otherwise the cache goes to a fixed directory
inside the checkout (the directory path is part of what makes a cache
hit, so it must not move between runs).
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"


def configure_compile_cache(default_dir: str) -> str:
    """Point JAX's persistent cache at $JAX_COMPILATION_CACHE_DIR or, when
    that is unset, at `default_dir` -> the directory in use. Graphs that
    compile in under a second are not cached."""
    import jax
    path = os.environ.get(ENV)
    if not path:
        path = default_dir
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
