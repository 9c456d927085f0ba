"""Where JAX keeps its persistent compilation cache.

`JAX_COMPILATION_CACHE_DIR`, when set, wins: JAX reads it by itself and
nothing here sets another path.  Otherwise the cache goes to one fixed
directory (the caller passes the checkout's `.jax_cache/`, which
`.gitignore` lists).  A cache directory is part of the cache key, so it is
never made from a temporary name, a pid or the time.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"


def enable_compile_cache(default_dir: str) -> str:
    """Turn the persistent cache on; returns the directory in use."""
    import jax

    env_dir = os.environ.get(ENV)
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", default_dir)
    return default_dir
