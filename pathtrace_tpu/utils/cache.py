"""Where JAX keeps its persistent compile cache."""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def setup_compile_cache() -> str:
    """Enable the persistent compile cache and return its directory.

    If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and no
    directory is set here; otherwise the cache lives in <repo>/.jax_cache.
    Call before the first compilation.
    """
    import jax

    path = os.environ.get(ENV_VAR)
    if not path:
        path = REPO_CACHE
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
