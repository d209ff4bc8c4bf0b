"""Where JAX keeps its persistent compilation cache.

`JAX_COMPILATION_CACHE_DIR` decides when it is set, and no other directory
is set in code. Otherwise the cache lives at the fixed `<checkout>/.jax_cache`
(git-ignored): the path is part of the cache's key, so a directory that moved
between runs (temporary, per-process or per-run) would never hit.
"""
from __future__ import annotations

import os

_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def compile_cache_dir() -> str:
    """The cache directory: the environment's, else `<checkout>/.jax_cache`."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _CHECKOUT, ".jax_cache"
    )


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at compile_cache_dir() and
    return that directory. Goes through jax.config because an interpreter
    that imported jax before this call has already read the environment."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
