"""The persistent XLA compile cache every entry point shares.

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and this
module sets nothing. Otherwise the cache lives at one fixed path inside
the checkout (`.jax_cache/`, listed in .gitignore): the path is part of
the cache key, so a fixed one is what lets a rerun hit.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable(min_compile_secs: float = 1.0) -> str:
    """Turn the cache on; returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return DEFAULT_DIR
