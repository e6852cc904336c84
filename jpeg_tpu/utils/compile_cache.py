"""JAX's persistent compilation cache, in one place.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
is set here. Otherwise the cache lives at a fixed path inside the checkout,
``build/jax_cache`` (git-ignored), so every process started from this
checkout finds what earlier ones compiled.
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
