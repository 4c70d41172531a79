"""Persistent XLA compilation cache for the entry points.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
here overrides it.  Otherwise the cache lives at a fixed directory inside
the checkout (``<repo>/.jax_cache``, gitignored): the path is part of the
cache key, so it must never move between runs.  Only the command-line
entry points call this — importing the package writes nothing.
"""

from __future__ import annotations

import os

__all__ = ["CACHE_DIR", "configure_compile_cache"]

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def configure_compile_cache() -> str:
    """Point JAX's persistent cache at its directory unless the environment
    already names one; returns the path in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
