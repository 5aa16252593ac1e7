"""JAX's persistent compilation cache, kept in one place.

The cache lives where ``JAX_COMPILATION_CACHE_DIR`` says when that is set,
and otherwise in ``.jax_cache`` at the root of the checkout.  A fixed path
matters: the directory is part of the cache key, so a moving one never hits.
"""

from __future__ import annotations

import os

import jax

__all__ = ["enable_compile_cache", "DEFAULT_DIR"]

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory; returns it."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    return path
