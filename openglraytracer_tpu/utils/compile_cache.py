"""JAX's persistent compilation cache, in one place.

The cache lives where ``JAX_COMPILATION_CACHE_DIR`` says when it is set, and
otherwise in ``.jax_cache`` at the root of the checkout (gitignored). The
path is part of the cache's key, so it is fixed rather than per-run.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

CHECKOUT = Path(__file__).resolve().parents[2]


def compile_cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") \
        or str(CHECKOUT / ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at compile_cache_dir() and
    return the path."""
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2)
    return path
