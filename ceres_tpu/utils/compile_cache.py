"""The one place that points JAX's persistent compilation cache.

JAX reads `JAX_COMPILATION_CACHE_DIR` itself. When that variable is set this
module sets no directory; otherwise the cache goes to `<checkout>/.jax_cache`,
a path derived from this file's location (the cache key includes the path,
so a directory that moves never hits).
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

CHECKOUT = Path(__file__).resolve().parents[2]
ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def cache_dir() -> str:
    """The directory the persistent cache uses."""
    return os.environ.get(ENV_VAR) or str(CHECKOUT / ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent cache for every compile; returns its path."""
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return cache_dir()
