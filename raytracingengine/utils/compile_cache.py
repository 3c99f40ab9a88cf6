"""Persistent XLA compilation cache.

Compiling the renderer's programs takes seconds to minutes, so every entry
point (CLI, bench, chip_smoke) enables JAX's persistent compilation cache
once per process. The directory is chosen by one rule:

  * `JAX_COMPILATION_CACHE_DIR` set: JAX already reads it; this module sets
    no directory of its own.
  * not set: `<checkout>/.jax_cache`, a fixed path (listed in .gitignore).
    The path is part of the cache key, so a moving directory never hits.
"""

from __future__ import annotations

import os

import jax

#: `<checkout>/.jax_cache` — the fallback cache directory.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the persistent cache uses under the rule above."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def setup_compile_cache() -> str:
    """Enable the persistent compilation cache (idempotent) -> its dir."""
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return cache_dir()
