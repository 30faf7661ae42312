"""Persistent XLA compilation cache.

Every entry point (bench, smoke check, examples, tools, tests) calls
:func:`setup` once before its first compile, so repeated runs load compiled
programs from disk instead of compiling them again.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets no directory. Otherwise the cache lives at the fixed path
``<checkout>/.jax_cache`` (listed in .gitignore): the path is part of the
cache key, so a directory that moves never hits.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.normpath(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", ".jax_cache")
)


def setup() -> str:
    """Enable the persistent cache for every program; returns its directory."""
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return jax.config.jax_compilation_cache_dir
