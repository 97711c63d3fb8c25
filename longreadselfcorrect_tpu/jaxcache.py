"""Persistent XLA compile cache placement.

Walk-engine compiles take tens of seconds each, so every entry point keeps
JAX's persistent compilation cache in one fixed place: a cache is found
again only at the same path, so the path must not move between runs.
"""
from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def configure_compile_cache() -> str:
    """Point JAX's compile cache at ``$JAX_COMPILATION_CACHE_DIR`` when that
    is set (JAX reads it itself; nothing else is touched), otherwise at
    ``<checkout>/.jax_cache``.  Returns the directory in use."""
    path = os.environ.get(ENV)
    if path:
        return path
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
