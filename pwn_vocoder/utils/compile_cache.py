"""Persistent XLA compilation cache for the entry points (CLI, bench.py,
chip_smoke.py).

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and nothing
is set here.  Otherwise the cache lives at one fixed path inside the
checkout, `<repo>/.jax_cache/` (git-ignored): the cache directory must
not move between runs for a later process to find what an earlier one
compiled.
"""

from __future__ import annotations

import os

import jax

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns its directory."""
    if os.environ.get(CACHE_ENV):
        return os.environ[CACHE_ENV]
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
