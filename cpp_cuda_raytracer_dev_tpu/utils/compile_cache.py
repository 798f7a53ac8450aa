"""JAX persistent compilation cache location, chosen in one place.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets nothing. Otherwise the cache goes to ``.jax_cache/`` at the
repository root — a fixed path, because the path is part of the cache key
and a directory that moves never hits.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory (call
    before the first compilation); returns the directory."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
