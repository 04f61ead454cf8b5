"""Where JAX's persistent compilation cache lives."""

from __future__ import annotations

import os
from pathlib import Path

import jax

CHECKOUT = Path(__file__).resolve().parents[2]


def enable() -> str:
    """Turn on the persistent compilation cache and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
    other directory is set here. Otherwise the cache goes to the fixed
    ``<checkout>/.jax_cache``: the path is part of what a later run has to
    find again, so it must not move between runs.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(CHECKOUT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
