"""Persistent compile cache at a fixed place."""

from __future__ import annotations

import os
from pathlib import Path

import jax

CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache; returns its directory.

    Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and this
    sets nothing. Otherwise the cache is `.jax_cache/` at the root of the
    checkout: a fixed path, because the path is part of what a later run
    must find again. Call it first in an entry point, before compiling.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE))
    return str(CHECKOUT_CACHE)
