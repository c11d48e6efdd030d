"""JAX's persistent compilation cache, kept at one fixed place.

Where $JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and this module
sets nothing.  Otherwise the cache lives at `.jax_cache/` in the checkout
(listed in .gitignore): a fixed path, because the path is part of what a
later run must find again.
"""
from __future__ import annotations

import os

import jax

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.normpath(os.path.join(os.path.dirname(__file__), "../../.jax_cache"))


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    if os.environ.get(CACHE_ENV):
        return os.environ[CACHE_ENV]
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
