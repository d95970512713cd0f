"""Persistent XLA compile cache at a fixed path.

A compiled sweep takes tens of seconds to build; the persistent cache lets
every later process with the same program skip that.  The cache directory
is part of what a later run must find again, so it is fixed: where
``JAX_COMPILATION_CACHE_DIR`` is set JAX reads it itself, and otherwise the
cache lives at ``<checkout>/.jax_cache``, derived from this package's
location.  Every entry point (CLI, bench.py, chip_smoke.py, tools) calls
``enable_compile_cache`` so the rule lives in one place.
"""

from __future__ import annotations

import os
from pathlib import Path

DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> None:
    """Points JAX's persistent compile cache at ``DEFAULT_CACHE_DIR`` unless
    ``JAX_COMPILATION_CACHE_DIR`` already names one.  Imports jax, so call
    it only on paths that are about to use jax anyway."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
