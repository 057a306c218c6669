"""Persistent XLA compilation cache for the entry points.

One fixed directory per checkout, so a program compiled once (minutes for
the conv routes' autotuned GEMMs) is found again by the next process.
Called by entry points only — `cli.main`, the HTTP server's `__main__`,
`bench.py`, `chip_smoke.py` — never at package import, so parallel test
workers never share a cache.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def checkout_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    If JAX_COMPILATION_CACHE_DIR is set, JAX already reads it: it is left
    alone and no other directory is set. Otherwise the cache goes to
    `<checkout>/.jax_cache` (listed in .gitignore)."""
    path = os.environ.get(ENV_VAR)
    if path:
        return path
    import jax
    path = os.path.join(checkout_root(), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
