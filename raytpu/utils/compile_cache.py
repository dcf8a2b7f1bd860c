"""JAX's persistent compilation cache, kept in one fixed directory.

Every entry point (the CLI, bench.py, chip_smoke.py, examples/) calls
`enable_compile_cache()` before its first compile, so repeated runs from
the same checkout reuse compiled programs.  The rule:

  * JAX_COMPILATION_CACHE_DIR set: JAX reads it itself, and nothing else
    is configured here;
  * otherwise: `<checkout>/.jax_cache/` (listed in .gitignore).  The path
    is fixed — part of each entry's key is where it lives, so a
    temporary or per-process directory would never hit.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Configure the persistent compilation cache; returns its directory."""
    path = os.environ.get(ENV_VAR)
    if path:
        return path
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
