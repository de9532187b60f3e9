"""Persistent XLA compilation cache at a fixed location.

Compiling the full-width phase-1 program takes tens of seconds; the
persistent cache lets the next process with the same program skip it.  The
cache directory is part of the cache key, so it must not move between runs:
``JAX_COMPILATION_CACHE_DIR`` wins when set (JAX reads it itself and nothing
is set here), otherwise the cache lives at ``<repo>/.jax_cache``.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its fixed directory.

    Call before the first compilation.  Returns the directory in use.
    """
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
