"""Persistent XLA compilation cache location.

JAX keys cached programs by their path, so the cache must stay at one fixed
place for a later process to find what an earlier one compiled. Where
`JAX_COMPILATION_CACHE_DIR` is set, JAX already reads it and nothing is set
here; otherwise the cache goes to `<repo>/.jax_cache` (listed in
.gitignore). Entry points (the CLI, bench.py, chip_smoke.py, tools/) call
`enable_compile_cache()` once before compiling; the tests do not.
"""
from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def cache_dir() -> str:
    """The directory the compile cache uses: the environment's, else the
    repository's fixed default."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at `cache_dir()` and
    return it. Sets no directory when the environment variable names one."""
    import jax
    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
