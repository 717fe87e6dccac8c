"""Persistent XLA compilation cache.

Caching compiled executables on disk lets a new process skip the compiles
an earlier one already paid for.  The cache lives where
``JAX_COMPILATION_CACHE_DIR`` says when that variable is set; otherwise in
:data:`DEFAULT_CACHE_DIR`, a fixed directory inside the checkout (listed in
``.gitignore``) — the path is part of the cache key, so it must not move
between runs.  Opt out with ``MMTPU_NO_JIT_CACHE=1``.

Device routes call :func:`enable_persistent_cache` before their first
compile: ``SearchEngine.run``, ``MultiSearcher.search``, the mesh path
(through the engine), ``bench.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import os
from pathlib import Path

__all__ = ["enable_persistent_cache", "DEFAULT_CACHE_DIR", "cache_dir"]

#: cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is unset
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"

_done = False


def cache_dir() -> Path:
    """The directory the persistent cache uses."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    return Path(env) if env else DEFAULT_CACHE_DIR


def enable_persistent_cache() -> None:
    """Point JAX's persistent compilation cache at :func:`cache_dir`
    (idempotent; a no-op under ``MMTPU_NO_JIT_CACHE``)."""
    global _done
    if _done:
        return
    _done = True
    if os.environ.get("MMTPU_NO_JIT_CACHE"):
        return
    import jax

    path = cache_dir()
    path.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(path))
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)
