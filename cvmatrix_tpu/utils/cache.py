"""Persistent XLA compilation cache wiring.

The reference library needs no compile-cache story (NumPy is interpret-time;
its JAX backend's worst published cold JIT is ~23 s on GPU —
``benchmark_results_jax.csv``). Every distinct config, fold size and chunk
shape here is its own XLA program, so first-run latency depends on JAX's
persistent compilation cache: with it enabled, every compile after the first
run of a given shape/config loads from disk.

The directory is ``$JAX_COMPILATION_CACHE_DIR`` when that is set, and
otherwise one fixed path inside the checkout (``<repo>/.jax_cache``). The
path is part of what makes a cache hit, so it never depends on a temporary
name, a process id or the time.
"""

import os

import jax

__all__ = ["enable_persistent_cache"]

_ENV = "JAX_COMPILATION_CACHE_DIR"


def _cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR``, else ``<repo>/.jax_cache``."""
    env = os.environ.get(_ENV)
    if env:
        return env
    repo = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    return os.path.join(repo, ".jax_cache")


def enable_persistent_cache() -> str:
    """Enable JAX's on-disk compilation cache (idempotent).

    Returns the directory used: ``$JAX_COMPILATION_CACHE_DIR`` when set,
    else ``<repo>/.jax_cache``. Safe to call
    before or after backend initialisation; affects only compiles that
    happen afterwards.
    """
    cache_dir = _cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    # Cache every program: the default 1s/small-entry filters would skip
    # exactly the many mid-sized fold programs a sweep compiles.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return cache_dir
