import os
import pathlib

from pangulu_jax.utils.perf import PerfCounters
from pangulu_jax.utils.log import get_logger

# Fixed in-checkout cache directory: the path is part of the cache key,
# so a directory that moved between runs would never hit.
DEFAULT_CACHE_DIR = str(
    pathlib.Path(__file__).resolve().parents[2] / ".jax_cache")


def enable_compilation_cache() -> str:
    """Persistent XLA compilation cache — amortizes jit compiles across
    processes (tests, bench, repeated solves).  When
    ``JAX_COMPILATION_CACHE_DIR`` is set JAX already reads it, and no
    other directory is configured; otherwise the cache is the fixed
    ``<checkout>/.jax_cache``.  Returns the directory in use."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path


__all__ = ["PerfCounters", "get_logger", "enable_compilation_cache"]
