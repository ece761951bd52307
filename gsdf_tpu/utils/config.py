"""Runtime configuration: JAX's persistent compilation cache.

The reference pays 8-60ms per part for GLSL codegen + driver shader compile
(README.md:113,149). XLA compilation of a large CSG tree costs seconds, so
importing gsdf_tpu turns on JAX's persistent compilation cache: each
distinct (tree hash, grid shape) compiles once per cache directory.

- Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and no
  directory is set here.
- Otherwise the cache lives at a fixed `<checkout>/.jax_cache` (listed in
  .gitignore): the directory is part of the cache key, so it must not move.

GSDF_TPU_NO_COMPILE_CACHE=1 turns the cache off.
"""
from __future__ import annotations

import os
import warnings

#: the cache directory used when JAX_COMPILATION_CACHE_DIR is not set
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)

_enabled = False


def enable_persistent_cache() -> None:
    global _enabled
    if _enabled or os.environ.get("GSDF_TPU_NO_COMPILE_CACHE"):
        return
    import jax

    try:
        if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
            os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
        _enabled = True
    except Exception as e:  # the cache only saves time: warn, don't fail
        warnings.warn(f"persistent compilation cache not enabled: {e}")
