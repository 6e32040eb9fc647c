"""Persistent XLA compilation cache.

Each distinct program compiles once per cache directory; later
processes load it instead.  Called by the CLI, bench and smoke entry
points.  Where JAX_COMPILATION_CACHE_DIR is set, JAX itself reads it and
this module sets no other directory.  Otherwise the cache lives at one
fixed path inside the checkout, so a later run there finds it again.
"""

from __future__ import annotations

import os
from pathlib import Path

DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compilation_cache(path: str | os.PathLike | None = None) -> str:
    """Turn the persistent cache on and return its directory:
    JAX_COMPILATION_CACHE_DIR when set, else `path`, else DEFAULT_DIR."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    cache_dir = env or str(Path(path) if path else DEFAULT_DIR)
    Path(cache_dir).mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache_dir
