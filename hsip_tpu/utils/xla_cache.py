"""Persistent XLA compilation cache for process entry points.

Every fresh process pays full XLA compiles (seconds per batch-shape
bucket). JAX's persistent compilation cache keys serialized executables by
HLO hash (and the compile options, XLA flags included), so repeat CLI /
benchmark invocations skip straight to execution. Enabled by the `hsip`
CLI, `bench.py` and `chip_smoke.py`; library users opt in by calling this
helper (it is NOT switched on at import time — libraries shouldn't mutate
global JAX config as a side effect).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

__all__ = ["default_cache_dir", "enable_persistent_compilation_cache"]


def default_cache_dir() -> Path:
    """The fixed in-checkout cache directory (``<repo>/.jax_cache``).

    Fixed, so that every process of a checkout finds what the others
    compiled: the directory is part of what a later process must match.
    """
    return Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_persistent_compilation_cache() -> Optional[str]:
    """Point JAX's persistent compilation cache at a stable directory.

    ``JAX_COMPILATION_CACHE_DIR`` is used as it is when set; otherwise
    :func:`default_cache_dir`. Returns the directory in use, or None when
    the cache could not be enabled (read-only checkout) — callers proceed
    without it; this is purely an optimization.
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        default_cache_dir()
    )
    try:
        Path(path).mkdir(parents=True, exist_ok=True)
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
        # Cache everything that took meaningful compile time (the default
        # 1 s threshold skips the many sub-second per-bucket compiles).
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)
    except Exception:
        return None
    return path
