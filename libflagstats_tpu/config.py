"""Framework configuration (SURVEY.md §5: the reference's three config
tiers — compile-time feature macros, runtime CPUID dispatch, CLI flags —
collapse here into one dataclass + backend capability probing + env vars).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path

#: the compile cache's fixed home when JAX_COMPILATION_CACHE_DIR is unset:
#: a path that never moves, so a later process finds what an earlier one
#: cached (the path is part of the cache key)
DEFAULT_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


@dataclass
class Config:
    """Live tuning knobs — every field is READ at its point of use
    (bucket floor in ops/dispatch.py, block size in io/codec.py, thread
    pool in io/stream.py), so editing CONFIG at runtime takes effect on
    the next call."""

    # shape-bucketing floor for device calls (words): bounds the compile
    # set, not a performance crossover
    xla_min: int = 1 << 14
    # io
    block_bytes: int = 1_024_000       # framed codec block (flagstats.cpp:136)
    decode_threads: int = 0            # 0 = hardware_concurrency


CONFIG = Config()
_cache_enabled = False


def compilation_cache_dir() -> Path | None:
    """Where this program puts JAX's persistent compile cache: nowhere
    of its own when JAX_COMPILATION_CACHE_DIR is set (JAX reads that
    variable itself), else DEFAULT_CACHE_DIR."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return DEFAULT_CACHE_DIR


def enable_compilation_cache() -> None:
    """Persist XLA/Triton compilations across processes, so a kernel
    compiles once per machine rather than once per process."""
    global _cache_enabled
    if _cache_enabled:
        return
    import jax

    path = compilation_cache_dir()
    if path is not None:
        jax.config.update("jax_compilation_cache_dir", str(path))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    _cache_enabled = True
