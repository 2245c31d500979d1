"""Set-algebra population counts over bitmaps.

Parity with the libalgebra layer the reference vendors
(STORM_intersect_count / STORM_union_count / STORM_diff_count and plain
popcount, reference: python/libalgebra.h:500-3398). On the device these
are trivially memory-bound fused reduce kernels: `lax.population_count` on
int32 lanes + sum, which XLA fuses into a single pass; a Harley-Seal
tree buys nothing when the hardware has a native per-lane popcount.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _as_u32(x) -> np.ndarray:
    """View any integer bitmap array as a flat uint32 buffer."""
    arr = np.ascontiguousarray(np.asarray(x))
    if arr.dtype.kind not in "ui":
        raise ValueError(f"bitmap array must be integer-typed, got {arr.dtype}")
    if arr.nbytes % 4:
        raise ValueError("bitmap byte size must be a multiple of 4")
    return arr.view(np.uint32).ravel()


@functools.cache
def _jit_unary():
    return jax.jit(
        lambda a: jnp.sum(jax.lax.population_count(a).astype(jnp.int32))
    )


@functools.cache
def _jit_binary(op: str):
    ops = {
        "intersect": jnp.bitwise_and,
        "union": jnp.bitwise_or,
        "diff": lambda a, b: jnp.bitwise_and(a, jnp.bitwise_not(b)),
    }
    f = ops[op]
    return jax.jit(
        lambda a, b: jnp.sum(jax.lax.population_count(f(a, b)).astype(jnp.int32))
    )


# Per-call lane cap: 2^25 lanes x 32 set bits = 2^30 < int32 max, so one
# device reduce can never wrap (with x64 disabled, jnp.sum of int32
# stays int32 — an unchunked 2^31-set-bit bitmap returned a NEGATIVE
# count). Chunks accumulate in Python ints (arbitrary precision), and
# the tail is zero-padded so every call shares one compiled shape.
_CHUNK_LANES = 1 << 25


def _chunks(arrs: tuple[np.ndarray, ...]):
    n = arrs[0].size
    if n <= _CHUNK_LANES:
        yield tuple(jnp.asarray(a) for a in arrs)
        return
    for off in range(0, n, _CHUNK_LANES):
        part = tuple(a[off:off + _CHUNK_LANES] for a in arrs)
        if part[0].size < _CHUNK_LANES:  # zero lanes are count-neutral
            part = tuple(
                np.concatenate([p, np.zeros(_CHUNK_LANES - p.size, np.uint32)])
                for p in part
            )
        yield tuple(jnp.asarray(p) for p in part)


def _native_count(a: np.ndarray, b: np.ndarray | None, op: str) -> int:
    """Host path: hardware POPCNT over uint64 slabs is memory-bound from
    thread one (io/native/flagstats_host.cpp lfs_setop_count)."""
    from . import native_host

    return native_host.setop_count_native(a, b, op)


def _native_available() -> bool:
    from . import native_host

    return native_host.available()


def popcnt(bitmap, impl: str | None = None) -> int:
    """Total set bits (reference: STORM_popcnt, libalgebra.h).

    Exact for any size; host-native POPCNT when the lib is present
    (memory speed-of-light), else int32-safe chunked device reduces
    accumulated in Python ints."""
    a = _as_u32(bitmap)
    if a.size == 0:
        return 0
    if impl not in (None, "native", "xla"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "native" or (impl is None and _native_available()):
        return _native_count(a, None, "popcnt")
    fn = _jit_unary()
    return sum(int(fn(c)) for (c,) in _chunks((a,)))


def _binary_count(a, b, op: str, impl: str | None = None) -> int:
    av, bv = _as_u32(a), _as_u32(b)
    if av.size != bv.size:
        raise ValueError("bitmaps must have equal size")
    if impl not in (None, "native", "xla"):
        raise ValueError(f"unknown impl {impl!r}")
    if av.size == 0:
        return 0
    if impl == "native" or (impl is None and _native_available()):
        return _native_count(av, bv, op)
    fn = _jit_binary(op)
    return sum(int(fn(ca, cb)) for ca, cb in _chunks((av, bv)))


def intersect_count(a, b, impl: str | None = None) -> int:
    """popcount(a & b) (reference: STORM_intersect_count)."""
    return _binary_count(a, b, "intersect", impl)


def union_count(a, b, impl: str | None = None) -> int:
    """popcount(a | b) (reference: STORM_union_count)."""
    return _binary_count(a, b, "union", impl)


def diff_count(a, b, impl: str | None = None) -> int:
    """popcount(a & ~b) (reference: STORM_diff_count)."""
    return _binary_count(a, b, "diff", impl)
