"""Data-parallel flagstat over a device mesh.

The reference is single-core; its natural shard unit is the sequential
stream of independent 512k-record blocks whose partial counters
accumulate into one array (reference: benchmark/flagstats.cpp:311-332).
Here that decomposition goes wide: the FLAG stream is sharded across a
1-D ``data`` mesh, each device runs the local kernel (the bit-sliced
Pallas kernel on GPUs, plain XLA elsewhere), and the per-device
(C[k], F[k]) stream sums — a tiny int32[2,16] payload — merge with
``jax.lax.psum`` (NCCL between GPUs; every card of a host reaches every
other over NVLink, so a 1-D mesh fits). Multi-process runs shard the
same way across processes, so scaling is communication-trivial: the
all-reduce payload is 128 bytes regardless of stream length.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.pallas_kernels import stream_sums_pallas
from ..ops.xla_ops import assemble_counters, stream_sums_xla

AXIS = "data"


def data_mesh(devices=None) -> Mesh:
    """1-D data-parallel mesh over the given (default: all) devices."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices.reshape(-1), (AXIS,))


def _local_sums(xs: jax.Array, impl: str, interpret: bool,
                report: bool = False):
    if impl == "pallas":
        return stream_sums_pallas(xs, report=report, interpret=interpret)
    if impl != "xla":
        # counters would come back CORRECT via the xla fallthrough, so a
        # typo'd impl would silently benchmark/validate the wrong kernel
        raise ValueError(
            f"unknown sharded impl {impl!r} (choose pallas or xla; report "
            "mode is the report= flag, not an impl name)")
    return stream_sums_xla(xs)


def make_sharded_counter_fn(mesh: Mesh, impl: str = "xla",
                            interpret: bool = False, report: bool = False):
    """Build a jitted (padded_flags, n) -> (32,) int32 counter function.

    ``padded_flags`` must be zero-padded to a multiple of
    mesh.size * SHARD_GRANULE; ``n`` is the true word count (traced
    scalar, so one compilation serves every tail length).
    """

    def local(xs: jax.Array, n: jax.Array) -> jax.Array:
        total, fail = _local_sums(xs, impl, interpret, report)
        total = jax.lax.psum(total, AXIS)
        fail = jax.lax.psum(fail, AXIS)
        return assemble_counters(total, fail, n)

    # check_vma=False: pallas_call outputs don't carry vma metadata yet
    mapped = jax.shard_map(
        local, mesh=mesh, in_specs=(P(AXIS), P()), out_specs=P(),
        check_vma=False,
    )
    return jax.jit(mapped)


#: per-shard length quantum (words): keeps every shard an even number
#: of words, so the kernel's uint32 view needs no per-shard pad
SHARD_GRANULE = 8


def pad_for_mesh(x: np.ndarray, mesh_size: int, granule: int) -> np.ndarray:
    step = mesh_size * granule
    padded = ((x.size + step - 1) // step) * step
    if padded == x.size:
        return x
    return np.concatenate([x, np.zeros(padded - x.size, dtype=np.uint16)])


@functools.cache
def _default_mesh(dev_ids) -> Mesh:
    # dev_ids keys cache invalidation if the visible device set changes
    return data_mesh()


@functools.cache
def _counter_fn_for(mesh: Mesh, impl, interpret, report):
    """Cache keyed on the mesh itself (Mesh is hashable): the
    explicit-mesh path must not rebuild shard_map + jit per call — each
    rebuild is a fresh executable to compile."""
    return make_sharded_counter_fn(mesh, impl=impl, interpret=interpret,
                                   report=report)


def flagstat_sharded(
    x, mesh: Mesh | None = None, impl: str | None = None,
    interpret: bool = False, report: bool = False,
) -> np.ndarray:
    """One-call data-parallel flagstat of a host uint16 array.

    Pads, shards over the mesh, runs the local kernel per device, psums
    the stream sums, and assembles the 32-counter vector (bit-exact vs
    the single-device run — tested on a virtual 8-device mesh).

    ``impl`` defaults to the backend's device tier (ops/dispatch.DISPATCH:
    "pallas" on GPUs, "xla" elsewhere). ``report=True`` selects the
    21-stream report-mode kernel on the Pallas path (only
    flags.REPORT_COUNTERS are guaranteed); the XLA tier computes all 32
    counters either way. Streams past the int32 device cap split into
    accumulating rounds automatically (exact by the block-accumulative
    contract). ``interpret`` runs the Pallas kernel in interpret mode
    (tests)."""
    from ..ops import dispatch as _dispatch
    from ..ops.dispatch import _validate_u16

    arr = _validate_u16(x)   # same lossless-cast + length rules as
    #                          flagstats_u16 — silent uint16 wrapping
    #                          would return plausible-looking garbage
    if impl is None:
        impl = _dispatch.device_impl()
    if mesh is None:
        mesh = _default_mesh(tuple(d.id for d in jax.devices()))
    if arr.size > _dispatch.DEVICE_WORD_CAP:
        rounds = -(-arr.size // _dispatch.DEVICE_WORD_CAP)
        acc = np.zeros(32, dtype=np.uint64)
        for part in np.array_split(arr, rounds):
            acc += flagstat_sharded(part, mesh=mesh, impl=impl,
                                    interpret=interpret, report=report)
        return acc
    fn = _counter_fn_for(mesh, impl, interpret, report)
    padded = pad_for_mesh(arr, mesh.size, SHARD_GRANULE)
    sharding = NamedSharding(mesh, P(AXIS))
    y = jax.device_put(padded, sharding)
    counters = fn(y, jnp.int32(arr.size))
    return np.asarray(counters, dtype=np.int64).astype(np.uint64)
