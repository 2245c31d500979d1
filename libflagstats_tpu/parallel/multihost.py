"""Multi-process scale-out and scaling sweeps.

Shard the FLAG stream across processes (one per card, or one per host),
each device accumulating counters, merged via all-reduce at the end;
measure flags/s scaling at 1 device / 1 host / N processes. The
communication payload is one int32[2,16] pair per merge — 128 bytes.

Multi-process runs initialize JAX's distributed runtime per process and
feed process-local shards; everything else reuses parallel/sharded.py
(the global psum is the same within a host and across hosts).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .. import flags as F
from ..bench.harness import kernel_time
from .sharded import (
    AXIS,
    SHARD_GRANULE,
    data_mesh,
    make_sharded_counter_fn,
    pad_for_mesh,
)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids=None,
               auto: bool = False) -> None:
    """Initialize the multi-process runtime.

    Pass the arguments explicitly for manual clusters, or ``auto=True``
    on environments where JAX auto-detects them from a cluster manager
    (a call this function must actually MAKE, so auto-detection needs
    the explicit opt-in). ``local_device_ids`` pins this process to
    those cards of its host — ``process_id`` itself for one process per
    card: unpinned, every process opens every card of the host and
    reserves memory on each. With neither arguments nor ``auto``, this
    is a no-op (single-process run)."""
    if auto or (num_processes is not None and num_processes > 1):
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids,
        )


def flagstat_multihost(local_flags: np.ndarray, total_words: int | None = None,
                       impl: str | None = None,
                       pad_to_words: int | None = None) -> np.ndarray:
    """Count a globally-sharded FLAG stream; every process passes its own
    host-local shard (e.g. its file shard) and receives the full global
    32-counter vector.

    ``total_words`` is the global true word count (defaults to the psum of
    local sizes). When shards are uneven, every process must pass the
    same ``pad_to_words`` (>= the largest local shard) so the global
    array assembles; zero padding is count-neutral. ``impl`` defaults to
    the backend's device tier (ops/dispatch.DISPATCH)."""
    from ..ops import dispatch as _dispatch

    if impl is None:
        impl = _dispatch.device_impl()
    mesh = data_mesh()
    local = np.ascontiguousarray(np.asarray(local_flags, dtype=np.uint16)).ravel()

    if total_words is None:
        # the TRUE local size, before any padding: counter 9 is derived
        # as total_words - n_fail, so pad words in the sum would inflate
        # the pass-total silently (zero FLAG words are count-neutral in
        # the per-bit sums, but not in the derived total)
        total_words = _global_sum(local.size)
    if total_words > _dispatch.DEVICE_WORD_CAP:
        # int32 counter/psum design cap (the merge payload stays 128
        # bytes): split into accumulating rounds — exact by the
        # block-accumulative contract (reference: flagstats.cpp:311-332).
        # Every process derives the same round count from the agreed
        # global total, and per-round true totals / pad sizes are
        # re-agreed globally (shards may be uneven).
        rounds = -(-total_words // _dispatch.DEVICE_WORD_CAP)
        acc = np.zeros(F.N_COUNTERS, dtype=np.uint64)
        for part in np.array_split(local, rounds):
            acc += flagstat_multihost(
                part, total_words=_global_sum(part.size), impl=impl,
                pad_to_words=_global_max(part.size))
        return acc
    if pad_to_words is not None:
        if pad_to_words < local.size:
            raise ValueError(
                f"pad_to_words={pad_to_words} < local shard size "
                f"{local.size}; every process must pass a value >= the "
                "largest shard or global shapes diverge across processes")
        if pad_to_words > local.size:
            local = np.concatenate(
                [local, np.zeros(pad_to_words - local.size, dtype=np.uint16)]
            )
    n_local_dev = jax.local_device_count()
    padded = pad_for_mesh(local, n_local_dev, SHARD_GRANULE)

    from jax.sharding import NamedSharding, PartitionSpec as P

    global_shape = (padded.size * jax.process_count(),)
    arr = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P(AXIS)), padded, global_shape
    )
    fn = make_sharded_counter_fn(mesh, impl=impl)
    counters = fn(arr, jnp.int32(total_words))
    return np.asarray(counters, dtype=np.int64).astype(np.uint64)


def flagstat_multihost_file(path, codec: str | int = "lz4",
                            impl: str | None = None,
                            n_threads: int = 0) -> np.ndarray:
    """Multi-process flagstat of one framed compressed stream.

    Each process scans the frame index (cheap, header-only), decodes its
    contiguous block range with the native thread pool, counts its shard
    on its local devices, and the int32[2,16] sums merge globally
    (the reference's sequential block loop, flagstats.cpp:311-332,
    spread across hosts).

    ``impl="native"`` (the default when the native lib is present): each
    process runs the fused C++ decode+count over its byte range and only
    the 32 uint64 counters cross processes — no device round-trip at
    all; the decode on the host is the bound, as in io/stream.py."""
    from ..io import codec as C
    from ..ops import native_host

    if impl is None and native_host.available():
        impl = "native"
    frames = C.scan_frames(path)
    ranges = C.shard_block_ranges(len(frames), jax.process_count())
    start, stop = ranges[jax.process_index()]
    if impl == "native":
        local_counters, _ = native_host.flagstat_framed_range_native(
            path, C._codec_id(codec), start, stop, threads=n_threads,
            frames=frames)
        return _global_counter_sum(local_counters)
    words = [sum(r for _, r, _ in frames[a:b]) // 2 for a, b in ranges]
    local = C.read_framed_range(path, codec, start, stop, n_threads=n_threads)
    return flagstat_multihost(local, total_words=sum(words), impl=impl,
                              pad_to_words=max(words))


def flagstat_multihost_bgzf_sam(path, n_threads: int = 0) -> np.ndarray:
    """Multi-host flagstat of one BGZF-compressed SAM (`bgzip x.sam`).

    The .sam.gz twin of flagstat_multihost_file's native leg: each
    process scans the BGZF member chain (header-only, no inflate),
    fused-counts its contiguous member range (parallel inflate + line
    parse + counting kernel, line ownership exact at range boundaries —
    io/native/sam_reader.cpp bgzf_sam_walk), and only the 32 uint64
    counters cross processes. Inflate is the bound, so P hosts
    multiply inflate capacity."""
    from ..io import codec as C
    from ..io.samio import bgzf_member_count, flagstat_sam_range

    n_members = bgzf_member_count(path)
    ranges = C.shard_block_ranges(n_members, jax.process_count())
    start, stop = ranges[jax.process_index()]
    # sub-split the local member range across in-process range walkers
    # (round 4): one walker per process is parse-thread-bound once
    # libdeflate made inflate cheap — the same split that fixed the
    # single-host path applies per process
    from ..io.samio import _flagstat_bgzf_sam_parallel

    local = _flagstat_bgzf_sam_parallel(path, threads=n_threads,
                                        member_start=start,
                                        member_stop=stop)
    if local is None:
        local = flagstat_sam_range(path, start, stop, threads=n_threads)
    return _global_counter_sum(local)


def flagstat_multihost_bam(path, n_threads: int = 0) -> np.ndarray:
    """Multi-host flagstat of one BAM (round 4) — completing the
    container set next to flagstat_multihost_file (framed) and
    flagstat_multihost_bgzf_sam.

    BAM records are self-delimited with no resync marker, so each
    process enters its inflated-byte range via the arrival-exact resync
    walk (io/native/bam_reader.cpp, the same machinery as the
    single-host lfs_bam_flagstat_parallel): process p walks
    [total*p/P, total*(p+1)/P) from the first structurally-validated
    record boundary, reports where its chain actually landed, and the
    gathered (start, end) endpoints are verified to stitch EXACTLY —
    end_p == start_{p+1} and end_{P-1} == EOF (process 0's start is the
    authoritative header end). Any break (or a failed resync) falls
    back to process 0 counting the whole file while the rest contribute
    zeros, so the global counters are integer-exact unconditionally.
    Only the 32 uint64 counters and the endpoint pairs cross
    processes."""
    from ..io.bamio import bam_raw_size, flagstat_bam, flagstat_bam_byte_range

    total = bam_raw_size(path)
    P, pid = jax.process_count(), jax.process_index()
    lo = total * pid // P
    hi = total * (pid + 1) // P
    try:
        res = flagstat_bam_byte_range(path, lo, hi, threads=n_threads)
    except ValueError:
        # a local hard error must still reach the allgather below as
        # ok=0 — raising here would leave the other processes hung in
        # the collective (review r1)
        res = None
    if res is None:
        ok, counters, start, end = 0, np.zeros(32, np.uint64), 0, 0
    else:
        counters, _, start, end = res
        ok = 1
    # gather (ok, start, end) per process and verify the chain
    meta = _allgather_i64(np.array([ok, start, end], dtype=np.int64))
    chain_ok = bool((meta[:, 0] == 1).all())
    if chain_ok:
        for p in range(P - 1):
            if meta[p, 2] != meta[p + 1, 1]:
                chain_ok = False
        if meta[P - 1, 2] != total:
            chain_ok = False
    if not chain_ok:
        counters = (np.asarray(flagstat_bam(path, threads=n_threads),
                               dtype=np.uint64)
                    if pid == 0 else np.zeros(32, np.uint64))
    return _global_counter_sum(counters)


def flagstat_multihost_cram(path, n_threads: int = 0) -> np.ndarray:
    """Multi-host flagstat of one CRAM (round 5) — completing the
    container set next to framed/.sam.gz/.bam.

    CRAM is the easy one: containers are self-describing and
    independent, so each process walks the header chain (seek-only, a
    few dozen bytes per container — no resync heuristics needed, unlike
    BAM) and fused-counts its contiguous container range
    (io/cramio.flagstat_cram_range); only the 32 uint64 counters cross
    processes."""
    from ..io.cramio import data_container_count, flagstat_cram_range
    from ..io import codec as C

    n = data_container_count(path)
    ranges = C.shard_block_ranges(n, jax.process_count())
    start, stop = ranges[jax.process_index()]
    local = flagstat_cram_range(path, start, stop, threads=n_threads)
    return _global_counter_sum(local)


def _allgather_i64(values: np.ndarray) -> np.ndarray:
    """Allgather a small int64 vector -> (P, len) int64 (identity
    single-process); (lo, hi) uint32 pair discipline like _global_sum."""
    if jax.process_count() == 1:
        return values.reshape(1, -1)
    from jax.experimental import multihost_utils

    v = values.astype(np.uint64)
    pairs = np.empty(2 * v.size, dtype=np.uint32)
    pairs[0::2] = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    pairs[1::2] = (v >> np.uint64(32)).astype(np.uint32)
    out = np.asarray(multihost_utils.process_allgather(jnp.asarray(pairs)),
                     dtype=np.uint64).reshape(-1, v.size, 2)
    return (out[:, :, 0] + (out[:, :, 1] << np.uint64(32))).astype(np.int64)


def _global_counter_sum(counters: np.ndarray) -> np.ndarray:
    """Sum a uint64[32] counter vector across processes (identity
    single-process). Gathered as (lo, hi) uint32 pairs for the same
    x64-downcast reason as _global_sum."""
    if jax.process_count() == 1:
        return counters
    from jax.experimental import multihost_utils

    pairs = np.empty(2 * counters.size, dtype=np.uint32)
    pairs[0::2] = (counters & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    pairs[1::2] = (counters >> np.uint64(32)).astype(np.uint32)
    out = np.asarray(multihost_utils.process_allgather(jnp.asarray(pairs)),
                     dtype=np.uint64).reshape(-1, counters.size, 2)
    return (out[:, :, 0] + (out[:, :, 1] << np.uint64(32))).sum(
        axis=0, dtype=np.uint64)


def _global_max(value: int) -> int:
    """Max of a host scalar across processes (identity single-process);
    same (lo, hi) uint32 gather discipline as _global_sum."""
    if jax.process_count() == 1:
        return value
    from jax.experimental import multihost_utils

    pair = np.array([value & 0xFFFFFFFF, value >> 32], dtype=np.uint32)
    out = np.asarray(multihost_utils.process_allgather(jnp.asarray(pair)),
                     dtype=np.uint64).reshape(-1, 2)
    return int(np.max(out[:, 0] + (out[:, 1] << np.uint64(32))))


def _global_sum(value: int) -> int:
    """All-reduce a host scalar across processes (identity single-process).

    Gathers as (lo, hi) uint32 pairs: with x64 disabled an int64 array
    would silently downcast to int32 and overflow past 2^31 local words
    (advisor finding, round 1)."""
    if jax.process_count() == 1:
        return value
    from jax.experimental import multihost_utils

    pair = np.array([value & 0xFFFFFFFF, value >> 32], dtype=np.uint32)
    out = np.asarray(multihost_utils.process_allgather(jnp.asarray(pair)),
                     dtype=np.uint64)
    out = out.reshape(-1, 2)
    return int(np.sum(out[:, 0]) + (np.sum(out[:, 1]) << np.uint64(32)))


def scaling_sweep(n_words: int = 1 << 24, impl: str | None = None,
                  device_counts=None, iters: int = 3) -> list[dict]:
    """flags/s at increasing device counts (BASELINE.json config #5).

    On a single host this sweeps subsets of local devices; in a multi-host
    job the mesh covers all processes and the sweep measures the full
    slice vs one chip."""
    from ..oracle import generate_flags

    if impl is None:
        from ..ops.dispatch import device_impl

        impl = device_impl()
    devices = jax.devices()
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= len(devices)]

    x = generate_flags(n_words, seed=0, full_range=True)
    results = []
    for nd in device_counts:
        mesh_devs = devices[:nd]
        mesh = data_mesh(mesh_devs)
        fn = make_sharded_counter_fn(mesh, impl=impl)
        padded = pad_for_mesh(x, mesh.size, SHARD_GRANULE)
        from jax.sharding import NamedSharding, PartitionSpec as P

        sharding = NamedSharding(mesh, P(AXIS))
        procs = sorted({d.process_index for d in mesh_devs})
        if procs == [jax.process_index()]:
            # every mesh device is addressable: plain placement works
            y = jax.device_put(padded, sharding)
        else:
            # multi-host mesh: device_put of a host array onto a
            # non-fully-addressable sharding raises — each process must
            # contribute its local slice instead. Require every process
            # to own part of the mesh (a subset mesh that excludes a
            # process cannot be driven SPMD from that process at all).
            if jax.process_index() not in procs:
                raise NotImplementedError(
                    f"device_counts={nd} spans processes {procs}, which "
                    f"excludes process {jax.process_index()}; sweep "
                    "device counts that cover every participating process")
            chunk = padded.size // len(procs)
            me = procs.index(jax.process_index())
            y = jax.make_array_from_process_local_data(
                sharding, padded[me * chunk:(me + 1) * chunk],
                (padded.size,))
        n = jnp.int32(x.size)
        # per-invocation device time: kernel_time runs the sharded body
        # K times inside one jitted call and differences repetition
        # counts, so dispatch overhead cancels
        best = kernel_time(lambda a: fn(a, n), y, iters=iters)
        results.append({
            "devices": nd,
            "words_per_s": n_words / best,
            "min_s": best,
        })
    base = results[0]["words_per_s"]
    for r in results:
        r["scaling_efficiency"] = r["words_per_s"] / (base * r["devices"])
    return results
