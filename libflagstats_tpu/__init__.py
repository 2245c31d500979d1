"""libflagstats_tpu — a samtools-flagstat engine in JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of
mklarqvist/libflagstats: positional population counts and the full
`samtools flagstat` summary over columns of 16-bit SAM FLAG words, at
memory-bandwidth speed-of-light on NVIDIA GPUs (a bit-sliced Pallas
kernel), scaling data-parallel over device meshes.

Public API:
  flagstats(values)        pyflagstats-compatible dict (python/libflagstats.pyx:8-37)
  flagstats_u16(arr, out)  32-counter vector, streaming-accumulative
                           (libflagstats.h:3025)
  pospopcnt_u16(arr)       16-bin positional popcount (libalgebra.h:3497)
  counters_to_report(c)    samtools flagstat report object
  popcnt / intersect_count / union_count / diff_count
                           set-algebra bitmap counts (libalgebra.h:500-3398)
  flagstat_file(path)      counters straight from any container
                           (.bam/.sam[.gz]/.cram/framed .lz4/.zst/raw
                           binary)
"""
from __future__ import annotations

import numpy as np

from . import flags
from .flags import (  # noqa: F401
    FPAIRED, FPROPER_PAIR, FUNMAP, FMUNMAP, FREVERSE, FMREVERSE,
    FREAD1, FREAD2, FSECONDARY, FQCFAIL, FDUP, FSUPPLEMENTARY,
    BIT12, BIT13, BIT14,
)
from .ops.dispatch import flagstats_u16, pospopcnt_u16, get_function  # noqa: F401
from .ops.setalgebra import (  # noqa: F401
    diff_count, intersect_count, popcnt, union_count,
)
from .report import FlagstatReport, counters_to_dict, counters_to_report  # noqa: F401


def flagstat_stream(path, **kwargs):
    """Streaming flagstat of a framed compressed file (see io.stream)."""
    from .io.stream import flagstat_stream as _fs

    return _fs(path, **kwargs)


def flagstat_sharded(values, **kwargs):
    """Data-parallel flagstat over the device mesh (see parallel.sharded)."""
    from .parallel.sharded import flagstat_sharded as _fs

    return _fs(values, **kwargs)


def flagstat_file(path, threads: int = 0, impl: str | None = None):
    """32-counter vector straight from any supported container — the
    `samtools flagstat <file>` workload with no samtools in the loop
    (format sniffed by io.sniff_format: .bam, .sam[.gz], .cram subset,
    framed .lz4/.zst, raw binary column). BAM and BGZF-SAM take the
    fused native walk+count (O(window) memory at any size); the rest
    read the column then count."""
    from .io import read_flags_auto, sniff_format

    kind = sniff_format(path)
    if kind == "bam":
        from .io.bamio import flagstat_bam

        return flagstat_bam(path, threads=threads, impl=impl)
    if kind == "sam":
        from .io.samio import flagstat_sam

        return flagstat_sam(path, threads=threads, impl=impl)
    if kind == "cram":
        from .io.cramio import flagstat_cram

        return flagstat_cram(path, threads=threads, impl=impl)
    if kind.startswith("framed-"):
        # the streaming pipeline (fused native mmap->decode->count off
        # device; overlapped decode-ahead on device) — never decodes
        # the whole column into memory
        from .io.stream import flagstat_stream

        return flagstat_stream(path, codec=kind.removeprefix("framed-"),
                               impl=impl, threads=threads)
    return flagstats_u16(read_flags_auto(path, threads=threads, kind=kind),
                         impl=impl)

__version__ = "0.1.0"


def flagstats(values, impl: str | None = None) -> dict:
    """pyflagstats-compatible entry point (reference: python/libflagstats.pyx:8-37)."""
    if not isinstance(values, np.ndarray):
        raise ValueError("Values must be an numpy.ndarray")
    if values.dtype != np.uint16:
        raise ValueError('Values must have the dtype "uint16"')
    if values.ndim != 1:
        # the reference's uint16_t[::1] memoryview rejects non-1-D too;
        # silently accepting would mix len(values) (first axis) into
        # n_values/mapped while the counters cover values.size words
        raise ValueError(f"Values must be 1-D, got shape {values.shape}")
    values = np.ascontiguousarray(values)
    counters = flagstats_u16(values, impl=impl)
    return counters_to_dict(counters, len(values))
