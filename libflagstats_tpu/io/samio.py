"""SAM-text ingest and synthetic generation.

Equivalents of the reference's tiny drivers:
* utility: text FLAG integers -> little-endian uint16 binary
  (reference: benchmark/utility.cpp:10-20; usage
  `samtools view | cut -f 2 | utility > flags.bin`, README.md:56)
* generate: uniform-random FLAG words in [0, 4096)
  (reference: benchmark/generate.cpp:7-18)

Beyond the reference: direct SAM ingest. The reference needs
`samtools view | cut -f2` upstream before `utility` can run; here
``read_sam_flags`` parses the FLAG field (column 2) straight out of
.sam / .sam.gz (gzip or BGZF) files, with a threaded native parser
(io/native/sam_reader.cpp) and this module's pure-Python reader as the
differential reference — the same two-tier discipline as io/bamio.py.
"""
from __future__ import annotations

import gzip
import sys

import numpy as np


def text_to_binary(text_in, binary_out, chunk_chars: int = 1 << 24) -> int:
    """Parse whitespace-separated FLAG integers -> uint16 binary stream.

    Reads in bounded chunks: the reference path is GB-scale
    (``samtools view | cut -f2 | utility``, README.md:56), so
    materializing the whole stream as Python strings would cost tens of
    GB at NA12878 scale. A token split across a chunk boundary is
    carried into the next chunk. Returns the number of words written."""
    total = 0
    pending = ""

    def flush(text: str) -> int:
        toks = text.split()
        if not toks:
            return 0
        vals = np.array(toks, dtype=np.uint16)
        binary_out.write(vals.astype("<u2").tobytes())
        return int(vals.size)

    while True:
        data = text_in.read(chunk_chars)
        if isinstance(data, bytes):
            data = data.decode()
        if not data:
            break
        data = pending + data
        if data[-1].isspace():
            pending = ""
        else:
            # hold the possibly-incomplete trailing token
            cut = max(data.rfind(c) for c in " \t\r\n")
            if cut == -1:
                pending = data
                continue
            pending = data[cut + 1:]
            data = data[:cut + 1]
        total += flush(data)
    total += flush(pending)
    return total


def generate_text(n: int, out=None, seed: int | None = None,
                  full_range: bool = False) -> None:
    """n uniform-random FLAG values as text lines — [0, 4096) by default
    (byte-compatible with the reference generator's output shape),
    [0, 65536) with ``full_range``."""
    out = out or sys.stdout
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 0x10000 if full_range else 4096, size=n,
                        dtype=np.uint16)
    out.write("\n".join(map(str, vals.tolist())))
    if n:
        out.write("\n")


def generate_binary(n: int, path, seed: int | None = None,
                    full_range: bool = False) -> np.ndarray:
    """Write n synthetic FLAG words; the draw recipe is
    oracle.generate_flags (one definition — file-based and in-memory
    test paths must stay bit-identical for the same seed)."""
    from ..oracle import generate_flags

    vals = generate_flags(n, seed=seed, full_range=full_range)
    with open(path, "wb") as f:
        f.write(vals.astype("<u2").tobytes())
    return vals


def is_gzip(path) -> bool:
    """True for any gzip container (plain .gz and BGZF both start
    1f 8b)."""
    with open(path, "rb") as fh:
        return fh.read(2) == b"\x1f\x8b"


def _realistic_sam_chunk(part: np.ndarray, start: int, seed: int) -> bytes:
    """Vectorized fixed-width realistic SAM lines (round 4, VERDICT r03
    #3): Illumina-style QNAME, zero-padded FLAG, 151-char SEQ/QUAL and
    an RG aux column — the text twin of bamio._realistic_chunk, so
    text-path container benchmarks carry real record weight
    (~382 B/line vs ~30 minimal). Zero-padded integer fields are
    spec-legal ([0-9]+)."""
    from .bamio import _QUAL_LUT, _RNAME_PREFIX, READ_LEN

    n = part.size
    rng = np.random.default_rng(np.uint64(seed) ^ np.uint64(start))
    seq_lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    qual_lut = (_QUAL_LUT + 33).astype(np.uint8)       # phred+33 ASCII
    name_digits = (5, 7)
    template = (_RNAME_PREFIX + b"0" * 5 + b":" + b"0" * 7
                + b"\t" + b"0" * 5                      # FLAG, zero-padded
                + b"\t*\t0\t0\t*\t*\t0\t0\t"
                + b"N" * READ_LEN + b"\t" + b"!" * READ_LEN
                + b"\tRG:Z:NA12878L1\n")
    line_len = len(template)
    recs = np.broadcast_to(
        np.frombuffer(template, dtype=np.uint8), (n, line_len)).copy()
    idx = np.arange(start, start + n, dtype=np.int64)
    dig0 = len(_RNAME_PREFIX)
    for w, base, val in ((5, dig0, idx // 10_000_000),
                         (7, dig0 + 6, idx % 10_000_000),
                         (5, dig0 + 14, part.astype(np.int64))):
        for d in range(w):
            recs[:, base + d] = (val // 10 ** (w - 1 - d)) % 10 + ord("0")
    seq0 = dig0 + 14 + 5 + 15                          # after the 8 mid cols
    rb = np.frombuffer(rng.bytes(n * READ_LEN), dtype=np.uint8)
    recs[:, seq0:seq0 + READ_LEN] = seq_lut[rb & 3].reshape(n, READ_LEN)
    q0 = seq0 + READ_LEN + 1
    qb = np.frombuffer(rng.bytes(n * READ_LEN), dtype=np.uint8)
    recs[:, q0:q0 + READ_LEN] = qual_lut[qb].reshape(n, READ_LEN)
    return recs.tobytes()


def write_sam(path, flags, with_header: bool = True,
              payload: str = "minimal", seed: int = 0) -> int:
    """Spec-shaped SAM text whose records carry the given FLAG values
    (11 mandatory fields, unmapped-style records) — the test /
    synthetic-benchmark twin of bamio.write_bam. ``payload="realistic"``
    writes 151bp HiSeqX-weight lines (_realistic_sam_chunk). Returns the
    record count."""
    flags = np.asarray(flags, dtype=np.uint16).ravel()
    chunk = 1 << 18
    header = b""
    if with_header:
        header = (b"@HD\tVN:1.6\tSO:unsorted\n"
                  b"@PG\tID:lfs\tPN:libflagstats_tpu\n")
    with open(path, "wb") as fh:
        fh.write(header)
        for start in range(0, flags.size, chunk):
            part = flags[start:start + chunk]
            if payload == "realistic":
                fh.write(_realistic_sam_chunk(part, start, seed))
            else:
                fh.write("".join(
                    f"r{start + i}\t{v}\t*\t0\t0\t*\t*\t0\t0\t*\t*\n"
                    for i, v in enumerate(part.tolist())).encode())
    return int(flags.size)


def _parse_sam_line(line: str) -> int | None:
    """One SAM text line -> FLAG value, None for header/empty lines,
    ValueError for anything malformed (strictness matches the native
    parser: column 2 must be bare ASCII digits <= 65535)."""
    # strip one "\n" then at most one "\r" — exactly what the native
    # parser does, so a stray mid-junk "\r\r\n" tail misparses (errors)
    # identically in both readers
    if line.endswith("\n"):
        line = line[:-1]
    if line.endswith("\r"):
        line = line[:-1]
    if not line or line[0] == "@":
        return None
    fields = line.split("\t")
    # a tabless line must be a bare FLAG integer (the cut -f2 column
    # shape the reference's `utility` consumes, reference README.md:56)
    tok = fields[1] if len(fields) >= 2 else fields[0]
    if not (tok.isascii() and tok.isdigit()):
        raise ValueError(f"SAM FLAG field is not a number: {tok[:80]!r}")
    v = int(tok)
    if v > 0xFFFF:
        raise ValueError(f"SAM FLAG out of uint16 range: {v}")
    return v


def read_sam_flags_py(path) -> np.ndarray:
    """Pure-Python FLAG-column extraction from SAM text (plain or
    gzip/BGZF) — the correctness reference for the native parser."""
    opener = gzip.open if is_gzip(path) else open
    out: list[int] = []
    # latin-1: strictness lives in the FLAG field only — the native
    # parser doesn't inspect other fields' bytes, so neither should
    # this. newline="\n": universal-newline mode would treat a lone
    # "\r" as a line break, which the native parser does not.
    with opener(path, "rt", encoding="latin-1", newline="\n") as fh:
        for line in fh:
            v = _parse_sam_line(line)
            if v is not None:
                out.append(v)
    return np.asarray(out, dtype=np.uint16)


def _parse_sam_buffer(lib, buf, n_bytes: int, threads: int) -> np.ndarray:
    """Run the native parser over one in-memory text buffer."""
    import ctypes

    addr = (buf.ctypes.data if isinstance(buf, np.ndarray)
            else ctypes.cast(ctypes.c_char_p(buf), ctypes.c_void_p))
    cap = lib.lfs_sam_bound(addr, n_bytes)
    out = np.empty(int(cap), dtype=np.uint16)
    got = lib.lfs_sam_flags(addr, n_bytes,
                            out.ctypes.data_as(ctypes.c_void_p),
                            int(cap), threads)
    if got < 0:
        raise ValueError(f"SAM parse failed (rc={got}) — malformed FLAG "
                         "column (see sam_reader.cpp parse contract)")
    return out[:got].copy()


def _read_bgzf_sam_native(lib, path, threads: int) -> np.ndarray | None:
    """BGZF-compressed SAM via the native parallel-inflate walker
    (lfs_bgzf_sam_flags — the same double-buffered window scheme as the
    BAM walker). Returns None when the file is gzip-but-not-BGZF, so
    the caller falls back to the generic stream-inflate path."""
    import ctypes
    import os

    if not hasattr(lib, "lfs_bgzf_sam_flags"):
        return None
    size = os.path.getsize(path)
    if size == 0:
        return np.zeros(0, dtype=np.uint16)
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    addr = mm.ctypes.data
    raw = lib.lfs_bgzf_raw_size(addr, size)
    if raw == -6:
        return None
    if raw < 0:
        raise ValueError(f"BGZF scan failed (rc={raw}) — file corrupt "
                         "or truncated")
    cap = raw // 2 + 1           # a flag-yielding line is >= 2 bytes ("0\n")
    out = np.empty(int(cap), dtype=np.uint16)
    got = lib.lfs_bgzf_sam_flags(
        addr, size, out.ctypes.data_as(ctypes.c_void_p), int(cap), threads)
    if got < 0:
        raise ValueError(f"BGZF SAM parse failed (rc={got}) — malformed "
                         "FLAG column or corrupt container")
    return out[:got].copy()


def read_sam_flags(path, threads: int = 0) -> np.ndarray:
    """FLAG column of a SAM text file (.sam, .sam.gz, BGZF) -> uint16.

    Native threaded parser when the native lib is present; gzip input is
    stream-inflated in bounded chunks (Python's gzip handles the
    multi-member BGZF chain) with partial lines carried across chunk
    boundaries, so memory stays O(chunk) regardless of file size."""
    from . import native_lib

    lib = native_lib.load()
    if lib is None or not hasattr(lib, "lfs_sam_flags"):
        return read_sam_flags_py(path)
    if is_gzip(path):
        got = _read_bgzf_sam_native(lib, path, threads)
        if got is not None:      # BGZF: parallel-inflate walker handled it
            return got
        parts: list[np.ndarray] = []
        carry = b""
        with gzip.open(path, "rb") as fh:
            while True:
                chunk = fh.read(1 << 23)
                if not chunk:
                    break
                chunk = carry + chunk
                cut = chunk.rfind(b"\n")
                if cut == -1:
                    carry = chunk
                    continue
                carry = chunk[cut + 1:]
                parts.append(_parse_sam_buffer(lib, chunk[:cut + 1],
                                               cut + 1, threads))
        if carry:
            parts.append(_parse_sam_buffer(lib, carry, len(carry), threads))
        return (np.concatenate(parts) if parts
                else np.zeros(0, dtype=np.uint16))
    import os

    size = os.path.getsize(path)
    if size == 0:
        return np.zeros(0, dtype=np.uint16)
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    return _parse_sam_buffer(lib, mm, size, threads)


def flagstat_sam(path, threads: int = 0, impl: str | None = None):
    """samtools-flagstat counters straight from a SAM text file — the
    `samtools flagstat <sam>` workload with no samtools in the loop
    (the .sam twin of bamio.flagstat_bam). BGZF-compressed input takes
    the FUSED native walk+count (`lfs_bgzf_sam_flagstat`): neither the
    text nor the FLAG column materializes, O(window) memory at any
    size. Other inputs (or a forced non-native ``impl``) read the
    column then count."""
    from ..ops.dispatch import flagstats_u16
    from . import native_lib

    if impl in (None, "native"):
        if is_gzip(path):
            counters = _flagstat_bgzf_sam_parallel(path, threads)
            if counters is not None:
                return counters
            # -6 = plain gzip, not BGZF: the stream path below handles it
            counters = native_lib.fused_flagstat(
                "lfs_bgzf_sam_flagstat", path, threads, fallback_rcs=(-6,))
        else:
            # plain text: range-parallel fused parse+count
            counters = native_lib.fused_flagstat("lfs_sam_flagstat", path,
                                                 threads)
        if counters is not None:
            return counters
    return flagstats_u16(read_sam_flags(path, threads=threads), impl=impl)


def _flagstat_bgzf_sam_parallel(path, threads: int = 0,
                                member_start: int = 0,
                                member_stop: int | None = None):
    """In-process member-range-parallel BGZF-SAM counting (round 4).

    The single fused walker is bound by its sequential text-parse
    thread once libdeflate made inflate cheap: measured on the full
    NA12878 .sam.gz, 1 process x 4 threads ≈ 1 x 2 (parse-bound, 12.2
    vs 12.7 s) while 2 coordinated processes x 2 threads ran 1.53x
    faster (tools/multihost_scaling.py). This applies the same member-
    range split INSIDE one process — R concurrent range walkers (each
    with its own inflate pool and parse thread; line ownership at range
    boundaries is exact, sam_reader.cpp bgzf_sam_walk), counters summed
    — capturing the multi-process speedup with one call. With
    ``member_start``/``member_stop`` it sub-splits one member range
    (the multihost per-process shard), so distributed legs get the same
    internal parallelism. Returns None (caller falls back to the single
    fused walker) when the native lib is missing, the input is not
    BGZF, or the range is too small for the split to pay."""
    import concurrent.futures as cf
    import os as _os

    from . import native_lib
    from .codec import shard_block_ranges

    lib = native_lib.load()
    if lib is None or not hasattr(lib, "lfs_bgzf_sam_flagstat_range"):
        return None
    ncpu = threads or _os.cpu_count() or 4
    shards = max(1, min(8, ncpu // 2))
    try:
        n_members = bgzf_member_count(path)
    except ValueError:
        return None                    # gzip-but-not-BGZF etc.
    if member_stop is None:
        member_stop = n_members
    span = member_stop - member_start
    if shards < 2 or span < 16 * shards:
        return None                    # too small: split overhead loses
    # prefetch once (the range walkers map the file without WILLNEED)
    native_lib.map_sequential(path)
    per = max(2, ncpu // shards)
    ranges = [(member_start + a, member_start + b)
              for a, b in shard_block_ranges(span, shards)]
    with cf.ThreadPoolExecutor(shards) as pool:
        parts = list(pool.map(
            lambda r: flagstat_sam_range(path, r[0], r[1], threads=per),
            ranges))
    total = np.zeros_like(parts[0])
    for p in parts:
        total += p
    return total


def bgzf_member_count(path) -> int:
    """Number of BGZF members in a .sam.gz (the shard unit for
    member-range counting). Raises on non-BGZF / corrupt input."""
    import os

    from . import native_lib

    lib = native_lib.load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    size = os.path.getsize(path)
    if size == 0:
        return 0
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    n = lib.lfs_bgzf_members(mm.ctypes.data, size)
    if n < 0:
        raise ValueError(f"BGZF scan failed (rc={n}) — not BGZF or corrupt")
    return int(n)


def flagstat_sam_range(path, member_start: int, member_stop: int,
                       threads: int = 0) -> np.ndarray:
    """Fused flagstat counters over one BGZF member range of a .sam.gz —
    the multi-process shard unit (line ownership at range boundaries is
    exact; see sam_reader.cpp bgzf_sam_walk). Counters accumulate across
    shards by plain summation."""
    import ctypes
    import os

    from .. import flags as F
    from . import native_lib

    lib = native_lib.load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    size = os.path.getsize(path)
    counters = np.zeros(F.N_COUNTERS, dtype=np.uint64)
    if size == 0 or member_start >= member_stop:
        return counters
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    got = lib.lfs_bgzf_sam_flagstat_range(
        mm.ctypes.data, size, member_start, member_stop,
        counters.ctypes.data_as(ctypes.c_void_p), threads, 0)
    if got < 0:
        raise ValueError(f"BGZF SAM range count failed (rc={got})")
    return counters


def read_binary(path, mmap: bool = True) -> np.ndarray:
    """Raw little-endian uint16 FLAG column (the reference's `-R` input).

    Memory-mapped by default (read-only view): kernels read straight
    from the page cache with no GB-scale buffer allocation — this host
    shows episodic 65 µs/page first-touch storms on fresh allocations,
    and the copy is pure waste for a read-once count. The mapping is
    madvised SEQUENTIAL+WILLNEED (native_lib.map_sequential: cold
    demand paging costs ~60 µs/fault here while the disk reads
    1.8 GB/s). Pass ``mmap=False`` for an owned, writable array."""
    if mmap:
        try:
            from . import native_lib

            arr = native_lib.map_sequential(path)
            if arr.size and arr.size % 2 == 0:
                return arr.view("<u2")
        except (OSError, ValueError):  # e.g. empty file -> owned path
            pass
    return np.fromfile(path, dtype="<u2").astype(np.uint16, copy=False)
