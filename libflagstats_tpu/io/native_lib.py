"""ctypes loader for the native IO library (C++, built on demand).

The native lib exposes a C ABI and is bound with ctypes (no pybind11).
Built lazily with g++ into build/ and cached; it needs only a C++
compiler and zlib's headers (liblz4, libzstd and libdeflate are used when
present). If the build fails, callers fall back to the pure-Python
codec (io/codec.py)."""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
from pathlib import Path

_SRCS = [
    Path(__file__).parent / "native" / "flagstats_io.cpp",
    Path(__file__).parent / "native" / "flagstats_host.cpp",
    Path(__file__).parent / "native" / "perf_events.cpp",
    Path(__file__).parent / "native" / "bam_reader.cpp",
    Path(__file__).parent / "native" / "sam_reader.cpp",
    Path(__file__).parent / "native" / "rans4x8.cpp",
    Path(__file__).parent / "native" / "cram_reader.cpp",
]
_BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build"
# -march=native binaries are host-specific: on a shared checkout
# (multi-host shard ranks) a lib built by an AVX-512 host must not be
# dlopened by an older-ISA host (SIGILL), so the artifact name carries
# a per-host tag
_HOST_TAG = hashlib.md5(
    f"{platform.node()}|{platform.machine()}".encode()
).hexdigest()[:8]
_LIB_PATH = _BUILD_DIR / f"libflagstats_io_{_HOST_TAG}.so"

_lib = None
_load_error: Exception | None = None


def _libdeflate_flags() -> list[str]:
    """Single-sourced libdeflate decision (ADVICE r04 #1): try-compile a
    real libdeflate call with the ACTUAL compiler. bgzf.h enables its
    libdeflate path via __has_include, which searches every compiler
    include path — so a header visible only via /usr/local/include or
    CPATH would pass a hardcoded /usr/include existence check's
    *negation*, compile the libdeflate call without -ldeflate, fail the
    link, and load() would silently degrade every native fast path to
    the pure-Python fallback. A compile+link probe is the only check
    that cannot disagree with the real build; on failure the zlib-only
    fallback is forced explicitly so header and link line stay in
    agreement."""
    probe = ("#include <libdeflate.h>\n"
             "int main(){return libdeflate_alloc_decompressor()==nullptr;}\n")
    try:
        r = subprocess.run(
            ["g++", "-x", "c++", "-", "-ldeflate", "-o", os.devnull],
            input=probe, text=True, capture_output=True, timeout=60)
        if r.returncode == 0:
            return ["-ldeflate"]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return ["-DLFS_NO_LIBDEFLATE"]


def _build() -> Path:
    _BUILD_DIR.mkdir(exist_ok=True)
    src_mtime = max(s.stat().st_mtime for s in _SRCS)
    if _LIB_PATH.exists() and _LIB_PATH.stat().st_mtime >= src_mtime:
        return _LIB_PATH
    # compile to a private temp name and publish atomically: a second
    # process's mtime check must never see (and dlopen) a half-written
    # .so. Concurrent builders each write their own temp file; last
    # replace wins with an identical artifact.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        cmd = [
            "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
            *(str(s) for s in _SRCS), "-o", tmp, "-lz", "-ldl",
            "-pthread",
            # libdeflate (2.5x zlib on whole-buffer BGZF members, measured
            # in io/native/bgzf.h) — linked iff the compiler itself can
            # compile AND link it (see _libdeflate_flags)
            *_libdeflate_flags(),
        ]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _LIB_PATH)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return _LIB_PATH


def map_sequential(path, willneed: bool = True):
    """Read-only mapping of a file with MADV_SEQUENTIAL (+
    MADV_WILLNEED by default). The fused container walks stream the
    file front-to-back, and on this host a cold mapping without the
    prefetch costs ~60 µs per synchronous major fault (measured: the
    1.44 GB BAM walk went 9 s warm -> 30 s cold, while WILLNEED
    prefetches the same bytes in 0.7 s — the disk itself reads
    1.8 GB/s). WILLNEED is advisory readahead into the page cache, so
    files larger than RAM degrade gracefully. ``willneed=False`` for
    walks that deliberately touch only a SUBSET of the pages (the
    columnar CRAM walker skips seq/qual-class blocks — prefetching the
    whole file would pay cold IO for bytes the walk never reads).
    Returns a uint8 ndarray view (the mapping stays alive via the
    array's .base chain)."""
    import mmap as _mmap

    import numpy as np

    fh = open(path, "rb")
    try:
        mm = _mmap.mmap(fh.fileno(), 0, prot=_mmap.PROT_READ)
    finally:
        fh.close()                       # the mapping outlives the fd
    if hasattr(mm, "madvise"):
        mm.madvise(_mmap.MADV_SEQUENTIAL)
        if willneed:
            mm.madvise(_mmap.MADV_WILLNEED)
    return np.frombuffer(mm, dtype=np.uint8)


def fused_flagstat(symbol: str, path, threads: int,
                   fallback_rcs: tuple[int, ...] = ()):
    """Shared driver for the fused container-counting entries
    (lfs_bam_flagstat / lfs_bgzf_sam_flagstat): mmap the file, call the
    walker with a zeroed uint64[32] counter vector, map errors.

    Returns the counters, or None when the lib/symbol is unavailable,
    the file is empty, or the walker returned one of ``fallback_rcs``
    (e.g. -6 = gzip-but-not-BGZF) — the caller then takes its
    read-then-count path. Other negative rcs raise ValueError."""
    import ctypes

    import numpy as np

    lib = load()
    if lib is None or not hasattr(lib, symbol):
        return None
    size = os.path.getsize(path)
    if size == 0:
        return None
    mm = map_sequential(path)
    counters = np.zeros(32, dtype=np.uint64)
    got = getattr(lib, symbol)(
        mm.ctypes.data, size, counters.ctypes.data_as(ctypes.c_void_p),
        threads, 0)
    if got >= 0:
        return counters
    if got in fallback_rcs:
        return None
    raise ValueError(f"{symbol} failed (rc={got}) — file corrupt, "
                     "truncated, or malformed")


def load():
    """Return the ctypes lib or None if unavailable."""
    global _lib, _load_error
    if _lib is not None:
        return _lib
    if _load_error is not None:
        return None
    try:
        lib = _bind(ctypes.CDLL(str(_build())))
    except Exception:
        # A stale prebuilt .so can pass the mtime check yet lack newer
        # symbols (e.g. an rsync -a checkout carrying old build/ onto a
        # host whose tag matches): binding raises AttributeError. Force
        # one rebuild before giving up; any remaining failure means the
        # toolchain or zlib headers are missing -> pure-Python fallback.
        try:
            _LIB_PATH.unlink(missing_ok=True)
            lib = _bind(ctypes.CDLL(str(_build())))
        except Exception as e:
            _load_error = e
            return None
    _lib = lib
    return _lib


def _bind(lib):
    i64, u8p, i32 = ctypes.c_int64, ctypes.c_char_p, ctypes.c_int
    lib.lfs_lz4_compress.restype = i64
    lib.lfs_lz4_compress.argtypes = [u8p, i64, ctypes.c_void_p, i64, i32]
    lib.lfs_lz4_compress_own.restype = i64
    lib.lfs_lz4_compress_own.argtypes = [u8p, i64, ctypes.c_void_p, i64, i32]
    lib.lfs_lz4_backend.restype = i32
    lib.lfs_lz4_backend.argtypes = []
    lib.lfs_lz4_set_own_only.restype = None
    lib.lfs_lz4_set_own_only.argtypes = [i32]
    lib.lfs_lz4_decompress.restype = i64
    lib.lfs_lz4_decompress.argtypes = [u8p, i64, ctypes.c_void_p, i64]
    lib.lfs_lz4_decompress_own.restype = i64
    lib.lfs_lz4_decompress_own.argtypes = [u8p, i64, ctypes.c_void_p, i64]
    lib.lfs_lz4_set_sys_decode.restype = None
    lib.lfs_lz4_set_sys_decode.argtypes = [i32]
    lib.lfs_lz4_bound.restype = i64
    lib.lfs_lz4_bound.argtypes = [i64]
    lib.lfs_zstd_compress.restype = i64
    lib.lfs_zstd_compress.argtypes = [u8p, i64, ctypes.c_void_p, i64, i32]
    lib.lfs_zstd_decompress.restype = i64
    lib.lfs_zstd_decompress.argtypes = [u8p, i64, ctypes.c_void_p, i64]
    lib.lfs_zstd_bound.restype = i64
    lib.lfs_zstd_bound.argtypes = [i64]
    lib.lfs_decode_stream.restype = i64
    lib.lfs_decode_stream.argtypes = [u8p, i64, ctypes.c_void_p, i64, i32, i32]
    lib.lfs_itf8_decode.restype = i64
    lib.lfs_itf8_decode.argtypes = [ctypes.c_void_p, i64,
                                    ctypes.c_void_p, i64]
    lib.lfs_rans4x8_bound.restype = i64
    lib.lfs_rans4x8_bound.argtypes = [i64]
    lib.lfs_rans4x8_compress.restype = i64
    lib.lfs_rans4x8_compress.argtypes = [ctypes.c_void_p, i64,
                                         ctypes.c_void_p, i64]
    lib.lfs_rans4x8_size.restype = i64
    lib.lfs_rans4x8_size.argtypes = [ctypes.c_void_p, i64]
    lib.lfs_rans4x8_decompress.restype = i64
    lib.lfs_rans4x8_decompress.argtypes = [ctypes.c_void_p, i64,
                                           ctypes.c_void_p, i64]
    lib.lfs_cram_flagstat.restype = i64
    lib.lfs_cram_flagstat.argtypes = [ctypes.c_void_p, i64,
                                      ctypes.c_void_p, i32,
                                      ctypes.POINTER(ctypes.c_int64)]
    lib.lfs_cram_flagstat_range.restype = i64
    lib.lfs_cram_flagstat_range.argtypes = [
        ctypes.c_void_p, i64, i64, i64, ctypes.c_void_p, i32,
        ctypes.POINTER(ctypes.c_int64)]
    lib.lfs_flagstat_u16.restype = i64
    lib.lfs_flagstat_u16.argtypes = [ctypes.c_void_p, i64, ctypes.c_void_p, i32]
    lib.lfs_flagstat_framed.restype = i64
    lib.lfs_flagstat_framed.argtypes = [ctypes.c_void_p, i64, i32, i32,
                                        ctypes.c_void_p, ctypes.c_void_p]
    lib.lfs_pospopcnt_u16.restype = i64
    lib.lfs_pospopcnt_u16.argtypes = [ctypes.c_void_p, i64, ctypes.c_void_p, i32]
    lib.lfs_setop_count.restype = i64
    lib.lfs_setop_count.argtypes = [ctypes.c_void_p, ctypes.c_void_p, i64,
                                    i32, i32, ctypes.c_void_p]
    lib.lfs_perf_open.restype = i64
    lib.lfs_perf_open.argtypes = [ctypes.c_void_p, ctypes.c_void_p, i32,
                                  ctypes.c_void_p]
    lib.lfs_perf_start.restype = i32
    lib.lfs_perf_start.argtypes = [i64]
    lib.lfs_perf_stop.restype = i32
    lib.lfs_perf_stop.argtypes = [i64, ctypes.c_void_p]
    lib.lfs_perf_close.restype = None
    lib.lfs_perf_close.argtypes = [i64]
    lib.lfs_bam_bound.restype = i64
    lib.lfs_bam_bound.argtypes = [ctypes.c_void_p, i64]
    lib.lfs_bam_flags.restype = i64
    lib.lfs_bam_flags.argtypes = [ctypes.c_void_p, i64, ctypes.c_void_p,
                                  i64, i32]
    lib.lfs_sam_bound.restype = i64
    lib.lfs_sam_bound.argtypes = [ctypes.c_void_p, i64]
    lib.lfs_sam_flags.restype = i64
    lib.lfs_sam_flags.argtypes = [ctypes.c_void_p, i64, ctypes.c_void_p,
                                  i64, i32]
    lib.lfs_bgzf_raw_size.restype = i64
    lib.lfs_bgzf_raw_size.argtypes = [ctypes.c_void_p, i64]
    lib.lfs_bgzf_sam_flags.restype = i64
    lib.lfs_bgzf_sam_flags.argtypes = [ctypes.c_void_p, i64,
                                       ctypes.c_void_p, i64, i32]
    lib.lfs_bam_flagstat.restype = i64
    lib.lfs_bam_flagstat.argtypes = [ctypes.c_void_p, i64,
                                     ctypes.c_void_p, i32, i64]
    lib.lfs_bam_flagstat_parallel.restype = i64
    lib.lfs_bam_flagstat_parallel.argtypes = [ctypes.c_void_p, i64,
                                              ctypes.c_void_p, i32, i64]
    lib.lfs_bam_flagstat_byte_range.restype = i64
    lib.lfs_bam_flagstat_byte_range.argtypes = [
        ctypes.c_void_p, i64, i64, i64, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        i32, i64]
    lib.lfs_bgzf_raw_size.restype = i64
    lib.lfs_bgzf_raw_size.argtypes = [ctypes.c_void_p, i64]
    lib.lfs_bgzf_sam_flagstat.restype = i64
    lib.lfs_bgzf_sam_flagstat.argtypes = [ctypes.c_void_p, i64,
                                          ctypes.c_void_p, i32, i64]
    lib.lfs_sam_flagstat.restype = i64
    lib.lfs_sam_flagstat.argtypes = [ctypes.c_void_p, i64,
                                     ctypes.c_void_p, i32, i64]
    lib.lfs_bgzf_members.restype = i64
    lib.lfs_bgzf_members.argtypes = [ctypes.c_void_p, i64]
    lib.lfs_bgzf_sam_flagstat_range.restype = i64
    lib.lfs_bgzf_sam_flagstat_range.argtypes = [
        ctypes.c_void_p, i64, i64, i64, ctypes.c_void_p, i32, i64]
    return lib
