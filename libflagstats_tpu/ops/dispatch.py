"""Size-tiered dispatch: the one-call entry points.

Equivalent of FLAGSTATS_get_function / FLAGSTATS_u16 (reference:
libflagstats.h:2977-3070) and of the size-tiered STORM_pospopcnt_u16
(libalgebra.h:3497-3551): the CPUID/XCR0 probe becomes the observed JAX
backend, and the ISA tiers become one row of ``DISPATCH`` per backend:

  n below the row's crossover -> host tier (the AVX-512/AVX2 native
                                 kernel when its library built, else
                                 the NumPy oracle)
  else                        -> the row's device tier (the bit-sliced
                                 Pallas kernel on a GPU, the fused XLA
                                 formulation on the CPU backend)
"""
from __future__ import annotations

import functools

import jax
import numpy as np

from .. import flags as F
from ..oracle import flagstat_numpy
from . import native_host, pallas_kernels
from .xla_ops import flagstat_xla, pospopcnt_u16_matmul, pospopcnt_u16_xla

#: implementation registry (reference counterpart: the kernel tables in
#: benchmark/inmemory.cpp:61-104 / instrumented_benchmark.cpp)
FLAGSTAT_IMPLS = {
    "numpy": "host vectorized mask-select oracle (FLAGSTAT_scalar tier)",
    "native": "host AVX2 Harley-Seal CSA kernel (C++, the FLAGSTATS_u16 "
              "tier itself; requires the native lib)",
    "xla": "fused jnp transform + positional reduce (the plain device "
           "version; SSE4/AVX2 tier)",
    "pallas": "bit-sliced transpose + Harley-Seal CSA GPU kernel "
              "(AVX512 tier; needs a GPU)",
    "pallas_report": "21-stream bit-sliced GPU kernel, report counters "
                     "only (improved3/4 analogue; masked-positional "
                     "counters are 0)",
}
POSPOPCNT_IMPLS = {
    "numpy": "host per-bit count",
    "native": "host AVX2 Harley-Seal CSA kernel (C++)",
    "xla": "fused jnp shift-mask-reduce",
    "xla_matmul": "int8 ones-matmul reduction with int32 accumulation",
    "pallas": "bit-sliced transpose + Harley-Seal CSA GPU kernel",
}

#: a crossover no call reaches: the host tier always wins
NEVER = 1 << 62

#: Dispatch table keyed by the observed JAX backend. ``device`` names
#: the backend's device tier; the ``*_min`` entries are the single-call
#: word counts (host array in, counters out) from which that tier beats
#: the host tier — ``device_min`` against the NumPy oracle,
#: ``native_device_min`` against the native kernel. A deployment
#: re-derives them with ``python tools/crossover_sweep.py --write``,
#: which records them in calibration.json (applied at import below).
#:
#: cpu: the XLA CPU backend never beats the native kernel (it counts in
#:   the same cores at a fraction of its rate); against NumPy it wins
#:   from 32Ki words (flagstat) and 128Ki words (pospopcnt, whose host
#:   path skips the transform) — tools/crossover_sweep.py on the CPU
#:   backend of a 4-core development host.
#: gpu: tools/crossover_sweep.py on one H100 SXM (power limit 400 W,
#:   16 host cores; PERF.md has the table): host-to-device copy plus
#:   kernel beats NumPy from the smallest size swept (2^16 words;
#:   pospopcnt from 2^18) but never beats the native kernel, which
#:   counts 2^30 host words in 28 ms against the device path's 1.2 s of
#:   mostly copying — so host-held arrays stay on the host whenever the
#:   native library built.
DISPATCH = {
    "cpu": {"device": "xla", "pospopcnt_device": "xla",
            "device_min": 1 << 15, "pospopcnt_device_min": 1 << 17,
            "native_device_min": NEVER,
            "pospopcnt_native_device_min": NEVER},
    "gpu": {"device": "pallas", "pospopcnt_device": "pallas",
            "device_min": 1 << 16, "pospopcnt_device_min": 1 << 18,
            "native_device_min": NEVER,
            "pospopcnt_native_device_min": NEVER},
}


def _apply_calibration() -> list[str]:
    """Override DISPATCH entries from calibration.json (written by
    tools/crossover_sweep.py --write; schema in calibration.py).
    Returns the names applied. Runs at import; call again after editing
    the file at runtime."""
    from ..calibration import load_thresholds

    applied = []
    for name, value in load_thresholds().items():
        row, key = name.split(".", 1)
        DISPATCH[row][key] = value
        applied.append(name)
    return applied


_CALIBRATED = _apply_calibration()


def xla_min() -> int:
    """Shape-bucketing floor for device calls (bounds the compile set;
    not a performance crossover). CONFIG.xla_min."""
    from ..config import CONFIG

    return CONFIG.xla_min


@functools.cache
def backend() -> str:
    from ..config import enable_compilation_cache

    enable_compilation_cache()
    return jax.default_backend()


def _row() -> dict:
    return DISPATCH.get(backend(), DISPATCH["cpu"])


def device_impl() -> str:
    """The observed backend's device tier ("pallas" on a GPU, "xla"
    elsewhere): the default of the paths that always count on a
    device (sharded, multihost, and the stream without the native
    library)."""
    return _row()["device"]


def _choose(n_len: int, prefix: str) -> str:
    native = native_host.available()
    key = prefix + ("native_device_min" if native else "device_min")
    host = "native" if native else "numpy"
    # below every row's crossover the backend is irrelevant, and probing
    # it initializes JAX: a host-sized call must not pay that
    if n_len < min(row[key] for row in DISPATCH.values()):
        return host
    row = _row()
    return host if n_len < row[key] else row[prefix + "device"]


def auto_impl(n_len: int) -> str:
    """The measured-fastest tier for one flagstat call of ``n_len``
    words (the size-tier selection of FLAGSTATS_u16,
    libflagstats.h:3047-3069)."""
    return _choose(n_len, "")


def pospopcnt_auto_impl(n_len: int) -> str:
    """The measured-fastest tier for one pospopcnt_u16 call (the size
    tiers of STORM_pospopcnt_u16, libalgebra.h:3519-3543)."""
    return _choose(n_len, "pospopcnt_")


@functools.cache
def _jit_flagstat(impl: str):
    # n is a TRACED scalar: it only feeds the derived pass-total
    # arithmetic (assemble_counters), so two streams sharing a padded
    # bucket but differing in true length share ONE executable
    if impl == "xla":
        return jax.jit(lambda x, n: flagstat_xla(x, n))
    return jax.jit(lambda x, n: pallas_kernels.flagstat_pallas(
        x, n, report=impl == "pallas_report"))


#: above this size the power-of-two bucket ladder switches to a 1.25x
#: geometric ladder: pow2 bucketing on an 824Mi-word call would pad to
#: 1Gi (+~400 MB of zeros through H2D), while below 64Mi the absolute
#: waste is small and pow2 keeps the compile set minimal (reference
#: tiering analogue: libalgebra.h:3519-3543)
BUCKET_LADDER_MIN = 64 << 20
BUCKET_LADDER_RATIO = 1.25


def bucket_target(n: int, minimum: int, granule: int = 8) -> int:
    """Padded length for an n-word device call: next power of two
    (>= minimum) up to BUCKET_LADDER_MIN, then the next rung of a
    deterministic 1.25x geometric ladder — max padding overhead ~25% at
    any size — rounded up to a multiple of ``granule``."""
    target = max(minimum, 1 << (max(n - 1, 0)).bit_length())
    if n > BUCKET_LADDER_MIN:
        target = BUCKET_LADDER_MIN
        while target < n:
            target = int(target * BUCKET_LADDER_RATIO)
    return -(-target // granule) * granule


def _bucket_pad(arr: np.ndarray, minimum: int, granule: int = 8) -> np.ndarray:
    """Zero-pad to the bucket_target length.

    Zero words are count-neutral (the true length flows separately into
    the derived pass-total), and bucketing bounds the set of shapes the
    backend ever compiles."""
    target = bucket_target(arr.size, minimum, granule)
    if target == arr.size:
        return arr
    return np.concatenate([arr, np.zeros(target - arr.size, dtype=arr.dtype)])


def get_function(n_len: int, impl: str | None = None):
    """Return a callable (np.uint16 array) -> (32,) np.ndarray of counts
    for streams of length ``n_len`` (reference: FLAGSTATS_get_function,
    libflagstats.h:2977)."""
    if impl is None:
        impl = auto_impl(n_len)

    if impl == "numpy":
        return lambda arr: flagstat_numpy(arr)
    if impl == "native":
        return lambda arr: native_host.flagstat_native(arr)
    if impl not in FLAGSTAT_IMPLS:
        raise ValueError(f"unknown impl {impl!r}")
    if impl.startswith("pallas"):
        pallas_kernels.require_gpu()
    fn = _jit_flagstat(impl)
    return lambda arr: np.asarray(
        fn(jax.numpy.asarray(_bucket_pad(arr, xla_min())),
           jax.numpy.int32(arr.size)))


#: the derived pass-total and on-device accumulators are int32 by design
#: (the psum payload stays 128 bytes), capping one device-path
#: accumulation at 2^31-1 words. The entry points CHUNK past it — the
#: block-accumulative contract (reference: the per-block accumulate loop,
#: benchmark/flagstats.cpp:311-332) makes splitting into accumulating
#: sub-calls exact: counter 9 is derived per chunk as
#: chunk_len - chunk_fail, and those sum to total_len - total_fail.
#: Module-level (not a Config field) so tests can monkeypatch it tiny and
#: exercise the chunking without 2^31-word inputs. The host tiers
#: (numpy, native) count in uint64 and never chunk.
DEVICE_WORD_CAP = 0x7FFFFFFF


def _device_chunks(arr: np.ndarray, impl: str, granule: int = 8):
    """Yield granule-aligned views of ``arr``, each within the device
    cap (one view = the whole array whenever it fits or the impl is a
    host tier)."""
    if impl in ("numpy", "native") or arr.size <= DEVICE_WORD_CAP:
        yield arr
        return
    step = max(DEVICE_WORD_CAP // granule, 1) * granule
    for start in range(0, arr.size, step):
        yield arr[start:start + step]


def _validate_u16(array) -> np.ndarray:
    arr = np.asarray(array)
    if arr.dtype != np.uint16:
        # allow lossless integer input; reject anything that would be a
        # silent value-mangling cast
        if arr.dtype.kind not in "ui" or (arr.size and
                                          (arr.min() < 0 or arr.max() > 0xFFFF)):
            raise ValueError(
                f"FLAG array must be uint16 (or losslessly convertible), "
                f"got {arr.dtype}"
            )
        arr = arr.astype(np.uint16)
    return np.ascontiguousarray(arr).ravel()


def flagstats_u16(array, out=None, impl: str | None = None) -> np.ndarray:
    """Count flagstat statistics of a uint16 FLAG array.

    Accumulates into ``out`` when given (the reference's streaming
    contract: one counter vector across many blocks,
    reference: FLAGSTATS_u16, libflagstats.h:3025 and
    benchmark/flagstats.cpp:304-329). Streams past the int32 device cap
    (DEVICE_WORD_CAP) are split into accumulating sub-calls
    automatically — bit-exact by the same contract."""
    arr = _validate_u16(array)
    if impl is None:
        impl = auto_impl(arr.size)
    acc = np.zeros(F.N_COUNTERS, dtype=np.uint64) if out is None else out
    for chunk in _device_chunks(arr, impl):
        acc += np.asarray(get_function(chunk.size, impl)(chunk),
                          dtype=np.uint64)
    return acc


def pospopcnt_u16(array, impl: str | None = None) -> np.ndarray:
    """Positional popcount of a uint16 array -> (16,) counts
    (reference: STORM_pospopcnt_u16, libalgebra.h:3497).

    Uses its own size tiers (the ``pospopcnt_*`` DISPATCH entries), not
    flagstat's: the host pospopcnt skips the mask-select transform and
    stays the faster single-call tier to larger sizes."""
    arr = _validate_u16(array)
    if impl is None:
        impl = pospopcnt_auto_impl(arr.size)
    if impl not in POSPOPCNT_IMPLS:
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "pallas":
        pallas_kernels.require_gpu()
    # past the int32 device cap, accumulate sub-calls (raw positional
    # counts sum exactly; same contract as flagstats_u16)
    acc = np.zeros(F.N_BITS, dtype=np.uint64)
    for chunk in _device_chunks(arr, impl):
        acc += np.asarray(_pospopcnt_once(chunk, impl), dtype=np.uint64)
    return acc


def _pospopcnt_once(arr: np.ndarray, impl: str) -> np.ndarray:
    if impl == "numpy":
        x = arr.astype(np.uint32)
        return np.array(
            [int(np.count_nonzero((x >> k) & 1)) for k in range(F.N_BITS)],
            dtype=np.uint64,
        )
    if impl == "native":
        return native_host.pospopcnt_native(arr)
    return np.asarray(_jit_pospopcnt(impl)(
        jax.numpy.asarray(_bucket_pad(arr, xla_min()))))


@functools.cache
def _jit_pospopcnt(impl: str):
    return jax.jit({"xla": pospopcnt_u16_xla,
                    "xla_matmul": pospopcnt_u16_matmul,
                    "pallas": pallas_kernels.pospopcnt_u16_pallas}[impl])
