#!/usr/bin/env python3
"""Measure the dispatch size-tier crossovers on the current backend.

The reference encodes *measured* crossovers in its size-tiered
dispatchers (STORM_pospopcnt_u16, libalgebra.h:3519-3543;
FLAGSTATS_u16, libflagstats.h:2999-3021). This sweep measures the same
decision for ops/dispatch.DISPATCH: one call on a host array, counters
back on the host, for

  * the host tiers: the NumPy oracle and the native kernel;
  * the backend's device tier, through the public entry point
    (bucket padding, host-to-device copy, kernel, counters back).

Each time is the minimum of a few warm calls. Prints a TSV per entry
point (flagstat, pospopcnt) and the first size at which the device tier
beats each host tier — the row's ``device_min`` and
``native_device_min`` (NEVER when it never does in the swept range).

    python tools/crossover_sweep.py                 # 2^16 .. 2^30 words
    python tools/crossover_sweep.py 65536 1048576   # explicit sizes
    python tools/crossover_sweep.py --write         # also calibration.json

``--write`` records the crossovers (with provenance: date, backend,
device kind) in calibration.json, which ops/dispatch.py applies at
import, so moving a deployment to another machine is one sweep run, not
a source edit.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

#: above this the NumPy oracle takes many seconds and gigabytes of
#: temporaries; it is the fallback tier of small calls only
NUMPY_MAX_WORDS = 1 << 26


def _min_seconds(fn, reps: int = 3) -> float:
    fn()                                     # warm: compile, first copy
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _pospopcnt_numpy(x):
    x32 = x.astype(np.uint32)
    return [int(np.count_nonzero((x32 >> k) & 1)) for k in range(16)]


def sweep(sizes, write: bool = False) -> int:
    from libflagstats_tpu.ops import dispatch as D
    from libflagstats_tpu.ops import native_host
    from libflagstats_tpu.oracle import flagstat_numpy, generate_flags

    backend = D.backend()
    row = D.DISPATCH.get(backend, D.DISPATCH["cpu"])
    device = {"": row["device"], "pospopcnt_": row["pospopcnt_device"]}
    has_native = native_host.available()
    x_all = generate_flags(max(sizes), seed=0, full_range=True)
    print(f"# backend={backend} device tiers={device} native={has_native}")
    found = {}
    for prefix, numpy_fn, native_fn, entry in (
            ("", flagstat_numpy, native_host.flagstat_native,
             D.flagstats_u16),
            ("pospopcnt_", _pospopcnt_numpy, native_host.pospopcnt_native,
             D.pospopcnt_u16)):
        name = prefix.rstrip("_") or "flagstat"
        print(f"# {name}\nwords\tnumpy_ms\tnative_ms\tdevice_ms")
        rows = []
        for n in sizes:
            x = x_all[:n]
            t_np = (_min_seconds(lambda: numpy_fn(x))
                    if n <= NUMPY_MAX_WORDS else float("nan"))
            t_nat = (_min_seconds(lambda: native_fn(x)) if has_native
                     else float("nan"))
            t_dev = _min_seconds(lambda: entry(x, impl=device[prefix]))
            rows.append((n, t_np, t_nat, t_dev))
            print(f"{n}\t{t_np * 1e3:.3f}\t{t_nat * 1e3:.3f}\t"
                  f"{t_dev * 1e3:.3f}", flush=True)
        for key, value in crossovers(rows, prefix).items():
            found[key] = value
            print(f"# {backend}.{key} = {value}")
    if write and found:
        print(f"# wrote {sorted(found)} to {write_calibration(found, backend)}")
    return 0


def crossovers(rows, prefix: str = "") -> dict:
    """(words, numpy_s, native_s, device_s) rows -> the DISPATCH entries
    they measure: the first size at which the device beats each host
    tier, NEVER when it never does (so a stale, lower entry from another
    machine cannot linger). A host tier with no measurement (NaN) sets
    nothing."""
    from libflagstats_tpu.ops.dispatch import NEVER

    found = {}
    for key, col in ((prefix + "device_min", 1),
                     (prefix + "native_device_min", 2)):
        measured = [r for r in rows if r[col] == r[col]]
        if measured:
            found[key] = next((r[0] for r in measured if r[3] < r[col]),
                              NEVER)
    return found


def write_calibration(found: dict, backend: str):
    from libflagstats_tpu.calibration import write_thresholds

    return write_thresholds({f"{backend}.{k}": v for k, v in found.items()},
                            _provenance(backend))


def _provenance(backend: str) -> dict:
    import datetime

    import jax

    return {"date": datetime.date.today().isoformat(), "backend": backend,
            "device_kind": jax.devices()[0].device_kind,
            "tool": "crossover_sweep"}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    write = "--write" in argv
    sizes = [int(a) for a in argv if a != "--write"]
    return sweep(sizes or [1 << k for k in range(16, 31, 2)], write=write)


if __name__ == "__main__":
    sys.exit(main())
