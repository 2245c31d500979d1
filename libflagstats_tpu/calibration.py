"""Measured dispatch-crossover calibration file.

The size-tier crossovers in ops/dispatch.DISPATCH are *measurements*,
and they are shaped by the machine: the host's cores, the host-to-device
link and the card (reference analogue: the runtime-probed, cached
dispatch of FLAGSTATS_get_function, libflagstats.h:2977-3022, which
re-probes per process instead of baking one machine's numbers into the
source). A deployment does not hand-copy sweep output into the source:
the sweep WRITES its measurements here and dispatch READS them at
import:

    python tools/crossover_sweep.py --write                # flagstat tiers
    python tools/crossover_sweep.py --pospopcnt --write    # pospopcnt tiers

File: ``calibration.json`` at the repo root by default (override with
``LFS_CALIBRATION_FILE``; set it to an empty string to disable loading).
Names are ``<backend>.<entry>`` of the DISPATCH table. Schema
(per-threshold provenance so a stale entry is self-describing):

    {"version": 1,
     "thresholds": {
       "gpu.native_device_min": {"value": 16777216, "date": "...",
                                 "backend": "gpu",
                                 "device_kind": "NVIDIA H100 80GB HBM3",
                                 "tool": "crossover_sweep"}}}

Unknown threshold names are ignored (forward compatibility); a malformed
file is reported and skipped (the built-in table is the fallback, never
a crash).
"""
from __future__ import annotations

import json
import os
import sys
from pathlib import Path

#: threshold names dispatch accepts from the file: the measured
#: crossover entries of each ops/dispatch.DISPATCH row
BACKENDS = ("cpu", "gpu")
THRESHOLD_KEYS = ("device_min", "native_device_min",
                  "pospopcnt_device_min", "pospopcnt_native_device_min")
KNOWN_THRESHOLDS = frozenset(
    f"{backend}.{key}" for backend in BACKENDS for key in THRESHOLD_KEYS)

_ENV = "LFS_CALIBRATION_FILE"


def calibration_path() -> Path | None:
    """The calibration file path: $LFS_CALIBRATION_FILE; else
    <repo root>/calibration.json when running from a source checkout;
    else a user-writable config path (an installed package's directory
    lives in site-packages — not writable, and wiped on upgrade, so a
    deployment's calibration must not live there). None when disabled
    (env set empty)."""
    env = os.environ.get(_ENV)
    if env is not None:
        return Path(env) if env else None
    root = Path(__file__).resolve().parent.parent
    if (root / "pyproject.toml").is_file():
        return root / "calibration.json"
    return (Path(os.path.expanduser("~")) / ".config"
            / "libflagstats-tpu" / "calibration.json")


def load_thresholds(path: Path | None = None) -> dict[str, int]:
    """{threshold_name: value} from the calibration file — only names in
    KNOWN_THRESHOLDS with usable integer values; {} when the file is
    absent/disabled, and {} with a stderr warning when it is malformed
    (silent fallback would make a deployment think it is calibrated)."""
    if path is None:
        path = calibration_path()
    if path is None or not path.is_file():
        return {}
    try:
        with open(path) as fh:
            blob = json.load(fh)
        entries = blob["thresholds"]
        if not isinstance(entries, dict):
            raise ValueError(f"'thresholds' must be a map, got "
                             f"{type(entries).__name__}")
        out = {}
        for name, ent in entries.items():
            if name not in KNOWN_THRESHOLDS:
                continue
            v = ent["value"] if isinstance(ent, dict) else ent
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                raise ValueError(f"threshold {name}: bad value {v!r}")
            out[name] = v
        return out
    except (OSError, KeyError, ValueError, TypeError, AttributeError,
            json.JSONDecodeError) as exc:
        # AttributeError/TypeError cover shape surprises (non-dict blob,
        # list thresholds, ...): a malformed file must NEVER break
        # `import libflagstats_tpu` — the built-in constants are the
        # documented fallback
        print(f"[libflagstats_tpu] WARNING: calibration file {path} "
              f"unusable ({type(exc).__name__}: {exc}); using built-in "
              f"dispatch thresholds", file=sys.stderr)
        return {}


def write_thresholds(thresholds: dict[str, int], provenance: dict,
                     path: Path | None = None) -> Path:
    """Merge measured ``thresholds`` (name -> value) into the
    calibration file, stamping each with ``provenance`` (date, backend,
    device_kind, dispatch_rtt_ms, tool). Existing entries for OTHER
    names are preserved — the flagstat and pospopcnt sweeps, and runs on
    different backends, accumulate into one file."""
    if path is None:
        path = calibration_path()
    if path is None:
        raise ValueError(f"calibration disabled ({_ENV} is empty)")
    unknown = set(thresholds) - KNOWN_THRESHOLDS
    if unknown:
        raise ValueError(f"unknown threshold names: {sorted(unknown)}")
    blob = {"version": 1, "thresholds": {}}
    if path.is_file():
        try:
            with open(path) as fh:
                old = json.load(fh)
            if isinstance(old.get("thresholds"), dict):
                blob["thresholds"].update(old["thresholds"])
        except (OSError, ValueError) as exc:
            print(f"[calibration] existing {path} unreadable "
                  f"({exc}); rewriting", file=sys.stderr)
    for name, value in thresholds.items():
        blob["thresholds"][name] = {"value": int(value), **provenance}
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "w") as fh:
        json.dump(blob, fh, indent=1, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)
    return path
