"""Dispatch-crossover calibration round-trip.

The sweep tool WRITES its measured crossovers to calibration.json and
ops/dispatch.py APPLIES them to its DISPATCH table at import — so moving
a deployment to another machine is a sweep run, not a source edit
(reference analogue: runtime-probed cached dispatch,
libflagstats.h:2977-3022).
"""
import copy
import importlib.util
import json
import sys
from pathlib import Path

import pytest

from libflagstats_tpu import calibration
from libflagstats_tpu.ops import dispatch

TOOLS = Path(__file__).resolve().parent.parent / "tools"


def _sweep_module():
    spec = importlib.util.spec_from_file_location(
        "crossover_sweep", TOOLS / "crossover_sweep.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def cal_file(tmp_path, monkeypatch):
    path = tmp_path / "calibration.json"
    monkeypatch.setenv("LFS_CALIBRATION_FILE", str(path))
    saved = copy.deepcopy(dispatch.DISPATCH)
    yield path
    # restore the built-in table for the rest of the suite
    monkeypatch.delenv("LFS_CALIBRATION_FILE")
    dispatch.DISPATCH.clear()
    dispatch.DISPATCH.update(saved)


def test_write_load_roundtrip(cal_file):
    calibration.write_thresholds(
        {"gpu.device_min": 1 << 13, "gpu.native_device_min": 1 << 20},
        {"date": "2026-10-16", "backend": "gpu", "device_kind": "x",
         "tool": "crossover_sweep"})
    got = calibration.load_thresholds()
    assert got == {"gpu.device_min": 1 << 13,
                   "gpu.native_device_min": 1 << 20}
    # provenance rides along in the file
    blob = json.loads(cal_file.read_text())
    assert blob["thresholds"]["gpu.device_min"]["backend"] == "gpu"
    assert blob["thresholds"]["gpu.device_min"]["device_kind"] == "x"


def test_write_merges_across_sweeps(cal_file):
    """The flagstat and pospopcnt sweeps accumulate into one file."""
    calibration.write_thresholds({"gpu.device_min": 1 << 13},
                                 {"tool": "crossover_sweep"})
    calibration.write_thresholds({"gpu.pospopcnt_device_min": 1 << 22},
                                 {"tool": "crossover_sweep"})
    got = calibration.load_thresholds()
    assert got == {"gpu.device_min": 1 << 13,
                   "gpu.pospopcnt_device_min": 1 << 22}


def test_dispatch_applies_calibration(cal_file):
    """File -> dispatch: entries override the DISPATCH table, and
    auto_impl's decisions actually move."""
    calibration.write_thresholds(
        {"gpu.native_device_min": 1 << 10, "cpu.device_min": 1 << 4},
        {"tool": "test"})
    applied = dispatch._apply_calibration()
    assert sorted(applied) == ["cpu.device_min", "gpu.native_device_min"]
    assert dispatch.DISPATCH["gpu"]["native_device_min"] == 1 << 10
    assert dispatch.DISPATCH["cpu"]["device_min"] == 1 << 4


def test_dispatch_auto_impl_moves_with_calibration(cal_file):
    """On this CPU-forced suite the native tier wins at every size by
    default; a calibrated (tiny) cpu.device_min must not disturb that,
    but with native unavailable the numpy->xla crossover must follow the
    file."""
    from libflagstats_tpu.ops import native_host

    calibration.write_thresholds({"cpu.device_min": 1 << 4}, {"tool": "test"})
    dispatch._apply_calibration()
    if native_host.available():
        assert dispatch.auto_impl(1 << 3) == "native"
    orig = native_host.available
    try:
        native_host.available = lambda: False
        assert dispatch.auto_impl(1 << 3) == "numpy"
        assert dispatch.auto_impl(1 << 5) == "xla"   # calibrated crossover
    finally:
        native_host.available = orig


def test_malformed_file_warns_and_falls_back(cal_file, capsys):
    cal_file.write_text("{not json")
    assert calibration.load_thresholds() == {}
    assert "unusable" in capsys.readouterr().err
    cal_file.write_text(json.dumps(
        {"version": 1, "thresholds": {"gpu.device_min": {"value": "big"}}}))
    assert calibration.load_thresholds() == {}


def test_unknown_names_ignored_on_load_rejected_on_write(cal_file):
    cal_file.write_text(json.dumps(
        {"version": 1,
         "thresholds": {"FUTURE_KNOB": {"value": 7},
                        "gpu.device_min": {"value": 64}}}))
    assert calibration.load_thresholds() == {"gpu.device_min": 64}
    with pytest.raises(ValueError, match="unknown threshold"):
        calibration.write_thresholds({"TYPO_MIN": 1}, {})


def test_env_empty_disables(monkeypatch):
    monkeypatch.setenv("LFS_CALIBRATION_FILE", "")
    assert calibration.calibration_path() is None
    assert calibration.load_thresholds() == {}


def test_sweep_writer_maps_crossovers_to_thresholds(cal_file, monkeypatch):
    """The sweep-side mapping: measured crossovers -> named DISPATCH
    entries of the backend, with provenance."""
    sweep = _sweep_module()
    monkeypatch.setattr(sweep, "_provenance",
                        lambda backend: {"backend": backend,
                                         "tool": "crossover_sweep"})
    sweep.write_calibration({"device_min": 1 << 20,
                             "pospopcnt_native_device_min": 1 << 24}, "gpu")
    got = calibration.load_thresholds()
    assert got == {"gpu.device_min": 1 << 20,
                   "gpu.pospopcnt_native_device_min": 1 << 24}
    blob = json.loads(cal_file.read_text())
    ent = blob["thresholds"]["gpu.device_min"]
    assert ent["tool"] == "crossover_sweep" and ent["backend"] == "gpu"


def test_sweep_crossover_rule():
    """First size at which the device beats each host tier; NEVER when
    it never does; nothing for an unmeasured (NaN) host tier."""
    sweep = _sweep_module()
    nan = float("nan")
    rows = [(1 << 16, 0.001, 0.0001, 0.002),
            (1 << 18, 0.004, 0.0004, 0.003),
            (1 << 20, 0.016, 0.0016, 0.004)]
    assert sweep.crossovers(rows) == {"device_min": 1 << 18,
                                      "native_device_min": dispatch.NEVER}
    rows = [(n, nan, nat, dev) for n, _, nat, dev in rows]
    assert sweep.crossovers(rows, "pospopcnt_") == {
        "pospopcnt_native_device_min": dispatch.NEVER}


def test_malformed_shapes_never_crash_import(cal_file, capsys):
    """A thresholds value of the wrong SHAPE (list, string, non-dict
    blob) must fall back with a warning — it is loaded at
    `import libflagstats_tpu.ops.dispatch` time, so an uncaught error
    bricks the whole library."""
    import json as _json

    for blob in ('{"version": 1, "thresholds": [1, 2]}',
                 '{"version": 1, "thresholds": "gpu.device_min"}',
                 '[1, 2, 3]', '"just a string"', "3"):
        cal_file.write_text(blob)
        assert calibration.load_thresholds() == {}, blob
        assert dispatch._apply_calibration() == []
    assert "unusable" in capsys.readouterr().err
