"""Unit coverage for the self-defending measurement helpers.

The gates themselves (fit ok / dispersion / reject-above-roofline) are
exercised on the card by bench.py and `cli kernels`; these tests pin the
pure retry/acceptance logic, the peak table and the reference-counter
disk cache so a regression shows up in the CPU suite.
"""
import jax
import numpy as np
import pytest

from libflagstats_tpu.bench import harness, refcache
from libflagstats_tpu.bench.harness import FitResult

from conftest import pospopcnt_ref


def _fit(slope_s: float, residual: float = 0.01,
         dispersion: float = 0.05) -> FitResult:
    return FitResult(slope_s=slope_s, intercept_s=0.05,
                     points=[(4, 0.05, 0.05), (64, 0.06, 0.06)],
                     rel_residual=residual, dispersion=dispersion,
                     raw_slope_s=slope_s)


def _patch_fits(monkeypatch, fits):
    it = iter(fits)
    calls = []

    def fake(body_fn, x, ks=(4, 64, 260), iters=4, salt_base=None):
        calls.append(salt_base)
        return next(it)

    monkeypatch.setattr(harness, "kernel_time_fit", fake)
    return calls


def test_gated_fit_accepts_first_good_sample(monkeypatch):
    good = _fit(1e-4)
    calls = _patch_fits(monkeypatch, [good])
    got = harness.gated_kernel_time_fit(None, None)
    assert got is good
    assert len(calls) == 1


def test_gated_fit_retries_past_dispersion_and_residual(monkeypatch):
    noisy = _fit(1e-4, dispersion=0.5)        # fails dispersion gate
    bent = _fit(1e-4, residual=0.3)           # fails .ok (residual)
    good = _fit(1e-4)
    calls = _patch_fits(monkeypatch, [noisy, bent, good])
    got = harness.gated_kernel_time_fit(None, None)
    assert got is good
    assert len(calls) == 3


def test_gated_fit_rejects_above_roofline(monkeypatch):
    # 1 KiB in 1 ns -> 1e12 B/s, far above a 500e9 roofline * 1.05;
    # the plausible 1e-6 s sample (1e9 B/s) must be the one accepted
    impossible = _fit(1e-9)
    plausible = _fit(1e-6)
    _patch_fits(monkeypatch, [impossible, plausible])
    got = harness.gated_kernel_time_fit(None, None, roof_bytes_per_s=500e9,
                                        n_bytes=1024)
    assert got is plausible


def test_gated_fit_returns_last_sample_when_gates_never_pass(monkeypatch):
    bad = [_fit(1e-4, dispersion=0.9) for _ in range(3)]
    calls = _patch_fits(monkeypatch, bad)
    got = harness.gated_kernel_time_fit(None, None, attempts=3)
    assert got is bad[-1]           # caller inspects .ok/.dispersion
    assert got.dispersion >= 0.30
    assert len(calls) == 3


def test_gated_fit_without_roofline_skips_throughput_gate(monkeypatch):
    fast = _fit(1e-9)               # would fail any roofline gate
    _patch_fits(monkeypatch, [fast])
    got = harness.gated_kernel_time_fit(None, None, roof_bytes_per_s=None,
                                        n_bytes=1024)
    assert got is fast


def test_refcache_roundtrip_and_recompute_count(tmp_path, monkeypatch):
    x = np.array([0, 1, 2, 0x0400], dtype=np.uint16)
    calls = {"n": 0}
    real = refcache.flagstat_numpy

    def counting(arr):
        calls["n"] += 1
        return real(arr)

    monkeypatch.setattr(refcache, "flagstat_numpy", counting)
    a = refcache.oracle_counters(x, len(x), seed=7, cache_dir=str(tmp_path))
    b = refcache.oracle_counters(x, len(x), seed=7, cache_dir=str(tmp_path))
    assert calls["n"] == 1          # second call served from disk
    assert a.shape == (32,) and (a == b).all()
    assert (a == real(x).astype(np.int64)).all()


def test_refcache_ignores_wrong_shape_file(tmp_path):
    x = np.arange(8, dtype=np.uint16)
    first = refcache.pospopcnt_counters(x, len(x), cache_dir=str(tmp_path))
    # corrupt the cached file with a wrong-shape payload
    files = list(tmp_path.glob("bench_pospop_*.npy"))
    assert len(files) == 1
    np.save(files[0], np.zeros(3, dtype=np.int64))
    again = refcache.pospopcnt_counters(x, len(x), cache_dir=str(tmp_path))
    assert (again == first).all()
    assert list(first) == list(pospopcnt_ref(x))


def test_refcache_key_depends_on_semantics_source(tmp_path, monkeypatch):
    """Editing the oracle/flag-model source must invalidate the cache —
    a stale counter file would fail every future correctness gate with
    no hint why."""
    x = np.arange(16, dtype=np.uint16)
    refcache.oracle_counters(x, len(x), cache_dir=str(tmp_path))
    monkeypatch.setattr(refcache, "_source_tag", lambda: "deadbeef00")
    refcache.oracle_counters(x, len(x), cache_dir=str(tmp_path))
    assert len(list(tmp_path.glob("bench_oracle_*.npy"))) == 2


def test_kernels_roster_runs_on_cpu(tmp_path, monkeypatch):
    """`cli kernels` row assembly end-to-end on the CPU backend: header,
    the gate-annotated xla row (the only CPU flagstat body) plus the two
    set-algebra rows, correctness checks against the cached oracle /
    host popcount, and the roofline footer when the defended roofline
    produced a number. Gate outcome itself is host-load dependent, so
    only the row STRUCTURE is asserted. cache_dir keeps the test's
    reference files out of the repo's load-bearing .jax_cache."""
    from libflagstats_tpu.bench import kernels

    # the CPU has no entry in the peak table; give it one for the test
    monkeypatch.setitem(harness.HBM_NOMINAL, jax.devices()[0].device_kind,
                        1e12)
    lines = kernels.run(n_words=65536, iters=2, cache_dir=str(tmp_path))
    assert lines[0] == kernels.HEADER
    rows = [l for l in lines[1:] if not l.startswith("[roofline")]
    assert [r.split("\t")[0] for r in rows] == [
        "xla", "setop_popcnt", "setop_intersect"]
    for row in rows:
        cols = row.split("\t")
        assert len(cols) == 6 and "MISMATCH" not in row
        assert cols[1] == "65536"
        float(cols[2])                  # time_us parses
        # the vs_roofline column may be any of: '0.123', '0.123!' (gate
        # failed), 'n/a' (no roofline), 'n/a!' (no roofline AND gate
        # failed)
        vs = cols[5].rstrip("!")
        assert vs == "n/a" or float(vs) > 0
    assert len(list(tmp_path.glob("bench_*.npy"))) == 2


def test_gated_fit_sets_gate_verdict(monkeypatch):
    """gate_passed is the single source of truth consumers use to mark
    rows — it must be True on an accepted sample and False when the
    gates were never satisfied."""
    good = _fit(1e-4)
    _patch_fits(monkeypatch, [good])
    assert harness.gated_kernel_time_fit(None, None).gate_passed is True
    bad = [_fit(1e-4, dispersion=0.9) for _ in range(3)]
    _patch_fits(monkeypatch, bad)
    got = harness.gated_kernel_time_fit(None, None, attempts=3)
    assert got.gate_passed is False


def test_refcache_key_binds_to_data(tmp_path):
    """Two different arrays with identical metadata must not share a
    cache entry — a mismatched caller would otherwise poison the entry
    for every later caller of the true key."""
    a = np.arange(16, dtype=np.uint16)
    b = np.arange(16, dtype=np.uint16)[::-1].copy()
    ra = refcache.oracle_counters(a, 16, seed=0, cache_dir=str(tmp_path))
    rb = refcache.oracle_counters(b, 16, seed=0, cache_dir=str(tmp_path))
    assert len(list(tmp_path.glob("bench_oracle_*.npy"))) == 2
    assert (ra == refcache.flagstat_numpy(a).astype(np.int64)).all()
    assert (rb == refcache.flagstat_numpy(b).astype(np.int64)).all()
    # non-contiguous input hashes its contiguous copy, same result
    c = np.arange(32, dtype=np.uint16)[::2]
    rc = refcache.oracle_counters(c, 16, seed=1, cache_dir=str(tmp_path))
    assert (rc == refcache.flagstat_numpy(c.copy()).astype(np.int64)).all()


def test_peak_table_raises_for_unknown_device(monkeypatch):
    """A device with no nominal bandwidth is an error, never a None that
    would silently drop the physical gate."""
    kind = jax.devices()[0].device_kind
    monkeypatch.delitem(harness.HBM_NOMINAL, kind, raising=False)
    with pytest.raises(ValueError, match="no nominal memory bandwidth"):
        harness.hbm_nominal_bytes_per_s()
    from libflagstats_tpu.bench import kernels

    with pytest.raises(ValueError):
        kernels.run(n_words=1 << 12, iters=1)


def test_peak_table_holds_the_h100(monkeypatch):
    assert harness.HBM_NOMINAL["NVIDIA H100 80GB HBM3"] == 3.35e12

    class _Dev:
        device_kind = "NVIDIA H100 80GB HBM3"

    monkeypatch.setattr(harness.jax, "devices", lambda: [_Dev()])
    assert harness.hbm_nominal_bytes_per_s() == 3.35e12
