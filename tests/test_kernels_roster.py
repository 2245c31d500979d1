"""`cli kernels` roster plumbing (bench/kernels.run) — CPU-runnable
slice: row format stays 6-column TSV, correctness gating works, and
the roofline row closes the table. (The GPU rows are exercised by
running the tool on the card; this pins the shared plumbing so a
refactor can't silently break the roster between card runs.)"""
import jax
import pytest


@pytest.fixture(autouse=True)
def _cpu_peak(monkeypatch):
    """The CPU has no entry in the peak table; give it one here."""
    from libflagstats_tpu.bench import harness

    monkeypatch.setitem(harness.HBM_NOMINAL, jax.devices()[0].device_kind,
                        1e12)


def test_roster_runs_and_formats(tmp_path):
    from libflagstats_tpu.bench.kernels import HEADER, run

    lines = run(n_words=1 << 15, iters=2, cache_dir=str(tmp_path))
    assert lines[0] == HEADER
    assert len(lines) >= 3                       # xla + 2 setop rows
    body = [ln for ln in lines[1:] if not ln.startswith("[roofline")]
    for ln in body:
        cols = ln.split("\t")
        assert len(cols) == 6, ln
        assert "MISMATCH" not in ln, ln
    names = [ln.split("\t")[0] for ln in body]
    assert "xla" in names and "setop_popcnt" in names


def test_roster_flags_mismatches(monkeypatch, tmp_path):
    """A kernel returning wrong counters must yield a MISMATCH row,
    not a timed row (the roster's whole point is oracle-gated
    timing)."""
    import libflagstats_tpu.bench.kernels as K

    def bad_bodies(n_words):
        import jax.numpy as jnp

        return {"xla": lambda a: jnp.zeros(32, jnp.int32)}

    monkeypatch.setattr(K, "_bodies", bad_bodies)
    lines = K.run(n_words=1 << 14, iters=1, cache_dir=str(tmp_path))
    assert any("MISMATCH" in ln for ln in lines), lines
