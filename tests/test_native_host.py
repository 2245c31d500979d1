"""Native host kernel (io/native/flagstats_host.cpp) — differential
tests against the oracles.

The host tier of the dispatch (reference: FLAGSTATS_u16 itself,
libflagstats.h:3025, and STORM_pospopcnt_u16, libalgebra.h:3497). The
AVX2 Harley-Seal body processes 256 words; sizes around that boundary
and the 4096-body flush cadence are the edge cases.
"""
import numpy as np
import pytest

from libflagstats_tpu.oracle import flagstat_loop, flagstat_numpy, generate_flags
from libflagstats_tpu.ops import native_host

from conftest import assert_counters_equal, pospopcnt_ref

pytestmark = pytest.mark.skipif(
    not native_host.available(), reason="native host library unavailable")


@pytest.mark.parametrize("full_range", [False, True])
@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 4095, 100_000,
                               (1 << 20) + 13])
def test_flagstat_native_matches_oracle(n, full_range):
    x = generate_flags(n, seed=n + full_range, full_range=full_range)
    assert_counters_equal(flagstat_numpy(x), native_host.flagstat_native(x))


def test_flagstat_native_matches_branchy_loop():
    """Root-of-trust check: the branchy per-word loop, not the
    vectorized oracle (which shares the transform formulation). The
    loop fills only the semantically-defined counters, so compare over
    the report set (the reference's own harness does the same,
    benchmark/inmemory.cpp:173-194)."""
    from libflagstats_tpu import flags as F

    x = generate_flags(3_000, seed=7, full_range=True)
    ref = flagstat_loop(x, count_paired=True)
    got = native_host.flagstat_native(x)
    idx = list(F.REPORT_COUNTERS)
    assert (got.astype(np.int64)[idx] == ref.astype(np.int64)[idx]).all()


def test_flagstat_native_accumulates():
    a = generate_flags(10_000, seed=1, full_range=True)
    b = generate_flags(777, seed=2, full_range=True)
    out = native_host.flagstat_native(a)
    native_host.flagstat_native(b, out=out)
    assert_counters_equal(flagstat_numpy(np.concatenate([a, b])), out)


def test_flagstat_native_threads_equivalent():
    """Thread-count must not change counts (order-free integer sums);
    exercises the multi-slab path (> 2^21-word slabs)."""
    x = generate_flags((1 << 22) + 999, seed=3, full_range=True)
    one = native_host.flagstat_native(x, threads=1)
    four = native_host.flagstat_native(x, threads=4)
    assert (one == four).all()
    assert_counters_equal(flagstat_numpy(x), four)


def test_pospopcnt_native_matches_reference():
    for n in (0, 1, 255, 256, 100_000, (1 << 21) + 5):
        x = generate_flags(n, seed=n, full_range=True)
        got = native_host.pospopcnt_native(x)
        np.testing.assert_array_equal(got.astype(np.int64), pospopcnt_ref(x))
    x = generate_flags(50_000, seed=9, full_range=True)
    assert (native_host.pospopcnt_native(x, threads=4).astype(np.int64)
            == pospopcnt_ref(x)).all()


def test_native_dispatch_impl():
    """The 'native' impl string works through the one-call entries and
    their accumulate contract."""
    from libflagstats_tpu.ops.dispatch import flagstats_u16, pospopcnt_u16

    x = generate_flags(65_537, seed=11, full_range=True)
    got = flagstats_u16(x, impl="native")
    assert_counters_equal(flagstat_numpy(x), got)
    out = np.zeros(32, np.uint64)
    flagstats_u16(x, out=out, impl="native")
    flagstats_u16(x, out=out, impl="native")
    assert (out == 2 * got.astype(np.uint64)).all()
    np.testing.assert_array_equal(
        pospopcnt_u16(x, impl="native").astype(np.int64), pospopcnt_ref(x))


def test_native_out_validation():
    x = generate_flags(10, seed=0)
    with pytest.raises(ValueError):
        native_host.flagstat_native(x, out=np.zeros(31, np.uint64))
    with pytest.raises(ValueError):
        native_host.flagstat_native(x, out=np.zeros(32, np.int64))
    with pytest.raises(ValueError):
        native_host.pospopcnt_native(x, out=np.zeros(16, np.uint32))
    # the C kernel writes through a raw pointer: strided and read-only
    # views must be rejected, not silently corrupted (review finding)
    strided = np.zeros(64, np.uint64)[::2]
    assert strided.size == 32
    with pytest.raises(ValueError):
        native_host.flagstat_native(x, out=strided)
    ro = np.zeros(32, np.uint64)
    ro.setflags(write=False)
    with pytest.raises(ValueError):
        native_host.flagstat_native(x, out=ro)
    with pytest.raises(ValueError):
        native_host.pospopcnt_native(x, out=np.zeros(32, np.uint64)[::2])


def test_huge_stream_cap_is_device_only():
    """The 2^31-word int32 cap applies to the device paths only, and is
    handled by CHUNKING into accumulating sub-calls (round-3: the
    OverflowErrors are gone); the uint64 host tiers never chunk.
    Exercised with a size-only mock array so no real 4 GiB is touched."""
    from libflagstats_tpu.ops import dispatch as D

    class _Fake:
        size = (1 << 31) + 5

        def __getitem__(self, sl):
            return np.zeros(min(sl.stop, self.size) - sl.start,
                            dtype=np.uint16)

    for impl in ("native", "numpy"):
        assert len(list(D._device_chunks(_Fake(), impl, 8))) == 1
    for impl in ("xla", "pallas", "pallas_report"):
        chunks = list(D._device_chunks(_Fake(), impl, 8))
        assert len(chunks) == 2
        assert sum(c.size for c in chunks) == _Fake.size
        assert all(c.size <= D.DEVICE_WORD_CAP for c in chunks)


def test_native_saturated_planes():
    """Adversarial constant streams: every word identical exercises the
    CSA residual weights (all planes saturate the same way)."""
    for word in (0x0000, 0x0FFF, 0xFFFF, 0x0200, 0x06A1):
        x = np.full(4_097, word, dtype=np.uint16)
        assert_counters_equal(flagstat_numpy(x),
                              native_host.flagstat_native(x))
        np.testing.assert_array_equal(
            native_host.pospopcnt_native(x).astype(np.int64),
            pospopcnt_ref(x))


def test_flagstat_framed_native(tmp_path):
    """Fused C++ decode+count over framed streams: counters and word
    count match the oracle for every codec; malformed streams raise."""
    from libflagstats_tpu.io import codec as C

    x = generate_flags(300_001, seed=13, full_range=True)
    ref = flagstat_numpy(x)
    for codec in ("raw", "lz4", "zstd"):
        p = tmp_path / f"t.{codec}"
        C.write_framed(p, x, codec=codec, level=1, block_bytes=1 << 17)
        got, n = native_host.flagstat_framed_native(p, C._codec_id(codec))
        assert n == x.size
        assert_counters_equal(ref, got)
    # accumulate contract
    out = np.zeros(32, np.uint64)
    native_host.flagstat_framed_native(tmp_path / "t.lz4", C.CODEC_LZ4,
                                       out=out)
    native_host.flagstat_framed_native(tmp_path / "t.lz4", C.CODEC_LZ4,
                                       out=out)
    assert (out == 2 * ref.astype(np.uint64)).all()
    # corrupted header -> ValueError, not a crash
    data = bytearray((tmp_path / "t.lz4").read_bytes())
    data[1] ^= 0x40  # inflate raw_len
    bad = tmp_path / "bad.lz4"
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError):
        native_host.flagstat_framed_native(bad, C.CODEC_LZ4)
    # empty file counts zero
    empty = tmp_path / "empty.lz4"
    empty.write_bytes(b"")
    got, n = native_host.flagstat_framed_native(empty, C.CODEC_LZ4)
    assert n == 0 and int(got.sum()) == 0


def test_flagstat_framed_range_native(tmp_path):
    """Block-range fused counting: shard ranges must sum to the whole
    stream (the multi-host decomposition), and invalid ranges raise."""
    from libflagstats_tpu.io import codec as C

    x = generate_flags(500_000, seed=17, full_range=True)
    p = tmp_path / "r.lz4"
    C.write_framed(p, x, codec="lz4", level=1, block_bytes=1 << 17)
    n_blocks = len(C.scan_frames(p))
    assert n_blocks >= 4
    ranges = C.shard_block_ranges(n_blocks, 3)
    total = np.zeros(32, np.uint64)
    n_total = 0
    for a, b in ranges:
        c, n = native_host.flagstat_framed_range_native(
            p, C.CODEC_LZ4, a, b, out=total)
        n_total += n
    assert n_total == x.size
    assert_counters_equal(flagstat_numpy(x), total)
    # empty range counts nothing; out-of-bounds raises
    c, n = native_host.flagstat_framed_range_native(p, C.CODEC_LZ4, 2, 2)
    assert n == 0 and int(c.sum()) == 0
    with pytest.raises(ValueError):
        native_host.flagstat_framed_range_native(p, C.CODEC_LZ4, 0,
                                                 n_blocks + 1)


def test_multihost_file_native_single_process(tmp_path):
    """flagstat_multihost_file(impl='native') on one process equals the
    oracle (the cross-process merge is leg 4 of the 2-proc test)."""
    from libflagstats_tpu.io import codec as C
    from libflagstats_tpu.parallel import multihost

    x = generate_flags(400_000, seed=19, full_range=True)
    p = tmp_path / "m.lz4"
    C.write_framed(p, x, codec="lz4", level=1, block_bytes=1 << 17)
    got = multihost.flagstat_multihost_file(p, codec="lz4", impl="native")
    assert_counters_equal(flagstat_numpy(x), got)


def _perf_available():
    from libflagstats_tpu.bench import perf_native as P

    return P.available()


def test_perf_group_counts_software_events():
    """The perf_event shim (io/native/perf_events.cpp; reference:
    linux/linux-perf-events.h:16-90) must open a group, bracket a region,
    and return per-event counts. Hardware events may be absent on
    virtualized hosts (ENOENT — true of this box); software events
    (task-clock) exist wherever perf_event_open is permitted at all, so
    the plumbing is fully exercised either way. Hosts where the syscall
    itself is blocked (seccomp, perf_event_paranoid >= 3) skip — the
    library degrades there by design and cli instrumented says so."""
    from libflagstats_tpu.bench import perf_native as P

    if not _perf_available():
        pytest.skip("perf_event_open blocked on this host")
    g = P.PerfGroup()
    try:
        assert g.ok
        assert "task_clock_ns" in g.names   # software events always open
        g.start()
        acc = 0
        for i in range(200_000):
            acc += i * i
        res = g.stop()
        assert res["task_clock_ns"] > 10_000   # >10us of counted CPU time
        # a second bracket must reset, not accumulate
        g.start()
        res2 = g.stop()
        assert res2["task_clock_ns"] < res["task_clock_ns"]
    finally:
        g.close()
    assert acc > 0


def test_perf_measure_native_kernels():
    """measure() reports overhead-calibrated per-word numbers for the
    native kernels and labels honestly whether hardware counters were
    real (counted) or only software events opened."""
    from libflagstats_tpu.bench import perf_native as P

    if not _perf_available():
        pytest.skip("perf_event_open blocked on this host")
    rows = P.native_kernel_report(n_words=1 << 18, iters=3)
    assert [r.name for r in rows] == ["lfs_flagstat_u16",
                                      "lfs_pospopcnt_u16"]
    for r in rows:
        assert r.counted == P.hardware_available()
        tk = r.min_per_word.get("task_clock_ns")
        # sane per-word on-CPU time: > 0 and well under a microsecond
        assert tk is not None and 0 < tk < 1000
        if r.counted:
            assert 0 < r.min_per_word["cycles"] < 1000
            assert r.ipc and r.ipc > 0
    report = P.format_report(rows)
    assert "lfs_flagstat_u16" in report
    if not P.hardware_available():
        assert "no hardware PMU" in report
