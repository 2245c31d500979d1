"""Card tests of the bit-sliced kernel and the paths that run it.

Each test skips without a GPU (the ``gpu`` fixture); run them on a card
with ``python -m pytest -m gpu tests/``. The kernel's arithmetic is
covered on the CPU by test_bitsliced_jnp.py (identical traced math) and
test_bitsliced_kernel.py (the Pallas plumbing in interpret mode); these
compile it for the card: masked loads, launch geometry, the PTX
popcount, partial-sum rows.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from libflagstats_tpu import flags as F
from libflagstats_tpu.oracle import flagstat_numpy, generate_flags
from libflagstats_tpu.ops import pallas_kernels as PK

from conftest import assert_counters_equal, pospopcnt_ref

pytestmark = [pytest.mark.gpu, pytest.mark.usefixtures("gpu")]


@pytest.mark.parametrize("n", [
    1,                                  # one word, one masked group
    PK.GROUP_WORDS,                     # one full group
    5 * PK.GROUP_WORDS - 12345,         # several programs, partial tail
    (1 << 24) + 7,                      # groups per program > 1, odd length
])
def test_flagstat_kernel_gpu(n):
    x = generate_flags(n, seed=n & 0xFFFF, full_range=True)
    ref = flagstat_numpy(x).astype(np.int64)
    got = np.asarray(PK.flagstat_pallas(jnp.asarray(x), n=n), dtype=np.int64)
    assert_counters_equal(ref, got)
    rep = np.asarray(PK.flagstat_pallas(jnp.asarray(x), n=n, report=True),
                     dtype=np.int64)
    idx = list(F.REPORT_COUNTERS)
    np.testing.assert_array_equal(rep[idx], ref[idx])
    np.testing.assert_array_equal(
        np.asarray(PK.pospopcnt_u16_pallas(jnp.asarray(x))), pospopcnt_ref(x))


def test_kernel_geometry_gpu():
    """A column of more groups than TARGET_PROGRAMS: several groups per
    program and a short last program, against the oracle."""
    n = 3 * PK.TARGET_PROGRAMS * PK.GROUP_WORDS + 12_345
    x = generate_flags(n, seed=5, full_range=True)
    programs, per = PK._launch(-(-n // PK.GROUP_WORDS))
    assert per > 1 and (programs - 1) * per < -(-n // PK.GROUP_WORDS)
    rows = np.asarray(PK.stream_partials(jnp.asarray(x), "flagstat"))
    assert rows.shape == (programs, PK.OUT_STREAMS)
    assert_counters_equal(
        flagstat_numpy(x),
        np.asarray(PK.flagstat_pallas(jnp.asarray(x), n=n)))
    np.testing.assert_array_equal(
        np.asarray(PK.pospopcnt_u16_pallas(jnp.asarray(x))), pospopcnt_ref(x))


def test_saturated_and_empty_gpu():
    n = 3 * PK.GROUP_WORDS
    x = np.full(n, 0xFFFF, dtype=np.uint16)
    got = np.asarray(PK.flagstat_pallas(jnp.asarray(x), n=n), dtype=np.int64)
    assert_counters_equal(flagstat_numpy(x), got)
    empty = jnp.zeros(0, jnp.uint16)
    assert (np.asarray(PK.flagstat_pallas(empty)) == 0).all()
    assert (np.asarray(PK.pospopcnt_u16_pallas(empty)) == 0).all()


def test_every_impl_string_via_dispatch_gpu():
    """Every registry string drives the public entries on the card."""
    from libflagstats_tpu.ops.dispatch import (
        FLAGSTAT_IMPLS,
        POSPOPCNT_IMPLS,
        flagstats_u16,
        pospopcnt_u16,
    )

    x = generate_flags(1_000_003, seed=7, full_range=True)
    ref = flagstat_numpy(x).astype(np.int64)
    for impl in FLAGSTAT_IMPLS:
        if impl == "native":
            continue  # host tier: covered by test_native_host.py
        got = np.asarray(flagstats_u16(x, impl=impl), dtype=np.int64)
        idx = (list(F.REPORT_COUNTERS) if impl == "pallas_report"
               else list(range(32)))
        assert (got[idx] == ref[idx]).all(), impl
    for impl in POSPOPCNT_IMPLS:
        if impl == "native":
            continue
        got = np.asarray(pospopcnt_u16(x, impl=impl), dtype=np.int64)
        np.testing.assert_array_equal(got, pospopcnt_ref(x), err_msg=impl)


def test_sharded_one_device_mesh_gpu():
    """shard_map + psum around the kernel on a one-device mesh."""
    import jax

    from libflagstats_tpu.parallel.sharded import data_mesh, flagstat_sharded

    x = generate_flags(3 * PK.GROUP_WORDS + 11, seed=99, full_range=True)
    got = flagstat_sharded(x, mesh=data_mesh(jax.devices()[:1]),
                           impl="pallas")
    assert_counters_equal(flagstat_numpy(x), got)


def test_stream_pallas_gpu(tmp_path):
    """Framed stream -> decode pool -> chunks -> kernel accumulate,
    with a padded tail chunk."""
    from libflagstats_tpu.io import codec as C
    from libflagstats_tpu.io.stream import flagstat_stream

    n = 2 * (1 << 20) + 12_345
    x = generate_flags(n, seed=51, full_range=True)
    path = tmp_path / "s.lz4"
    C.write_framed(path, x, codec="lz4", level=1)
    got = flagstat_stream(path, codec="lz4", impl="pallas",
                          chunk_words=1 << 20)
    assert_counters_equal(flagstat_numpy(x), got)
