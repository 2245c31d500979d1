"""Differential test of the full bit-sliced device algorithm (the jnp
twin of the Pallas kernel: identical traced math, no pallas_call)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libflagstats_tpu.oracle import flagstat_numpy, generate_flags
from libflagstats_tpu.ops.pallas_kernels import (
    GROUP_WORDS,
    flagstat_bitsliced_jnp,
    pospopcnt_bitsliced_jnp,
)

from conftest import assert_counters_equal, pospopcnt_ref


@pytest.fixture(scope="module")
def jitted():
    return (
        jax.jit(flagstat_bitsliced_jnp, static_argnames=("n", "report")),
        jax.jit(pospopcnt_bitsliced_jnp),
    )


def test_flagstat_bitsliced_one_step(jitted, full_range):
    fn, _ = jitted
    n = GROUP_WORDS  # exactly one transpose group
    x = generate_flags(n, seed=1, full_range=full_range)
    got = np.asarray(fn(jnp.asarray(x), n=n), dtype=np.int64)
    assert_counters_equal(flagstat_numpy(x).astype(np.int64), got)


def test_flagstat_bitsliced_with_tail(jitted):
    fn, _ = jitted
    # several groups, the last one zero-padded (padding neutrality)
    n = 3 * GROUP_WORDS - 1234
    x = generate_flags(n, seed=2, full_range=True)
    got = np.asarray(fn(jnp.asarray(x), n=n), dtype=np.int64)
    assert_counters_equal(flagstat_numpy(x).astype(np.int64), got)


def test_pospopcnt_bitsliced(jitted):
    _, fn = jitted
    n = 2 * GROUP_WORDS + 5
    x = generate_flags(n, seed=3, full_range=True)
    ref = pospopcnt_ref(x)
    got = np.asarray(fn(jnp.asarray(x)))
    np.testing.assert_array_equal(got, ref)


def test_flagstat_bitsliced_report_mode(jitted):
    """Report mode (21 streams) is bit-exact on every reported counter
    and zero on the masked-positional ones (improved3/4 analogue)."""
    import libflagstats_tpu.flags as F

    fn, _ = jitted
    n = 2 * GROUP_WORDS - 333
    x = generate_flags(n, seed=8, full_range=True)
    got = np.asarray(fn(jnp.asarray(x), n=n, report=True), dtype=np.int64)
    ref = flagstat_numpy(x).astype(np.int64)
    idx = list(F.REPORT_COUNTERS)
    np.testing.assert_array_equal(got[idx], ref[idx])
    zeros = [1, 3, 4, 5, 17, 19, 20, 21]
    assert (got[zeros] == 0).all()


def test_adversarial_saturated_planes(jitted):
    """All-ones FLAG words saturate every CSA plane (a carry out of every
    adder, every group) — the worst case for the staged-counter
    discipline (SURVEY.md §4 implication (f))."""
    fn, _ = jitted
    n = 2 * GROUP_WORDS
    x = np.full(n, 0x0FFF, dtype=np.uint16)
    got = np.asarray(fn(jnp.asarray(x), n=n), dtype=np.int64)
    assert_counters_equal(flagstat_numpy(x).astype(np.int64), got)
    # sanity: every word is QC-fail + secondary here
    assert got[16 + 8] == n and got[25] == n and got[9] == 0


def test_empty_input_all_pallas_entries_interpret():
    """An empty column launches no kernel: every entry short-circuits to
    exact zeros (the twin included)."""
    from libflagstats_tpu.ops import pallas_kernels as PK

    empty = jnp.zeros(0, jnp.uint16)
    c = np.asarray(PK.flagstat_pallas(empty, interpret=True))
    assert c.shape == (32,) and (c == 0).all()
    t, f = PK.stream_sums_pallas(empty, interpret=True)
    assert (np.asarray(t) == 0).all() and (np.asarray(f) == 0).all()
    pp = np.asarray(PK.pospopcnt_u16_pallas(empty, interpret=True))
    assert pp.shape == (16,) and (pp == 0).all()
    tw = np.asarray(PK.flagstat_bitsliced_jnp(empty))
    assert tw.shape == (32,) and (tw == 0).all()
