"""Device-path tests: plain-XLA formulation vs host oracle."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest


from libflagstats_tpu.oracle import flagstat_numpy, generate_flags, transform_words
from libflagstats_tpu.ops.xla_ops import (
    flagstat_xla,
    pospopcnt_u16_matmul,
    pospopcnt_u16_xla,
    transform_words_jnp,
)

from conftest import assert_counters_equal, pospopcnt_ref


@pytest.mark.parametrize("n", [1, 64, 1000, 65536, 100001])
def test_flagstat_xla_matches_oracle(n, full_range):
    x = generate_flags(n, seed=n, full_range=full_range)
    got = np.asarray(jax.jit(flagstat_xla, static_argnames="n")(jnp.asarray(x)))
    assert_counters_equal(flagstat_numpy(x), got)


def test_transform_words_jnp_matches_numpy(full_range):
    x = generate_flags(20_000, seed=9, full_range=full_range)
    ref = transform_words(x)
    got = np.asarray(transform_words_jnp(jnp.asarray(x)))
    np.testing.assert_array_equal(got, ref)


def test_pospopcnt_xla():
    x = generate_flags(100_000, seed=4, full_range=True)
    ref = pospopcnt_ref(x)
    got = np.asarray(jax.jit(pospopcnt_u16_xla)(jnp.asarray(x)))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n", [1, 100, 4096, 100_000, (1 << 17) + 13, 1 << 18])
def test_pospopcnt_matmul(n):
    """int8 ones-matmul formulation, staged per chunk inside lax.scan:
    bit-exact vs the host count at sizes below / straddling / above the
    chunk boundary."""
    x = generate_flags(n, seed=n % 97, full_range=True)
    ref = pospopcnt_ref(x)
    got = np.asarray(jax.jit(pospopcnt_u16_matmul)(jnp.asarray(x)))
    np.testing.assert_array_equal(got, ref)


def test_pospopcnt_matmul_dispatch():
    from libflagstats_tpu.ops.dispatch import pospopcnt_u16

    x = generate_flags(50_000, seed=12, full_range=True)
    got = pospopcnt_u16(x, impl="xla_matmul")
    ref = pospopcnt_u16(x, impl="numpy")
    np.testing.assert_array_equal(got, ref)


def test_flagstat_xla_padding_neutral():
    """Zero padding must only affect the derived pass-total via n."""
    x = generate_flags(1000, seed=6)
    padded = np.concatenate([x, np.zeros(24, dtype=np.uint16)])
    got = np.asarray(flagstat_xla(jnp.asarray(padded), n=1000))
    assert_counters_equal(flagstat_numpy(x), got)
