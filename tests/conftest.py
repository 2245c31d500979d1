"""Test harness config.

The suite runs on the CPU with 8 virtual devices, so the multi-device
sharding paths (mesh + psum) are exercised without a card. Tests that
need an NVIDIA GPU carry the ``gpu`` marker and the ``gpu`` fixture,
which skips them when JAX finds no GPU; ``python -m pytest -m gpu tests/``
selects exactly them and leaves the platform to JAX, so on a machine
with a card they run there.
"""
import os
import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # repo root

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from libflagstats_tpu.oracle import generate_flags  # noqa: E402


def pytest_configure(config):
    """Force the CPU platform with 8 virtual devices, unless the run
    selects exactly the card tests (``-m gpu``). This decides the
    platform, never which tests exist: every worker collects the same
    tests either way."""
    if (config.getoption("markexpr") or "").strip() != "gpu":
        flags = os.environ.get("XLA_FLAGS", "")
        m = re.search(r"--xla_force_host_platform_device_count=(\d+)", flags)
        if m is None:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()
        elif m.group(1) != "8":
            # a foreign count left in the shell (e.g. =1 from debugging)
            # would silently stop the mesh/psum tests exercising 8 devices
            os.environ["XLA_FLAGS"] = flags.replace(
                m.group(0), "--xla_force_host_platform_device_count=8")
        import jax

        jax.config.update("jax_platforms", "cpu")

    from libflagstats_tpu.config import enable_compilation_cache

    enable_compilation_cache()


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided here, inside the test, so
    every worker collects the same tests)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: python -m pytest -m gpu tests/")


@pytest.fixture(params=[False, True], ids=["flags<4096", "full16bit"])
def full_range(request):
    return request.param


@pytest.fixture
def make_flags():
    def _make(n, seed=0, full_range=False):
        return generate_flags(n, seed=seed, full_range=full_range)

    return _make


def pospopcnt_ref(x) -> np.ndarray:
    """Shared positional-popcount reference (was copy-pasted in six test
    files — one definition so a width/dtype fix lands everywhere)."""
    x32 = np.asarray(x).astype(np.uint32)
    return np.array(
        [int(np.count_nonzero((x32 >> k) & 1)) for k in range(16)],
        dtype=np.int64,
    )


def assert_counters_equal(expected, actual, counters=None, msg=""):
    expected = np.asarray(expected).astype(np.int64)
    actual = np.asarray(actual).astype(np.int64)
    if counters is not None:
        expected = expected[list(counters)]
        actual = actual[list(counters)]
    np.testing.assert_array_equal(actual, expected, err_msg=msg)
