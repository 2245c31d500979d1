"""Multi-host API degenerate-path and scaling-sweep tests (virtual mesh)."""
import jax
import numpy as np
import pytest

from libflagstats_tpu.oracle import flagstat_numpy, generate_flags
from libflagstats_tpu.parallel.multihost import flagstat_multihost, scaling_sweep

from conftest import assert_counters_equal


def test_multihost_single_process():
    x = generate_flags(200_000, seed=31, full_range=True)
    got = flagstat_multihost(x, impl="xla")
    assert_counters_equal(flagstat_numpy(x), got)


def test_scaling_sweep_sane():
    """Falsifiable properties of the sweep on the virtual CPU mesh.

    Per-device scaling efficiency is NOT assertable here — the 8
    'devices' share the same physical cores, so aggregate throughput is
    roughly flat by construction. What must hold: (a) the sweep's
    1-device number agrees with a direct sync-correct kernel_time
    measurement of the same sharded fn (catches the round-1 bug where
    the sweep timed one dispatch), and (b) sharding wider must not
    collapse aggregate throughput (a serialized or re-executing mesh
    composition would)."""
    import jax.numpy as jnp

    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")

    from libflagstats_tpu.bench.harness import kernel_time
    from libflagstats_tpu.parallel.sharded import (
        SHARD_GRANULE, data_mesh, make_sharded_counter_fn, pad_for_mesh,
    )

    n = 1 << 21
    # the shared 4-core host jitters wildly under concurrent load
    # (observed 14x slowdowns); re-measure both sides a few times and
    # pass if ANY attempt shows agreement — the round-1 bug this guards
    # against (timing a no-op) fails every attempt by ~100x
    last = None
    for _ in range(3):
        res = scaling_sweep(n_words=n, impl="xla",
                            device_counts=[1, len(jax.devices())], iters=2)
        assert [r["devices"] for r in res] == [1, len(jax.devices())]

        # (a) cross-check the 1-device point against a direct measurement
        mesh = data_mesh(jax.devices()[:1])
        fn = make_sharded_counter_fn(mesh, impl="xla")
        x = generate_flags(n, seed=0, full_range=True)
        padded = pad_for_mesh(x, 1, SHARD_GRANULE)
        y = jax.device_put(padded)
        direct = kernel_time(lambda a: fn(a, jnp.int32(n)), y, iters=2)
        ratio = res[0]["min_s"] / direct
        ok_a = 1 / 3 < ratio < 3
        # (b) aggregate throughput must not collapse when sharded wide
        ok_b = res[-1]["words_per_s"] > 0.3 * res[0]["words_per_s"]
        if ok_a and ok_b:
            return
        last = (res[0]["min_s"], direct, ratio,
                res[0]["words_per_s"], res[-1]["words_per_s"])
    raise AssertionError(f"no agreeing attempt in 3: {last}")


def test_multihost_file_single_process(tmp_path):
    from libflagstats_tpu.io import codec as C
    from libflagstats_tpu.parallel.multihost import flagstat_multihost_file

    x = generate_flags(1_200_000, seed=41, full_range=True)
    path = tmp_path / "mh.lz4"
    C.write_framed(path, x, codec="lz4", level=1)
    got = flagstat_multihost_file(path, codec="lz4", impl="xla")
    assert_counters_equal(flagstat_numpy(x), got)


def test_multihost_padded_derived_total(tmp_path):
    """total_words must default to the TRUE pre-pad size: counter 9 is
    derived as total - n_fail, so counting pad words would inflate the
    pass-total (round-2 review). Single-process, uneven-pad analogue."""
    x = generate_flags(100_003, seed=7, full_range=True)  # odd size
    got = flagstat_multihost(x, impl="xla", pad_to_words=120_000)
    assert_counters_equal(flagstat_numpy(x), got)


def test_multihost_pad_smaller_than_shard_raises():
    x = generate_flags(4096, seed=1)
    with pytest.raises(ValueError, match="pad_to_words"):
        flagstat_multihost(x, impl="xla", pad_to_words=1024)


def test_multihost_chunks_past_device_cap(monkeypatch):
    """Past the int32 cap the multihost entry splits into accumulating
    rounds (per-round derived totals re-agreed globally) instead of
    raising (round-2 verdict next #3)."""
    from libflagstats_tpu.ops import dispatch as D

    monkeypatch.setattr(D, "DEVICE_WORD_CAP", 70_000)
    x = generate_flags(200_003, seed=53, full_range=True)
    got = flagstat_multihost(x, impl="xla")
    assert_counters_equal(flagstat_numpy(x), got)


def test_scaling_efficiency_arithmetic(monkeypatch):
    """The efficiency column must be words_per_s / (base_words_per_s *
    devices) — asserted against injected deterministic timings, so the
    formula (not the hardware) is what's tested (round-2 verdict next
    #6)."""
    from libflagstats_tpu.parallel import multihost as M

    # perfect scaling: time halves when devices double
    fake = {1: 0.08, 2: 0.04, 4: 0.02}

    class _State:
        nd = 1

    def fake_mesh(devs=None):
        _State.nd = len(devs) if devs is not None else _State.nd
        from libflagstats_tpu.parallel.sharded import data_mesh

        return data_mesh(devs)

    monkeypatch.setattr(M, "data_mesh", fake_mesh)
    monkeypatch.setattr(M, "make_sharded_counter_fn",
                        lambda mesh, impl=None: (lambda a, n: None))
    monkeypatch.setattr(M, "kernel_time",
                        lambda fn, y, iters=3: fake[_State.nd])
    monkeypatch.setattr(M, "pad_for_mesh", lambda x, s, g: x)
    import jax

    monkeypatch.setattr(jax, "device_put", lambda x, s=None: x)

    n = 1 << 20
    res = M.scaling_sweep(n_words=n, impl="xla", device_counts=[1, 2, 4])
    assert [r["devices"] for r in res] == [1, 2, 4]
    for r in res:
        assert r["words_per_s"] == n / fake[r["devices"]]
        assert abs(r["scaling_efficiency"] - 1.0) < 1e-12
    # imperfect scaling must show up proportionally: 4 devices at the
    # 2-device speed -> efficiency 0.5
    fake[4] = 0.04
    res = M.scaling_sweep(n_words=n, impl="xla", device_counts=[1, 4])
    assert abs(res[1]["scaling_efficiency"] - 0.5) < 1e-12
