"""The bit-sliced Pallas kernel in interpret mode on the CPU: the Pallas
plumbing (masked loads past the end, launch geometry, per-program
partial-sum rows) and the wrapper around it (uint32 view, odd lengths,
the card requirement). Compiled for the card, the same kernel is tested
by test_bitsliced_gpu.py."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libflagstats_tpu import flags as F
from libflagstats_tpu.ops import bitslice as B
from libflagstats_tpu.ops import pallas_kernels as PK
from libflagstats_tpu.oracle import flagstat_numpy, generate_flags

from conftest import pospopcnt_ref

G = PK.GROUP_WORDS

#: case -> (words, data kind)
CASES = {
    "one_program": (G - 1234, "random"),
    "programs_with_tail": (3 * G - 777, "random"),
    "empty": (0, "random"),
    "saturated": (G - 1234, "ones"),
}


def _column(n, kind, seed=0):
    if kind == "ones":
        return np.full(n, 0xFFFF, dtype=np.uint16)
    return generate_flags(n, seed=seed, full_range=True)


def _expected_sums(x, mode):
    """Per-stream totals the kernel must produce, from the oracle."""
    if mode == "pospopcnt":
        return pospopcnt_ref(x)
    report = mode == "flagstat_report"
    c_idx = B.REPORT_C_STREAMS if report else B.C_STREAMS
    f_idx = B.REPORT_F_STREAMS if report else B.F_STREAMS
    ref = flagstat_numpy(x).astype(np.int64)
    fail_total = ref[16 + F.FQCFAIL_OFF]
    total = ref[:16] + ref[16:]
    total[F.FQCFAIL_OFF] = fail_total
    return np.array([total[k] for k in c_idx] + [ref[16 + k] for k in f_idx],
                    dtype=np.int64)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mode", PK.MODES)
def test_kernel_interpret(mode, case):
    n, kind = CASES[case]
    x = _column(n, kind, seed=n)
    sums = np.asarray(PK._stream_sums(jnp.asarray(x), mode, True))
    want = _expected_sums(x, mode)
    np.testing.assert_array_equal(sums[:want.size], want)
    assert (sums[want.size:] == 0).all()


@pytest.mark.parametrize("mode", PK.MODES)
def test_kernel_interpret_groups_per_program(mode, monkeypatch):
    """Several groups per program (the loop with a data-dependent trip
    count) and a short last program give the oracle's sums. A launch
    aimed at 2 programs stands in for a column of thousands of groups;
    the traces made under it are dropped before and after."""
    x = _column(5 * G - 99, "random", seed=5)
    monkeypatch.setattr(PK, "TARGET_PROGRAMS", 2)
    PK.stream_partials.clear_cache()
    try:
        deep = np.asarray(PK.stream_partials(jnp.asarray(x), mode, True))
    finally:
        PK.stream_partials.clear_cache()
    assert deep.shape == (2, PK.OUT_STREAMS)
    want = _expected_sums(x, mode)
    np.testing.assert_array_equal(deep.sum(axis=0)[:want.size], want)


def test_launch_geometry():
    """Programs cover every group, none is empty, all but the last do
    the same number of groups."""
    for n_groups in (1, 2, 131, 2112, 2113, 100_652, 262_145):
        programs, per = PK._launch(n_groups)
        assert programs <= PK.TARGET_PROGRAMS
        assert (programs - 1) * per < n_groups <= programs * per


def test_u32_view_pairs_words_and_pads_odd_lengths():
    x = jnp.asarray(np.array([1, 2, 3], dtype=np.uint16))
    v = np.asarray(PK._as_u32(x))
    assert v.dtype == np.uint32 and v.shape == (2,)
    assert v[0] & 0xFFFF in (1, 2) and v[0] >> 16 in (1, 2)
    assert v[1] in (3, 3 << 16)      # the pad word is zero
    with pytest.raises(ValueError, match="uint16"):
        PK._as_u32(jnp.zeros(4, jnp.uint32))


def test_odd_length_counts_exactly():
    x = generate_flags(2 * G + 1, seed=11, full_range=True)
    got = np.asarray(PK.flagstat_pallas(jnp.asarray(x), interpret=True))
    np.testing.assert_array_equal(got, flagstat_numpy(x).astype(np.int64))


def test_partial_sum_rows():
    """One int32 row of OUT_STREAMS per program; columns past the
    mode's stream count stay zero."""
    x = jnp.asarray(_column(3 * G, "random", seed=3))
    for mode, n_streams in (("flagstat", B.N_STREAMS),
                            ("flagstat_report", B.N_REPORT_STREAMS),
                            ("pospopcnt", 16)):
        rows = np.asarray(PK.stream_partials(x, mode, True))
        assert rows.dtype == np.int32 and rows.shape == (3, PK.OUT_STREAMS)
        assert (rows[:, n_streams:] == 0).all()


def test_oversized_column_raises():
    """Past 2 * MAX_U32 words the int32 load offsets would wrap:
    refused at trace time (nothing is allocated here)."""
    big = jax.ShapeDtypeStruct((2 * PK.MAX_U32 + 1,), jnp.uint16)
    with pytest.raises(ValueError, match="split the column"):
        PK.stream_partials.lower(big, "flagstat", True)


def _largest_device_calls():
    """The longest columns the entry points hand one kernel call: a
    DEVICE_WORD_CAP column and a full _device_chunks step, each after
    the 1.25x bucket padding, and a one-device sharded call."""
    from libflagstats_tpu.ops import dispatch as D
    from libflagstats_tpu.parallel.sharded import SHARD_GRANULE

    step = D.DEVICE_WORD_CAP // 8 * 8
    sizes = [D.bucket_target(D.DEVICE_WORD_CAP, D.xla_min()),
             D.bucket_target(step, D.xla_min()),
             -(-D.DEVICE_WORD_CAP // SHARD_GRANULE) * SHARD_GRANULE]
    assert max(sizes) > 0x7FFFFFFF      # the padding goes past 2^31 - 1
    return sizes


@pytest.mark.parametrize("which", range(3))
@pytest.mark.parametrize("mode", PK.MODES)
def test_largest_device_call_traces(mode, which, monkeypatch):
    """Every column the dispatch and sharded paths can pass to one
    call, bucket padding included, is within the kernel's limit. Traced
    for the card (shapes only: nothing is allocated or compiled)."""
    monkeypatch.setattr(PK, "require_gpu", lambda: None)
    n = _largest_device_calls()[which]
    out = jax.eval_shape(functools.partial(PK._stream_sums, mode=mode,
                                           interpret=False),
                         jax.ShapeDtypeStruct((n,), jnp.uint16))
    assert out.shape == (PK.OUT_STREAMS,) and out.dtype == jnp.int32


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown kernel mode"):
        PK._mode_setup("flagstat_raw")


def test_kernel_tier_requires_gpu():
    """Without a GPU the compiled kernel is refused, never silently
    interpreted: every entry that can run it raises."""
    from libflagstats_tpu.ops import dispatch as D
    from libflagstats_tpu.parallel.sharded import flagstat_sharded

    assert jax.default_backend() != "gpu"
    x = generate_flags(4096, seed=1)
    with pytest.raises(RuntimeError, match="needs a GPU"):
        PK.flagstat_pallas(jnp.asarray(x))
    for impl in ("pallas", "pallas_report"):
        with pytest.raises(RuntimeError, match="needs a GPU"):
            D.flagstats_u16(x, impl=impl)
    with pytest.raises(RuntimeError, match="needs a GPU"):
        D.pospopcnt_u16(x, impl="pallas")
    with pytest.raises(RuntimeError, match="needs a GPU"):
        flagstat_sharded(x, impl="pallas")


def test_stream_kernel_tier_requires_gpu(tmp_path):
    from libflagstats_tpu.io import codec as C
    from libflagstats_tpu.io.stream import flagstat_stream

    path = tmp_path / "s.lz4"
    C.write_framed(path, generate_flags(1000, seed=2), codec="lz4")
    with pytest.raises(RuntimeError, match="needs a GPU"):
        flagstat_stream(path, codec="lz4", impl="pallas")


def test_graft_entry_uses_kernel_tier():
    """The single-device entry step runs the card's kernel: without a
    GPU, tracing it raises instead of counting on the CPU."""
    import __graft_entry__ as ge

    fn, (x,) = ge.entry()
    assert x.dtype == np.uint16 and x.size == 64 * G
    with pytest.raises(RuntimeError, match="needs a GPU"):
        jax.jit(fn)(x)
