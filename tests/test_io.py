"""IO subsystem tests: framed block codec (LZ4 clean-room, Zstd), round
trips, reference frame layout, CLI drivers."""
import io
import struct

import numpy as np
import pytest

from libflagstats_tpu.io import codec as C
from libflagstats_tpu.io import native_lib, samio
from libflagstats_tpu.oracle import flagstat_numpy, generate_flags


@pytest.fixture(scope="module")
def native():
    lib = native_lib.load()
    if lib is None:
        pytest.skip("native IO lib unavailable")
    return lib


@pytest.mark.parametrize("codec", ["raw", "lz4", "zstd"])
@pytest.mark.parametrize("n", [0, 1, 1000, 700_000])
def test_framed_roundtrip(tmp_path, codec, n):
    x = generate_flags(n, seed=n)
    path = tmp_path / f"flags_{codec}_{n}.bin"
    info = C.write_framed(path, x, codec=codec, level=2)
    assert info.raw_bytes == 2 * n
    got = C.read_framed(path, codec)
    np.testing.assert_array_equal(got, x)
    # block-streaming decode agrees too
    parts = list(C.iter_framed_blocks(path, codec))
    got2 = np.concatenate(parts) if parts else np.zeros(0, np.uint16)
    np.testing.assert_array_equal(got2, x)


def test_frame_layout_matches_reference(tmp_path):
    """Each block: int32 raw_len, int32 comp_len, payload; 1,024,000-byte
    blocks (reference: flagstats.cpp:136-138)."""
    n = 600_000  # 1,200,000 bytes -> 2 blocks
    x = generate_flags(n, seed=1)
    path = tmp_path / "flags.raw.framed"
    C.write_framed(path, x, codec="raw")
    data = path.read_bytes()
    raw1, comp1 = struct.unpack_from("<ii", data, 0)
    assert raw1 == C.BLOCK_BYTES == comp1
    raw2, comp2 = struct.unpack_from("<ii", data, 8 + comp1)
    assert raw2 == 2 * n - C.BLOCK_BYTES
    assert len(data) == 16 + comp1 + comp2


def test_lz4_python_fallback_roundtrip():
    x = generate_flags(10_000, seed=3)
    raw = x.tobytes()
    comp = C._lz4_compress_py(raw)
    out = C._lz4_decompress_py(comp, len(raw))
    assert out == raw


def test_lz4_native_vs_python_decoder(native):
    """Native LZ4 encoder output must decode identically via the
    independent pure-Python decoder (cross-validation)."""
    rng = np.random.default_rng(0)
    # compressible data: FLAG-like with repeats
    x = rng.integers(0, 64, size=200_000, dtype=np.uint16)
    raw = x.tobytes()
    for effort in (0, 4):
        comp = C.compress_block(raw, "lz4", level=effort + 1)
        assert len(comp) < len(raw)  # actually compresses
        out = C._lz4_decompress_py(comp, len(raw))
        assert out == raw


def test_lz4_incompressible_data(native):
    rng = np.random.default_rng(1)
    raw = rng.bytes(100_000)
    comp = C.compress_block(raw, "lz4", level=1)
    assert C.decompress_block(comp, len(raw), "lz4") == raw


@pytest.mark.parametrize("threads", [1, 4])
def test_parallel_stream_decode(tmp_path, native, threads):
    x = generate_flags(2_000_000, seed=9)
    path = tmp_path / "big.lz4"
    C.write_framed(path, x, codec="lz4", level=1)
    got = C.read_framed(path, "lz4", n_threads=threads)
    np.testing.assert_array_equal(got, x)


def test_utility_and_generate(tmp_path):
    text = io.StringIO("99 147 1024\n512\n")
    out = io.BytesIO()
    n = samio.text_to_binary(text, out)
    assert n == 4
    vals = np.frombuffer(out.getvalue(), dtype="<u2")
    np.testing.assert_array_equal(vals, [99, 147, 1024, 512])

    path = tmp_path / "gen.bin"
    vals = samio.generate_binary(1000, path, seed=0)
    got = samio.read_binary(path)
    np.testing.assert_array_equal(got, vals)
    assert got.max() < 4096


def test_cli_end_to_end(tmp_path):
    """generate -> compress -> decompress+flagstat through the CLI."""
    from libflagstats_tpu.cli import main

    bin_path = tmp_path / "flags.bin"
    samio.generate_binary(50_000, bin_path, seed=5)
    lz4_path = tmp_path / "flags.lz4"
    assert main(["compress", str(bin_path), "--codec", "lz4", "--level", "2",
                 "-o", str(lz4_path)]) == 0

    import contextlib

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["decompress", str(lz4_path), "--mode", "d",
                     "--codec", "lz4", "--impl", "numpy"]) == 0
    report = buf.getvalue()
    x = samio.read_binary(bin_path)
    ref = flagstat_numpy(x)
    expected_total = f"{int(ref[9])} + {int(ref[25])} in total"
    assert expected_total in report


def test_lz4_system_and_own_encoders(native):
    """Both compressor backends (system liblz4 when present, clean-room
    fallback) must produce streams our hardened decoder round-trips;
    the HC and fast/acceleration families are exercised (reference
    knobs: flagstats.cpp:110,147)."""
    import ctypes

    rng = np.random.default_rng(3)
    vals = np.array([99, 147, 83, 163, 1123, 77, 141], dtype=np.uint16)
    raw = vals[rng.integers(0, 7, 500_000)].tobytes()
    bound = native.lfs_lz4_bound(len(raw))
    dst = ctypes.create_string_buffer(bound)
    out = ctypes.create_string_buffer(len(raw))
    for own_only in (0, 1):
        for sys_decode in (0, 1):
            native.lfs_lz4_set_own_only(own_only)
            native.lfs_lz4_set_sys_decode(sys_decode)
            try:
                for effort in (-9, 0, 4, 9):
                    r = native.lfs_lz4_compress(
                        raw, len(raw), ctypes.cast(dst, ctypes.c_void_p),
                        bound, effort)
                    assert r > 0
                    d = native.lfs_lz4_decompress(
                        dst.raw[:r], r, ctypes.cast(out, ctypes.c_void_p),
                        len(raw))
                    assert d == len(raw) and out.raw == raw, \
                        (own_only, sys_decode, effort)
                    # the clean-room decoder must agree with whatever
                    # the dispatcher picked
                    out2 = ctypes.create_string_buffer(len(raw))
                    d2 = native.lfs_lz4_decompress_own(
                        dst.raw[:r], r, ctypes.cast(out2, ctypes.c_void_p),
                        len(raw))
                    assert d2 == len(raw) and out2.raw == raw, \
                        (own_only, sys_decode, effort)
            finally:
                native.lfs_lz4_set_own_only(0)
                native.lfs_lz4_set_sys_decode(0)


def test_lz4_fast_acceleration_levels(tmp_path):
    """Negative lz4 levels select the LZ4-fast acceleration family end
    to end, and the output naming matches the reference scheme."""
    x = generate_flags(300_000, seed=17)
    for level in (-9, 0, 1):
        path = tmp_path / f"a{level}.lz4"
        C.write_framed(path, x, codec="lz4", level=level)
        got = C.read_framed(path, "lz4")
        np.testing.assert_array_equal(got, x)
    assert C.codec_filename("f", "lz4", -9).endswith("_fast_a10.lz4")
    assert C.codec_filename("f", "lz4", 1).endswith("_fast_a1.lz4")
    assert C.codec_filename("f", "lz4", 9).endswith("_HC_c9.lz4")


def test_cli_instrumented_smoke():
    """`cli instrumented` runs on CPU and reports a passing check column
    for every variant (round-1 verdict test hole)."""
    import contextlib

    from libflagstats_tpu.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["instrumented", "-n", "65536", "-i", "1",
                     "--no-roofline"]) == 0
    out = buf.getvalue().splitlines()
    assert out[0].startswith("variant\t")
    assert len(out) >= 3           # header + numpy + xla
    variant_rows = out[1:out.index("")] if "" in out else out[1:]
    assert len(variant_rows) >= 2
    for row in variant_rows:
        assert row.endswith("ok"), row
    if "" in out:                  # native lib present: counted perf table
        perf = out[out.index("") + 1:]
        # hosts where perf_event_open is blocked entirely (seccomp,
        # paranoid>=3) get the labeled-unavailable line instead of rows
        assert (perf[0].startswith("kernel\t")
                or perf[0].startswith("perf_event unavailable"))
        if perf[0].startswith("kernel\t"):
            assert any("lfs_flagstat_u16" in r for r in perf)


def test_cli_kernels_smoke(monkeypatch, capsys):
    """`cli kernels` (dispatch-free per-kernel table) refuses a device
    with no known peak, and runs on the CPU once it has one."""
    import contextlib

    import jax

    from libflagstats_tpu.bench import harness
    from libflagstats_tpu.cli import main

    assert main(["kernels", "-n", "4096", "-i", "1"]) == 1
    assert "no nominal memory bandwidth" in capsys.readouterr().err
    monkeypatch.setitem(harness.HBM_NOMINAL, jax.devices()[0].device_kind,
                        1e12)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["kernels", "-n", "65536", "-i", "1"]) == 0
    out = buf.getvalue().splitlines()
    assert out[0].startswith("kernel\t")
    assert any(row.startswith("xla\t") for row in out[1:])
    assert not any("MISMATCH" in row for row in out)


def test_scan_and_range_decode(tmp_path):
    x = generate_flags(1_700_000, seed=13)
    path = tmp_path / "r.lz4"
    info = C.write_framed(path, x, codec="lz4", level=1)
    frames = C.scan_frames(path)
    assert len(frames) == info.n_blocks
    assert sum(r for _, r, _ in frames) == 2 * x.size

    # shard into 3 ranges; concatenation must reproduce the stream
    ranges = C.shard_block_ranges(len(frames), 3)
    assert ranges[0][0] == 0 and ranges[-1][1] == len(frames)
    parts = [C.read_framed_range(path, "lz4", a, b) for a, b in ranges]
    np.testing.assert_array_equal(np.concatenate(parts), x)


def test_shard_block_ranges_edge():
    assert C.shard_block_ranges(5, 3) == [(0, 2), (2, 4), (4, 5)]
    assert C.shard_block_ranges(2, 4) == [(0, 1), (1, 2), (2, 2), (2, 2)]


def test_empty_block_roundtrip():
    for codec in ("raw", "lz4", "zstd"):
        comp = C.compress_block(b"", codec, 1)
        assert C.decompress_block(comp, 0, codec) == b""


def test_corrupt_negative_frame_header(tmp_path):
    bad = tmp_path / "bad.bin"
    bad.write_bytes(struct.pack("<ii", -5, -9) + b"xxxx")
    with pytest.raises((ValueError, RuntimeError)):
        C.read_framed(bad, "raw")
    with pytest.raises(ValueError):
        C.scan_frames(bad)
    with pytest.raises(ValueError):
        list(C.iter_framed(bad))


def test_corrupt_odd_raw_len_rejected(tmp_path):
    """A crafted odd raw_len must be rejected before the native decoder
    writes raw_total bytes into a raw_total//2-word (raw_total-1-byte)
    buffer (advisor finding, round 1)."""
    bad = tmp_path / "odd.bin"
    bad.write_bytes(struct.pack("<ii", 5, 5) + b"abcde")
    with pytest.raises(ValueError, match="odd raw length"):
        C.read_framed(bad, "raw")
    with pytest.raises(ValueError, match="odd raw length"):
        C.scan_frames(bad)
    # the streaming parser must reject the identical input identically —
    # not surface it later as an np.frombuffer size error
    with pytest.raises(ValueError, match="odd raw length"):
        list(C.iter_framed(bad))


def test_raw_codec_truncated_block_rejected(tmp_path):
    """CODEC_RAW fallback must reject a payload whose size disagrees
    with the declared raw_len, exactly like the native decoder — a
    truncated raw frame must not silently yield short counts."""
    with pytest.raises(ValueError, match="corrupt raw block"):
        C.decompress_block(b"\x00" * 10, 16, "raw")
    # native path end-to-end: frame declaring more raw bytes than payload
    x = np.arange(64, dtype=np.uint16)
    path = tmp_path / "t.bin"
    C.write_framed(path, x, codec="raw")
    data = bytearray(path.read_bytes())
    data[0:4] = struct.pack("<i", 256)  # raw_len lies (payload is 128 B)
    path.write_bytes(bytes(data))
    with pytest.raises((ValueError, RuntimeError)):
        C.read_framed(path, "raw")


def test_lz4_python_truncated_sequence_is_valueerror():
    """Truncation inside a match header must surface as the corrupt-
    stream ValueError contract, not IndexError (round-2 review)."""
    good = C._lz4_compress_py(b"abcdabcdabcdabcd")
    # every strict prefix MUST raise (short output fails the final
    # length check even when the prefix parses) — a bare try/except
    # would also pass on silent success, hiding removal of that check
    for cut in range(1, len(good)):
        with pytest.raises(ValueError):
            C._lz4_decompress_py(good[:cut], 16)
    # crafted: token with literal run then truncated offset byte
    with pytest.raises(ValueError):
        C._lz4_decompress_py(bytes([0x12, 0x41, 0x05]), 32)


def test_read_framed_trailing_garbage_rejected(tmp_path):
    """read_framed now shares scan_frames' validated header walk, which
    rejects trailing bytes the old inline walk silently skipped."""
    x = np.arange(1024, dtype=np.uint16)
    path = tmp_path / "g.lz4"
    C.write_framed(path, x, codec="lz4", level=1)
    with open(path, "ab") as f:
        f.write(b"\x01\x02\x03")        # 3 garbage bytes (not a header)
    with pytest.raises(ValueError):
        C.read_framed(path, "lz4")


def test_text_to_binary_chunked_boundaries(tmp_path):
    """The text parser reads in bounded chunks (GB-scale ingest path);
    tokens split across chunk boundaries must reassemble exactly."""
    import io as _io

    vals = np.arange(0, 3000, 7, dtype=np.uint16) % 4096
    text = " ".join(str(v) for v in vals.tolist())
    for chunk in (1, 3, 16, 1 << 24):   # pathological to normal
        out = _io.BytesIO()
        n = samio.text_to_binary(_io.StringIO(text), out, chunk_chars=chunk)
        got = np.frombuffer(out.getvalue(), dtype="<u2")
        assert n == vals.size and (got == vals).all(), chunk
    # bytes input + trailing whitespace + empty input
    out = _io.BytesIO()
    assert samio.text_to_binary(_io.BytesIO(b"7 11 13\n"), out, 4) == 3
    out = _io.BytesIO()
    assert samio.text_to_binary(_io.StringIO(""), out) == 0


def test_generate_binary_matches_generate_flags(tmp_path):
    """File-based and in-memory synthetic data share ONE draw recipe —
    the two entry points must stay bit-identical per seed."""
    from libflagstats_tpu.oracle import generate_flags

    p = tmp_path / "g.bin"
    written = samio.generate_binary(5000, p, seed=42, full_range=True)
    assert (written == generate_flags(5000, seed=42, full_range=True)).all()
    assert (samio.read_binary(p) == written).all()


def test_frame_parsers_agree_on_corrupted_streams(tmp_path):
    """Differential fuzz: iter_framed (streaming) and scan_frames
    (indexing) must accept/reject IDENTICAL inputs — a divergence means
    multi-host block assignment (scan) could disagree with single-host
    decode (iter) about the same file."""
    rng = np.random.default_rng(77)
    x = generate_flags(40_000, seed=7)
    base_path = tmp_path / "base.lz4"
    C.write_framed(base_path, x, codec="lz4", level=1, block_bytes=9_000)
    base = bytearray(base_path.read_bytes())

    def verdicts(data: bytes):
        p = tmp_path / "fuzz.bin"
        p.write_bytes(data)
        try:
            blocks = [(r, len(pl)) for r, pl in C.iter_framed(p)]
            it = ("ok", blocks)
        except ValueError:
            it = ("reject", None)
        try:
            frames = [(r, c) for _, r, c in C.scan_frames(p)]
            sc = ("ok", frames)
        except ValueError:
            sc = ("reject", None)
        return it, sc

    cases = [bytes(base)]
    for _ in range(120):
        kind = rng.integers(0, 3)
        b = bytearray(base)
        if kind == 0:    # truncate anywhere (mid-header, mid-payload)
            b = b[: int(rng.integers(0, len(b)))]
        elif kind == 1:  # flip bytes, biased toward headers
            for _ in range(int(rng.integers(1, 4))):
                pos = int(rng.integers(0, min(len(b), 64)))
                b[pos] ^= int(rng.integers(1, 256))
        else:            # append garbage (1..12 bytes)
            b += bytes(rng.integers(0, 256, size=int(rng.integers(1, 13)),
                                    dtype=np.uint8))
        cases.append(bytes(b))

    for i, data in enumerate(cases):
        it, sc = verdicts(data)
        assert it[0] == sc[0], (i, it[0], sc[0])
        if it[0] == "ok":   # and on acceptance, identical frame layout
            assert it[1] == sc[1], i
