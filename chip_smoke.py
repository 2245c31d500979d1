#!/usr/bin/env python3
"""Bring-up check of the whole system on NVIDIA GPUs.

    python chip_smoke.py               # phases 0-4 on one card
    python chip_smoke.py --four-cards  # only the four-card paths (phase 5)

Phases (each integer-exact against the NumPy oracle, the native host
counter where it built, and the NA12878 construction's own counters):

0. device: nvidia-smi's name and power limit, JAX version, device kind
   (probed in a short child process), native host library status;
1. card tests: ``pytest -m gpu`` in a child, before this process opens
   the card (one process per card);
2. the bit-sliced kernel in each mode at real widths — the full NA12878
   column (824,541,892 words) and 2^27 + 12345 random words — against
   the references, with each kernel's memory analysis;
3. the main path through the user-facing entry points at NA12878 size:
   flagstats_u16 / pospopcnt_u16 (explicit and automatic tier),
   flagstat_stream over a framed LZ4 file, the CLI's flagstat and
   inmemory commands in-process, and flagstat_sharded on a one-device
   mesh;
4. each kernel mode timed against its plain XLA version on the resident
   column;
5. (--four-cards) flagstat_sharded over a 1-D mesh of four cards and
   flagstat_multihost in four processes (one card each), against the
   one-card counters and the oracle.

Exits non-zero if any phase fails, when JAX finds no GPU, or when the
repository is not beside this file. The last stdout line is one JSON
object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""
from __future__ import annotations

import argparse
import json
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, NVIDIA data sheet
NA12878_WORDS = 824_541_892
RANDOM_WORDS = (1 << 27) + 12345
INMEMORY_WORDS = 1 << 26
SCALE_DIVISOR = 1               # NA12878 at full size
MASKED_POSITIONAL = (4, 5)      # random REVERSE/MREVERSE in the synthetic set


class PhaseError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise PhaseError(what)
    log(f"  ok: {what}")


def nvidia_smi() -> str:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise PhaseError(f"nvidia-smi unavailable: {exc}") from exc
    if r.returncode != 0 or not r.stdout.strip():
        raise PhaseError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip()


def oracle(x, chunk: int = 1 << 26):
    """flagstat_numpy over bounded chunks (host memory stays small)."""
    import numpy as np

    from libflagstats_tpu.oracle import flagstat_numpy

    acc = np.zeros(32, dtype=np.uint64)
    for start in range(0, x.size, chunk):
        flagstat_numpy(x[start:start + chunk], out=acc)
    return acc.astype(np.int64)


def pospopcnt_ref(x, chunk: int = 1 << 26):
    import numpy as np

    acc = np.zeros(16, dtype=np.int64)
    for start in range(0, x.size, chunk):
        part = x[start:start + chunk]
        for k in range(16):
            acc[k] += np.count_nonzero((part >> k) & 1)
    return acc


def same(got, want, idx=None) -> bool:
    import numpy as np

    got = np.asarray(got).astype(np.int64)
    want = np.asarray(want).astype(np.int64)
    if idx is not None:
        got, want = got[list(idx)], want[list(idx)]
    return bool(np.array_equal(got, want))


def not_masked_positional():
    return [k for k in range(32) if k % 16 not in MASKED_POSITIONAL]


# --------------------------------------------------------------------------
# phases 0-1 (this process stays off the card)
# --------------------------------------------------------------------------

def phase0(native: bool = True) -> tuple[str, dict]:
    log("== phase 0: device")
    smi = nvidia_smi()
    log(f"nvidia-smi: {smi}")
    probe = subprocess.run(
        [sys.executable, "-c",
         "import json, jax; d = jax.devices(); print(json.dumps({"
         "'version': jax.__version__, 'backend': jax.default_backend(), "
         "'platform': d[0].platform, 'kind': d[0].device_kind, "
         "'count': len(d)}))"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    if probe.returncode != 0:
        raise PhaseError(f"JAX device probe failed: {probe.stderr[-2000:]}")
    info = json.loads(probe.stdout.strip().splitlines()[-1])
    log(f"jax {info['version']}: backend {info['backend']}, "
        f"{info['count']} x {info['kind']}")
    check(info["backend"] == "gpu", "JAX runs on a GPU")
    if native:
        from libflagstats_tpu.ops import native_host

        t = time.perf_counter()
        built = native_host.available()
        log(f"native host library built here: {built} "
            f"({time.perf_counter() - t:.1f} s)")
    return smi, info


def phase1() -> None:
    log("== phase 1: card tests (pytest -m gpu, child process)")
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu",
         "-p", "no:cacheprovider", "tests/"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    tail = "\n".join(r.stdout.strip().splitlines()[-15:])
    log(tail)
    check(r.returncode == 0 and " passed" in tail and "skipped" not in tail,
          "every gpu-marked test passed on the card")


# --------------------------------------------------------------------------
# phases 2-4 (this process owns the card)
# --------------------------------------------------------------------------

def load_columns():
    import numpy as np

    from libflagstats_tpu.datasets import synth_na12878
    from libflagstats_tpu.ops import native_host

    t = time.perf_counter()
    col, expected = synth_na12878(scale_divisor=SCALE_DIVISOR, seed=0)
    log(f"NA12878 column: {col.size} words (scale_divisor "
        f"{SCALE_DIVISOR}), built in {time.perf_counter() - t:.1f} s")
    check(SCALE_DIVISOR > 1 or col.size == NA12878_WORDS,
          "the column has the published record count")
    ref = oracle(col)
    check(same(ref, expected, not_masked_positional()),
          "oracle equals the NA12878 construction")
    rng = np.random.default_rng(27)
    rnd = rng.integers(0, 1 << 16, size=RANDOM_WORDS, dtype=np.uint16)
    cols = {
        "na12878": {"x": col, "ref": ref, "pp": pospopcnt_ref(col),
                    "expected": expected},
        "random": {"x": rnd, "ref": oracle(rnd), "pp": pospopcnt_ref(rnd)},
    }
    if native_host.available():
        for name, c in cols.items():
            check(same(native_host.flagstat_native(c["x"]), c["ref"]),
                  f"native host counter equals the oracle ({name})")
            check(same(native_host.pospopcnt_native(c["x"]), c["pp"]),
                  f"native host pospopcnt equals the reference ({name})")
    return cols


def phase2(cols) -> None:
    import jax
    import jax.numpy as jnp

    from libflagstats_tpu import flags as F
    from libflagstats_tpu.ops import pallas_kernels as PK
    from libflagstats_tpu.ops.xla_ops import pospopcnt_u16_matmul

    log("== phase 2: kernel against the references at real widths")
    report_idx = list(F.REPORT_COUNTERS)
    masked = [k + s for k in (1, 3, 4, 5) for s in (0, 16)]
    for name, c in cols.items():
        x = jax.device_put(c["x"])
        n = c["x"].size
        for mode in PK.MODES:
            compiled = PK.stream_partials.lower(x, mode).compile()
            log(f"  {name} {mode} memory_analysis: "
                f"{compiled.memory_analysis()}")
            partial = compiled(x)
            check(partial.shape[1] == PK.OUT_STREAMS,
                  f"{name} {mode}: partial sums are (programs, 32)")
        full = jax.jit(lambda a: PK.flagstat_pallas(a, n=n))(x)
        check(same(full, c["ref"]), f"{name}: full parity equals the oracle")
        if "expected" in c:
            check(same(full, c["expected"], not_masked_positional()),
                  f"{name}: full parity equals the NA12878 construction")
        rep = jax.jit(lambda a: PK.flagstat_pallas(a, n=n, report=True))(x)
        check(same(rep, c["ref"], report_idx)
              and same(rep, [0] * 32, masked),
              f"{name}: report mode equals the oracle on the report counters")
        pp = jax.jit(PK.pospopcnt_u16_pallas)(x)
        check(same(pp, c["pp"]), f"{name}: pospopcnt equals the reference")
        if name == "random":
            mm = jax.jit(pospopcnt_u16_matmul)(x)
            check(same(mm, c["pp"]),
                  "int8 ones-matmul pospopcnt equals the reference")
        del x


def phase3(cols, tmp: Path) -> None:
    import contextlib
    import io

    import jax
    import numpy as np

    import libflagstats_tpu as lfs
    from libflagstats_tpu import cli
    from libflagstats_tpu.datasets import na12878_report_values
    from libflagstats_tpu.io import codec as C
    from libflagstats_tpu.parallel.sharded import data_mesh
    from libflagstats_tpu.report import counters_to_report

    log("== phase 3: main path through the entry points")
    c = cols["na12878"]
    col, ref = c["x"], c["ref"]
    published = na12878_report_values(SCALE_DIVISOR)
    want_text = counters_to_report(ref.astype(np.uint64)).text()

    got = lfs.flagstats_u16(col, impl="pallas")
    check(same(got, ref), "flagstats_u16(impl='pallas') equals the oracle")
    rep = counters_to_report(got)
    check(all(getattr(rep, key) == (value, 0)
              for key, value in published.items()),
          "its report equals the published NA12878 report, line by line")
    got = lfs.flagstats_u16(col)
    from libflagstats_tpu.ops.dispatch import auto_impl

    log(f"  automatic tier at {col.size} words: {auto_impl(col.size)}")
    check(same(got, ref), "flagstats_u16(impl=None) equals the oracle")
    check(same(lfs.pospopcnt_u16(col, impl="pallas"), c["pp"]),
          "pospopcnt_u16(impl='pallas') equals the reference")
    check(same(lfs.pospopcnt_u16(col), c["pp"]),
          "pospopcnt_u16(impl=None) equals the reference")

    path = tmp / "na12878.lz4"
    t = time.perf_counter()
    C.write_framed(path, col, codec="lz4", level=1)
    log(f"  framed LZ4 file written at scale_divisor {SCALE_DIVISOR} in "
        f"{time.perf_counter() - t:.1f} s ({path.stat().st_size} bytes)")
    t = time.perf_counter()
    got = lfs.flagstat_stream(path, codec="lz4", impl="pallas")
    log(f"  flagstat_stream(impl='pallas'): {time.perf_counter() - t:.2f} s")
    check(same(got, ref), "flagstat_stream(impl='pallas') equals the oracle")

    for argv in (["flagstat", str(path), "--impl", "pallas"],
                 ["flagstat", str(path)]):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        check(rc == 0 and out.getvalue().strip() == want_text.strip(),
              f"cli {' '.join(argv[:1] + argv[2:])} prints the oracle's "
              "report")
    log("  report: " + want_text.replace("\n", "\n  report: "))

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["inmemory", "-n", str(INMEMORY_WORDS)])
    log("  " + out.getvalue().strip().replace("\n", "\n  "))
    check(rc == 0 and "MISMATCH" not in out.getvalue()
          and "pallas" in out.getvalue(),
          "cli inmemory: every tier, the GPU tiers included, is exact")

    got = lfs.flagstat_sharded(col, mesh=data_mesh(jax.devices()[:1]),
                               impl="pallas")
    check(same(got, ref),
          "flagstat_sharded(impl='pallas') on a one-device mesh equals "
          "the oracle")


def device_seconds(fn, x, reps: int = 20) -> float:
    """Mean seconds of one call: warm-up, then ``reps`` back-to-back
    calls synchronised once with block_until_ready."""
    import jax

    jax.block_until_ready(fn(x))
    t = time.perf_counter()
    for _ in range(reps):
        out = fn(x)
    jax.block_until_ready(out)
    return (time.perf_counter() - t) / reps


def phase4(cols, smi: str) -> None:
    import jax
    import jax.numpy as jnp

    from libflagstats_tpu.ops import pallas_kernels as PK
    from libflagstats_tpu.ops.xla_ops import pospopcnt_u16_xla, stream_sums_xla

    log("== phase 4: kernel against plain XLA on the resident column")
    x = jax.device_put(cols["na12878"]["x"])
    n = x.size
    rows = {
        "flagstat (29 streams)": (
            jax.jit(lambda a: PK.stream_sums_pallas(a)),
            jax.jit(stream_sums_xla)),
        "flagstat_report (21 streams)": (
            jax.jit(lambda a: PK.stream_sums_pallas(a, report=True)),
            jax.jit(stream_sums_xla)),
        "pospopcnt (16 streams)": (
            jax.jit(PK.pospopcnt_u16_pallas), jax.jit(pospopcnt_u16_xla)),
        "read roofline (sum of the column as uint32)": (
            jax.jit(lambda a: jnp.sum(jax.lax.bitcast_convert_type(
                a.reshape(-1, 2), jnp.uint32), dtype=jnp.uint32)), None),
    }
    for name, (kernel, plain) in rows.items():
        for label, fn in (("kernel", kernel), ("plain XLA", plain)):
            if fn is None:
                continue
            sec = device_seconds(fn, x)
            log(f"  [{smi}] {name} {label}: {sec * 1e3:.4f} ms, "
                f"{n / sec / 1e9:.1f} Gwords/s, "
                f"{2 * n / sec / PEAK_BYTES_PER_S:.3f} of 3.35 TB/s")


# --------------------------------------------------------------------------
# phase 5 (--four-cards)
# --------------------------------------------------------------------------

def multihost_worker(pid: int, port: int, out_path: str) -> int:
    """One of four processes of the multihost leg: pinned to card
    ``pid``, counts its quarter of the NA12878 column."""
    import numpy as np

    from libflagstats_tpu.datasets import synth_na12878
    from libflagstats_tpu.parallel import multihost

    multihost.initialize(coordinator_address=f"localhost:{port}",
                         num_processes=4, process_id=pid,
                         local_device_ids=pid)
    import jax

    col, _ = synth_na12878(scale_divisor=SCALE_DIVISOR, seed=0)
    shard = np.array_split(col, 4)[pid]
    counters = multihost.flagstat_multihost(
        shard, pad_to_words=-(-col.size // 4), impl="pallas")
    if pid == 0:
        Path(out_path).write_text(json.dumps({
            "counters": [int(v) for v in counters],
            "devices": len(jax.devices()),
            "local_devices": len(jax.local_devices())}))
    return 0


def phase5(smi: str) -> None:
    from libflagstats_tpu.datasets import synth_na12878

    log("== phase 5: four cards")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out_path = ROOT / ".chip_smoke_multihost.json"
    out_path.unlink(missing_ok=True)
    # this process stays off the cards while the four workers run
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--multihost-worker",
         str(pid), str(port), str(out_path)], cwd=ROOT)
        for pid in range(4)]
    try:
        t = time.perf_counter()
        col, expected = synth_na12878(scale_divisor=SCALE_DIVISOR, seed=0)
        ref = oracle(col)
        check(same(ref, expected, not_masked_positional()),
              "oracle equals the NA12878 construction")
        rcs = [p.wait(timeout=900) for p in procs]
        log(f"  multihost processes finished in "
            f"{time.perf_counter() - t:.1f} s: rcs {rcs}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(rcs == [0, 0, 0, 0], "four multihost processes exited cleanly")
    mh = json.loads(out_path.read_text())
    out_path.unlink()
    check(mh["devices"] == 4 and mh["local_devices"] == 1,
          "each multihost process is pinned to one card of four")
    check(same(mh["counters"], ref),
          "flagstat_multihost in 4 processes equals the oracle")

    import jax

    from libflagstats_tpu.parallel.sharded import data_mesh, flagstat_sharded

    check(len(jax.devices()) == 4, "four cards visible")
    one = flagstat_sharded(col, mesh=data_mesh(jax.devices()[:1]),
                           impl="pallas")
    four = flagstat_sharded(col, mesh=data_mesh(jax.devices()[:4]),
                            impl="pallas")
    check(same(one, ref), "one-card flagstat_sharded equals the oracle")
    check(same(four, one), "four-card flagstat_sharded equals one card")
    check(same(four, mh["counters"]),
          "four-card sharded equals the four-process multihost run")
    log(f"  [{smi.splitlines()[0]}] x4: sharded and multihost exact at "
        f"{col.size} words")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the four-card paths (needs 4 GPUs)")
    p.add_argument("--multihost-worker", nargs=3, metavar=("PID", "PORT",
                                                            "OUT"),
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if not (ROOT / "libflagstats_tpu" / "__init__.py").is_file():
        print("chip_smoke: the repository is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    if args.multihost_worker:
        pid, port, out = args.multihost_worker
        return multihost_worker(int(pid), int(port), out)
    t0 = time.perf_counter()
    try:
        smi, info = phase0(native=not args.four_cards)
        if args.four_cards:
            phase5(smi)
        else:
            phase1()
            import jax

            from libflagstats_tpu.config import enable_compilation_cache

            enable_compilation_cache()
            check(jax.default_backend() == "gpu", "this process runs on a GPU")
            cols = load_columns()
            phase2(cols)
            tmp = ROOT / ".chip_smoke_tmp"
            tmp.mkdir(exist_ok=True)
            try:
                phase3(cols, tmp)
            finally:
                for f in tmp.iterdir():
                    f.unlink()
                tmp.rmdir()
            phase4(cols, smi)
    except PhaseError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    import jax

    devices = jax.devices()
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
