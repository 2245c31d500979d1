#!/usr/bin/env python3
"""End-to-end NA12878-scale pipeline run (BASELINE.json config #4).

Reconstructs the 824,541,892-read NA12878 FLAG column synthetically
(datasets.synth_na12878 — report-provably identical to the published
flagstat numbers; the real BAM is unreachable from this zero-egress
box), writes it as the reference's framed LZ4 stream, then runs the full
host-decode → device-count pipeline and checks every reported value
against the published report (reference: README.md:177-196; the
reference's own timing of this workload is 0.72 s over LZ4-HC,
README.md:35).

Usage: python tools/na12878_run.py [--scale 1] [--codec lz4] [--keep]

`--container bam|sam|sam.gz` runs the same conformance check through
the container-ingest path instead (BGZF/SAM walkers + read_flags_auto,
the `samtools flagstat <file>` workload end-to-end).
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=1,
                    help="divide the 824M-read dataset by this factor")
    ap.add_argument("--codec", default="lz4", choices=["raw", "lz4", "zstd"])
    ap.add_argument("--level", type=int, default=1)
    ap.add_argument("--workdir", default="/tmp/na12878")
    ap.add_argument("--impl", default=None)
    ap.add_argument("--threads", type=int, default=0)
    ap.add_argument("--chunk-words", type=int, default=None,
                    help="device chunk size (default: one kernel grid step)")
    ap.add_argument("--container", default=None,
                    choices=["bam", "sam", "sam.gz", "cram"],
                    help="run through the container-ingest path instead "
                         "of the framed stream (cram: flags-only subset "
                         "container, io/cramio.py — payload must be "
                         "minimal)")
    ap.add_argument("--payload", default="minimal",
                    choices=["minimal", "realistic"],
                    help="container record weight: flags-only records, or "
                         "151bp HiSeqX-weight SEQ/QUAL/name/aux (~10x the "
                         "inflate bytes — the real NA12878 record shape, "
                         "reference README.md:33)")
    ap.add_argument("--cold", action="store_true",
                    help="drop the page cache before the first timed run "
                         "(reference clear_cache discipline, "
                         "benchmark/flagstats.cpp:82-88); needs root")
    ap.add_argument("--keep", action="store_true")
    args = ap.parse_args()

    from libflagstats_tpu.config import enable_compilation_cache

    enable_compilation_cache()

    from libflagstats_tpu.datasets import na12878_report_values, synth_na12878
    from libflagstats_tpu.io import codec as C
    from libflagstats_tpu.io.stream import flagstat_stream

    wd = Path(args.workdir)
    wd.mkdir(parents=True, exist_ok=True)

    if args.container:
        return _container_run(args, wd)

    # the cache name must carry every knob that changes the bytes —
    # reusing a level-1 stream for a --level 19 run would silently
    # record the wrong codec's timings
    lvl = "" if args.codec == "raw" else f"_l{args.level}"
    stream_path = wd / f"na12878_s{args.scale}{lvl}.{args.codec}"

    if stream_path.exists():
        # verification only needs na12878_report_values; skip the
        # minutes + ~1.6 GB of synthesizing an array we'd discard
        print(f"[gen] reusing {stream_path}", flush=True)
    else:
        t0 = time.perf_counter()
        arr, _ = synth_na12878(scale_divisor=args.scale, seed=0)
        t_gen = time.perf_counter() - t0
        print(f"[gen] {arr.size:,} words in {t_gen:.1f}s "
              f"({2*arr.size/1e9:.2f} GB)", flush=True)
        t0 = time.perf_counter()
        info = C.write_framed(stream_path, arr, codec=args.codec,
                              level=args.level)
        t_comp = time.perf_counter() - t0
        print(f"[compress] {info.n_blocks} blocks, "
              f"{info.raw_bytes/1e9:.2f} -> {info.compressed_bytes/1e9:.2f} GB "
              f"({info.raw_bytes/max(info.compressed_bytes,1):.2f}x) "
              f"in {t_comp:.1f}s", flush=True)
        del arr

    # warmup pass compiles the chunk kernel (excluded, like the
    # reference's separate cache-warmup mode, flagstats.cpp:596)
    t0 = time.perf_counter()
    counters = flagstat_stream(stream_path, codec=args.codec, impl=args.impl,
                               threads=args.threads, chunk_words=args.chunk_words)
    t_warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    counters = flagstat_stream(stream_path, codec=args.codec, impl=args.impl,
                               threads=args.threads, chunk_words=args.chunk_words)
    t_run = time.perf_counter() - t0

    ok = _check_report(counters, args.scale)
    expected = na12878_report_values(scale_divisor=args.scale)
    n = expected["total"]
    print(f"[time] warm(compile) {t_warm:.2f}s; steady run {t_run:.2f}s "
          f"({n/t_run/1e6:.0f} Mwords/s end-to-end; reference: 0.72s for "
          f"824.5M reads over LZ4-HC)")
    if not args.keep:
        stream_path.unlink(missing_ok=True)
    return 0 if ok else 1


def _check_report(counters, scale: int) -> bool:
    from libflagstats_tpu.datasets import na12878_report_values
    from libflagstats_tpu.report import counters_to_report

    rep = counters_to_report(counters)
    expected = na12878_report_values(scale_divisor=scale)
    checks = {
        "total": rep.total[0], "supplementary": rep.supplementary[0],
        "mapped": rep.mapped[0],
        "paired_in_sequencing": rep.paired_in_sequencing[0],
        "read1": rep.read1[0], "read2": rep.read2[0],
        "properly_paired": rep.properly_paired[0],
        "both_mapped": rep.both_mapped[0], "singletons": rep.singletons[0],
        "secondary": rep.secondary[0], "duplicates": rep.duplicates[0],
    }
    print(rep.text())
    ok = all(checks[k] == expected[k] for k in checks)
    print(f"[check] published-report match: {ok}")
    return ok


def _io_counters() -> tuple[int, int]:
    """(cumulative bytes actually read from storage by this process,
    cumulative major faults) — the cold-vs-warm diagnostic (VERDICT r03
    weak #3): a cold run should show ~file-size disk reads; a warm run
    ~0; a cold run whose disk GB/s is far below the device's streaming
    rate is readahead-starved (mmap faults), not decompress-bound."""
    read_bytes = 0
    try:
        with open("/proc/self/io") as fh:
            for line in fh:
                if line.startswith("read_bytes:"):
                    read_bytes = int(line.split()[1])
    except OSError:
        pass
    import resource

    return read_bytes, resource.getrusage(resource.RUSAGE_SELF).ru_majflt


def drop_page_cache() -> bool:
    """Best-effort page-cache drop (the reference clears the cache
    between decompress timings, benchmark/flagstats.cpp:82-88)."""
    try:
        with open("/proc/sys/vm/drop_caches", "w") as fh:
            fh.write("3\n")
        return True
    except OSError as exc:
        print(f"[cold] page-cache drop unavailable ({exc}); "
              "timing with whatever is cached", flush=True)
        return False


def _write_sam_gz_streaming(path, arr, payload: str,
                            chunk_records: int = 1 << 20) -> None:
    """BGZF-SAM writer with O(chunk) disk/memory — no whole-file plain
    .tmp. The round-4 flow materialized the full SAM text first, which
    at scale 2 realistic is ~160 GB and exceeds this box's disk; SAM
    text chunks per FLAG slice compress straight to BGZF members
    (members are independent, so per-chunk compression concatenates
    into a valid BGZF stream)."""
    import concurrent.futures as cf
    import io as _io

    from libflagstats_tpu.io.bamio import BGZF_EOF, _bgzf_member

    with open(path, "wb") as fh, cf.ThreadPoolExecutor(4) as pool:
        for start in range(0, arr.size, chunk_records):
            part = arr[start:start + chunk_records]
            buf = _io.BytesIO()
            # reuse the canonical SAM writer chunk-wise; header only on
            # the first chunk, record names continue via the start index
            _write_sam_chunk(buf, part, start, payload,
                             with_header=start == 0)
            data = buf.getbuffer()
            offs = range(0, len(data), 60000)
            for member in pool.map(
                    lambda o: _bgzf_member(bytes(data[o:o + 60000]),
                                           level=1),
                    offs, chunksize=64):
                fh.write(member)
        fh.write(BGZF_EOF)


def _write_sam_chunk(fh, part, start: int, payload: str,
                     with_header: bool) -> None:
    from libflagstats_tpu.io import samio

    if with_header:
        fh.write(b"@HD\tVN:1.6\tSO:unsorted\n"
                 b"@PG\tID:lfs\tPN:libflagstats_tpu\n")
    if payload == "realistic":
        fh.write(samio._realistic_sam_chunk(part, start, 0))
    else:
        fh.write("".join(
            f"r{start + i}\t{v}\t*\t0\t0\t*\t*\t0\t0\t*\t*\n"
            for i, v in enumerate(part.tolist())).encode())


def _container_run(args, wd: Path) -> int:
    """Full `samtools flagstat <container>` conformance: synthesize the
    column, build the container, count straight from it."""
    from libflagstats_tpu import flagstat_file
    from libflagstats_tpu.datasets import synth_na12878

    tag = "_real" if args.payload == "realistic" else ""
    path = wd / f"na12878_s{args.scale}{tag}.{args.container}"
    if path.exists():
        print(f"[gen] reusing {path}", flush=True)
    else:
        t0 = time.perf_counter()
        arr, _ = synth_na12878(scale_divisor=args.scale, seed=0)
        print(f"[gen] {arr.size:,} words in {time.perf_counter()-t0:.1f}s",
              flush=True)
        t0 = time.perf_counter()
        if args.container == "bam":
            from libflagstats_tpu.io.bamio import write_bam

            write_bam(path, arr, level=1, payload=args.payload)
        elif args.container == "cram":
            from libflagstats_tpu.io.cramio import write_cram

            if args.payload != "minimal":
                raise SystemExit("cram container carries the FLAG column "
                                 "only (payload=minimal)")
            write_cram(path, arr)
        elif args.container == "sam":
            from libflagstats_tpu.io.samio import write_sam

            write_sam(path, arr, payload=args.payload)
        else:
            _write_sam_gz_streaming(path, arr, args.payload)
        print(f"[container] {path.name}: "
              f"{path.stat().st_size/1e9:.2f} GB in "
              f"{time.perf_counter()-t0:.1f}s", flush=True)
        del arr

    c = None
    for label in (("cold" if args.cold else "first"), "warm"):
        if label == "cold":
            drop_page_cache()
        io0, mf0 = _io_counters()
        t0 = time.perf_counter()
        counters = flagstat_file(path, threads=args.threads, impl=args.impl)
        t_run = time.perf_counter() - t0
        io1, mf1 = _io_counters()
        c = np.asarray(counters, dtype=np.uint64)
        n = int(c[9] + c[25])        # pass + fail record totals
        print(f"[time] flagstat({path.name}) [{label}] {t_run:.2f}s "
              f"({n/t_run/1e6:.0f} Mrec/s end-to-end; samtools published "
              f"30m50s for the full 824.5M-record BAM)", flush=True)
        print(f"[io]   [{label}] disk_read {(io1-io0)/1e9:.2f} GB "
              f"({(io1-io0)/max(t_run,1e-9)/1e9:.2f} GB/s), "
              f"major_faults {mf1-mf0:,}", flush=True)

    ok = _check_report(counters, args.scale)
    if not args.keep:
        path.unlink(missing_ok=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
