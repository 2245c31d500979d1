"""Per-kernel throughput table, dispatch-latency-free.

The device analogue of the reference's per-variant cycles/word table
(linux/instrumented_benchmark.cpp -t): every device kernel variant timed
with the headline's gated multi-K fit (bench/harness.gated_kernel_time_fit)
over the same data, reported as words/s, GB/s, and fraction of the
DEFENDED HBM read roofline. Correctness is asserted against the host
oracle before timing. Rows whose sample never passed the gates are
marked with a trailing '!'.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


from ..oracle import generate_flags
from ..ops.xla_ops import stream_sums_xla
from .harness import defended_roofline, gated_kernel_time_fit
from .refcache import oracle_counters, pospopcnt_counters

HEADER = "kernel\twords\ttime_us\tMwords/s\tGB/s\tvs_roofline"


def _bodies(n_words: int):
    from ..ops import pallas_kernels as PK

    bodies = {
        "xla": lambda a: jnp.concatenate(stream_sums_xla(a)),
    }
    if jax.default_backend() == "gpu":
        bodies["pallas_bitsliced"] = lambda a: jnp.concatenate(
            PK.stream_sums_pallas(a))
        bodies["pallas_report"] = lambda a: jnp.concatenate(
            PK.stream_sums_pallas(a, report=True))
        bodies["pospopcnt_bitsliced"] = PK.pospopcnt_u16_pallas
    return bodies


def run(n_words: int = 64 * 1024 * 1024, iters: int = 5,
        check: bool = True, cache_dir: str | None = None) -> list[str]:
    x_host = generate_flags(n_words, seed=0, full_range=True)
    x = jax.block_until_ready(jnp.asarray(x_host))
    # host references are disk-cached (minutes of host time at 64Mi
    # words otherwise, every run — see bench/refcache.py)
    ref = oracle_counters(x_host, n_words, seed=0, full_range=True,
                          cache_dir=cache_dir)
    pp_ref = pospopcnt_counters(x_host, n_words, seed=0, full_range=True,
                                cache_dir=cache_dir)

    # defended roofline (fit gates + nominal-HBM cap + 2-sample
    # agreement) — a single max-of-candidates sample can be a caching
    # artifact (observed live: 1112 GB/s on an 819 GB/s part), which
    # would silently skew every row's vs_roofline column
    roof, roof_kind = defended_roofline(2 * n_words, with_kind=True)
    if roof != roof:  # NaN: no sample passed the gates
        roof = None

    lines = [HEADER]
    bodies = _bodies(n_words)
    for name, body in bodies.items():
        if check:
            out = np.asarray(jax.jit(body)(x), dtype=np.int64)
            if name.startswith("pospopcnt"):
                ok = (out == pp_ref).all()
            else:
                total, fail = out[:16], out[16:]
                from ..ops.xla_ops import assemble_counters

                counters = np.asarray(
                    assemble_counters(jnp.asarray(total, jnp.int32),
                                      jnp.asarray(fail, jnp.int32),
                                      jnp.int32(n_words)),
                    dtype=np.int64,
                )
                if name.endswith("_report"):
                    from .. import flags as F

                    idx = list(F.REPORT_COUNTERS)
                    ok = (counters[idx] == ref[idx]).all()
                else:
                    ok = (counters == ref).all()
            if not ok:
                lines.append(f"{name}\t{n_words}\tMISMATCH")
                continue
        row_bytes = 2 * n_words
        fit = gated_kernel_time_fit(body, x, roof_bytes_per_s=roof,
                                    n_bytes=row_bytes, iters=iters)
        t = fit.slope_s
        gated_ok = bool(fit.gate_passed)   # verdict set by the shared gate
        gbs = row_bytes / t / 1e9
        frac = f"{row_bytes / t / roof:.3f}" if roof else "n/a"
        lines.append(
            f"{name}\t{n_words}\t{t*1e6:.1f}\t{n_words/t/1e6:.0f}\t"
            f"{gbs:.1f}\t{frac}{'' if gated_ok else '!'}"
        )
    lines += _setop_rows(x_host, n_words, roof, iters=iters, check=check)
    if roof:
        lines.append(
            f"[roofline:{roof_kind}]\t{n_words}\t-\t-\t{roof/1e9:.1f}\t1.000")
    return lines


def _setop_rows(x_host, n_words: int, roof, iters: int,
                check: bool) -> list[str]:
    """Set-algebra device-tier rows (reference: STORM_popcnt /
    STORM_intersect_count, libalgebra.h:500-3398): the fused
    population_count+sum reduce, measured with the same gated fits.
    One 1-stream row and one 2-stream row characterize the family
    (union/diff are the same op count as intersect)."""
    def skip_rows(reason: str) -> list[str]:
        # well-formed 6-column rows so table consumers never break
        return [f"{name}\t{n_words}\tskipped:{reason}\t-\t-\t-"
                for name in ("setop_popcnt", "setop_intersect")]

    if n_words % 2:                              # uint32 view needs even words
        return skip_rows("odd word count")
    # lanes x <=32 bits must stay < 2^31 for one exact int32 reduce (the
    # library path chunks at 2^25 lanes for the same reason); above
    # that, skip rather than time a wrapping reduce
    if n_words // 2 > (1 << 25):
        return skip_rows(">2^25 lanes (library path chunks)")

    a_host = x_host.view(np.uint32)              # 2*n_words bytes, 32-bit lanes
    rng = np.random.default_rng(1)
    b_host = rng.integers(0, 1 << 32, size=a_host.size, dtype=np.uint32)
    a = jax.block_until_ready(jnp.asarray(a_host))
    b = jax.block_until_ready(jnp.asarray(b_host))

    def popcnt_body(v):
        return jnp.sum(jax.lax.population_count(v).astype(jnp.int32))

    def intersect_body(v):
        return jnp.sum(jax.lax.population_count(
            jnp.bitwise_and(v, b)).astype(jnp.int32))

    rows = []
    for name, body, nb, expect in (
        ("setop_popcnt", popcnt_body, 2 * n_words, (a_host,)),
        ("setop_intersect", intersect_body, 4 * n_words,
         (a_host, b_host)),
    ):
        if check:
            want = _host_popcount(expect[0] & expect[1]
                                  if len(expect) == 2 else expect[0])
            got = int(jax.jit(body)(a))
            if got != want:
                rows.append(f"{name}\t{n_words}\tMISMATCH")
                continue
        fit = gated_kernel_time_fit(body, a, roof_bytes_per_s=roof,
                                    n_bytes=nb, iters=iters)
        t = fit.slope_s
        frac = f"{nb / t / roof:.3f}" if roof else "n/a"
        rows.append(
            f"{name}\t{n_words}\t{t*1e6:.1f}\t{n_words/t/1e6:.0f}\t"
            f"{nb/t/1e9:.1f}\t{frac}{'' if fit.gate_passed else '!'}")
    return rows


def _host_popcount(u32: np.ndarray) -> int:
    if hasattr(np, "bitwise_count"):             # numpy >= 2
        return int(np.bitwise_count(u32).sum(dtype=np.int64))
    return int(np.unpackbits(u32.view(np.uint8)).sum(dtype=np.int64))
