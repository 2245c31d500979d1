#!/usr/bin/env python3
"""Full codec sweep over the synthetic NA12878 FLAG column (default 1/8
scale): LZ4-HC c1-9, LZ4-fast a1-10, Zstd c1-20, raw — mirroring the
reference's published table (README.md:136-175).

Columns: compressed size, ratio, compress time, warm decode time (native
thread pool), decode+flagstat time, and the fused native pipeline
(lfs_flagstat_framed: mmap -> per-block decode+count, the headline
end-to-end path). The separate flagstat term is the forced-CPU XLA tier
measured once (it is codec-independent); counters are asserted
bit-exact against the host oracle once per codec family (and per codec
family again through the fused path).
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import tempfile
import time

import numpy as np


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")  # codec sweep is host-side
    import jax.numpy as jnp

    from libflagstats_tpu.datasets import synth_na12878
    from libflagstats_tpu.io import codec as C
    from libflagstats_tpu.ops.xla_ops import flagstat_xla
    from libflagstats_tpu.oracle import flagstat_numpy

    scale = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    x, _ = synth_na12878(scale_divisor=scale, seed=0)
    print(f"# {x.size} words (NA12878/{scale} synthetic)", file=sys.stderr)
    ref = flagstat_numpy(x).astype(np.int64)

    # codec-independent flagstat term: forced-CPU XLA tier, warm min
    fs = jax.jit(flagstat_xla, static_argnames="n")
    xj = jnp.asarray(x)
    got = np.asarray(fs(xj, n=x.size), dtype=np.int64)
    assert (got == ref).all()
    t_flag = min(
        (lambda t0: (np.asarray(fs(xj, n=x.size)), time.perf_counter() - t0)[1])(
            time.perf_counter())
        for _ in range(3)
    )
    print(f"# flagstat (CPU-XLA tier, codec-independent): {t_flag*1e3:.0f} ms",
          file=sys.stderr)

    configs = ([("lz4", lv, f"HC_c{lv}") for lv in range(2, 10)]
               + [("lz4", 1, "fast_a1")]
               + [("lz4", 1 - a, f"fast_a{a}") for a in range(2, 11)]
               + [("zstd", lv, f"c{lv}") for lv in range(1, 21)]
               + [("raw", 0, "-")])
    from libflagstats_tpu.ops import native_host

    have_native = native_host.available()
    checked = set()
    print("codec\tconfig\tcomp_MB\tratio\tcomp_s\tdecode_ms\t"
          "decode_flagstat_ms\tfused_native_ms")
    for codec, lv, label in configs:
        with tempfile.TemporaryDirectory() as td:
            p = Path(td) / "s.bin"
            t0 = time.perf_counter()
            info = C.write_framed(p, x, codec=codec, level=lv)
            t_comp = time.perf_counter() - t0
            t0 = time.perf_counter()
            out = C.read_framed(p, codec)
            t_dec = time.perf_counter() - t0
            t0 = time.perf_counter()
            out = C.read_framed(p, codec)
            t_dec = min(t_dec, time.perf_counter() - t0)
            t_fused = float("nan")
            if have_native:
                t_fused = float("inf")
                for _ in range(2):
                    t0 = time.perf_counter()
                    counters, nw = native_host.flagstat_framed_native(
                        p, C._codec_id(codec))
                    t_fused = min(t_fused, time.perf_counter() - t0)
                assert nw == x.size
                if codec not in checked:
                    np.testing.assert_array_equal(
                        counters.astype(np.int64), ref)
            if codec not in checked:
                checked.add(codec)
                np.testing.assert_array_equal(out, x)
            ratio = info.raw_bytes / max(info.compressed_bytes, 1)
            print(f"{codec}\t{label}\t{info.compressed_bytes/1e6:.2f}\t"
                  f"{ratio:.2f}\t{t_comp:.2f}\t{t_dec*1e3:.0f}\t"
                  f"{(t_dec + t_flag)*1e3:.0f}\t{t_fused*1e3:.0f}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
