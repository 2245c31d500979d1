#!/usr/bin/env python3
"""Randomized differential stress (optional, minutes-long).

Mirrors the reference's fuzz-while-benchmarking discipline
(linux/instrumented_benchmark.cpp:174-208) as a standalone sweep:
random sizes x seeds x value ranges, every registered implementation
diffed against the branchy loop oracle on the defined counters.

Usage: python tools/stress.py [--rounds 50] [--max-words 2000000] [--gpu]
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--max-words", type=int, default=2_000_000)
    ap.add_argument("--loop-oracle-max", type=int, default=30_000,
                    help="cap for the slow per-word loop oracle cross-check")
    ap.add_argument("--gpu", action="store_true",
                    help="also run the GPU kernel tiers on the card (default: "
                         "CPU tiers only)")
    ap.add_argument("--seed", type=int, default=None,
                    help="RNG seed (default: time-derived; always printed "
                         "so a MISMATCH can be reproduced)")
    args = ap.parse_args()

    import numpy as np

    if not args.gpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    from libflagstats_tpu import flags as F
    from libflagstats_tpu.config import enable_compilation_cache
    from libflagstats_tpu.oracle import flagstat_loop, flagstat_numpy
    from libflagstats_tpu.ops.dispatch import FLAGSTAT_IMPLS, flagstats_u16
    from libflagstats_tpu.ops import native_host

    enable_compilation_cache()
    # every registry string whose tier can run here
    impls = [i for i in FLAGSTAT_IMPLS
             if (i != "native" or native_host.available())
             and (args.gpu or not i.startswith("pallas"))]

    seed = args.seed if args.seed is not None else int(time.time())
    print(f"[stress] seed={seed} (rerun with --seed {seed} to reproduce)",
          flush=True)
    rng = np.random.default_rng(seed)
    tested = list(F.TESTED_COUNTERS)
    report_idx = list(F.REPORT_COUNTERS)
    t0 = time.time()
    for r in range(args.rounds):
        n = int(rng.integers(0, args.max_words))
        hi = int(rng.choice([0x1000, 0x10000]))
        x = rng.integers(0, hi, size=n, dtype=np.uint16)
        ref = flagstat_numpy(x).astype(np.int64)
        if n <= args.loop_oracle_max:
            loop = flagstat_loop(x).astype(np.int64)
            assert (ref[tested] == loop[tested]).all(), (r, n, hi, "oracle split")
        for impl in impls:
            got = np.asarray(flagstats_u16(x, impl=impl), dtype=np.int64)
            idx = report_idx if impl == "pallas_report" else list(range(32))
            if not (got[idx] == ref[idx]).all():
                print(f"MISMATCH round={r} impl={impl} n={n} hi={hi:#x} "
                      f"seed={seed}")
                print("ref:", ref)
                print("got:", got)
                return 1
        if (r + 1) % 10 == 0:
            print(f"[{r+1}/{args.rounds}] ok ({time.time()-t0:.1f}s)", flush=True)
    print(f"stress OK: {args.rounds} rounds x {len(impls)} impls")
    return 0


if __name__ == "__main__":
    sys.exit(main())
