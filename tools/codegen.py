#!/usr/bin/env python3
"""Constant derivation & verification tool.

Device counterpart of the reference's offline codegen scripts
(paper/scripts/*.py, which print the pshufb/vpermw lookup tables pasted
into the SIMD kernels). The device kernels have no lookup tables — their
"constants" are the masked-swap transpose stages and the plane-space
boolean transform — so this tool *derives* those from first principles
and verifies them against brute force, printing them in copy-pastable
form. Run it after touching ops/bitslice.py.

Usage: python tools/codegen.py
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from libflagstats_tpu import flags as F  # noqa: E402
from libflagstats_tpu.ops import bitslice as B  # noqa: E402
from libflagstats_tpu.oracle import transform_words  # noqa: E402


def derive_transpose_stages():
    """Verify the 4-stage elided-j=16 network by brute force: every
    (word, bit) marker must land exactly once, in the row the mapping
    predicts, and every row must be a pure single-bit plane."""
    stages = [(j, m) for j, m in B.TRANSPOSE_STAGES]
    assert [j for j, _ in stages] == [8, 4, 2, 1]

    for w in range(64):
        for b in range(16):
            words = np.zeros(64, dtype=np.uint32)
            words[w] = 1 << b
            regs = [
                np.array([words[2 * k] | (words[2 * k + 1] << 16)], np.uint32)
                for k in range(32)
            ]
            out = B.transpose32_np(regs)
            hits = [
                (r, c)
                for r in range(32)
                for c in range(32)
                if (int(out[r][0]) >> c) & 1
            ]
            assert len(hits) == 1, (w, b, hits)
            row = hits[0][0]
            assert row in (B.first_half_row(b), B.second_half_row(b)), (w, b, row)
    return stages


def derive_transform_truth_table():
    """Exhaustive truth table of the word transform over the 7 control
    bits (PAIRED, PROPER, UNMAP, MUNMAP, SEC, QCFAIL, SUP), verifying the
    plane-space formulation against the word-space oracle
    (analogue of the reference's expand_data.py truth table,
    paper/scripts/expand_data.py:3-10)."""
    all_words = np.arange(4096, dtype=np.uint16)
    word_space = transform_words(all_words)

    # plane-space: run transform_planes on bit-planes of all 4096 words
    planes = [((all_words >> k) & 1).astype(np.uint32) for k in range(12)]
    t_planes = B.transform_planes(planes)
    plane_space = np.zeros(4096, dtype=np.uint32)
    for k, tp in enumerate(t_planes):
        plane_space |= (tp & 1) << k
    assert (word_space == plane_space).all()
    return word_space


def main() -> int:
    stages = derive_transpose_stages()
    print("# transpose stages (j, mask) — verified vs brute force")
    for j, m in stages:
        print(f"  ({j:2d}, 0x{m:08X}),")

    pruned = B.pruned_pairs()
    total = sum(len(v) for v in pruned.values())
    print(f"# pruned swap pairs: {total}/80 "
          f"({ {j: len(p) for j, p in pruned.items()} })")

    tt = derive_transform_truth_table()
    print("# word transform truth table verified (4096 words, "
          "word-space == plane-space)")
    interesting = [0x0, 0x1, 0x3, 0x63, 0x93, 0x141, 0x841, 0xB63]
    for w in interesting:
        print(f"  t(0x{w:04X}) = 0x{int(tt[w]):04X}")

    print("# stream layout")
    print(f"  C streams: {list(B.C_STREAMS)}")
    print(f"  F streams: {list(B.F_STREAMS)}")
    print(f"  needed planes: {list(B.NEEDED_PLANES)}")
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
