"""SAM FLAG bit model and flagstat counter layout.

Re-derivation of the reference bit model
(reference: libflagstats.h:69-112) plus the three synthesized bits the
SIMD/Pallas kernels create:

  BIT12 = "properly paired"        = FPAIRED & FPROPER_PAIR & ~FUNMAP
  BIT13 = "singleton"              = FPAIRED & FMUNMAP & ~FUNMAP
  BIT14 = "both mates mapped"      = FPAIRED & ~FMUNMAP & ~FUNMAP

(all three additionally gated on the word being in the "pair branch":
not secondary, not supplementary — reference: libflagstats.h:281-290.)

Output contract (reference: libflagstats.h "kernel-internal invariants"):
a 32-counter vector; counters[0..15] are per-bit-position counts of the
mask-transformed word for QC-pass reads, counters[16..31] the same for
QC-fail reads. Counter 9 (FQCFAIL_OFF) in the *pass* stratum holds the
total number of QC-pass reads (derived as len - n_fail, reference:
libflagstats.h:429); counter 25 holds the number of QC-fail reads.
"""
from __future__ import annotations

# ---- the 12 real SAM FLAG bits (reference: libflagstats.h:69-112) ----
FPAIRED = 1 << 0          # read is paired in sequencing
FPROPER_PAIR = 1 << 1     # read mapped in a proper pair
FUNMAP = 1 << 2           # read itself unmapped
FMUNMAP = 1 << 3          # mate unmapped
FREVERSE = 1 << 4         # read on reverse strand
FMREVERSE = 1 << 5        # mate on reverse strand
FREAD1 = 1 << 6           # first read of pair
FREAD2 = 1 << 7           # second read of pair
FSECONDARY = 1 << 8       # secondary alignment
FQCFAIL = 1 << 9          # QC failure
FDUP = 1 << 10            # PCR/optical duplicate
FSUPPLEMENTARY = 1 << 11  # supplementary alignment

# ---- synthesized bits (reference: libflagstats.h:104-112) ----
BIT12 = 1 << 12           # properly paired (within pair branch)
BIT13 = 1 << 13           # singleton (within pair branch)
BIT14 = 1 << 14           # both mates mapped (within pair branch)

# ---- bit offsets ----
FPAIRED_OFF = 0
FPROPER_PAIR_OFF = 1
FUNMAP_OFF = 2
FMUNMAP_OFF = 3
FREVERSE_OFF = 4
FMREVERSE_OFF = 5
FREAD1_OFF = 6
FREAD2_OFF = 7
FSECONDARY_OFF = 8
FQCFAIL_OFF = 9
FDUP_OFF = 10
FSUPPLEMENTARY_OFF = 11
BIT12_OFF = 12
BIT13_OFF = 13
BIT14_OFF = 14

N_BITS = 16               # positional counters per stratum
N_COUNTERS = 32           # two strata of 16

# Real SAM FLAG words use bits 0..11 only; bits 12-15 of the raw input are
# ignored (the scalar oracle never reads them; reference kernels assume
# inputs < 4096, see benchmark/generate.cpp:7-18 and inmemory.cpp:113).
INPUT_MASK = 0x0FFF

# Bits that survive the mask-select transform unconditionally
# (reference: m1S/m2S carry masks, libflagstats.h:215-217):
# QCFAIL + SECONDARY + UNMAP + DUP.
KEEP_ALWAYS = FQCFAIL | FSECONDARY | FUNMAP | FDUP

# Bits that survive only when the word is in the samtools "pair branch"
# (paired, not secondary, not supplementary).
PAIR_BRANCH_MASK = (
    FPAIRED | FPROPER_PAIR | FMUNMAP | FREVERSE | FMREVERSE | FREAD1 | FREAD2
)

# The 20 counters with defined flagstat semantics, i.e. the set the
# reference's own conformance harness compares (benchmark/inmemory.cpp:173-194).
TESTED_COUNTERS = tuple(
    off + stratum
    for stratum in (0, 16)
    for off in (
        FQCFAIL_OFF,
        FSECONDARY_OFF,
        FSUPPLEMENTARY_OFF,
        BIT12_OFF,
        FREAD1_OFF,
        FREAD2_OFF,
        BIT13_OFF,
        BIT14_OFF,
        FUNMAP_OFF,
        FDUP_OFF,
    )
)

# Counters used by the samtools flagstat report (adds FPAIRED to the
# tested set; reference: benchmark/flagstats.cpp:578-590).
REPORT_COUNTERS = tuple(sorted(set(TESTED_COUNTERS) | {FPAIRED_OFF, FPAIRED_OFF + 16}))

SAM_FLAG_NAMES = (
    "FPAIRED", "FPROPER_PAIR", "FUNMAP", "FMUNMAP", "FREVERSE", "FMREVERSE",
    "FREAD1", "FREAD2", "FSECONDARY", "FQCFAIL", "FDUP", "FSUPPLEMENTARY",
    "n_pair_good", "n_sgltn", "n_pair_map",
)
