"""Plain-XLA (jnp) flagstat and pospopcnt — the plain device version.

This is the "let XLA fuse it" formulation: the mask-select transform as
vectorized bitwise ops and the positional popcount as a fused
broadcast-shift-reduce. It is the device tier of the CPU backend, the
plain version every hand-written kernel is timed and tested against,
and the device-side differential baseline for the Pallas kernel.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import flags as F


def transform_words_jnp(x: jax.Array) -> jax.Array:
    """Word-space mask-select transform (uint32 in/out), traceable.

    Thin delegation: the load-bearing mask-select logic exists ONCE, in
    oracle.transform_words — its numpy scalar constants and operators
    trace cleanly on jax arrays (differentially verified), so keeping a
    near-identical jnp copy here only invited silent divergence.
    (Reference: the LOAD macro chain O1/O2/O3 + L1/L2/L3,
    libflagstats.h:281-290.)
    """
    from ..oracle import transform_words

    return transform_words(x)


def pospopcnt_u16_xla(x: jax.Array, n_bits: int = F.N_BITS) -> jax.Array:
    """Positional popcount of a uint16 stream -> (n_bits,) int32.

    Device analogue of STORM_pospopcnt_u16 (libalgebra.h:3497),
    packed-SWAR form: two words per uint32 lane, per-bit fused
    shift-mask-sum (no (N, n_bits) bit-matrix intermediate).
    """
    n = x.size
    pad = (-n) % 256
    if pad:
        x = jnp.pad(x.ravel(), (0, pad))
    x2 = x.reshape(-1, 256)
    packed = x2[:, :128].astype(jnp.uint32) | (
        x2[:, 128:].astype(jnp.uint32) << 16
    )
    one = jnp.uint32(0x00010001)
    out = []
    for k in range(n_bits):
        c = (packed >> k) & one
        both = (c + (c >> 16)) & jnp.uint32(3)
        out.append(jnp.sum(both.astype(jnp.int32)))
    return jnp.stack(out)


_ONE16 = 0x00010001


def _transform_words_packed(x: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Packed-SWAR word transform + QC split.

    ``x``: uint32 lanes holding two independent FLAG words. Returns
    (pass_words, fail_words) with the transformed bit layout of
    oracle.transform_words. All ops stay within 16-bit fields."""
    one = jnp.uint32(_ONE16)
    x = x & jnp.uint32(0x0FFF0FFF)        # drop input bits 12-15 per field
    sec = (x >> 8) & one
    sup = (x >> 11) & one
    pair = x & one
    inpair = pair & (sec ^ one) & (sup ^ one)
    supc = sup & (sec ^ one)
    im = inpair & ((x >> 2) & one ^ one)  # inpair & mapped
    b12 = im & (x >> 1) & one
    b13 = im & (x >> 3) & one
    b14 = im ^ b13

    pair_mask = (inpair << 8) - inpair     # 0x00FF per field when inpair
    keep = pair_mask | jnp.uint32(F.KEEP_ALWAYS * _ONE16)
    t = (x & keep) | (supc << 11) | (b12 << 12) | (b13 << 13) | (b14 << 14)

    q = (x >> F.FQCFAIL_OFF) & one
    mq = (q << 16) - q                     # 0xFFFF per field when QC-fail
    tf = t & mq
    return t ^ tf, tf


def stream_sums_xla(x: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Raw stratified stream sums: (C[k], F[k]) each (16,) int32.

    C[k] counts transformed bit k over all words, F[k] over QC-fail words.
    These are plain sums, so they can be psum-merged across shards before
    the derived-counter assembly (reference invariant: counters are
    block-accumulative, benchmark/flagstats.cpp:304-329).

    Packed-SWAR formulation: words pair into uint32 lanes, the transform
    + QC split run once per lane (two words), and each bit reduces via a
    fused shift-mask-sum — no (N, 16) bit-matrix intermediate.
    """
    n = x.size
    pad = (-n) % 256
    if pad:
        x = jnp.pad(x.ravel(), (0, pad))  # zero words are count-neutral
    # pairing: the two halves of each 256-word row share a uint32 lane;
    # any pairing is count-neutral
    x2 = x.reshape(-1, 256)
    packed = x2[:, :128].astype(jnp.uint32) | (
        x2[:, 128:].astype(jnp.uint32) << 16
    )
    tp, tf = _transform_words_packed(packed)
    one = jnp.uint32(0x00010001)

    def counts(t):
        out = []
        for k in range(F.N_BITS):
            c = (t >> k) & one
            both = (c + (c >> 16)) & jnp.uint32(3)   # 0..2 per lane
            out.append(jnp.sum(both.astype(jnp.int32)))
        return jnp.stack(out)

    fail = counts(tf)
    total = counts(tp) + fail
    return total, fail


def pospopcnt_u16_matmul(x: jax.Array, n_bits: int = F.N_BITS,
                         chunk: int = 1 << 17) -> jax.Array:
    """Positional popcount as a matrix product: expand bits to int8 and
    reduce with a ones-vector int8 dot accumulating in int32 (exact: no
    float product exists). Off the hot path; kept as an independent
    formulation — the reference's analogue is its family of distinct
    pospopcnt algorithms
    (sad / blend_popcnt / harvey_seal / adder_forest,
    libalgebra.h:836-2554). The bit expansion is staged per ``chunk``
    words inside a lax.scan so the (chunk, n_bits) int8 intermediate
    stays a few MB regardless of stream length (the round-1 version
    materialized the full (N, 16) matrix — an 8x memory blowup)."""
    n = x.size
    chunk = max(128, min(chunk, -(-n // 128) * 128))
    pad = (-n) % chunk
    if pad:
        x = jnp.pad(x.ravel(), (0, pad))  # zero words are count-neutral
    xg = x.reshape(-1, chunk)
    ks = jnp.arange(n_bits, dtype=jnp.uint32)
    ones = jnp.ones((1, chunk), jnp.int8)

    def step(acc, row):
        bits = ((row.astype(jnp.uint32)[:, None] >> ks[None, :])
                & jnp.uint32(1)).astype(jnp.int8)
        out = jax.lax.dot_general(
            ones, bits, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        return acc + out[0], None

    acc, _ = jax.lax.scan(step, jnp.zeros(n_bits, jnp.int32), xg)
    return acc


def flagstat_xla(x: jax.Array, n=None) -> jax.Array:
    """Flagstat counters for a uint16 FLAG batch -> (32,) int32.

    ``n`` is the true (unpadded) word count used for the derived
    pass-stratum total (reference: libflagstats.h:429); zero padding is
    exactly neutral for every other counter.
    """
    if n is None:
        n = x.size
    total, fail = stream_sums_xla(x)
    return assemble_counters(total, fail, n)


def assemble_counters(total: jax.Array, fail: jax.Array, n) -> jax.Array:
    """(C[k], F[k]) stream sums -> 32-counter vector (int32).

    pass[k] = C[k] - F[k]; fail[9] = C[9] (= number of QC-fail reads);
    pass[9] = n - C[9] (derived pass total, reference: libflagstats.h:429).
    """
    total = total.astype(jnp.int32)
    fail = fail.astype(jnp.int32)
    n_fail = total[F.FQCFAIL_OFF]
    passed = total - fail
    passed = passed.at[F.FQCFAIL_OFF].set(jnp.int32(n) - n_fail)
    failed = fail.at[F.FQCFAIL_OFF].set(n_fail)
    return jnp.concatenate([passed, failed])
