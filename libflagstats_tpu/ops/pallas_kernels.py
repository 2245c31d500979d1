"""Bit-sliced flagstat and positional popcount for Hopper GPUs (Pallas,
Triton route).

The hot path of the framework. Design (see ops/bitslice.py for the
executable NumPy spec):

* the uint16 FLAG column is bitcast to uint32 in the wrapper, so every
  uint32 holds two words in its 16-bit fields (any pairing is
  count-neutral). A *transpose group* is 32 consecutive runs of LANES
  uint32 values: run k is "register" k, a (LANES,) vector whose load is
  one coalesced read, and each of the LANES positions holds an
  independent 32x32 bit matrix (64 FLAG words);
* a masked-swap network bit-transposes each group into plane rows — the
  replacement for the reference's pshufb/vpermw lookups (reference:
  libflagstats.h:281-290, 1850-2075). The classic j=16 stage is elided:
  it only permutes words, and counting is order-free (ops/bitslice.py);
* the samtools flagstat logic runs in plane space, one bitwise op per
  32 words (reference semantics: libflagstats.h:118-142);
* each counted plane pair goes through a carry-save adder (XOR3 and
  majority, one LOP3 each: the reference's VPTERNLOG 0x96/0xE8 pair,
  libalgebra.h:2311-2319) whose sum plane stays in registers across the
  program's loop; the carry plane is peeled every group with a native
  popcount into int32 lane accumulators. A deeper Harley-Seal tree
  (v2/v4/v8, as in STORM_pospopcnt_csa_avx512) was measured on the
  H100: no faster once the kernel reads at the memory bound, more
  registers, and far slower to compile (PERF.md).

Each program walks its own contiguous run of groups in a loop, flushes
its planes at the end, and writes one row of per-stream int32 partial
sums; XLA adds the rows (exact integer sums). Loads past the end of the
column are masked to zero, and zero FLAG words count nothing, so no
input padding is needed beyond one word for an odd length (unlike the
reference's scalar tail, libflagstats.h:187-189).

The same group step also runs outside ``pallas_call`` as a plain-jnp twin
(``flagstat_bitsliced_jnp``), so the arithmetic is testable on the CPU
without the Pallas interpreter.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from .. import flags as F
from . import bitslice as B
from .xla_ops import assemble_counters

LANES = 128                 # positions per program: one uint32 per thread
NUM_WARPS = LANES // 32
REGS = 32                   # uint32 registers per transpose group
GROUP_WORDS = 2 * REGS * LANES    # uint16 words per group (8192)
_GROUP_U32 = REGS * LANES
#: programs to aim a launch at: enough waves over the H100's 132 SMs
#: that the last one's imbalance is small
TARGET_PROGRAMS = 132 * 16
OUT_STREAMS = 32            # partial-sum row width (29 streams, pow2)
#: uint32 values one call may read: every load offset, up to the end of
#: the last (masked) group, stays an int32
MAX_U32 = 0x80000000 - _GROUP_U32

MODES = ("flagstat", "flagstat_report", "pospopcnt")

_U32 = jnp.uint32


def _u32(c: int) -> jax.Array:
    return jnp.uint32(c & 0xFFFFFFFF)


def _transpose32(A: list[jax.Array], stages: dict[int, list[int]]) -> list[jax.Array]:
    """Masked-swap bit transpose of 32 uint32 vectors (4-stage elided
    network: bit j lands at rows 15-j and 31-j; see bitslice.py)."""
    A = list(A)
    for j, mask in B.TRANSPOSE_STAGES:
        m = _u32(mask)
        for k in stages[j]:
            t = (A[k] ^ (A[k + j] >> j)) & m
            A[k] = A[k] ^ t
            A[k + j] = A[k + j] ^ (t << j)
    return A


def _popcount32(x: jax.Array) -> jax.Array:
    """Per-element popcount of uint32 planes (the CSA-plane 'peel'),
    as int32."""
    return jax.lax.population_count(x).astype(jnp.int32)


def _popcount32_ptx(x: jax.Array) -> jax.Array:
    """The same peel as one PTX ``popc`` per element: the compiled
    Triton route has no lowering for ``population_count`` (and its
    inline assembly takes signless results, hence int32)."""
    (out,) = plt.elementwise_inline_asm(
        "popc.b32 $0, $1;", args=[x], constraints="=r,r", pack=1,
        result_shape_dtypes=[jax.ShapeDtypeStruct(x.shape, jnp.int32)])
    return out


def _csa(v: jax.Array, a: jax.Array, b: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Carry-save full adder: returns (sum, carry) of v+a+b per bit.

    The reference's VPTERNLOG 0x96/0xE8 pair (libalgebra.h:2311-2319)
    is XOR3 / majority, one LOP3 each on the GPU."""
    va = v ^ a
    return va ^ b, (v & a) | (b & va)


def _stream_inputs_flagstat(rows: list[jax.Array], report: bool = False) -> list:
    """Transposed rows -> the counted plane streams (C then F), each a
    (first-half, second-half) pair; 29 streams in full-parity mode, 21
    in report mode."""
    c_streams = B.REPORT_C_STREAMS if report else B.C_STREAMS
    f_streams = B.REPORT_F_STREAMS if report else B.F_STREAMS
    streams = []
    for row_of in (B.first_half_row, B.second_half_row):
        p = [None if (report and j in (4, 5)) else rows[row_of(j)]
             for j in range(12)]
        t = B.transform_planes(p, report=report)
        q = t[F.FQCFAIL_OFF]
        streams.append([t[k] for k in c_streams]
                       + [t[k] & q for k in f_streams])
    return list(zip(streams[0], streams[1]))


def _stream_inputs_pospopcnt(rows: list[jax.Array]) -> list:
    """Transposed rows -> 16 raw positional bit streams."""
    h1 = [rows[B.first_half_row(j)] for j in range(16)]
    h2 = [rows[B.second_half_row(j)] for j in range(16)]
    return list(zip(h1, h2))


def _mode_setup(mode: str):
    """(transpose stages, stream builder, stream count) for a mode."""
    if mode == "flagstat":
        return B.pruned_pairs(), _stream_inputs_flagstat, B.N_STREAMS
    if mode == "flagstat_report":
        return (B.pruned_pairs(B.REPORT_NEEDED_ROWS),
                functools.partial(_stream_inputs_flagstat, report=True),
                B.N_REPORT_STREAMS)
    if mode == "pospopcnt":
        return ({j: B.swap_pairs(j) for j, _ in B.TRANSPOSE_STAGES},
                _stream_inputs_pospopcnt, F.N_BITS)
    raise ValueError(f"unknown kernel mode {mode!r} (choose from {MODES})")


def _init_state(n_streams: int):
    planes = tuple(jnp.zeros((LANES,), _U32) for _ in range(n_streams))
    acc = tuple(jnp.zeros((LANES,), jnp.int32) for _ in range(n_streams))
    return planes, acc


def _group(load, state, mode: str, popcount=_popcount32):
    """Count one transpose group into ``state``.

    ``load(k)`` returns register k of the group as a (LANES,) uint32
    vector; ``state`` is (planes, acc), one sum plane and one int32
    accumulator per stream. The group's (first-half, second-half) plane
    pair of each stream goes through one carry-save adder with the
    stream's sum plane; the carry plane (weight 2) is peeled into the
    accumulator."""
    stages, make_streams, _ = _mode_setup(mode)
    planes, acc = list(state[0]), list(state[1])
    rows = _transpose32([load(k) for k in range(REGS)], stages)
    for s, (d0, d1) in enumerate(make_streams(rows)):
        planes[s], twos = _csa(planes[s], d0, d1)
        acc[s] = acc[s] + (popcount(twos) << 1)
    return tuple(planes), tuple(acc)


def _flush(state, popcount=_popcount32) -> list[jax.Array]:
    """Fold the residual sum planes into the accumulators (reference:
    the weighted CSA-plane reduction, libflagstats.h:1790-1840) and
    reduce each stream over its lanes -> one int32 scalar per stream."""
    planes, acc = state
    return [jnp.sum(a + popcount(p)) for p, a in zip(planes, acc)]


def _launch(n_groups: int) -> tuple[int, int]:
    """(programs, groups per program) covering ``n_groups``: as close
    to ``TARGET_PROGRAMS`` as whole groups allow, with every program
    but the last doing the same work."""
    per = max(-(-n_groups // TARGET_PROGRAMS), 1)
    return max(-(-n_groups // per), 1), per


def _make_kernel(mode: str, m32: int, n_groups: int, per: int,
                 interpret: bool):
    n = _mode_setup(mode)[2]
    popcount = _popcount32 if interpret else _popcount32_ptx

    def kernel(x_ref, o_ref):
        first = pl.program_id(0) * per
        # one group per program: a static trip count (every program has
        # a full or tail group to walk)
        count = 1 if per == 1 else jnp.minimum(per, n_groups - first)
        lane = jax.lax.broadcasted_iota(jnp.int32, (LANES,), 0)

        def step(i, state):
            base = (first + i) * _GROUP_U32

            def load(k):
                off = base + k * LANES
                # zero past the end of the column: count-neutral
                return plt.load(x_ref.at[pl.ds(off, LANES)],
                                mask=lane < m32 - off, other=0)

            return _group(load, state, mode, popcount)

        state = jax.lax.fori_loop(0, count, step, _init_state(n))
        row = jnp.zeros((OUT_STREAMS,), jnp.int32)
        slot = jax.lax.broadcasted_iota(jnp.int32, (OUT_STREAMS,), 0)
        for s, total in enumerate(_flush(state, popcount)):
            row = jnp.where(slot == s, total, row)
        o_ref[...] = row

    return kernel


def _as_u32(x: jax.Array) -> jax.Array:
    """Flat uint16 column -> flat uint32 view (one zero word appended
    for an odd length: count-neutral)."""
    if x.dtype != jnp.uint16:
        raise ValueError(f"expected uint16, got {x.dtype}")
    x = x.ravel()
    if x.size % 2:
        x = jnp.pad(x, (0, 1))
    return jax.lax.bitcast_convert_type(x.reshape(-1, 2), _U32)


def require_gpu() -> None:
    """The compiled kernels run on a GPU only; interpret mode is for
    tests and must be asked for explicitly."""
    if jax.default_backend() != "gpu":
        raise RuntimeError(
            "the Pallas kernel tier needs a GPU (JAX backend is "
            f"{jax.default_backend()!r}); choose impl='native', 'xla' or "
            "'numpy', or pass interpret=True in tests")


@functools.partial(jax.jit, static_argnames=("mode", "interpret"))
def stream_partials(x: jax.Array, mode: str, interpret: bool = False) -> jax.Array:
    """Per-program partial stream sums, (programs, OUT_STREAMS) int32.

    ``x`` is a flat uint16 column of up to 2 * MAX_U32 words (the load
    offsets are int32). The sums are int32 too, so a call counts at most
    2^31 - 1 nonzero words: ops/dispatch splits longer columns at
    DEVICE_WORD_CAP and pads only with zeros, which count nothing.
    Column s of the result is stream s of ``mode`` (streams past the
    mode's count are 0)."""
    x32 = _as_u32(x)
    m32 = x32.size
    if m32 > MAX_U32:
        raise ValueError(f"{x.size} words exceed one kernel call's "
                         f"{2 * MAX_U32}; split the column")
    n_groups = -(-m32 // _GROUP_U32)
    programs, per = _launch(n_groups)
    return pl.pallas_call(
        _make_kernel(mode, m32, n_groups, per, interpret),
        grid=(programs,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((None, OUT_STREAMS), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((programs, OUT_STREAMS), jnp.int32),
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name=f"bitsliced_{mode}",
    )(x32)


def _stream_sums(x: jax.Array, mode: str, interpret: bool) -> jax.Array:
    """(OUT_STREAMS,) int32 per-stream totals of ``mode`` over ``x``."""
    if not interpret:
        require_gpu()
    if x.size == 0:
        return jnp.zeros(OUT_STREAMS, jnp.int32)
    return jnp.sum(stream_partials(x, mode, interpret), axis=0)


def _sums_to_streams(sums: jax.Array, report: bool) -> tuple[jax.Array, jax.Array]:
    """Per-stream totals -> (C[k], F[k]) scattered into 16-bin vectors."""
    c_idx = np.array(B.REPORT_C_STREAMS if report else B.C_STREAMS)
    f_idx = np.array(B.REPORT_F_STREAMS if report else B.F_STREAMS)
    total = jnp.zeros(F.N_BITS, jnp.int32).at[c_idx].set(sums[: len(c_idx)])
    fail = jnp.zeros(F.N_BITS, jnp.int32).at[f_idx].set(
        sums[len(c_idx):len(c_idx) + len(f_idx)])
    return total, fail


def stream_sums_pallas(x: jax.Array, report: bool = False,
                       interpret: bool = False) -> tuple[jax.Array, jax.Array]:
    """Raw stratified stream sums (C[k], F[k]), each (16,) int32 and
    psum-mergeable. ``report=True`` runs the 21-stream kernel that skips
    the four masked-positional counters the flagstat report never
    reads."""
    mode = "flagstat_report" if report else "flagstat"
    return _sums_to_streams(_stream_sums(x, mode, interpret), report)


def flagstat_pallas(x: jax.Array, n=None, interpret: bool = False,
                    report: bool = False) -> jax.Array:
    """Flagstat counters for a uint16 FLAG column -> (32,) int32.

    ``n`` is the true (pre-padding) length for the derived pass-total
    (reference: libflagstats.h:429). ``report=True`` leaves the four
    masked-positional counters at 0 (reference analogue:
    FLAGSTAT_avx512_improved3/4)."""
    if n is None:
        n = x.size
    total, fail = stream_sums_pallas(x, report=report, interpret=interpret)
    return assemble_counters(total, fail, n)


def pospopcnt_u16_pallas(x: jax.Array, interpret: bool = False) -> jax.Array:
    """Raw positional popcount of a uint16 column -> (16,) int32
    (analogue of STORM_pospopcnt_u16_avx512bw_harvey_seal,
    libalgebra.h:2383)."""
    return _stream_sums(x, "pospopcnt", interpret)[:F.N_BITS]


# ---------------------------------------------------------------------------
# Plain-jnp twin: the kernel's group step (_group/_flush, identical
# traced math) applied to each group of the column in turn, without
# pallas_call. The CPU tests check the arithmetic here; the Pallas
# plumbing (masked loads, launch geometry, partial rows) is checked by
# the interpret-mode tests and, compiled, on the card.
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("mode",))
def _stream_sums_twin(x: jax.Array, mode: str) -> jax.Array:
    x32 = _as_u32(x)
    n_groups = -(-x32.size // _GROUP_U32)
    x32 = jnp.pad(x32, (0, n_groups * _GROUP_U32 - x32.size))
    state = _init_state(_mode_setup(mode)[2])
    # groups unrolled: the twin serves small test inputs, where a
    # straight-line trace compiles far faster on the CPU than a loop
    for i in range(n_groups):
        def load(k, base=i * _GROUP_U32):
            return x32[base + k * LANES:base + (k + 1) * LANES]

        state = _group(load, state, mode)
    return jnp.stack(_flush(state))


def flagstat_bitsliced_jnp(x: jax.Array, n=None,
                           report: bool = False) -> jax.Array:
    """CPU-testable twin of flagstat_pallas (same math, no pallas_call)."""
    if n is None:
        n = x.size
    mode = "flagstat_report" if report else "flagstat"
    total, fail = _sums_to_streams(_stream_sums_twin(x, mode), report)
    return assemble_counters(total, fail, n)


def pospopcnt_bitsliced_jnp(x: jax.Array) -> jax.Array:
    """CPU-testable twin of pospopcnt_u16_pallas."""
    return _stream_sums_twin(x, "pospopcnt")
