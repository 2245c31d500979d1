// Native host flagstat / positional-popcount kernels.
//
// The reference's entire product is a CPU kernel family
// (FLAGSTATS_u16, libflagstats.h:3025; STORM_pospopcnt_u16,
// libalgebra.h:3497). This framework's compute path is the GPU, but the
// host tier matters twice: (a) single-call dispatch below the device
// crossover (where the host-to-device copy costs more than counting
// here), (b) CPU-only deployments of the same library. This file gives
// the host tier a kernel in the reference's performance class instead
// of the NumPy oracle.
//
// Clean-room design, derived from this repo's OWN formulations — the
// packed-SWAR word transform (ops/xla_ops._transform_words_packed,
// itself derived from oracle.transform_words) vectorized with AVX2
// 16-bit lanes, and a Harley-Seal carry-save tree with a sixteens peel
// built from the device kernel's adder (ops/pallas_kernels._csa).
// Reference counterparts for parity bookkeeping only: the mask-select
// transform libflagstats.h:234-290, the dual pass/fail CSA trees
// libflagstats.h:1706-1754, the 16-bit staged counters flushed before
// overflow libflagstats.h:230-232, the derived pass-total
// libflagstats.h:429.
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

// ---- bit model (flags.py; reference: libflagstats.h:69-112) ----
constexpr uint32_t kInputMask = 0x0FFF;   // raw bits 12-15 are ignored
constexpr uint32_t kKeepAlways = 0x0704;  // QCFAIL|SECONDARY|UNMAP|DUP
constexpr int kQcOff = 9;

// Mask-select transform, one word (spec: oracle.transform_words).
// Bits of the result are exactly the positional events flagstat counts.
inline uint32_t transform_word(uint32_t v) {
    const uint32_t x = v & kInputMask;
    const uint32_t sec = (x >> 8) & 1u;
    const uint32_t sup = (x >> 11) & 1u;
    const uint32_t pair = x & 1u;
    const uint32_t inpair = pair & (sec ^ 1u) & (sup ^ 1u);
    const uint32_t supc = sup & (sec ^ 1u);
    const uint32_t im = inpair & (((x >> 2) & 1u) ^ 1u);  // in pair & mapped
    const uint32_t b12 = im & ((x >> 1) & 1u);            // properly paired
    const uint32_t b13 = im & ((x >> 3) & 1u);            // singleton
    const uint32_t b14 = im ^ b13;                        // both mates mapped
    const uint32_t keep = (inpair * 0xFFu) | kKeepAlways;
    return (x & keep) | (supc << 11) | (b12 << 12) | (b13 << 13) | (b14 << 14);
}

// Scalar flagstat over [data, data+n) into local[32] (positional counts
// only; no derived total here).
void flagstat_scalar_range(const uint16_t* data, int64_t n, uint64_t* local) {
    for (int64_t i = 0; i < n; ++i) {
        const uint32_t t = transform_word(data[i]);
        uint64_t* c = local + (((t >> kQcOff) & 1u) ? 16 : 0);
        for (int k = 0; k < 15; ++k) c[k] += (t >> k) & 1u;
    }
}

void pospopcnt_scalar_range(const uint16_t* data, int64_t n, uint64_t* local) {
    for (int64_t i = 0; i < n; ++i) {
        const uint32_t w = data[i];
        for (int k = 0; k < 16; ++k) local[k] += (w >> k) & 1u;
    }
}

#if defined(__AVX2__)

// Carry-save full adder on 256-bit lanes: v <- sum(v,a,b) per bit,
// carry out (the XOR3/majority pair; ops/pallas_kernels._csa).
inline void csa256(__m256i& v, __m256i a, __m256i b, __m256i& carry) {
    const __m256i va = _mm256_xor_si256(v, a);
    carry = _mm256_or_si256(_mm256_and_si256(v, a), _mm256_and_si256(b, va));
    v = _mm256_xor_si256(va, b);
}

// Vector transform of 16 words; writes the QC-pass and QC-fail streams
// (each word lands wholly in one stream; the other gets 0 in its slot —
// zero words are count-neutral through the CSA tree).
inline void transform16(__m256i x, __m256i& tp, __m256i& tf) {
    const __m256i one = _mm256_set1_epi16(1);
    x = _mm256_and_si256(x, _mm256_set1_epi16((short)kInputMask));
    const __m256i sec = _mm256_and_si256(_mm256_srli_epi16(x, 8), one);
    const __m256i sup = _mm256_and_si256(_mm256_srli_epi16(x, 11), one);
    const __m256i pair = _mm256_and_si256(x, one);
    const __m256i notsec = _mm256_xor_si256(sec, one);
    const __m256i inpair = _mm256_and_si256(
        pair, _mm256_and_si256(notsec, _mm256_xor_si256(sup, one)));
    const __m256i supc = _mm256_and_si256(sup, notsec);
    const __m256i im = _mm256_and_si256(
        inpair,
        _mm256_xor_si256(_mm256_and_si256(_mm256_srli_epi16(x, 2), one), one));
    const __m256i b12 =
        _mm256_and_si256(im, _mm256_and_si256(_mm256_srli_epi16(x, 1), one));
    const __m256i b13 =
        _mm256_and_si256(im, _mm256_and_si256(_mm256_srli_epi16(x, 3), one));
    const __m256i b14 = _mm256_xor_si256(im, b13);
    // keep mask: low byte when in the pair branch ((inpair<<8)-inpair
    // = 0x00FF per lane), plus the unconditional carry bits
    const __m256i keep = _mm256_or_si256(
        _mm256_sub_epi16(_mm256_slli_epi16(inpair, 8), inpair),
        _mm256_set1_epi16((short)kKeepAlways));
    __m256i t = _mm256_and_si256(x, keep);
    t = _mm256_or_si256(t, _mm256_slli_epi16(supc, 11));
    t = _mm256_or_si256(t, _mm256_slli_epi16(b12, 12));
    t = _mm256_or_si256(t, _mm256_slli_epi16(b13, 13));
    t = _mm256_or_si256(t, _mm256_slli_epi16(b14, 14));
    // QC split: propagate bit 9 to a full-lane mask (<<6 puts it in the
    // sign bit, arithmetic >>15 smears it)
    const __m256i mq = _mm256_srai_epi16(_mm256_slli_epi16(x, 6), 15);
    tf = _mm256_and_si256(t, mq);
    tp = _mm256_xor_si256(t, tf);
}

// One Harley-Seal body: fold 16 input vectors into the carried
// v1/v2/v4/v8 planes and peel the emitted sixteens plane into the
// 16-bit lane counters cnt[nbits] (each peeled bit = 16 words).
template <int NBITS>
inline void hs_body16(const __m256i* d, __m256i* v, __m256i* cnt) {
    __m256i twosA, twosB, foursA, foursB, eightsA, eightsB, sixteens;
    csa256(v[0], d[0], d[1], twosA);
    csa256(v[0], d[2], d[3], twosB);
    csa256(v[1], twosA, twosB, foursA);
    csa256(v[0], d[4], d[5], twosA);
    csa256(v[0], d[6], d[7], twosB);
    csa256(v[1], twosA, twosB, foursB);
    csa256(v[2], foursA, foursB, eightsA);
    csa256(v[0], d[8], d[9], twosA);
    csa256(v[0], d[10], d[11], twosB);
    csa256(v[1], twosA, twosB, foursA);
    csa256(v[0], d[12], d[13], twosA);
    csa256(v[0], d[14], d[15], twosB);
    csa256(v[1], twosA, twosB, foursB);
    csa256(v[2], foursA, foursB, eightsB);
    csa256(v[3], eightsA, eightsB, sixteens);
    const __m256i one = _mm256_set1_epi16(1);
    for (int k = 0; k < NBITS; ++k)
        cnt[k] = _mm256_add_epi16(
            cnt[k], _mm256_and_si256(_mm256_srli_epi16(sixteens, k), one));
}

// Horizontal-sum a 16x uint16-lane counter vector (rare: flush path).
inline uint64_t hsum_epu16(__m256i v) {
    alignas(32) uint16_t lanes[16];
    _mm256_store_si256((__m256i*)lanes, v);
    uint64_t s = 0;
    for (int i = 0; i < 16; ++i) s += lanes[i];
    return s;
}

// Add the residual CSA planes (weights 1/2/4/8) into local counts.
template <int NBITS>
void flush_residuals(const __m256i* v, uint64_t* local) {
    for (int w = 0; w < 4; ++w) {
        alignas(32) uint16_t lanes[16];
        _mm256_store_si256((__m256i*)lanes, v[w]);
        for (int i = 0; i < 16; ++i) {
            const uint32_t word = lanes[i];
            for (int k = 0; k < NBITS; ++k)
                local[k] += (uint64_t)((word >> k) & 1u) << w;
        }
    }
}

// Lane-counter flush cadence: each body adds <= 1 per uint16 lane, so
// lanes stay < 2^16 for 65535 bodies; flush every 4096 bodies (1Mi
// words) for headroom (reference discipline: libflagstats.h:230-232).
constexpr int64_t kBodyWords = 256;  // 16 vectors x 16 words
constexpr int64_t kFlushBodies = 4096;

// AVX2 flagstat of a 256-word-aligned range into local[32].
void flagstat_avx2_range(const uint16_t* data, int64_t n_bodies,
                         uint64_t* local) {
    __m256i vp[4], vf[4], cntp[15], cntf[15];
    for (auto& v : vp) v = _mm256_setzero_si256();
    for (auto& v : vf) v = _mm256_setzero_si256();

    int64_t body = 0;
    while (body < n_bodies) {
        const int64_t burst =
            std::min(n_bodies - body, kFlushBodies);
        for (auto& c : cntp) c = _mm256_setzero_si256();
        for (auto& c : cntf) c = _mm256_setzero_si256();
        for (int64_t b = 0; b < burst; ++b, ++body) {
            const uint16_t* p = data + body * kBodyWords;
            __m256i tp[16], tf[16];
            for (int i = 0; i < 16; ++i)
                transform16(_mm256_loadu_si256((const __m256i*)(p + 16 * i)),
                            tp[i], tf[i]);
            hs_body16<15>(tp, vp, cntp);
            hs_body16<15>(tf, vf, cntf);
        }
        for (int k = 0; k < 15; ++k) {
            local[k] += hsum_epu16(cntp[k]) << 4;       // sixteens weight
            local[16 + k] += hsum_epu16(cntf[k]) << 4;
        }
    }
    flush_residuals<15>(vp, local);
    flush_residuals<15>(vf, local + 16);
}

void pospopcnt_avx2_range(const uint16_t* data, int64_t n_bodies,
                          uint64_t* local) {
    __m256i v[4], cnt[16];
    for (auto& x : v) x = _mm256_setzero_si256();
    int64_t body = 0;
    while (body < n_bodies) {
        const int64_t burst = std::min(n_bodies - body, kFlushBodies);
        for (auto& c : cnt) c = _mm256_setzero_si256();
        for (int64_t b = 0; b < burst; ++b, ++body) {
            const uint16_t* p = data + body * kBodyWords;
            __m256i d[16];
            for (int i = 0; i < 16; ++i)
                d[i] = _mm256_loadu_si256((const __m256i*)(p + 16 * i));
            hs_body16<16>(d, v, cnt);
        }
        for (int k = 0; k < 16; ++k) local[k] += hsum_epu16(cnt[k]) << 4;
    }
    flush_residuals<16>(v, local);
}

#endif  // __AVX2__

#if defined(__AVX512BW__)

// AVX-512BW variants: 32 words per vector, and the CSA pair collapses
// to two VPTERNLOG ops (0x96 = XOR3, 0xE8 = majority) — the identical
// instruction economy the reference's STORM_pospopcnt_csa_avx512 uses
// (libalgebra.h:2311-2319); derived here from the same _csa contract
// as the AVX2/Pallas versions.
inline void csa512(__m512i& v, __m512i a, __m512i b, __m512i& carry) {
    carry = _mm512_ternarylogic_epi32(v, a, b, 0xE8);
    v = _mm512_ternarylogic_epi32(v, a, b, 0x96);
}

// The transform's conditional structure depends on only six input bits
// — pair(0), proper(1), unmap(2), munmap(3), sec(8), sup(11) — so the
// derived-bit word D and the keep-mask K are 64-entry uint16 tables
// indexed by those bits, each fetched with ONE cross-lane
// VPERMI2W. Same instruction economy as the reference's vpermw
// mask/expand tables (FLAGSTAT_avx512_improved, libflagstats.h:
// 1850-2075), but the tables here are self-derived at startup from the
// same boolean logic the scalar transform uses — no pasted constants.
struct TransformTables512 {
    alignas(64) uint16_t d[64];   // supc<<11 | b12<<12 | b13<<13 | b14<<14
    alignas(64) uint16_t k[64];   // keep mask: 0xFF when in-pair, + KEEP_ALWAYS
    TransformTables512() {
        for (uint32_t idx = 0; idx < 64; ++idx) {
            const uint32_t pair = idx & 1, proper = (idx >> 1) & 1,
                           unmap = (idx >> 2) & 1, munmap = (idx >> 3) & 1,
                           sec = (idx >> 4) & 1, sup = (idx >> 5) & 1;
            const uint32_t inpair = pair & (sec ^ 1u) & (sup ^ 1u);
            const uint32_t supc = sup & (sec ^ 1u);
            const uint32_t im = inpair & (unmap ^ 1u);
            const uint32_t b12 = im & proper;
            const uint32_t b13 = im & munmap;
            const uint32_t b14 = im ^ b13;
            d[idx] = (uint16_t)((supc << 11) | (b12 << 12) | (b13 << 13) |
                                (b14 << 14));
            k[idx] = (uint16_t)((inpair * 0xFFu) | kKeepAlways);
        }
    }
};
static const TransformTables512 kTables512;

struct TransformRegs512 {
    __m512i d_lo, d_hi, k_lo, k_hi;
    TransformRegs512()
        : d_lo(_mm512_load_si512((const void*)kTables512.d)),
          d_hi(_mm512_load_si512((const void*)(kTables512.d + 32))),
          k_lo(_mm512_load_si512((const void*)kTables512.k)),
          k_hi(_mm512_load_si512((const void*)(kTables512.k + 32))) {}
};

inline void transform32(__m512i x, const TransformRegs512& T, __m512i& tp,
                        __m512i& tf) {
    x = _mm512_and_si512(x, _mm512_set1_epi16((short)kInputMask));
    // gather the six conditional bits into a 0..63 lane index
    const __m512i idx = _mm512_or_si512(
        _mm512_and_si512(x, _mm512_set1_epi16(0x0F)),
        _mm512_or_si512(
            _mm512_and_si512(_mm512_srli_epi16(x, 4), _mm512_set1_epi16(0x10)),
            _mm512_and_si512(_mm512_srli_epi16(x, 6),
                             _mm512_set1_epi16(0x20))));
    const __m512i d = _mm512_permutex2var_epi16(T.d_lo, idx, T.d_hi);
    const __m512i k = _mm512_permutex2var_epi16(T.k_lo, idx, T.k_hi);
    const __m512i t = _mm512_or_si512(_mm512_and_si512(x, k), d);
    // QC split: propagate bit 9 to a full-lane mask (<<6 puts it in the
    // sign bit, arithmetic >>15 smears it)
    const __m512i mq = _mm512_srai_epi16(_mm512_slli_epi16(x, 6), 15);
    tf = _mm512_and_si512(t, mq);
    tp = _mm512_xor_si512(t, tf);
}

template <int NBITS>
inline void hs512_body16(const __m512i* d, __m512i* v, __m512i* cnt) {
    __m512i twosA, twosB, foursA, foursB, eightsA, eightsB, sixteens;
    csa512(v[0], d[0], d[1], twosA);
    csa512(v[0], d[2], d[3], twosB);
    csa512(v[1], twosA, twosB, foursA);
    csa512(v[0], d[4], d[5], twosA);
    csa512(v[0], d[6], d[7], twosB);
    csa512(v[1], twosA, twosB, foursB);
    csa512(v[2], foursA, foursB, eightsA);
    csa512(v[0], d[8], d[9], twosA);
    csa512(v[0], d[10], d[11], twosB);
    csa512(v[1], twosA, twosB, foursA);
    csa512(v[0], d[12], d[13], twosA);
    csa512(v[0], d[14], d[15], twosB);
    csa512(v[1], twosA, twosB, foursB);
    csa512(v[2], foursA, foursB, eightsB);
    csa512(v[3], eightsA, eightsB, sixteens);
    const __m512i one = _mm512_set1_epi16(1);
    for (int k = 0; k < NBITS; ++k)
        cnt[k] = _mm512_add_epi16(
            cnt[k], _mm512_and_si512(_mm512_srli_epi16(sixteens, k), one));
}

inline uint64_t hsum512_epu16(__m512i v) {
    alignas(64) uint16_t lanes[32];
    _mm512_store_si512((__m512i*)lanes, v);
    uint64_t s = 0;
    for (int i = 0; i < 32; ++i) s += lanes[i];
    return s;
}

template <int NBITS>
void flush_residuals512(const __m512i* v, uint64_t* local) {
    for (int w = 0; w < 4; ++w) {
        alignas(64) uint16_t lanes[32];
        _mm512_store_si512((__m512i*)lanes, v[w]);
        for (int i = 0; i < 32; ++i) {
            const uint32_t word = lanes[i];
            for (int k = 0; k < NBITS; ++k)
                local[k] += (uint64_t)((word >> k) & 1u) << w;
        }
    }
}

constexpr int64_t kBodyWords512 = 512;  // 16 vectors x 32 words

void flagstat_avx512_range(const uint16_t* data, int64_t n_bodies,
                           uint64_t* local) {
    const TransformRegs512 T;   // lookup tables resident in 4 zmm regs
    __m512i vp[4], vf[4], cntp[15], cntf[15];
    for (auto& v : vp) v = _mm512_setzero_si512();
    for (auto& v : vf) v = _mm512_setzero_si512();
    int64_t body = 0;
    while (body < n_bodies) {
        const int64_t burst = std::min(n_bodies - body, kFlushBodies);
        for (auto& c : cntp) c = _mm512_setzero_si512();
        for (auto& c : cntf) c = _mm512_setzero_si512();
        for (int64_t b = 0; b < burst; ++b, ++body) {
            const uint16_t* p = data + body * kBodyWords512;
            __m512i tp[16], tf[16];
            for (int i = 0; i < 16; ++i)
                transform32(_mm512_loadu_si512((const void*)(p + 32 * i)),
                            T, tp[i], tf[i]);
            hs512_body16<15>(tp, vp, cntp);
            hs512_body16<15>(tf, vf, cntf);
        }
        for (int k = 0; k < 15; ++k) {
            local[k] += hsum512_epu16(cntp[k]) << 4;
            local[16 + k] += hsum512_epu16(cntf[k]) << 4;
        }
    }
    flush_residuals512<15>(vp, local);
    flush_residuals512<15>(vf, local + 16);
}

void pospopcnt_avx512_range(const uint16_t* data, int64_t n_bodies,
                            uint64_t* local) {
    __m512i v[4], cnt[16];
    for (auto& x : v) x = _mm512_setzero_si512();
    int64_t body = 0;
    while (body < n_bodies) {
        const int64_t burst = std::min(n_bodies - body, kFlushBodies);
        for (auto& c : cnt) c = _mm512_setzero_si512();
        for (int64_t b = 0; b < burst; ++b, ++body) {
            const uint16_t* p = data + body * kBodyWords512;
            __m512i d[16];
            for (int i = 0; i < 16; ++i)
                d[i] = _mm512_loadu_si512((const void*)(p + 32 * i));
            hs512_body16<16>(d, v, cnt);
        }
        for (int k = 0; k < 16; ++k) local[k] += hsum512_epu16(cnt[k]) << 4;
    }
    flush_residuals512<16>(v, local);
}

#endif  // __AVX512BW__

// Shared multi-threaded range driver: run `range_fn(start, len, local)`
// over contiguous slabs, merging per-thread locals into out[n_out].
template <typename RangeFn>
void run_ranges(int64_t n, int64_t slab, int n_threads, int n_out,
                uint64_t* out, RangeFn range_fn) {
    const int64_t n_slabs = (n + slab - 1) / slab;
    int nt = n_threads > 0 ? n_threads
                           : (int)std::thread::hardware_concurrency();
    if (nt < 1) nt = 1;
    if (nt > n_slabs) nt = (int)n_slabs;
    if (nt <= 1) {
        range_fn(0, n, out);
        return;
    }
    std::atomic<int64_t> next{0};
    std::vector<std::vector<uint64_t>> locals(nt,
                                              std::vector<uint64_t>(n_out, 0));
    std::vector<std::thread> pool;
    for (int t = 0; t < nt; ++t) {
        pool.emplace_back([&, t]() {
            for (;;) {
                const int64_t s = next.fetch_add(1);
                if (s >= n_slabs) return;
                const int64_t start = s * slab;
                range_fn(start, std::min(slab, n - start),
                         locals[t].data());
            }
        });
    }
    for (auto& th : pool) th.join();
    for (int t = 0; t < nt; ++t)
        for (int k = 0; k < n_out; ++k) out[k] += locals[t][k];
}

constexpr int64_t kSlabWords = 1 << 21;  // 4 MiB per work unit

}  // namespace

extern "C" {

// Flagstat counters of n uint16 FLAG words, ACCUMULATED into flags[32]
// (the reference streaming contract: one counter vector across many
// blocks, libflagstats.h "kernels accumulate"). flags[0..15] QC-pass
// positional counts, flags[16..31] QC-fail; flags[9] gets the derived
// pass-read total (+= n - n_fail, applied once per call — reference:
// libflagstats.h:429). n_threads: 0 = hardware concurrency.
// Returns 0 on success.
int64_t lfs_flagstat_u16(const uint16_t* data, int64_t n, uint64_t* flags,
                         int n_threads) {
    if (n < 0 || (!data && n)) return -1;
    uint64_t counts[32] = {0};
    auto range = [&](int64_t start, int64_t len, uint64_t* local) {
#if defined(__AVX512BW__)
        const int64_t bodies = len / kBodyWords512;
        flagstat_avx512_range(data + start, bodies, local);
        flagstat_scalar_range(data + start + bodies * kBodyWords512,
                              len - bodies * kBodyWords512, local);
#elif defined(__AVX2__)
        const int64_t bodies = len / kBodyWords;
        flagstat_avx2_range(data + start, bodies, local);
        flagstat_scalar_range(data + start + bodies * kBodyWords,
                              len - bodies * kBodyWords, local);
#else
        flagstat_scalar_range(data + start, len, local);
#endif
    };
    run_ranges(n, kSlabWords, n_threads, 32, counts, range);
    // transformed pass words never carry bit 9, fail words always do
    counts[kQcOff] += (uint64_t)n - counts[16 + kQcOff];
    for (int k = 0; k < 32; ++k) flags[k] += counts[k];
    return 0;
}

// Set-algebra population counts over byte buffers (reference:
// STORM_popcnt / STORM_intersect_count / STORM_union_count /
// STORM_diff_count, libalgebra.h:500-3398). The hardware POPCNT on
// uint64 runs at one 8-byte word per cycle per core — memory-bound
// from the first thread — so the scalar builtin + the shared slab
// pool IS the speed-of-light kernel here (no Harley-Seal needed on a
// machine with native popcount; the reference's CSA trees predate
// assuming POPCNT). op: 0 = a&b, 1 = a|b, 2 = a&~b, 3 = unary (b
// ignored). Result ACCUMULATED into *out. Returns 0.
int64_t lfs_setop_count(const uint8_t* a, const uint8_t* b, int64_t n_bytes,
                        int op, int n_threads, uint64_t* out) {
    if (n_bytes < 0 || (!a && n_bytes) || (op != 3 && !b && n_bytes))
        return -1;
    if (op < 0 || op > 3) return -1;
    uint64_t total = 0;
    auto range = [&](int64_t start, int64_t len, uint64_t* local) {
        const uint8_t* pa = a + start;
        const uint8_t* pb = b ? b + start : nullptr;
        uint64_t s = 0;
        int64_t i = 0;
        auto load = [](const uint8_t* p) {
            uint64_t w;
            std::memcpy(&w, p, 8);
            return w;
        };
        for (; i + 8 <= len; i += 8) {
            uint64_t w = load(pa + i);
            if (op == 0) w &= load(pb + i);
            else if (op == 1) w |= load(pb + i);
            else if (op == 2) w &= ~load(pb + i);
            s += (uint64_t)__builtin_popcountll(w);
        }
        for (; i < len; ++i) {
            uint64_t w = pa[i];
            if (op == 0) w &= pb[i];
            else if (op == 1) w |= pb[i];
            else if (op == 2) w &= ~(uint64_t)pb[i];
            s += (uint64_t)__builtin_popcountll(w & 0xFF);
        }
        local[0] += s;
    };
    run_ranges(n_bytes, 2 * kSlabWords, n_threads, 1, &total, range);
    *out += total;
    return 0;
}

// Positional popcount of n uint16 words, ACCUMULATED into counts[16]
// (reference: STORM_pospopcnt_u16, libalgebra.h:3497). Returns 0.
int64_t lfs_pospopcnt_u16(const uint16_t* data, int64_t n, uint64_t* counts,
                          int n_threads) {
    if (n < 0 || (!data && n)) return -1;
    auto range = [&](int64_t start, int64_t len, uint64_t* local) {
#if defined(__AVX512BW__)
        const int64_t bodies = len / kBodyWords512;
        pospopcnt_avx512_range(data + start, bodies, local);
        pospopcnt_scalar_range(data + start + bodies * kBodyWords512,
                               len - bodies * kBodyWords512, local);
#elif defined(__AVX2__)
        const int64_t bodies = len / kBodyWords;
        pospopcnt_avx2_range(data + start, bodies, local);
        pospopcnt_scalar_range(data + start + bodies * kBodyWords,
                               len - bodies * kBodyWords, local);
#else
        pospopcnt_scalar_range(data + start, len, local);
#endif
    };
    run_ranges(n, kSlabWords, n_threads, 16, counts, range);
    return 0;
}

}  // extern "C"
