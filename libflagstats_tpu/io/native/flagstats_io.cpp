// Native host-side IO for libflagstats_tpu.
//
// Implements the reference's framed block codec (per block:
//   int32 uncompressed_size, int32 compressed_size, payload
// reference: benchmark/flagstats.cpp:110-226, block size 1,024,000 bytes)
// with a clean-room LZ4 block-format codec written from the public LZ4
// block specification, and Zstd via the system libzstd. A std::thread
// worker pool decodes blocks in parallel — the reference pipeline is
// sequential and ~80% ingest-bound (README.md:27-29), so parallel decode
// is where the device pipeline wins back the host side.
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <new>
#include <thread>
#include <vector>

#include <dlfcn.h>

extern "C" {

// ---------------------------------------------------------------------------
// LZ4 block format (clean-room implementation from the public spec).
// ---------------------------------------------------------------------------

// Decompress an LZ4 block into dst; returns decompressed size or -1.
// Hot loop uses wild 16-byte copies inside safety margins (short matches
// and literals dominate columnar FLAG data, so per-sequence overhead is
// the whole game); falls back to exact copies near buffer ends.
// This is the clean-room implementation — always available, and the
// target of the ASan/fuzz hardening; `lfs_lz4_decompress` below routes
// to the system LZ4_decompress_safe when liblz4 is present.
int64_t lfs_lz4_decompress_own(const uint8_t* src, int64_t src_len,
                               uint8_t* dst, int64_t dst_cap) {
    const uint8_t* ip = src;
    const uint8_t* iend = src + src_len;
    uint8_t* op = dst;
    uint8_t* oend = dst + dst_cap;
    // Wild-copy margins are checked arithmetically per copy site
    // ((iend - ip) / (oend - op) >= 32) rather than via precomputed
    // "fast end" pointers: with dst_cap < 32 a clamped oend_fast == dst
    // still compared equal to op on the first sequence, letting a 16B
    // wild copy overrun a tiny output buffer (advisor finding, round 1).

    while (ip < iend) {
        const uint8_t token = *ip++;
        int64_t lit = token >> 4;
        if (lit == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return -1;
                b = *ip++;
                lit += b;
            } while (b == 255);
        }
        // bounds checks below use the subtraction form (len > end - p):
        // ip <= iend and op <= oend are loop invariants, and the
        // pointer-addition form (p + len > end) forms a far-out-of-
        // bounds pointer first -- UB a compiler may fold away, and
        // invisible to ASan since no access happens
        if (lit <= 16 && (iend - ip) >= 32 && (oend - op) >= 32) {
            std::memcpy(op, ip, 16);                  // wild copy
        } else {
            if (lit > iend - ip || lit > oend - op) return -1;
            std::memcpy(op, ip, static_cast<size_t>(lit));
        }
        ip += lit;
        op += lit;
        if (ip >= iend) break;  // last sequence: literals only

        if (iend - ip < 2) return -1;
        const uint32_t offset = static_cast<uint32_t>(ip[0]) |
                                (static_cast<uint32_t>(ip[1]) << 8);
        ip += 2;
        if (offset == 0 || op - dst < static_cast<int64_t>(offset)) return -1;
        int64_t mlen = (token & 0x0F) + 4;
        if ((token & 0x0F) == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return -1;
                b = *ip++;
                mlen += b;
            } while (b == 255);
        }
        if (mlen > oend - op) return -1;
        const uint8_t* match = op - offset;
        if (mlen <= 16 && offset >= 16 && (oend - op) >= 32) {
            std::memcpy(op, match, 16);               // wild copy
            op += mlen;
        } else if (offset >= 8) {
            uint8_t* o = op;
            op += mlen;
            if ((oend - op) >= 32) {
                do {                                   // 8B wild chunks
                    std::memcpy(o, match, 8);
                    o += 8; match += 8;
                } while (o < op);
            } else {
                int64_t n = mlen;
                while (n >= 8) { std::memcpy(o, match, 8); o += 8; match += 8; n -= 8; }
                while (n--) *o++ = *match++;
            }
        } else {
            // short offset: expand the repeating pattern to 8 bytes, then
            // chunk-copy with the pattern-aligned stride
            uint8_t pat[16];
            for (int i = 0; i < 16; ++i) pat[i] = match[i % offset];
            const int64_t stride = (16 / offset) * offset;
            uint8_t* o = op;
            op += mlen;
            if ((oend - op) >= 32) {
                do {
                    std::memcpy(o, pat, 16);
                    o += stride;
                } while (o < op);
            } else {
                for (int64_t i = 0; i < mlen; ++i) o[i] = match[i];
            }
        }
    }
    return op - dst;
}

static inline uint32_t lfs_read32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
}

static inline uint32_t lfs_hash4(uint32_t v) {
    return (v * 2654435761u) >> 17;  // 15-bit hash
}

// ---------------------------------------------------------------------------
// Optional system liblz4 (runtime dlopen — no dev package needed). The
// reference pipeline is built on the real LZ4_compress_HC /
// LZ4_compress_fast / LZ4_decompress_safe (benchmark/flagstats.cpp:
// 110,147,316); when the shared library is present we use it for both
// directions and keep the clean-room codec as the no-dependency
// fallback. The clean-room decoder remains the ASan/fuzz hardening
// target (lfs_lz4_decompress_own) since it is the path that must stand
// on its own where liblz4 is absent.
// ---------------------------------------------------------------------------

typedef int (*lfs_LZ4_compress_fast_t)(const char*, char*, int, int, int);
typedef int (*lfs_LZ4_compress_HC_t)(const char*, char*, int, int, int);
typedef int (*lfs_LZ4_decompress_safe_t)(const char*, char*, int, int);

static lfs_LZ4_compress_fast_t lfs_sys_lz4_fast = nullptr;
static lfs_LZ4_compress_HC_t lfs_sys_lz4_hc = nullptr;
static lfs_LZ4_decompress_safe_t lfs_sys_lz4_dec = nullptr;
static std::atomic<int> lfs_lz4_own_only{0};
static std::atomic<int> lfs_lz4_sys_decode{0};

static void lfs_lz4_sys_init() {
    static std::once_flag once;
    std::call_once(once, [] {
        void* h = dlopen("liblz4.so.1", RTLD_NOW);
        if (!h) h = dlopen("liblz4.so", RTLD_NOW);
        if (h) {
            lfs_sys_lz4_fast = reinterpret_cast<lfs_LZ4_compress_fast_t>(
                dlsym(h, "LZ4_compress_fast"));
            lfs_sys_lz4_hc = reinterpret_cast<lfs_LZ4_compress_HC_t>(
                dlsym(h, "LZ4_compress_HC"));
            lfs_sys_lz4_dec = reinterpret_cast<lfs_LZ4_decompress_safe_t>(
                dlsym(h, "LZ4_decompress_safe"));
        }
        const char* e = getenv("LFS_LZ4_SYS_DECODE");
        if (e && *e && *e != '0') lfs_lz4_sys_decode.store(1);
    });
}

// Runtime switch mirroring the LFS_LZ4_SYS_DECODE env opt-in (tests).
void lfs_lz4_set_sys_decode(int v) { lfs_lz4_sys_decode.store(v); }

// Block decompress entry. Default is the clean-room decoder: measured
// on the synthetic NA12878 column (103 MB, LZ4-fast a1) it decodes
// 1.03 GB/s/thread vs the system LZ4_decompress_safe's 0.81 — the
// short-offset pattern-expansion path fits FLAG data's 2/4-byte-period
// matches better than liblz4's generic copy loop. LFS_LZ4_SYS_DECODE=1
// opts into the system decoder for platforms/data where it wins.
// Both reject malformed streams and never write past dst_cap.
int64_t lfs_lz4_decompress(const uint8_t* src, int64_t src_len,
                           uint8_t* dst, int64_t dst_cap) {
    lfs_lz4_sys_init();
    if (lfs_lz4_sys_decode.load(std::memory_order_relaxed) &&
        lfs_sys_lz4_dec && !lfs_lz4_own_only.load() &&
        src_len <= INT32_MAX && dst_cap <= INT32_MAX) {
        const int r = lfs_sys_lz4_dec(reinterpret_cast<const char*>(src),
                                      reinterpret_cast<char*>(dst),
                                      static_cast<int>(src_len),
                                      static_cast<int>(dst_cap));
        return r < 0 ? -1 : r;
    }
    return lfs_lz4_decompress_own(src, src_len, dst, dst_cap);
}

// Force the clean-room encoder even when liblz4 is present (tests).
void lfs_lz4_set_own_only(int v) { lfs_lz4_own_only.store(v); }

// 1 if compression will use the system liblz4, else 0.
int lfs_lz4_backend() {
    lfs_lz4_sys_init();
    return (!lfs_lz4_own_only.load() && lfs_sys_lz4_fast && lfs_sys_lz4_hc)
               ? 1 : 0;
}

int64_t lfs_lz4_compress_own(const uint8_t* src, int64_t src_len,
                             uint8_t* dst, int64_t dst_cap, int effort);

// Compress src into dst (LZ4 block format). `effort` <= 0 selects the
// LZ4-fast family with acceleration (1 - effort) (reference knob:
// flagstats.cpp:110); >= 1 selects LZ4-HC at that level (flagstats.cpp:
// 147). Returns compressed size, or -1 if dst_cap too small.
int64_t lfs_lz4_compress(const uint8_t* src, int64_t src_len,
                         uint8_t* dst, int64_t dst_cap, int effort) {
    if (lfs_lz4_backend() && src_len <= INT32_MAX && dst_cap <= INT32_MAX) {
        int r;
        if (effort >= 1) {
            const int level = effort > 12 ? 12 : effort;
            r = lfs_sys_lz4_hc(reinterpret_cast<const char*>(src),
                               reinterpret_cast<char*>(dst),
                               static_cast<int>(src_len),
                               static_cast<int>(dst_cap), level);
        } else {
            r = lfs_sys_lz4_fast(reinterpret_cast<const char*>(src),
                                 reinterpret_cast<char*>(dst),
                                 static_cast<int>(src_len),
                                 static_cast<int>(dst_cap), 1 - effort);
        }
        return r > 0 ? r : -1;
    }
    return lfs_lz4_compress_own(src, src_len, dst, dst_cap, effort);
}

// Clean-room encoder (fallback; block-format spec implementation).
// `effort` <= 0 = greedy single probe; >= 1 = hash-chain search depth.
int64_t lfs_lz4_compress_own(const uint8_t* src, int64_t src_len,
                             uint8_t* dst, int64_t dst_cap, int effort) {
    constexpr int HASH_SIZE = 1 << 15;
    constexpr int64_t MFLIMIT = 12;   // no matches within last 12 bytes
    constexpr int64_t LASTLITERALS = 5;

    uint8_t* op = dst;
    uint8_t* oend = dst + dst_cap;
    const int64_t mflimit = src_len - MFLIMIT;

    std::vector<int64_t> head(HASH_SIZE, -1);
    std::vector<int64_t> chain;
    const bool hc = effort > 0;
    if (hc) chain.assign(static_cast<size_t>(src_len > 0 ? src_len : 1), -1);

    auto emit = [&](int64_t lit_start, int64_t lit_len, int64_t mlen,
                    uint32_t offset) -> bool {
        // token + extended literal length
        int64_t need = 1 + lit_len / 255 + 1 + lit_len + (mlen ? 2 + mlen / 255 + 1 : 0);
        if (need > oend - op) return false;
        uint8_t* token = op++;
        int64_t l = lit_len;
        if (l >= 15) {
            *token = 15 << 4;
            l -= 15;
            while (l >= 255) { *op++ = 255; l -= 255; }
            *op++ = static_cast<uint8_t>(l);
        } else {
            *token = static_cast<uint8_t>(l << 4);
        }
        std::memcpy(op, src + lit_start, static_cast<size_t>(lit_len));
        op += lit_len;
        if (mlen) {
            *op++ = static_cast<uint8_t>(offset & 0xFF);
            *op++ = static_cast<uint8_t>(offset >> 8);
            int64_t m = mlen - 4;
            if (m >= 15) {
                *token |= 15;
                m -= 15;
                while (m >= 255) { *op++ = 255; m -= 255; }
                *op++ = static_cast<uint8_t>(m);
            } else {
                *token |= static_cast<uint8_t>(m);
            }
        }
        return true;
    };

    int64_t anchor = 0;
    int64_t pos = 0;
    int64_t miss_run = 0;   // LZ4-fast style skip acceleration
    while (pos < mflimit) {
        const uint32_t h = lfs_hash4(lfs_read32(src + pos));
        int64_t best_len = 0;
        int64_t best_ref = -1;
        int64_t cand = head[h];
        int probes = hc ? effort : 1;
        while (cand >= 0 && probes-- > 0 && pos - cand <= 65535) {
            if (lfs_read32(src + cand) == lfs_read32(src + pos)) {
                int64_t len = 4;
                const int64_t maxlen = src_len - LASTLITERALS - pos;
                while (len + 8 <= maxlen &&
                       lfs_read32(src + cand + len) == lfs_read32(src + pos + len) &&
                       lfs_read32(src + cand + len + 4) == lfs_read32(src + pos + len + 4))
                    len += 8;
                while (len < maxlen && src[cand + len] == src[pos + len]) ++len;
                if (len > best_len) { best_len = len; best_ref = cand; }
            }
            cand = hc ? chain[static_cast<size_t>(cand)] : -1;
        }
        if (hc) chain[static_cast<size_t>(pos)] = head[h];
        head[h] = pos;
        if (best_len >= 4) {
            miss_run = 0;
            if (!emit(anchor, pos - anchor,
                      best_len, static_cast<uint32_t>(pos - best_ref)))
                return -1;
            const int64_t end = pos + best_len;
            // index a couple of interior positions only (classic lz4
            // inserts just the match tail; full-stride indexing was the
            // encoder hot spot on highly repetitive columnar data)
            if (hc) {
                for (int64_t q = pos + 1; q + 4 <= end && q < mflimit; ++q) {
                    const uint32_t hq = lfs_hash4(lfs_read32(src + q));
                    chain[static_cast<size_t>(q)] = head[hq];
                    head[hq] = q;
                }
            } else if (end - 2 > pos && end - 2 + 4 <= src_len) {
                const uint32_t hq = lfs_hash4(lfs_read32(src + end - 2));
                head[hq] = end - 2;
            }
            pos = end;
            anchor = pos;
        } else {
            pos += 1 + (miss_run++ >> 6);   // accelerate through noise
        }
    }
    // final literals
    if (!emit(anchor, src_len - anchor, 0, 0)) return -1;
    return op - dst;
}

// ---------------------------------------------------------------------------
// Zstd via the system libzstd, loaded at runtime like liblz4: the shared
// library is enough (no dev package, no link flag). Without it every
// zstd entry returns -1 and the Python codec reports the failure.
// ---------------------------------------------------------------------------

typedef size_t (*lfs_ZSTD_compress_t)(void*, size_t, const void*, size_t,
                                      int);
typedef size_t (*lfs_ZSTD_decompress_t)(void*, size_t, const void*, size_t);
typedef size_t (*lfs_ZSTD_compressBound_t)(size_t);
typedef unsigned (*lfs_ZSTD_isError_t)(size_t);

static lfs_ZSTD_compress_t lfs_sys_zstd_compress = nullptr;
static lfs_ZSTD_decompress_t lfs_sys_zstd_decompress = nullptr;
static lfs_ZSTD_compressBound_t lfs_sys_zstd_bound = nullptr;
static lfs_ZSTD_isError_t lfs_sys_zstd_is_error = nullptr;

static bool lfs_zstd_sys_init() {
    static std::once_flag once;
    std::call_once(once, [] {
        void* h = dlopen("libzstd.so.1", RTLD_NOW);
        if (!h) h = dlopen("libzstd.so", RTLD_NOW);
        if (!h) return;
        lfs_sys_zstd_compress = reinterpret_cast<lfs_ZSTD_compress_t>(
            dlsym(h, "ZSTD_compress"));
        lfs_sys_zstd_decompress = reinterpret_cast<lfs_ZSTD_decompress_t>(
            dlsym(h, "ZSTD_decompress"));
        lfs_sys_zstd_bound = reinterpret_cast<lfs_ZSTD_compressBound_t>(
            dlsym(h, "ZSTD_compressBound"));
        lfs_sys_zstd_is_error = reinterpret_cast<lfs_ZSTD_isError_t>(
            dlsym(h, "ZSTD_isError"));
    });
    return lfs_sys_zstd_compress && lfs_sys_zstd_decompress &&
           lfs_sys_zstd_bound && lfs_sys_zstd_is_error;
}

int64_t lfs_zstd_compress(const uint8_t* src, int64_t src_len,
                          uint8_t* dst, int64_t dst_cap, int level) {
    if (!lfs_zstd_sys_init()) return -1;
    const size_t r = lfs_sys_zstd_compress(
        dst, static_cast<size_t>(dst_cap), src, static_cast<size_t>(src_len),
        level);
    return lfs_sys_zstd_is_error(r) ? -1 : static_cast<int64_t>(r);
}

int64_t lfs_zstd_decompress(const uint8_t* src, int64_t src_len,
                            uint8_t* dst, int64_t dst_cap) {
    if (!lfs_zstd_sys_init()) return -1;
    const size_t r = lfs_sys_zstd_decompress(
        dst, static_cast<size_t>(dst_cap), src, static_cast<size_t>(src_len));
    return lfs_sys_zstd_is_error(r) ? -1 : static_cast<int64_t>(r);
}

int64_t lfs_zstd_bound(int64_t src_len) {
    if (!lfs_zstd_sys_init()) return -1;
    return static_cast<int64_t>(
        lfs_sys_zstd_bound(static_cast<size_t>(src_len)));
}

int64_t lfs_lz4_bound(int64_t src_len) {
    return src_len + src_len / 255 + 16;
}

// ---------------------------------------------------------------------------
// Parallel framed-stream decode: given a concatenated framed stream
// ([u32 raw_len][u32 comp_len][payload])*, decompress every block into a
// caller-provided contiguous output buffer using a thread pool.
// codec: 0 = raw/stored, 1 = lz4, 2 = zstd.
// Returns total decompressed bytes, or -1 on error.
// ---------------------------------------------------------------------------

// One shared walk of the untrusted [u32 raw_len][u32 comp_len][payload]*
// headers for both C entries (the Python parsers must stay in lockstep
// too — see io/codec.py scan_frames/iter_framed). Lengths that read as
// negative int32 are rejected exactly like the Python side's `<i`
// parse; `require_even` adds the FLAG-word constraint (raw bytes come
// in uint16 pairs) used by the flagstat entry but NOT by the generic
// byte-stream decoder. Returns total raw bytes, or -1.
struct LfsFrame { int64_t src_off, src_len, raw_len; };

static int64_t lfs_parse_frames(const uint8_t* stream, int64_t stream_len,
                                bool require_even,
                                std::vector<LfsFrame>& blocks) {
    int64_t off = 0, raw_total = 0;
    while (off + 8 <= stream_len) {
        const uint32_t raw_len = lfs_read32(stream + off);
        const uint32_t comp_len = lfs_read32(stream + off + 4);
        off += 8;
        if (raw_len > 0x7FFFFFFFu || comp_len > 0x7FFFFFFFu) return -1;
        if (off + comp_len > stream_len) return -1;
        if (require_even && raw_len % 2) return -1;
        blocks.push_back({off, static_cast<int64_t>(comp_len),
                          static_cast<int64_t>(raw_len)});
        off += comp_len;
        raw_total += raw_len;
    }
    return off == stream_len ? raw_total : -1;
}

int64_t lfs_decode_stream(const uint8_t* stream, int64_t stream_len,
                          uint8_t* out, int64_t out_cap,
                          int codec, int n_threads) {
    struct Block { int64_t src_off, src_len, dst_off, raw_len; };
    std::vector<LfsFrame> frames;
    if (lfs_parse_frames(stream, stream_len, false, frames) < 0) return -1;
    std::vector<Block> blocks;
    blocks.reserve(frames.size());
    int64_t dst_off = 0;
    for (const LfsFrame& f : frames) {
        if (dst_off + f.raw_len > out_cap) return -1;
        blocks.push_back({f.src_off, f.src_len, dst_off, f.raw_len});
        dst_off += f.raw_len;
    }

    std::atomic<size_t> next{0};
    std::atomic<bool> failed{false};
    auto worker = [&]() {
        for (;;) {
            const size_t i = next.fetch_add(1);
            if (i >= blocks.size() || failed.load(std::memory_order_relaxed))
                return;
            const Block& b = blocks[i];
            int64_t r;
            if (codec == 0) {
                if (b.src_len != b.raw_len) { failed = true; return; }
                std::memcpy(out + b.dst_off, stream + b.src_off,
                            static_cast<size_t>(b.raw_len));
                r = b.raw_len;
            } else if (codec == 1) {
                r = lfs_lz4_decompress(stream + b.src_off, b.src_len,
                                       out + b.dst_off, b.raw_len);
            } else {
                r = lfs_zstd_decompress(stream + b.src_off, b.src_len,
                                        out + b.dst_off, b.raw_len);
            }
            if (r != b.raw_len) failed = true;
        }
    };

    int nt = n_threads > 0 ? n_threads
                           : static_cast<int>(std::thread::hardware_concurrency());
    if (nt < 1) nt = 1;
    if (static_cast<size_t>(nt) > blocks.size()) nt = static_cast<int>(blocks.size());
    if (nt <= 1) {
        worker();
    } else {
        std::vector<std::thread> pool;
        pool.reserve(static_cast<size_t>(nt));
        for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
        for (auto& th : pool) th.join();
    }
    return failed ? -1 : dst_off;
}

// Host flagstat kernel entry (flagstats_host.cpp, same .so).
int64_t lfs_flagstat_u16(const uint16_t* data, int64_t n, uint64_t* flags,
                         int n_threads);

// Fused decode+count over a framed stream: each worker decodes one
// block into a small thread-local buffer (cache-hot) and counts it
// immediately, so the decoded column is never materialized — the
// stream's memory traffic drops from (write + reread) 2x raw bytes to
// L2-resident block recycling. The reference's pipeline decodes into
// one reused block buffer then counts it, sequentially
// (benchmark/flagstats.cpp:311-332); this is that loop parallelized
// with the count fused in. flags: uint64[32], ACCUMULATED (the
// per-call derived pass-total is additive across calls and blocks).
// n_words_out: total decoded words. codec: 0 raw, 1 LZ4, 2 Zstd.
// Returns 0, or -1 on malformed frames / decode failure.
int64_t lfs_flagstat_framed(const uint8_t* stream, int64_t stream_len,
                            int codec, int n_threads, uint64_t* flags,
                            int64_t* n_words_out) {
    std::vector<LfsFrame> blocks;
    const int64_t raw_total = lfs_parse_frames(stream, stream_len,
                                               /*require_even=*/true, blocks);
    if (raw_total < 0) return -1;

    std::atomic<size_t> next{0};
    std::atomic<bool> failed{false};
    int nt = n_threads > 0 ? n_threads
                           : static_cast<int>(std::thread::hardware_concurrency());
    if (nt < 1) nt = 1;
    if (static_cast<size_t>(nt) > blocks.size())
        nt = static_cast<int>(blocks.size() ? blocks.size() : 1);

    std::vector<std::vector<uint64_t>> locals(
        static_cast<size_t>(nt), std::vector<uint64_t>(32, 0));
    auto worker = [&](int t) {
        std::vector<uint8_t> buf;
        for (;;) {
            const size_t i = next.fetch_add(1);
            if (i >= blocks.size() || failed.load(std::memory_order_relaxed))
                return;
            const LfsFrame& b = blocks[i];
            const uint16_t* words;
            if (codec == 0) {
                if (b.src_len != b.raw_len) { failed = true; return; }
                // raw blocks count straight from the source bytes
                words = reinterpret_cast<const uint16_t*>(stream + b.src_off);
            } else {
                if (static_cast<int64_t>(buf.size()) < b.raw_len) {
                    // a lying header can claim up to 2 GiB per block;
                    // an allocation failure must fail the CALL, not
                    // escape the worker thread and abort the process
                    try {
                        buf.resize(static_cast<size_t>(b.raw_len));
                    } catch (const std::bad_alloc&) {
                        failed = true;
                        return;
                    }
                }
                int64_t r;
                if (codec == 1)
                    r = lfs_lz4_decompress(stream + b.src_off, b.src_len,
                                           buf.data(), b.raw_len);
                else
                    r = lfs_zstd_decompress(stream + b.src_off, b.src_len,
                                            buf.data(), b.raw_len);
                if (r != b.raw_len) { failed = true; return; }
                words = reinterpret_cast<const uint16_t*>(buf.data());
            }
            lfs_flagstat_u16(words, b.raw_len / 2,
                             locals[static_cast<size_t>(t)].data(), 1);
        }
    };
    if (nt <= 1) {
        worker(0);
    } else {
        std::vector<std::thread> pool;
        pool.reserve(static_cast<size_t>(nt));
        for (int t = 0; t < nt; ++t) pool.emplace_back(worker, t);
        for (auto& th : pool) th.join();
    }
    if (failed) return -1;
    for (int t = 0; t < nt; ++t)
        for (int k = 0; k < 32; ++k) flags[k] += locals[static_cast<size_t>(t)][k];
    if (n_words_out) *n_words_out = raw_total / 2;
    return 0;
}

// CRAM itf8 stream decoder (io/cramio.py fast path): decode exactly
// max_out values, returning the bytes consumed, or -1 on truncation.
// itf8 (CRAM 3.0 §2.3): leading-ones prefix gives 0-4 extra bytes; the
// 5-byte form uses only the LOW 4 bits of its last byte.
int64_t lfs_itf8_decode(const uint8_t* src, int64_t n_bytes,
                        int32_t* out, int64_t max_out) {
    int64_t off = 0;
    for (int64_t i = 0; i < max_out; ++i) {
        if (off >= n_bytes) return -1;
        const uint8_t b0 = src[off];
        uint32_t v;
        int need;
        if (b0 < 0x80) { v = b0; need = 1; }
        else if (b0 < 0xC0) { v = (uint32_t)(b0 & 0x3F) << 8; need = 2; }
        else if (b0 < 0xE0) { v = (uint32_t)(b0 & 0x1F) << 16; need = 3; }
        else if (b0 < 0xF0) { v = (uint32_t)(b0 & 0x0F) << 24; need = 4; }
        else { v = (uint32_t)(b0 & 0x0F) << 28; need = 5; }
        if (off + need > n_bytes) return -1;
        switch (need) {
            case 2: v |= src[off + 1]; break;
            case 3: v |= (uint32_t)src[off + 1] << 8 | src[off + 2]; break;
            case 4: v |= (uint32_t)src[off + 1] << 16 |
                         (uint32_t)src[off + 2] << 8 | src[off + 3]; break;
            case 5: v |= (uint32_t)src[off + 1] << 20 |
                         (uint32_t)src[off + 2] << 12 |
                         (uint32_t)src[off + 3] << 4 |
                         (src[off + 4] & 0x0F); break;
            default: break;
        }
        out[i] = (int32_t)v;
        off += need;
    }
    return off;
}

}  // extern "C"
