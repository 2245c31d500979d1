// TSAN stress for the native thread pools: lfs_decode_stream and the
// fused framed decode+count pool
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <vector>
#include <random>
extern "C" {
int64_t lfs_lz4_compress(const uint8_t*, int64_t, uint8_t*, int64_t, int);
int64_t lfs_lz4_bound(int64_t);
int64_t lfs_decode_stream(const uint8_t*, int64_t, uint8_t*, int64_t, int, int);
int64_t lfs_flagstat_framed(const uint8_t*, int64_t, int, int, uint64_t*,
                            int64_t*);
int64_t lfs_flagstat_u16(const uint16_t*, int64_t, uint64_t*, int);
}
int main() {
    std::mt19937 rng(0);
    const int n_blocks = 13;
    const int64_t block = 1024000;
    std::vector<uint8_t> raw(n_blocks * block);
    for (auto& b : raw) b = rng() & 0x3F;
    std::vector<uint8_t> stream;
    for (int i = 0; i < n_blocks; ++i) {
        std::vector<uint8_t> comp(lfs_lz4_bound(block));
        int64_t c = lfs_lz4_compress(raw.data() + i * block, block,
                                     comp.data(), comp.size(), 0);
        if (c < 0) { printf("compress fail\n"); return 1; }
        int32_t rl = block, cl = c;
        stream.insert(stream.end(), (uint8_t*)&rl, (uint8_t*)&rl + 4);
        stream.insert(stream.end(), (uint8_t*)&cl, (uint8_t*)&cl + 4);
        stream.insert(stream.end(), comp.begin(), comp.begin() + c);
    }
    for (int trial = 0; trial < 5; ++trial) {
        std::vector<uint8_t> out(raw.size());
        int64_t r = lfs_decode_stream(stream.data(), stream.size(),
                                      out.data(), out.size(), 1, 8);
        if (r != (int64_t)raw.size() || memcmp(out.data(), raw.data(), raw.size())) {
            printf("decode mismatch\n");
            return 1;
        }
    }
    // fused decode+count pool (8 workers, thread-local buffers + counter
    // merge) vs the single-thread run and the threaded in-memory kernel
    {
        uint64_t f1[32] = {0}, f8[32] = {0}, fm[32] = {0};
        int64_t nw1 = 0, nw8 = 0;
        if (lfs_flagstat_framed(stream.data(), stream.size(), 1, 1, f1,
                                &nw1) != 0 ||
            lfs_flagstat_framed(stream.data(), stream.size(), 1, 8, f8,
                                &nw8) != 0 ||
            nw1 != (int64_t)raw.size() / 2 || nw8 != nw1) {
            printf("fused flagstat fail\n");
            return 1;
        }
        lfs_flagstat_u16((const uint16_t*)raw.data(), nw1, fm, 8);
        for (int k = 0; k < 32; ++k)
            if (f1[k] != f8[k] || f1[k] != fm[k]) {
                printf("fused flagstat mismatch k=%d\n", k);
                return 1;
            }
    }
    printf("TSAN decode stress OK\n");
    return 0;
}
