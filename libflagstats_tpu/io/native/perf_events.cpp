// perf_event_open counter groups for the native host tier.
//
// This framework's analogue of the reference's instrumented
// benchmark wrapper (reference: linux/linux-perf-events.h:16-90 and its
// use in linux/instrumented_benchmark.cpp:161-166,417-454): a group of
// hardware counters around the host kernels so cycles/instructions per
// 16-bit word are COUNTED, not inferred from wall clock. Clean-room
// design: a C ABI handle table over raw syscalls (the reference is a
// C++ RAII template class); group reads use PERF_FORMAT_GROUP|ID so one
// read() returns every counter coherently.
//
// Graceful degradation is part of the contract: virtualized hosts (like
// this environment) often expose no hardware PMU (perf_event_open
// returns ENOENT for PERF_TYPE_HARDWARE); lfs_perf_open then reports
// which events failed so the caller can fall back to software events or
// wall-clock inference, explicitly labeled.

#include <cstdint>
#include <cstring>

#if defined(__linux__)
#include <linux/perf_event.h>
#include <sys/ioctl.h>
#include <sys/syscall.h>
#include <unistd.h>
#include <cerrno>

namespace {

constexpr int kMaxGroups = 16;
constexpr int kMaxEvents = 12;

struct Group {
    int n = 0;
    int fds[kMaxEvents];
    uint64_t ids[kMaxEvents];
    bool used = false;
};

Group g_groups[kMaxGroups];

long perf_open(perf_event_attr* attr, int group_fd) {
    return syscall(__NR_perf_event_open, attr, 0 /*this thread*/,
                   -1 /*any cpu*/, group_fd, 0);
}

}  // namespace

extern "C" {

// Open a counter group of n events; types[i]/configs[i] are the
// perf_event_attr type/config pairs (e.g. PERF_TYPE_HARDWARE /
// PERF_COUNT_HW_CPU_CYCLES). Returns a handle >= 0, or -1 when no slot
// is free. Events that fail to open are skipped; ok_mask gets bit i set
// for each event that opened (so callers know exactly which columns are
// real). If NO event opens, returns -2.
int64_t lfs_perf_open(const uint32_t* types, const uint64_t* configs,
                      int32_t n, uint64_t* ok_mask) {
    int slot = -1;
    for (int i = 0; i < kMaxGroups; i++) {
        if (!g_groups[i].used) { slot = i; break; }
    }
    if (slot < 0) return -1;
    if (n > kMaxEvents) n = kMaxEvents;
    Group& g = g_groups[slot];
    g.n = 0;
    uint64_t mask = 0;
    int leader = -1;
    for (int i = 0; i < n; i++) {
        perf_event_attr attr;
        std::memset(&attr, 0, sizeof(attr));
        attr.type = types[i];
        attr.size = sizeof(attr);
        attr.config = configs[i];
        attr.disabled = (leader < 0) ? 1 : 0;  // group toggles via leader
        attr.exclude_kernel = 1;
        attr.exclude_hv = 1;
        attr.read_format = PERF_FORMAT_GROUP | PERF_FORMAT_ID;
        int fd = (int)perf_open(&attr, leader);
        if (fd < 0) continue;  // event unsupported here: skip, report via mask
        uint64_t id = 0;
        if (ioctl(fd, PERF_EVENT_IOC_ID, &id) != 0) { close(fd); continue; }
        if (leader < 0) leader = fd;
        g.fds[g.n] = fd;
        g.ids[g.n] = id;
        g.n++;
        mask |= (uint64_t)1 << i;
    }
    if (ok_mask) *ok_mask = mask;
    if (g.n == 0) return -2;
    g.used = true;
    return slot;
}

int32_t lfs_perf_start(int64_t h) {
    if (h < 0 || h >= kMaxGroups || !g_groups[h].used) return -1;
    Group& g = g_groups[h];
    if (ioctl(g.fds[0], PERF_EVENT_IOC_RESET, PERF_IOC_FLAG_GROUP) != 0)
        return -errno;
    if (ioctl(g.fds[0], PERF_EVENT_IOC_ENABLE, PERF_IOC_FLAG_GROUP) != 0)
        return -errno;
    return 0;
}

// Stop the group and write the counter values, in the order the events
// were OPENED (i.e. the surviving subset of the requested order), into
// out[0..n_opened). Returns the number of values written, or -errno.
int32_t lfs_perf_stop(int64_t h, uint64_t* out) {
    if (h < 0 || h >= kMaxGroups || !g_groups[h].used) return -1;
    Group& g = g_groups[h];
    if (ioctl(g.fds[0], PERF_EVENT_IOC_DISABLE, PERF_IOC_FLAG_GROUP) != 0)
        return -errno;
    // read_format GROUP|ID layout: u64 nr; { u64 value; u64 id; } cnt[nr];
    uint64_t buf[1 + 2 * kMaxEvents];
    ssize_t want = (ssize_t)((1 + 2 * (size_t)g.n) * sizeof(uint64_t));
    ssize_t got = read(g.fds[0], buf, sizeof(buf));
    if (got < want) return -EIO;
    uint64_t nr = buf[0];
    for (int i = 0; i < g.n; i++) out[i] = 0;
    for (uint64_t k = 0; k < nr && k < (uint64_t)kMaxEvents; k++) {
        uint64_t value = buf[1 + 2 * k];
        uint64_t id = buf[2 + 2 * k];
        for (int i = 0; i < g.n; i++) {
            if (g.ids[i] == id) { out[i] = value; break; }
        }
    }
    return g.n;
}

void lfs_perf_close(int64_t h) {
    if (h < 0 || h >= kMaxGroups || !g_groups[h].used) return;
    Group& g = g_groups[h];
    for (int i = 0; i < g.n; i++) close(g.fds[i]);
    g.n = 0;
    g.used = false;
}

}  // extern "C"

#else  // !__linux__

extern "C" {
int64_t lfs_perf_open(const uint32_t*, const uint64_t*, int32_t,
                      uint64_t* ok_mask) {
    if (ok_mask) *ok_mask = 0;
    return -2;
}
int32_t lfs_perf_start(int64_t) { return -1; }
int32_t lfs_perf_stop(int64_t, uint64_t*) { return -1; }
void lfs_perf_close(int64_t) {}
}

#endif
