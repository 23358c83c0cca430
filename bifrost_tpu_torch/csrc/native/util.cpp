// bifrost_tpu_torch's own copy of native/util.cpp, built by
// bifrost_tpu_torch/native.py with g++ at first use.
//
// Host-side utility C ABI for bifrost_tpu: affinity, aligned memory,
// strided copies, and a native ProcLog writer.
//
// These are the reference's host-native utility surfaces re-expressed
// for the TPU runtime (reference: src/bifrost/affinity.h, memory.h,
// proclog.h; implementations src/affinity.cpp, src/memory.cpp,
// src/proclog.cpp).  Device ('tpu') memory is owned by XLA and never
// routes here — only the host side of the space lattice does, which is
// exactly the part the reference implements with plain
// posix_memalign/memcpy under its space dispatch.

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>

#if defined(__linux__)
#include <pthread.h>
#include <sched.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>
#endif

#define BFT_OK 0
#define BFT_ERR_INVALID (-1)
#define BFT_ERR_STATE (-2)
#define BFT_ERR_ALLOC (-3)
#define BFT_ERR_OS (-6)

namespace {
constexpr int64_t ALIGNMENT = 512;   // BF_ALIGNMENT-equivalent
}

extern "C" {

// ---- affinity (reference: src/affinity.cpp bfAffinitySetCore /
// bfAffinityGetCore) --------------------------------------------------

int bft_affinity_set_core(int core) {
#if defined(__linux__)
    cpu_set_t s;
    CPU_ZERO(&s);
    if (core >= 0) {
        if (core >= CPU_SETSIZE) return BFT_ERR_INVALID;
        CPU_SET(core, &s);
    } else {
        // core < 0: unbind (allow all online cpus)
        long n = sysconf(_SC_NPROCESSORS_ONLN);
        for (long c = 0; c < n && c < CPU_SETSIZE; ++c) CPU_SET(c, &s);
    }
    if (pthread_setaffinity_np(pthread_self(), sizeof(s), &s))
        return BFT_ERR_OS;
    return BFT_OK;
#else
    (void)core;
    return BFT_ERR_STATE;
#endif
}

int bft_affinity_get_core(int* core_out) {
#if defined(__linux__)
    if (!core_out) return BFT_ERR_INVALID;
    cpu_set_t s;
    CPU_ZERO(&s);
    if (pthread_getaffinity_np(pthread_self(), sizeof(s), &s))
        return BFT_ERR_OS;
    int found = -1, count = 0;
    for (int c = 0; c < CPU_SETSIZE; ++c) {
        if (CPU_ISSET(c, &s)) {
            if (!count) found = c;
            ++count;
        }
    }
    // single-core binding reports the core; multi-core reports -1,
    // matching the reference's semantics
    *core_out = (count == 1) ? found : -1;
    return BFT_OK;
#else
    if (core_out) *core_out = -1;
    return BFT_ERR_STATE;
#endif
}

// ---- aligned host memory (reference: src/memory.cpp bfMalloc/bfFree/
// bfMemcpy/bfMemcpy2D/bfMemset, host-space arms) ----------------------

int bft_malloc(void** ptr_out, int64_t size) {
    if (!ptr_out || size < 0) return BFT_ERR_INVALID;
    if (size == 0) {
        *ptr_out = nullptr;
        return BFT_OK;
    }
    void* p = nullptr;
    int64_t padded = ((size + ALIGNMENT - 1) / ALIGNMENT) * ALIGNMENT;
    if (posix_memalign(&p, ALIGNMENT, padded)) return BFT_ERR_ALLOC;
    *ptr_out = p;
    return BFT_OK;
}

int bft_free(void* ptr) {
    std::free(ptr);
    return BFT_OK;
}

int bft_memcpy(void* dst, const void* src, int64_t n) {
    if ((!dst || !src) && n) return BFT_ERR_INVALID;
    if (n < 0) return BFT_ERR_INVALID;
    std::memcpy(dst, src, (size_t)n);
    return BFT_OK;
}

int bft_memcpy2d(void* dst, int64_t dst_stride,
                 const void* src, int64_t src_stride,
                 int64_t width, int64_t height) {
    if (width < 0 || height < 0) return BFT_ERR_INVALID;
    if ((!dst || !src) && width && height) return BFT_ERR_INVALID;
    if (dst_stride < width || src_stride < width) return BFT_ERR_INVALID;
    auto* d = static_cast<char*>(dst);
    auto* s = static_cast<const char*>(src);
    for (int64_t r = 0; r < height; ++r)
        std::memcpy(d + r * dst_stride, s + r * src_stride,
                    (size_t)width);
    return BFT_OK;
}

int bft_memset(void* ptr, int value, int64_t n) {
    if (!ptr && n) return BFT_ERR_INVALID;
    if (n < 0) return BFT_ERR_INVALID;
    std::memset(ptr, value, (size_t)n);
    return BFT_OK;
}

int bft_memset2d(void* ptr, int64_t stride, int value,
                 int64_t width, int64_t height) {
    if (width < 0 || height < 0 || stride < width) return BFT_ERR_INVALID;
    if (!ptr && width && height) return BFT_ERR_INVALID;
    auto* d = static_cast<char*>(ptr);
    for (int64_t r = 0; r < height; ++r)
        std::memset(d + r * stride, value, (size_t)width);
    return BFT_OK;
}

// ---- ProcLog writer (reference: src/proclog.cpp ProcLog::update;
// layout <base>/<pid>/<block>/<log>, one "key : value" per line).
// The directory base matches bifrost_tpu/proclog.py so native blocks
// and Python blocks land in one tree. -----------------------------------

static std::string g_proclog_base;
static std::mutex g_proclog_mutex;

int bft_proclog_set_base(const char* base) {
    if (!base || !*base) return BFT_ERR_INVALID;
    std::lock_guard<std::mutex> lk(g_proclog_mutex);
    g_proclog_base = base;
    return BFT_OK;
}

int bft_proclog_update(const char* block, const char* log,
                       const char* contents) {
#if defined(__linux__)
    if (!block || !log || !contents) return BFT_ERR_INVALID;
    std::string base;
    {
        std::lock_guard<std::mutex> lk(g_proclog_mutex);
        base = g_proclog_base;
    }
    if (base.empty()) return BFT_ERR_STATE;
    std::string dir = base + "/" +
        std::to_string((long long)getpid());
    if (mkdir(dir.c_str(), 0775) && errno != EEXIST) return BFT_ERR_OS;
    dir += "/";
    dir += block;
    if (mkdir(dir.c_str(), 0775) && errno != EEXIST) return BFT_ERR_OS;
    std::string tmp = dir + "/." + log + ".tmp";
    std::string fin = dir + "/" + log;
    FILE* f = std::fopen(tmp.c_str(), "w");
    if (!f) return BFT_ERR_OS;
    size_t len = std::strlen(contents);
    if (len && std::fwrite(contents, 1, len, f) != len) {
        std::fclose(f);
        std::remove(tmp.c_str());
        return BFT_ERR_OS;
    }
    std::fclose(f);
    if (std::rename(tmp.c_str(), fin.c_str())) {
        std::remove(tmp.c_str());
        return BFT_ERR_OS;
    }
    return BFT_OK;
#else
    (void)block; (void)log; (void)contents;
    return BFT_ERR_STATE;
#endif
}

}  // extern "C"
