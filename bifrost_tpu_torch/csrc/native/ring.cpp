// bifrost_tpu_torch's own copy of native/ring.cpp, built by
// bifrost_tpu_torch/native.py with g++ at first use.
//
// Native ring buffer runtime for bifrost_tpu.
//
// Re-implements the semantics of the reference ring
// (reference: src/ring_impl.{hpp,cpp} — ghost region, guarantees,
// tail-pull overwrite, in-order commit barrier, blocking acquire with
// partial final span, live resize preserving buffered data) as a small
// C++17 library with a pure-C ABI consumed from Python via ctypes
// (replacing the reference's ctypesgen-generated bindings,
// python/Makefile.in:23-30).
//
// Concurrency model matches the reference: one mutex per ring plus
// condition variables for readers (data committed), writers (space
// freed), sequences (new sequence / sequence ended), and span-close
// (resize waits for quiescence).
//
// Memory spaces: this core manages HOST memory (posix_memalign, 512-byte
// aligned like BF_ALIGNMENT, reference: src/memory.cpp:334-351).  Device
// ('tpu') rings keep their payloads as jax Arrays on the Python side;
// only host rings route here.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#if defined(__linux__)
#include <dirent.h>
#include <sys/syscall.h>
#include <unistd.h>
#endif
#include <deque>
#include <limits>
#include <map>
#include <memory>
#include <mutex>
#include <set>
#include <string>
#include <vector>

#define BFT_OK 0
#define BFT_END_OF_DATA 1
#define BFT_WOULD_BLOCK 2
#define BFT_ERR_INVALID (-1)
#define BFT_ERR_STATE (-2)
#define BFT_ERR_ALLOC (-3)

namespace {

constexpr int64_t ALIGNMENT = 512;
constexpr int64_t NO_END = std::numeric_limits<int64_t>::max();

struct Sequence {
    std::string name;
    long long time_tag = -1;
    std::string header;
    int64_t begin = 0;
    int64_t end = NO_END;     // NO_END while open
    int64_t nringlet = 1;
    Sequence* next = nullptr;

    bool finished() const { return end != NO_END; }
};

struct WSpan {
    int64_t id = 0;
    int64_t begin = 0;
    int64_t nbyte = 0;
    int64_t commit_nbyte = -1;   // -1 = still open
};

struct Reader {
    int64_t id = 0;
    bool guarantee = true;
    int64_t guarantee_offset = 0;   // only meaningful if guarantee
    // Begin offsets of this reader's OPEN spans.  A guaranteed reader
    // with several spans outstanding (the bridge's credit window holds
    // spans un-released until the peer acks them) must keep the
    // guarantee at the OLDEST open span — the reference refcount-locks
    // the tail per span (ring_impl.hpp:110-141); a bare watermark
    // would let a later acquire unlock bytes an earlier open span is
    // still exporting zero-copy.
    std::multiset<int64_t> open_spans;
    // END offset per open-span begin (max over duplicates): a release
    // advances the consumed frontier to the span's END — the reader
    // READ those bytes, so a drop_oldest shed racing the
    // no-open-spans window must not count them again (the shed ledger
    // would otherwise exceed produced == delivered + shed).
    std::map<int64_t, int64_t> open_span_ends;
    // Highest span END ever RELEASED: out-of-order releases must
    // advance the guarantee to this high-water mark once no span is
    // open, not to the last-released begin.
    int64_t release_high = 0;
};

// Bind freshly allocated ring pages to the NUMA node of `core` via the
// raw mbind syscall (reference binds ring memory with hwloc:
// ring_impl.cpp:164-166).  Advisory: failures are ignored.
#if defined(__linux__)
static void numa_bind_to_core(void* addr, size_t len, int core) {
#ifdef SYS_mbind
    if (core < 0 || !addr || !len) return;
    char path[96];
    std::snprintf(path, sizeof(path),
                  "/sys/devices/system/cpu/cpu%d", core);
    DIR* d = opendir(path);
    if (!d) return;
    int node = -1;
    while (struct dirent* e = readdir(d)) {
        if (std::strncmp(e->d_name, "node", 4) == 0 &&
            e->d_name[4] >= '0' && e->d_name[4] <= '9') {
            node = std::atoi(e->d_name + 4);
            break;
        }
    }
    closedir(d);
    if (node < 0) return;
    const int MPOL_BIND_ = 2;
    unsigned long mask = 1UL << node;
    long page = sysconf(_SC_PAGESIZE);
    uintptr_t start = (uintptr_t)addr & ~(uintptr_t)(page - 1);
    size_t length = len + ((uintptr_t)addr - start);
    syscall(SYS_mbind, (void*)start, length, MPOL_BIND_, &mask,
            8 * sizeof(mask) + 1, 0);
#else
    (void)addr; (void)len; (void)core;
#endif
}
#else
static void numa_bind_to_core(void*, size_t, int) {}
#endif

struct Ring {
    std::mutex mtx;
    std::condition_variable read_cv;     // data committed / seq ended
    std::condition_variable write_cv;    // space freed
    std::condition_variable seq_cv;      // sequence list changed
    std::condition_variable span_cv;     // span closed (resize gate)

    std::string name;

    uint8_t* buf = nullptr;
    int64_t size = 0;        // per-lane capacity
    int64_t ghost = 0;       // per-lane ghost span
    int64_t nringlet = 1;

    int64_t tail = 0;
    int64_t head = 0;
    int64_t reserve_head = 0;

    // Sequences are kept for the lifetime of the ring (registry) but the
    // *live* window is [live_begin, end of deque).
    std::deque<std::unique_ptr<Sequence>> sequences;
    size_t live_begin = 0;

    std::deque<WSpan> open_wspans;       // reserve order
    int64_t next_wspan_id = 1;

    std::map<int64_t, std::unique_ptr<Reader>> readers;
    int64_t next_reader_id = 1;

    int nwrite_open = 0;
    int nread_open = 0;
    bool writing = false;
    bool eod = false;
    int bind_core = -1;      // NUMA-bind new allocations to this core
    std::atomic<long long> total_written{0};

    // deferred resize (bft_ring_request_resize): target geometry
    // recorded while spans were open, applied by the span-release
    // paths the moment the ring goes quiescent.  -1 = none pending.
    int64_t pending_ghost = -1;
    int64_t pending_size = -1;
    int64_t pending_nringlet = -1;
    // external apply blockers (bft_ring_resize_hold): the Python layer
    // holds one per registered deferred D2H fill, whose cached numpy
    // view into THIS buffer would dangle under a re-layout
    int resize_holds = 0;

    int64_t lane_nbyte() const { return size + ghost; }

    bool resize_pending_locked() const { return pending_size >= 0; }

    // fold the pending request into an explicit target (MAX semantics)
    // and clear it; callers apply the returned geometry themselves.
    // MUST NOT be called while resize_holds > 0: the holds exist
    // precisely because a deferred fill's cached view into the
    // current buffer would dangle under a re-layout — callers that
    // reach quiescence on spans alone keep the target pending.
    void fold_pending_locked(int64_t* g, int64_t* s, int64_t* n) {
        if (resize_holds != 0) return;
        if (pending_ghost > *g) *g = pending_ghost;
        if (pending_size > *s) *s = pending_size;
        if (pending_nringlet > *n) *n = pending_nringlet;
        pending_ghost = pending_size = pending_nringlet = -1;
    }

    // apply a pending deferred resize if quiescent RIGHT NOW; returns
    // BFT_OK whether or not anything was pending (alloc errors pass
    // through)
    int maybe_apply_pending_locked() {
        if (!resize_pending_locked()) return BFT_OK;
        if (nwrite_open != 0 || nread_open != 0 || resize_holds != 0)
            return BFT_OK;
        int64_t g = ghost, s = size, n = nringlet;
        fold_pending_locked(&g, &s, &n);
        if (g == ghost && s == size && n == nringlet) return BFT_OK;
        int rc = realloc_locked(s, g, n);
        if (rc != BFT_OK) {
            // fold cleared the pending target; an allocation failure
            // must not silently lose the requested grow (the tuner's
            // re-issue contract relies on the target staying pending
            // until it lands) — restore it for the next quiescence
            if (g > ghost && g > pending_ghost) pending_ghost = g;
            if (s > size && s > pending_size) pending_size = s;
            if (n > nringlet && n > pending_nringlet)
                pending_nringlet = n;
            return rc;
        }
        write_cv.notify_all();
        read_cv.notify_all();
        return BFT_OK;
    }

    int64_t min_guarantee_locked() const {
        int64_t g = NO_END;
        for (auto& kv : readers) {
            if (kv.second->guarantee && kv.second->guarantee_offset < g)
                g = kv.second->guarantee_offset;
        }
        return g;
    }

    void gc_sequences_locked() {
        // drop fully-consumed finished sequences from the live window;
        // the Sequence objects themselves stay valid (Python may hold
        // pointers) but their header payloads are released
        while (sequences.size() - live_begin > 1) {
            Sequence* s = sequences[live_begin].get();
            if (s->finished() && s->end <= tail && s->next != nullptr) {
                std::string().swap(s->header);
                ++live_begin;
            } else {
                break;
            }
        }
    }

    int realloc_locked(int64_t new_size, int64_t new_ghost,
                       int64_t new_nringlet) {
        uint8_t* nb = nullptr;
        size_t total = (size_t)new_nringlet * (new_size + new_ghost);
        if (posix_memalign(reinterpret_cast<void**>(&nb), ALIGNMENT,
                           total ? total : ALIGNMENT) != 0)
            return BFT_ERR_ALLOC;
        // bind BEFORE first touch: mbind without MPOL_MF_MOVE only
        // steers future page faults, and memset faults every page
        numa_bind_to_core(nb, total, bind_core);
        std::memset(nb, 0, total);
        if (buf && head > tail) {
            // preserve [tail, head) across the re-layout, per lane
            int64_t t = tail, h = head;
            if (h - t > new_size) t = h - new_size;
            for (int64_t o = t; o < h;) {
                int64_t run = h - o;
                run = std::min(run, size - (o % size));
                run = std::min(run, new_size - (o % new_size));
                for (int64_t lane = 0;
                     lane < std::min(nringlet, new_nringlet); ++lane) {
                    std::memcpy(nb + lane * (new_size + new_ghost)
                                   + (o % new_size),
                                buf + lane * lane_nbyte() + (o % size),
                                (size_t)run);
                }
                o += run;
            }
        }
        std::free(buf);
        buf = nb;
        size = new_size;
        ghost = new_ghost;
        nringlet = new_nringlet;
        return BFT_OK;
    }

    void ghost_write_locked(int64_t begin, int64_t nbyte) {
        // mirror overflow past the nominal end back to the start
        int64_t bo = begin % size;
        int64_t over = bo + nbyte - size;
        if (over > 0) {
            for (int64_t lane = 0; lane < nringlet; ++lane) {
                uint8_t* base = buf + lane * lane_nbyte();
                std::memcpy(base, base + size, (size_t)over);
            }
        }
    }

    void ghost_read_locked(int64_t begin, int64_t nbyte) {
        // refresh the ghost from the start before a wrapped read
        int64_t bo = begin % size;
        int64_t over = bo + nbyte - size;
        if (over > 0) {
            for (int64_t lane = 0; lane < nringlet; ++lane) {
                uint8_t* base = buf + lane * lane_nbyte();
                std::memcpy(base + size, base, (size_t)over);
            }
        }
    }

    ~Ring() { std::free(buf); }
};

}  // namespace

extern "C" {

int bft_ring_create(void** out, const char* name) {
    if (!out) return BFT_ERR_INVALID;
    Ring* r = new (std::nothrow) Ring();
    if (!r) return BFT_ERR_ALLOC;
    r->name = name ? name : "";
    *out = r;
    return BFT_OK;
}

int bft_ring_destroy(void* ring) {
    delete static_cast<Ring*>(ring);
    return BFT_OK;
}

int bft_ring_set_core(void* ring_, int core) {
    Ring* r = static_cast<Ring*>(ring_);
    if (!r) return BFT_ERR_INVALID;
    std::lock_guard<std::mutex> lk(r->mtx);
    r->bind_core = core;
    return BFT_OK;
}

int bft_ring_resize(void* ring_, long long contig, long long total,
                    long long nringlet) {
    Ring* r = static_cast<Ring*>(ring_);
    if (!r) return BFT_ERR_INVALID;
    std::unique_lock<std::mutex> lk(r->mtx);
    if (total < 0) total = contig * 4;
    int64_t ghost = std::max<int64_t>(r->ghost, contig);
    int64_t size = std::max<int64_t>(r->size, total);
    int64_t nrl = std::max<int64_t>(r->nringlet, nringlet);
    // fold in any deferred request_resize target: this blocking path
    // reaches quiescence anyway, so the pending geometry lands here
    if (r->resize_pending_locked())
        r->fold_pending_locked(&ghost, &size, &nrl);
    if (size == r->size && ghost == r->ghost && nrl == r->nringlet)
        return BFT_OK;
    // wait for quiescence (reference: RingReallocLock)
    r->span_cv.wait(lk, [&] {
        return r->nwrite_open == 0 && r->nread_open == 0;
    });
    int rc = r->realloc_locked(size, ghost, nrl);
    if (rc != BFT_OK) return rc;
    r->write_cv.notify_all();
    r->read_cv.notify_all();
    return BFT_OK;
}

int bft_ring_request_resize(void* ring_, long long contig,
                            long long total, long long nringlet,
                            int* applied) {
    // Non-blocking deferred resize (the auto-tuner's retune protocol):
    // apply immediately when quiescent, else record the target and let
    // bft_ring_commit / bft_reader_release apply it the moment the
    // oldest open span releases and no other span remains open.
    // *applied = 1 when the requested geometry is live on return.
    Ring* r = static_cast<Ring*>(ring_);
    if (!r || !applied) return BFT_ERR_INVALID;
    std::lock_guard<std::mutex> lk(r->mtx);
    if (total < 0) total = contig * 4;
    int64_t ghost = std::max<int64_t>(r->ghost, contig);
    int64_t size = std::max<int64_t>(r->size, total);
    int64_t nrl = std::max<int64_t>(r->nringlet, nringlet);
    if (size == r->size && ghost == r->ghost && nrl == r->nringlet) {
        *applied = 1;                 // no-op: already that large
        return BFT_OK;
    }
    if (ghost > r->pending_ghost) r->pending_ghost = ghost;
    if (size > r->pending_size) r->pending_size = size;
    if (nrl > r->pending_nringlet) r->pending_nringlet = nrl;
    int rc = r->maybe_apply_pending_locked();
    if (rc != BFT_OK) return rc;
    *applied = r->resize_pending_locked() ? 0 : 1;
    return BFT_OK;
}

int bft_ring_resize_hold(void* ring_, int delta) {
    // adjust the external apply-blocker count (deferred fills); a drop
    // to zero is itself a quiescence point
    Ring* r = static_cast<Ring*>(ring_);
    if (!r) return BFT_ERR_INVALID;
    std::lock_guard<std::mutex> lk(r->mtx);
    r->resize_holds += delta;
    if (r->resize_holds < 0) r->resize_holds = 0;
    if (r->resize_holds == 0) return r->maybe_apply_pending_locked();
    return BFT_OK;
}

int bft_ring_resize_pending(void* ring_, int* pending) {
    Ring* r = static_cast<Ring*>(ring_);
    if (!r || !pending) return BFT_ERR_INVALID;
    std::lock_guard<std::mutex> lk(r->mtx);
    *pending = r->resize_pending_locked() ? 1 : 0;
    return BFT_OK;
}

int bft_ring_geometry(void* ring_, unsigned char** buf, long long* size,
                      long long* ghost, long long* nringlet) {
    Ring* r = static_cast<Ring*>(ring_);
    if (!r) return BFT_ERR_INVALID;
    std::lock_guard<std::mutex> lk(r->mtx);
    if (buf) *buf = r->buf;
    if (size) *size = r->size;
    if (ghost) *ghost = r->ghost;
    if (nringlet) *nringlet = r->nringlet;
    return BFT_OK;
}

int bft_ring_begin_writing(void* ring_) {
    Ring* r = static_cast<Ring*>(ring_);
    if (!r) return BFT_ERR_INVALID;
    std::lock_guard<std::mutex> lk(r->mtx);
    r->writing = true;
    r->eod = false;
    return BFT_OK;
}

int bft_ring_end_writing(void* ring_) {
    Ring* r = static_cast<Ring*>(ring_);
    if (!r) return BFT_ERR_INVALID;
    std::lock_guard<std::mutex> lk(r->mtx);
    r->writing = false;
    r->eod = true;
    r->read_cv.notify_all();
    r->seq_cv.notify_all();
    return BFT_OK;
}

int bft_ring_begin_sequence(void* ring_, const char* name,
                            long long time_tag, const char* header,
                            long long header_len, long long nringlet,
                            void** seq_out) {
    Ring* r = static_cast<Ring*>(ring_);
    if (!r || !seq_out) return BFT_ERR_INVALID;
    std::lock_guard<std::mutex> lk(r->mtx);
    if (!r->sequences.empty()) {
        Sequence* prev = r->sequences.back().get();
        if (!prev->finished()) return BFT_ERR_STATE;
    }
    auto seq = std::make_unique<Sequence>();
    seq->name = name ? name : "";
    seq->time_tag = time_tag;
    seq->header.assign(header ? header : "", (size_t)header_len);
    seq->begin = r->head;
    seq->nringlet = nringlet;
    Sequence* sp = seq.get();
    if (!r->sequences.empty())
        r->sequences.back()->next = sp;
    r->sequences.push_back(std::move(seq));
    r->seq_cv.notify_all();
    *seq_out = sp;
    return BFT_OK;
}

int bft_ring_end_sequence(void* ring_, void* seq_) {
    Ring* r = static_cast<Ring*>(ring_);
    Sequence* s = static_cast<Sequence*>(seq_);
    if (!r || !s) return BFT_ERR_INVALID;
    std::lock_guard<std::mutex> lk(r->mtx);
    s->end = r->head;
    r->read_cv.notify_all();
    r->seq_cv.notify_all();
    return BFT_OK;
}

int bft_seq_info(void* seq_, const char** name, long long* time_tag,
                 const char** header, long long* header_len,
                 long long* begin, long long* nringlet) {
    Sequence* s = static_cast<Sequence*>(seq_);
    if (!s) return BFT_ERR_INVALID;
    if (name) *name = s->name.c_str();
    if (time_tag) *time_tag = s->time_tag;
    if (header) *header = s->header.data();
    if (header_len) *header_len = (long long)s->header.size();
    if (begin) *begin = s->begin;
    if (nringlet) *nringlet = s->nringlet;
    return BFT_OK;
}

int bft_seq_end_offset(void* seq_, long long* end) {
    Sequence* s = static_cast<Sequence*>(seq_);
    if (!s || !end) return BFT_ERR_INVALID;
    *end = s->finished() ? s->end : -1;
    return BFT_OK;
}

// ---- writer spans ---------------------------------------------------------

int bft_ring_reserve(void* ring_, long long nbyte, int nonblocking,
                     long long* begin_out, long long* span_id_out) {
    Ring* r = static_cast<Ring*>(ring_);
    if (!r || !begin_out || !span_id_out || nbyte < 0)
        return BFT_ERR_INVALID;
    std::unique_lock<std::mutex> lk(r->mtx);
    // A queued partial commit truncates reserve_head when it lands;
    // reserving past it would hand out offsets that the truncation
    // then invalidates.
    for (auto& ws : r->open_wspans)
        if (ws.commit_nbyte >= 0 && ws.commit_nbyte < ws.nbyte)
            return BFT_ERR_STATE;
    if (nbyte > r->ghost) {
        // guaranteed-contiguous window too small; grow it (folding in
        // any deferred request_resize target — we are at quiescence)
        r->span_cv.wait(lk, [&] {
            return r->nwrite_open == 0 && r->nread_open == 0;
        });
        int64_t g = std::max<int64_t>(r->ghost, nbyte);
        int64_t s = std::max<int64_t>(r->size, nbyte * 4);
        int64_t n = r->nringlet;
        if (r->resize_pending_locked())
            r->fold_pending_locked(&g, &s, &n);
        int rc = r->realloc_locked(s, g, n);
        if (rc != BFT_OK) return rc;
    }
    int64_t begin = r->reserve_head;
    int64_t new_reserve = begin + nbyte;
    for (;;) {
        int64_t new_tail = new_reserve - r->size;
        int64_t limit = std::min<int64_t>(r->head,
                                          r->min_guarantee_locked());
        if (new_tail <= limit) break;
        if (nonblocking) return BFT_WOULD_BLOCK;
        r->write_cv.wait(lk);
    }
    r->reserve_head = new_reserve;
    int64_t new_tail = new_reserve - r->size;
    if (new_tail > r->tail) {
        r->tail = new_tail;     // overwrite: pull the tail forward
        r->gc_sequences_locked();
    }
    WSpan ws;
    ws.id = r->next_wspan_id++;
    ws.begin = begin;
    ws.nbyte = nbyte;
    r->open_wspans.push_back(ws);
    r->nwrite_open += 1;
    *begin_out = begin;
    *span_id_out = ws.id;
    return BFT_OK;
}

int bft_ring_reserve_shed(void* ring_, long long nbyte,
                          long long frame_nbyte, long long* begin_out,
                          long long* span_id_out,
                          long long* shed_bytes_out) {
    // bft_ring_reserve with the drop_oldest overload policy
    // (docs/robustness.md "Overload & degradation"): instead of
    // blocking on guaranteed readers, advance their guarantees in
    // whole-frame steps past the bytes this reservation must
    // overwrite — clamped at each reader's oldest OPEN span, so a
    // held span's zero-copy view is never invalidated.  The shed is
    // COUNTED: *shed_bytes_out accumulates the min-guarantee advance
    // (== the bytes a sequential guaranteed reader will observe as
    // nframe_skipped at its next acquire — the byte-accurate audit
    // the chaos harness checks).  Blocks only on the committed head
    // (the writer's own open spans) and on readers pinned by open
    // spans, both of which resolve by peer progress — never a
    // deadlock against a slow reader.
    Ring* r = static_cast<Ring*>(ring_);
    if (!r || !begin_out || !span_id_out || !shed_bytes_out ||
        nbyte < 0)
        return BFT_ERR_INVALID;
    if (frame_nbyte <= 0) frame_nbyte = 1;
    *shed_bytes_out = 0;
    std::unique_lock<std::mutex> lk(r->mtx);
    for (auto& ws : r->open_wspans)
        if (ws.commit_nbyte >= 0 && ws.commit_nbyte < ws.nbyte)
            return BFT_ERR_STATE;
    if (nbyte > r->ghost) {
        r->span_cv.wait(lk, [&] {
            return r->nwrite_open == 0 && r->nread_open == 0;
        });
        int64_t g = std::max<int64_t>(r->ghost, nbyte);
        int64_t s = std::max<int64_t>(r->size, nbyte * 4);
        int64_t n = r->nringlet;
        if (r->resize_pending_locked())
            r->fold_pending_locked(&g, &s, &n);
        int rc = r->realloc_locked(s, g, n);
        if (rc != BFT_OK) return rc;
    }
    int64_t begin = r->reserve_head;
    int64_t new_reserve = begin + nbyte;
    for (;;) {
        int64_t new_tail = new_reserve - r->size;
        int64_t limit = std::min<int64_t>(r->head,
                                          r->min_guarantee_locked());
        if (new_tail <= limit) break;
        // shed: only guaranteed readers can be advanced, and only
        // over COMMITTED bytes (new_tail <= head); otherwise the
        // writer is blocked on its own commit barrier and must wait
        bool advanced = false;
        if (new_tail <= r->head) {
            int64_t old_min = r->min_guarantee_locked();
            for (auto& kv : r->readers) {
                Reader* rd = kv.second.get();
                if (!rd->guarantee || rd->guarantee_offset >= new_tail)
                    continue;
                int64_t target = rd->guarantee_offset +
                    ((new_tail - rd->guarantee_offset + frame_nbyte - 1)
                     / frame_nbyte) * frame_nbyte;
                if (!rd->open_spans.empty())
                    target = std::min<int64_t>(
                        target, *rd->open_spans.begin());
                if (target > rd->guarantee_offset) {
                    rd->guarantee_offset = target;
                    advanced = true;
                }
            }
            if (advanced) {
                int64_t new_min = r->min_guarantee_locked();
                if (new_min > old_min && old_min != NO_END)
                    *shed_bytes_out += new_min - old_min;
                continue;           // re-check the limit
            }
        }
        r->write_cv.wait(lk);
    }
    r->reserve_head = new_reserve;
    int64_t new_tail = new_reserve - r->size;
    if (new_tail > r->tail) {
        r->tail = new_tail;
        r->gc_sequences_locked();
    }
    WSpan ws;
    ws.id = r->next_wspan_id++;
    ws.begin = begin;
    ws.nbyte = nbyte;
    r->open_wspans.push_back(ws);
    r->nwrite_open += 1;
    *begin_out = begin;
    *span_id_out = ws.id;
    return BFT_OK;
}

int bft_ring_commit(void* ring_, long long span_id, long long commit_nbyte) {
    Ring* r = static_cast<Ring*>(ring_);
    if (!r) return BFT_ERR_INVALID;
    std::lock_guard<std::mutex> lk(r->mtx);
    // A partial commit truncates reserve_head, so it is only legal on
    // the newest outstanding span; reject it up front, before any state
    // changes (an error raised mid-pop used to leak nwrite_open and
    // permanently block resize quiescence).
    bool found = false;
    for (auto& ws : r->open_wspans) {
        if (ws.id == span_id) {
            if (ws.commit_nbyte >= 0) return BFT_ERR_STATE;
            if (commit_nbyte > ws.nbyte) return BFT_ERR_INVALID;
            if (commit_nbyte < ws.nbyte &&
                ws.id != r->open_wspans.back().id)
                return BFT_ERR_STATE;
            ws.commit_nbyte = commit_nbyte;
            found = true;
            break;
        }
    }
    if (!found) return BFT_ERR_INVALID;
    // in-order commit barrier (reference: ring_impl.cpp:591-594)
    while (!r->open_wspans.empty() &&
           r->open_wspans.front().commit_nbyte >= 0) {
        WSpan ws = r->open_wspans.front();
        r->open_wspans.pop_front();
        if (ws.commit_nbyte > 0)
            r->ghost_write_locked(ws.begin, ws.commit_nbyte);
        if (ws.commit_nbyte < ws.nbyte)
            r->reserve_head = ws.begin + ws.commit_nbyte;
        r->head = ws.begin + ws.commit_nbyte;
        r->total_written += ws.commit_nbyte;
        r->nwrite_open -= 1;
    }
    // quiescence point: a deferred request_resize applies the moment
    // no span remains open
    r->maybe_apply_pending_locked();
    r->read_cv.notify_all();
    r->span_cv.notify_all();
    return BFT_OK;
}

// ---- readers --------------------------------------------------------------

int bft_reader_create(void* ring_, int guarantee, long long* reader_id) {
    Ring* r = static_cast<Ring*>(ring_);
    if (!r || !reader_id) return BFT_ERR_INVALID;
    std::lock_guard<std::mutex> lk(r->mtx);
    auto rd = std::make_unique<Reader>();
    rd->id = r->next_reader_id++;
    rd->guarantee = guarantee != 0;
    rd->guarantee_offset = r->tail;
    *reader_id = rd->id;
    r->readers[rd->id] = std::move(rd);
    return BFT_OK;
}

int bft_reader_destroy(void* ring_, long long reader_id) {
    Ring* r = static_cast<Ring*>(ring_);
    if (!r) return BFT_ERR_INVALID;
    std::lock_guard<std::mutex> lk(r->mtx);
    r->readers.erase(reader_id);
    r->write_cv.notify_all();
    return BFT_OK;
}

int bft_reader_set_guarantee(void* ring_, long long reader_id,
                             long long offset, int clamp_forward_only) {
    Ring* r = static_cast<Ring*>(ring_);
    if (!r) return BFT_ERR_INVALID;
    std::lock_guard<std::mutex> lk(r->mtx);
    auto it = r->readers.find(reader_id);
    if (it == r->readers.end()) return BFT_ERR_INVALID;
    Reader* rd = it->second.get();
    // a sequence move (reader_moved) must not unlock bytes a still-open
    // span of the previous sequence is exporting; mode 2 (the poison
    // wakeup) forces past open spans — the ring is dead and blocked
    // writers must be released
    if (clamp_forward_only != 2 && !rd->open_spans.empty())
        offset = std::min<long long>(offset, *rd->open_spans.begin());
    if (clamp_forward_only && offset < rd->guarantee_offset)
        return BFT_OK;
    rd->guarantee_offset = std::max<int64_t>(offset, 0);
    r->write_cv.notify_all();
    return BFT_OK;
}

// which: 0=specific(name), 1=at(time_tag), 2=latest, 3=earliest
int bft_ring_open_sequence(void* ring_, int which, const char* name,
                           long long time_tag, void** seq_out) {
    Ring* r = static_cast<Ring*>(ring_);
    if (!r || !seq_out) return BFT_ERR_INVALID;
    std::unique_lock<std::mutex> lk(r->mtx);
    for (;;) {
        for (size_t i = r->live_begin; i < r->sequences.size(); ++i) {
            Sequence* s = r->sequences[i].get();
            switch (which) {
                case 0:
                    if (s->name == (name ? name : "")) {
                        *seq_out = s;
                        return BFT_OK;
                    }
                    break;
                case 1:
                    if (s->time_tag == time_tag) {
                        *seq_out = s;
                        return BFT_OK;
                    }
                    break;
                case 3:
                    if (!s->finished() || s->end > r->tail) {
                        *seq_out = s;
                        return BFT_OK;
                    }
                    break;
                default:
                    break;
            }
        }
        if (which == 2 && r->live_begin < r->sequences.size()) {
            *seq_out = r->sequences.back().get();
            return BFT_OK;
        }
        if (which == 3 && r->live_begin < r->sequences.size()) {
            *seq_out = r->sequences.back().get();
            return BFT_OK;
        }
        if (r->eod) return BFT_END_OF_DATA;
        r->seq_cv.wait(lk);
    }
}

int bft_seq_next(void* ring_, void* seq_, void** next_out) {
    Ring* r = static_cast<Ring*>(ring_);
    Sequence* s = static_cast<Sequence*>(seq_);
    if (!r || !s || !next_out) return BFT_ERR_INVALID;
    std::unique_lock<std::mutex> lk(r->mtx);
    for (;;) {
        if (s->next) {
            *next_out = s->next;
            return BFT_OK;
        }
        if (r->eod && s->finished()) return BFT_END_OF_DATA;
        r->seq_cv.wait(lk);
    }
}

int bft_reader_acquire(void* ring_, long long reader_id, void* seq_,
                       long long offset, long long nbyte,
                       long long frame_nbyte, long long* begin_out,
                       long long* nbyte_out) {
    Ring* r = static_cast<Ring*>(ring_);
    Sequence* s = static_cast<Sequence*>(seq_);
    if (!r || !s || !begin_out || !nbyte_out || frame_nbyte <= 0)
        return BFT_ERR_INVALID;
    std::unique_lock<std::mutex> lk(r->mtx);
    int64_t want_begin = s->begin + offset;
    // NOTE: never cache the Reader* across a cv wait — a concurrent
    // bft_reader_destroy can free it while the mutex is released.
    auto find_reader = [&]() -> Reader* {
        auto it = r->readers.find(reader_id);
        return it == r->readers.end() ? nullptr : it->second.get();
    };
    {
        Reader* rd = find_reader();
        // pre-wait bump: only when no span is open — an open span's
        // begin already bounds the guarantee and must keep doing so
        if (rd && rd->guarantee && rd->open_spans.empty()) {
            int64_t g = std::min<int64_t>(want_begin, r->head);
            if (g > rd->guarantee_offset) rd->guarantee_offset = g;
        }
    }
    int64_t end;
    for (;;) {
        int64_t seq_end = s->finished() ? s->end : NO_END;
        if (seq_end != NO_END && want_begin >= seq_end)
            return BFT_END_OF_DATA;
        int64_t limit = (seq_end != NO_END) ? seq_end
                        : (r->eod ? r->head : NO_END);
        if (r->eod && limit != NO_END && want_begin >= limit)
            return BFT_END_OF_DATA;
        if (want_begin + nbyte <= r->head) {
            end = want_begin + nbyte;
            break;
        }
        if (limit != NO_END && limit <= r->head) {
            end = std::min<int64_t>(limit, want_begin + nbyte);
            break;
        }
        r->read_cv.wait(lk);
    }
    int64_t begin = want_begin;
    if (begin < r->tail) {
        int64_t skip = r->tail - begin;
        skip = ((skip + frame_nbyte - 1) / frame_nbyte) * frame_nbyte;
        begin = std::min<int64_t>(begin + skip, end);
    }
    Reader* rd = find_reader();   // re-lookup: may have been destroyed
    if (rd && rd->guarantee) {
        rd->open_spans.insert(begin);
        int64_t& e = rd->open_span_ends[begin];
        if (end > e) e = end;
        // guarantee = oldest open span (never jumps past a held
        // span); an ADVANCE frees writer space, so notify
        int64_t g = *rd->open_spans.begin();
        if (g > rd->guarantee_offset) r->write_cv.notify_all();
        rd->guarantee_offset = g;
    }
    int64_t got = std::max<int64_t>(end - begin, 0);
    if (got > 0) r->ghost_read_locked(begin, got);
    r->nread_open += 1;
    *begin_out = begin;
    *nbyte_out = got;
    return BFT_OK;
}

int bft_reader_release(void* ring_, long long reader_id,
                       long long span_begin) {
    Ring* r = static_cast<Ring*>(ring_);
    if (!r) return BFT_ERR_INVALID;
    std::lock_guard<std::mutex> lk(r->mtx);
    auto it = r->readers.find(reader_id);
    if (it != r->readers.end()) {
        Reader* rd = it->second.get();
        if (rd->guarantee) {
            auto os = rd->open_spans.find(span_begin);
            if (os != rd->open_spans.end()) rd->open_spans.erase(os);
            // consumed frontier = the released span's END (the reader
            // read those bytes); only forget the end once no
            // duplicate-begin span remains open
            int64_t span_end = span_begin;
            auto ie = rd->open_span_ends.find(span_begin);
            if (ie != rd->open_span_ends.end()) {
                span_end = ie->second;
                if (rd->open_spans.find(span_begin)
                        == rd->open_spans.end())
                    rd->open_span_ends.erase(ie);
            }
            if (span_end > rd->release_high)
                rd->release_high = span_end;
            // advance to the oldest still-open span, else to the
            // high-water RELEASED end (out-of-order releases must
            // not park the guarantee at an already-released begin)
            int64_t g = rd->open_spans.empty()
                        ? rd->release_high : *rd->open_spans.begin();
            if (g > rd->guarantee_offset) rd->guarantee_offset = g;
        }
    }
    r->nread_open -= 1;
    // quiescence point for deferred resize: "the oldest open span
    // releases" — apply once no span at all remains open
    r->maybe_apply_pending_locked();
    r->write_cv.notify_all();
    r->span_cv.notify_all();
    return BFT_OK;
}

int bft_ring_overwritten_in(void* ring_, long long begin, long long nbyte,
                            long long* out) {
    Ring* r = static_cast<Ring*>(ring_);
    if (!r || !out) return BFT_ERR_INVALID;
    std::lock_guard<std::mutex> lk(r->mtx);
    int64_t ov = std::min<int64_t>(r->tail - begin, nbyte);
    *out = std::max<int64_t>(ov, 0);
    return BFT_OK;
}

int bft_ring_tail_head(void* ring_, long long* tail, long long* head) {
    Ring* r = static_cast<Ring*>(ring_);
    if (!r) return BFT_ERR_INVALID;
    std::lock_guard<std::mutex> lk(r->mtx);
    if (tail) *tail = r->tail;
    if (head) *head = r->head;
    return BFT_OK;
}

int bft_version(void) { return 1; }

}  // extern "C"
