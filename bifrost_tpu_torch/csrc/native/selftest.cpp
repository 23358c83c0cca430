// bifrost_tpu_torch's own copy of native/selftest.cpp, built by
// bifrost_tpu_torch/native.py with g++ at first use.
//
// In-library self-test (reference analogue: src/testsuite.cpp:30-204,
// exposed through the ABI as bfTestSuite).  Exercises the ring core's
// contracts from C++ with no Python in the loop: geometry, sequence
// lifecycle, reserve/commit ordering, the partial-commit legality
// rules, ghost-region contiguity, and a reader round trip.
// Returns 0 on success, or a small failure code identifying the check.

#include <cstring>
#include <string>

extern "C" {
int bft_ring_create(void**, const char*);
int bft_ring_destroy(void*);
int bft_ring_resize(void*, long long, long long, long long);
int bft_ring_geometry(void*, unsigned char**, long long*, long long*,
                      long long*);
int bft_ring_begin_writing(void*);
int bft_ring_end_writing(void*);
int bft_ring_begin_sequence(void*, const char*, long long, const char*,
                            long long, long long, void**);
int bft_ring_end_sequence(void*, void*);
int bft_ring_reserve(void*, long long, int, long long*, long long*);
int bft_ring_commit(void*, long long, long long);
int bft_reader_create(void*, int, long long*);
int bft_reader_destroy(void*, long long);
int bft_ring_open_sequence(void*, int, const char*, long long, void**);
int bft_reader_acquire(void*, long long, void*, long long, long long,
                       long long, long long*, long long*);
int bft_reader_release(void*, long long, long long);

int bft_selftest(void) {
    void* ring = nullptr;
    if (bft_ring_create(&ring, "selftest") != 0) return 1;
    struct Cleanup {
        void* r;
        ~Cleanup() { bft_ring_destroy(r); }
    } cleanup{ring};

    if (bft_ring_resize(ring, 64, 256, 1) != 0) return 2;
    unsigned char* buf = nullptr;
    long long size = 0, ghost = 0, nrl = 0;
    if (bft_ring_geometry(ring, &buf, &size, &ghost, &nrl) != 0 ||
        !buf || size < 256 || ghost < 64 || nrl != 1)
        return 3;

    if (bft_ring_begin_writing(ring) != 0) return 4;
    void* seq = nullptr;
    const char* hdr = "{\"t\":1}";
    if (bft_ring_begin_sequence(ring, "s0", 42, hdr,
                                (long long)std::strlen(hdr), 1,
                                &seq) != 0)
        return 5;

    // reserve/commit with data, crossing the nominal end to exercise
    // the ghost mirror
    for (int k = 0; k < 6; ++k) {
        long long begin = 0, span_id = 0;
        if (bft_ring_reserve(ring, 48, 0, &begin, &span_id) != 0)
            return 6;
        bft_ring_geometry(ring, &buf, &size, &ghost, &nrl);
        std::memset(buf + (begin % size), 0x40 + k, 48);
        if (bft_ring_commit(ring, span_id, 48) != 0) return 7;
    }

    // partial-commit legality: with two outstanding spans, a partial
    // commit of the OLDER one must be rejected without corrupting state
    long long b1 = 0, id1 = 0, b2 = 0, id2 = 0;
    if (bft_ring_reserve(ring, 32, 0, &b1, &id1) != 0) return 8;
    if (bft_ring_reserve(ring, 32, 0, &b2, &id2) != 0) return 9;
    if (bft_ring_commit(ring, id1, 16) == 0) return 10;   // must fail
    if (bft_ring_commit(ring, id1, 32) != 0) return 11;   // recovers
    if (bft_ring_commit(ring, id2, 32) != 0) return 12;

    if (bft_ring_end_sequence(ring, seq) != 0) return 13;
    bft_ring_end_writing(ring);

    // reader round trip over the final spans
    long long reader = 0;
    if (bft_reader_create(ring, 1, &reader) != 0) return 14;
    void* rseq = nullptr;
    if (bft_ring_open_sequence(ring, 3 /* earliest */, "", -1,
                               &rseq) != 0)
        return 15;
    long long got_begin = 0, got_nbyte = 0;
    // the ring holds the last 256 bytes; ask for the final 48-byte gulp
    if (bft_reader_acquire(ring, reader, rseq, 5 * 48 + 64 - 48, 48, 48,
                           &got_begin, &got_nbyte) != 0)
        return 16;
    if (got_nbyte <= 0) return 17;
    bft_reader_release(ring, reader, got_begin);
    bft_reader_destroy(ring, reader);
    return 0;
}
}
