// FX-correlator X-step kernels for Hopper (sm_90a): integer visibilities
//   vis[g, f, a, b] = sum_t x_i[g, t, f, a] * conj(x_j[g, t, f, b])
// of int8 voltage planes, summed over time in int32, written once as
// complex64 (interleaved float pairs that torch.view_as_complex reads):
//
//   re = sum_t (re_a re_b + im_a im_b)
//   im = sum_t (im_a re_b - re_a im_b)
//
//   K7 bf_xcorr_herm: the Hermitian auto-correlation, x_i = x_j.
//      Replaces bifrost_tpu/ops/pallas_kernels.py:xcorr_herm
//      (pl.pallas_call at :155), candidate 'pallas' of the X-engine and of
//      xcorr_int8's auto family.
//   K8 bf_xcorr_cross: the cross-correlation of an input block against
//      another.  Replaces pallas_kernels.py:xcorr_cross (pl.pallas_call at
//      :199), candidate 'pallas' of xcorr_int8's cross family (the
//      station-sharded mesh correlator's row block against the gathered
//      columns).
//
// Both are one kernel, xcorr_kernel<kHerm>: the same staging, tensor-core
// arithmetic and store warps, walking the lower triangle of tiles and
// mirroring them for K7, the whole rectangle unmirrored for K8.
//
// Every int32 sum is exact while T <= 65,535 (|re| <= 2 * 128^2 * T <
// 2^31; the wrappers refuse more), and its __int2float_rn cast is the
// plain version's int -> float32 cast.
//
// ---------------------------------------------------------------------------
// Exact int8 tensor-core correlator.
//
// Bound on the H100: the output write.  At the FX path's gulp (2 groups of
// 128 frames, 1024 channels, 512 inputs) K7 reads 268 MB and writes 4.29 GB
// of complex64, 1.362 ms at 3.35 TB/s, against 0.28 ms for its 5.5e11
// operations at the 1,979 TOP/s int8 rate.  K8 at the 2-D mesh's block
// (128 frames, 1024 channels, 128 or 256 rows against 512 columns) reads
// 168-201 MB and writes 0.54-1.07 GB, 0.210-0.381 ms, against 0.035-0.070
// ms of operations.  The design keeps the write stream running and hides
// the rest behind it.
//
// Design:
// - Arithmetic: time is the contraction axis of mma.sync.m16n8k32 (s8 x s8
//   -> s32, no .satfinite); rows are inputs a of x_i, columns inputs b of
//   x_j.  Two accumulators an output, two products each per 32-frame step:
//     vr += re_a . re_b + im_a . im_b
//     vi += im_a . re_b + re_a . (~im_b),   and then vi += R_a = sum_t re_a
//   ~im = -im - 1 is an int8 for every int8 (~(-128) = 127), so
//   sum_t re_a (~im_b) + R_a = -sum_t re_a im_b exactly: vi = ir - ri for
//   every int8 value, -128 included.  R_a is summed on the tensor cores
//   too (the row operand re_a against a column of ones, one more MMA a
//   step).  The s32 sums wrap; the finals fit.  Padded frames and inputs
//   hold kPad = 0 in both planes: ~0 = -1 meets re_a = 0 there, and R_a
//   gains nothing.
// - Staging as the data lies: a frame's row of the interleaved ci8 view (n
//   (re, im) pairs) is copied 16 bytes (8 inputs) at a time by cp.async into
//   shared memory, piece c of staged frame t at slot c ^ (t & 7), so the 8
//   rows that an ldmatrix reads fall in 8 distinct bank groups.  Every
//   other layout (separate planes, odd strides, any n) is gathered by a
//   scalar path into the same pieces.  Rows and columns take their own
//   path, each by its own planes' layout (in the mesh the row block is a
//   view of the local gulp, the columns a gathered copy).  Both feed the
//   same tensor-core code.
// - Fragments: ldmatrix.x4.trans of 8 frames x 8 inputs of 16-bit (re, im)
//   pairs gives a lane one input's pairs at frames 2q, 2q + 1; __byte_perm
//   of two such registers (this 8-frame block and the next) makes the re
//   word and the im word of four frames, the four K of a fragment register.
//   A and B take the frames in the same order, so the sums are the sums.
// - Resident jobs, so that input leaves HBM once a job: one persistent
//   block an SM walks them, its 64-input blocks staged as cp.async groups
//   in order, each tile started as soon as the groups it reads are in.
//   K7: a job is a channel, staged once where it fits beside the output
//   slots (T n 2 bytes: 128 KB at the FX shape, 64 KB at x-stateful's
//   T = 64), and row block ti's tiles start once blocks 0 .. ti are in.
//   K8: a job is one 64-input row block of a channel, staged beside all the
//   channel's columns (T (64 + 64 ceil(n_j / 64)) 2 bytes: 144 KB at the
//   mesh's T = 128, n_j = 512; the whole channel would not fit there), and
//   tile (ti, tj) starts once the row block and column block tj are in;
//   the columns pass through L2 once per row block.
// - Chunked jobs where that does not fit (T = 256 at 512 inputs, the mesh
//   arms): a job is one tile, its 64 rows and 64 columns staged kChunk7
//   frames at a time into two alternating buffers, the next chunk's copies
//   in flight while this one multiplies (the input then passes through L2
//   once per tile).
// - Output streamed by warp specialization: eight compute warps each own
//   16 x 32 outputs of a tile and put the finished tile, converted with
//   __int2float_rn, into one of kSlots7 shared-memory slots (rows padded
//   to 65 float2); four store warps write each slot's rows and, for K7 off
//   the diagonal, its conjugate transpose's rows, 256 contiguous bytes a
//   streaming store, while the compute warps run the next tile.  Slots are
//   handed over with named barriers (bar.arrive / bar.sync), so no warp
//   ever waits on its own stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCompute7 = 256;       // 8 warps of mma.sync
constexpr int kStore7 = 128;         // 4 warps that write the output
constexpr int kThreads7 = kCompute7 + kStore7;
constexpr int kTile7 = 64;           // inputs per tile side
constexpr int kSlots7 = 2;           // finished tiles in flight
constexpr int kOutRow7 = kTile7 + 1; // float2 a row of a finished tile
constexpr int kSlotBytes7 = kTile7 * kOutRow7 * 8;
// named barriers: the compute warps' own, and per slot full and empty
constexpr int kBarCompute = 1, kBarFull = 2, kBarEmpty = 2 + kSlots7;
constexpr int kChunk7 = 256;         // frames a chunk when not resident
constexpr uint32_t kPad = 0u;        // the bytes staged past T and n

// One operand's int8 planes
struct XPlanes {
  const int8_t* re;     // 16-byte path: byte 0 of each (re, im) pair
  const int8_t* im;
  long long sg, st, sf, sn;  // strides in bytes (= elements)
  int n;                // inputs
  int vec;              // the 16-byte staging
};

struct XArgs {
  XPlanes xi, xj;       // rows and columns (K7: the same planes)
  float2* out;          // (groups, nfreq, xi.n, xj.n)
  int ntime, nfreq;
  int resident;         // a job's inputs live in shared memory whole
  int tch;              // frames a chunk, a multiple of 32
  int nch;              // 16-byte pieces a staged frame row
  int nti, ntj;         // tiles a side: row blocks, column blocks
  int ntiles;           // tiles a channel (K7: of the lower triangle)
  long long njobs;      // resident: channels (K7) or row blocks (K8);
                        // chunked: tiles
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wait until at most n of the thread's cp.async groups are in flight (at
// most 7: waiting for more is only stricter)
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// four 8 x 8 matrices of 16-bit elements, transposed: from rows (frames)
// at the addresses of lanes 8m .. 8m + 7, lane (g, q) gets the (re, im)
// pairs of input g at frames 2q and 2q + 1 of matrix m in d[m]
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&d)[4], const char* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a)
      : "memory");
}

// Stage pieces c0 .. c0 + 7 of frames t0 .. t0 + tlen - 1 of operand x at
// byte offset off (its group and channel): per frame a row of a.nch
// 16-byte pieces, piece c0 + p holding the (re, im) pairs of inputs
// in0 + 8 p .. in0 + 8 p + 7 at slot (c0 + p) ^ (frame & 7); frames past T
// and inputs past x.n hold kPad.  Thread k stages piece k % 8 of frames
// k / 8, k / 8 + 32, ...: the 16-byte path issues a cp.async a piece (the
// caller commits and waits); the scalar path gathers it byte by byte.
__device__ __forceinline__ void k7_stage(const XArgs& a, const XPlanes& x,
                                         char* stage, int64_t off, int c0,
                                         int in0, int t0, int tlen) {
  const int p = threadIdx.x & 7, in = in0 + 8 * p;
  const int first = threadIdx.x >> 3;     // frames first + 32 m
  const int slot = 16 * ((c0 + p) ^ (first & 7));
  const int64_t row = 16 * (int64_t)a.nch;
  for (int tt = first; tt < tlen; tt += kCompute7 / 8) {
    const int t = t0 + tt;
    char* dst = stage + tt * row + slot;
    if (t >= a.ntime || in >= x.n) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(kPad, kPad, kPad, kPad);
    } else if (x.vec) {
      cp_async16(dst, x.re + off + t * x.st + 2 * (int64_t)in);
    } else {
      const int64_t base = off + t * x.st + (int64_t)in * x.sn;
      uint32_t u[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        u[e] = kPad;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (in + 2 * e + h < x.n) {
            const int64_t o = base + (2 * e + h) * x.sn;
            const uint32_t pair = (uint8_t)__ldg(x.re + o) |
                                  (uint32_t)(uint8_t)__ldg(x.im + o) << 8;
            u[e] = (u[e] & ~(0xffffu << (16 * h))) | pair << (16 * h);
          }
        }
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(u[0], u[1], u[2], u[3]);
    }
  }
}

__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a, uint32_t b0,
                                       uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One staged chunk of nkg 32-frame steps into a warp's 16 x 32
// accumulators: rows (inputs) from piece ca of the staged frame rows,
// columns from piece cb.  Matrix m of an ldmatrix.x4 is 8 frames of 8
// inputs; the re bytes (0x6420) and im bytes (0x7531) of two such
// registers make the words of four frames that a fragment register holds
// (K 4q .. 4q + 3 are frames 2q, 2q + 1 of one 8-frame block and of the
// next, in A and B alike).  racc += re_a . 1 sums R_a of the rows on the
// tensor cores.
__device__ __forceinline__ void k7_tile_chunk(const char* stage, int nch,
                                              int ca, int cb, int nkg,
                                              int lane, int (&vr)[4][4],
                                              int (&vi)[4][4],
                                              int (&racc)[4]) {
  const int row = 16 * nch;                  // bytes a staged frame
  const int m = lane >> 3, r = lane & 7;
  // A: matrices (frames 8 (m & 1) + r of the 16-frame half, inputs
  // 8 (m >> 1) ..); the second ldmatrix takes the next 16 frames
  const char* pa = stage + (8 * (m & 1) + r) * row +
                   16 * ((ca + (m >> 1)) ^ r);
  // B: matrix m is frames 8 m + r of the 32-frame step
  const char* pb = stage + (8 * m + r) * row;
#pragma unroll 1
  for (int kg = 0; kg < nkg; ++kg) {
    const int ko = 32 * kg * row;
    uint32_t d0[4], d1[4], ar[4], ai[4];
    ldsm_x4_t(d0, pa + ko);
    ldsm_x4_t(d1, pa + ko + 16 * row);
    ar[0] = __byte_perm(d0[0], d0[1], 0x6420);
    ai[0] = __byte_perm(d0[0], d0[1], 0x7531);
    ar[1] = __byte_perm(d0[2], d0[3], 0x6420);
    ai[1] = __byte_perm(d0[2], d0[3], 0x7531);
    ar[2] = __byte_perm(d1[0], d1[1], 0x6420);
    ai[2] = __byte_perm(d1[0], d1[1], 0x7531);
    ar[3] = __byte_perm(d1[2], d1[3], 0x6420);
    ai[3] = __byte_perm(d1[2], d1[3], 0x7531);
    mma_s8(racc, ar, 0x01010101u, 0x01010101u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t e[4];
      ldsm_x4_t(e, pb + ko + 16 * ((cb + j) ^ r));
      const uint32_t br0 = __byte_perm(e[0], e[1], 0x6420);
      const uint32_t bi0 = __byte_perm(e[0], e[1], 0x7531);
      const uint32_t br1 = __byte_perm(e[2], e[3], 0x6420);
      const uint32_t bi1 = __byte_perm(e[2], e[3], 0x7531);
      mma_s8(vr[j], ar, br0, br1);
      mma_s8(vr[j], ai, bi0, bi1);
      mma_s8(vi[j], ai, br0, br1);
      mma_s8(vi[j], ar, ~bi0, ~bi1);
    }
  }
}

// vi += R_a = sum_t re_a: with it, sum_t re_a (~im_b) becomes
// -sum_t re_a im_b.  racc's C fragment holds R of the rows of vi's.
__device__ __forceinline__ void k7_add_r(int (&vi)[4][4],
                                         const int (&racc)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) vi[j][e] += racc[e];
}

__device__ __forceinline__ void bar_sync(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(nthreads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int nthreads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(nthreads) : "memory");
}

// A compute warp's 16 x 32 outputs (rows wr .., columns wc .. of the tile)
// into a slot, as float32 pairs
__device__ __forceinline__ void k7_put(float2* slot, int wr, int wc, int g,
                                       int q, const int (&vr)[4][4],
                                       const int (&vi)[4][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float2* const row = slot + (wr + g + 8 * h) * kOutRow7 + wc + 2 * q;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      row[8 * j] = make_float2(__int2float_rn(vr[j][2 * h]),
                               __int2float_rn(vi[j][2 * h]));
      row[8 * j + 1] = make_float2(__int2float_rn(vr[j][2 * h + 1]),
                                   __int2float_rn(vi[j][2 * h + 1]));
    }
  }
}

// A store warp's share (sw of 4) of a finished tile at rows a0 ..,
// columns b0 .. of the channel's (ni, nj) matrix o: 16 of its rows, and
// with mirror (K7, off the diagonal; ni = nj there) 16 rows of its
// conjugate transpose; a warp writes 256 contiguous bytes a store.
// 0 - v keeps a zero imaginary part +0, as the plain version's cast gives.
__device__ __forceinline__ void k7_write(float2* o, int ni, int nj, int a0,
                                         int b0, bool mirror,
                                         const float2* slot, int sw,
                                         int lane) {
  for (int k = 0; k < kTile7 / 4; ++k) {
    const int r = sw * (kTile7 / 4) + k, a = a0 + r;
    if (a >= ni) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = lane + 32 * h;
      if (b0 + c < nj)
        __stcs(o + (int64_t)a * nj + b0 + c, slot[r * kOutRow7 + c]);
    }
  }
  if (!mirror) return;
  for (int k = 0; k < kTile7 / 4; ++k) {
    const int c = sw * (kTile7 / 4) + k, b = b0 + c;
    if (b >= nj) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lane + 32 * h;
      if (a0 + r < ni) {
        const float2 v = slot[r * kOutRow7 + c];
        __stcs(o + (int64_t)b * nj + a0 + r,
               make_float2(v.x, __fsub_rn(0.f, v.y)));
      }
    }
  }
}

// Tile k of a channel, at row block ti and column block tj: K7 walks the
// lower triangle, k = ti (ti + 1) / 2 + tj with tj <= ti; K8 the whole
// rectangle by rows, k = ti ntj + tj
template <bool kHerm>
__device__ __forceinline__ void xc_tile_of(const XArgs& a, int k, int& ti,
                                           int& tj) {
  if (kHerm) {
    ti = (int)((sqrtf(8.f * k + 1.f) - 1.f) * 0.5f);
    while ((ti + 1) * (ti + 2) / 2 <= k) ++ti;
    while (ti * (ti + 1) / 2 > k) --ti;
    tj = k - ti * (ti + 1) / 2;
  } else {
    ti = k / a.ntj;
    tj = k % a.ntj;
  }
}

// A job's channel, as group g and channel f, and its tiles k0 .. k1 - 1:
// chunked, one tile; resident, all of a channel's tiles (K7) or those of
// its row block ti (K8)
struct XJob {
  long long g;
  int f, k0, k1;
};

template <bool kHerm>
__device__ __forceinline__ XJob xc_job(const XArgs& a, long long job) {
  long long chan;
  XJob j;
  if (!a.resident) {
    chan = job / a.ntiles;
    j.k0 = (int)(job - chan * a.ntiles);
    j.k1 = j.k0 + 1;
  } else if (kHerm) {
    chan = job;
    j.k0 = 0;
    j.k1 = a.ntiles;
  } else {
    chan = job / a.nti;
    j.k0 = (int)(job - chan * a.nti) * a.ntj;
    j.k1 = j.k0 + a.ntj;
  }
  j.g = chan / a.nfreq;
  j.f = (int)(chan - j.g * a.nfreq);
  return j;
}

// byte offset of a job's channel in operand x
__device__ __forceinline__ int64_t xc_off(const XPlanes& x, const XJob& j) {
  return j.g * x.sg + (int64_t)j.f * x.sf;
}

// A finished tile to slot i % kSlots7, once the store warps have emptied it
__device__ __forceinline__ void k7_hand_over(float2* slots, long long i,
                                             int wr, int wc, int g, int q,
                                             int (&vr)[4][4],
                                             int (&vi)[4][4],
                                             const int (&racc)[4]) {
  k7_add_r(vi, racc);
  const int s = (int)(i % kSlots7);
  if (i >= kSlots7) bar_sync(kBarEmpty + s, kThreads7);
  k7_put(slots + s * (kSlotBytes7 / 8), wr, wc, g, q, vr, vi);
  bar_arrive(kBarFull + s, kThreads7);
}

// The compute warps: stage, multiply, and hand each finished tile over.
// Resident: a job's 64-input blocks are staged as cp.async groups in
// order (K7: the channel's blocks; K8: the row block, then the column
// blocks), and each tile starts once the groups it reads are in, while
// the store warps drain the slots.  Chunked: the steps (tile, frame
// chunk) alternate between two stage buffers, the next step's copies in
// flight while this one multiplies.
template <bool kHerm>
__device__ void k7_compute(const XArgs& a, char* stage, float2* slots) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;      // mma groupID, thread in group
  const int wr = 16 * (warp % 4), wc = 32 * (warp / 4);
  long long i = 0;                           // the block's tile sequence
  if (a.resident) {
    const int ngrp = kHerm ? a.nti : 1 + a.ntj;
    for (long long job = blockIdx.x; job < a.njobs; job += gridDim.x) {
      const XJob jb = xc_job<kHerm>(a, job);
      bar_sync(kBarCompute, kCompute7);      // the last job is done
      if (kHerm) {
        const int64_t off = xc_off(a.xi, jb);
        for (int b = 0; b < a.nti; ++b) {
          k7_stage(a, a.xi, stage, off, 8 * b, kTile7 * b, 0, a.tch);
          cp_async_commit();
        }
      } else {
        k7_stage(a, a.xi, stage, xc_off(a.xi, jb), 0,
                 jb.k0 / a.ntj * kTile7, 0, a.tch);
        cp_async_commit();
        const int64_t off = xc_off(a.xj, jb);
        for (int b = 0; b < a.ntj; ++b) {
          k7_stage(a, a.xj, stage, off, 8 + 8 * b, kTile7 * b, 0, a.tch);
          cp_async_commit();
        }
      }
      int in = -1;                           // groups 0 .. in are in
      for (int k = jb.k0; k < jb.k1; ++k, ++i) {
        int ti, tj;
        xc_tile_of<kHerm>(a, k, ti, tj);
        const int need = kHerm ? ti : 1 + tj;  // the last group it reads
        if (need > in) {
          cp_async_wait_upto(ngrp - 1 - need);
          bar_sync(kBarCompute, kCompute7);
          in = need;
        }
        // K8's row block is pieces 0 .. 7, its column block tj 8 + 8 tj ..
        const int ca = kHerm ? 8 * ti : 0;
        const int cb = kHerm ? 8 * tj : 8 + 8 * tj;
        int vr[4][4] = {}, vi[4][4] = {}, racc[4] = {};
        k7_tile_chunk(stage, a.nch, ca + wr / 8, cb + wc / 8, a.tch / 32,
                      lane, vr, vi, racc);
        k7_hand_over(slots, i, wr, wc, g, q, vr, vi, racc);
      }
    }
    return;
  }
  // a tile's rows are staged as pieces 0 .. 7, its columns as 8 .. 15
  const int nchunk = (a.ntime + a.tch - 1) / a.tch;
  const long long nstep =
      (a.njobs - blockIdx.x + gridDim.x - 1) / gridDim.x * nchunk;
  const int buf = a.tch * a.nch * 16;
  auto issue = [&](long long step) {
    const XJob jb = xc_job<kHerm>(a, blockIdx.x + step / nchunk * gridDim.x);
    int ti, tj;
    xc_tile_of<kHerm>(a, jb.k0, ti, tj);
    const int t0 = (int)(step % nchunk) * a.tch;
    const int tlen = min(a.tch, (a.ntime - t0 + 31) / 32 * 32);
    char* const dst = stage + (step & 1) * buf;
    k7_stage(a, a.xi, dst, xc_off(a.xi, jb), 0, ti * kTile7, t0, tlen);
    k7_stage(a, a.xj, dst, xc_off(a.xj, jb), 8, tj * kTile7, t0, tlen);
    cp_async_commit();
  };
  int vr[4][4], vi[4][4], racc[4];
  if (nstep > 0) issue(0);
  for (long long step = 0; step < nstep; ++step) {
    const int c = (int)(step % nchunk), t0 = c * a.tch;
    if (step + 1 < nstep) {
      issue(step + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    bar_sync(kBarCompute, kCompute7);        // this step's copies are in
    if (c == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) vr[j][e] = vi[j][e] = racc[e] = 0;
    }
    const int tlen = min(a.tch, (a.ntime - t0 + 31) / 32 * 32);
    k7_tile_chunk(stage + (step & 1) * buf, a.nch, wr / 8,
                  (kTile7 + wc) / 8, tlen / 32, lane, vr, vi, racc);
    if (c == nchunk - 1) k7_hand_over(slots, i++, wr, wc, g, q, vr, vi, racc);
    bar_sync(kBarCompute, kCompute7);        // done with this buffer
  }
}

// The store warps: each finished tile, in the compute warps' order, to
// the output, then its slot back to them (but for the last kSlots7).
template <bool kHerm>
__device__ void k7_stores(const XArgs& a, const float2* slots) {
  const int sw = threadIdx.x / 32 - kCompute7 / 32, lane = threadIdx.x % 32;
  const int per_job = !a.resident ? 1 : kHerm ? a.ntiles : a.ntj;
  const long long ntiles =
      (a.njobs - blockIdx.x + gridDim.x - 1) / gridDim.x * per_job;
  long long i = 0;
  for (long long job = blockIdx.x; job < a.njobs; job += gridDim.x) {
    const XJob jb = xc_job<kHerm>(a, job);
    float2* const o =
        a.out + (jb.g * a.nfreq + jb.f) * a.xi.n * (int64_t)a.xj.n;
    for (int k = jb.k0; k < jb.k1; ++k, ++i) {
      int ti, tj;
      xc_tile_of<kHerm>(a, k, ti, tj);
      const int s = (int)(i % kSlots7);
      bar_sync(kBarFull + s, kThreads7);
      k7_write(o, a.xi.n, a.xj.n, ti * kTile7, tj * kTile7,
               kHerm && ti != tj, slots + s * (kSlotBytes7 / 8), sw, lane);
      if (i + kSlots7 < ntiles) bar_arrive(kBarEmpty + s, kThreads7);
    }
  }
}

template <bool kHerm>
__global__ void __launch_bounds__(kThreads7, 1)
xcorr_kernel(const XArgs a) {
  extern __shared__ __align__(128) char smem7[];
  float2* const slots = reinterpret_cast<float2*>(smem7);
  char* const stage = smem7 + kSlots7 * kSlotBytes7;
  if (threadIdx.x < kCompute7)
    k7_compute<kHerm>(a, stage, slots);
  else
    k7_stores<kHerm>(a, slots);
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

constexpr int kMaxDev = 64;

// one kernel's state on a device
struct KernelInfo {
  bool attr;            // its dynamic shared-memory attribute is set
  size_t occ_bytes;     // the last launch's shared memory, and the
  int occ_blocks;       // blocks an SM holds with it
};

struct DevInfo {
  int sms, smem;  // SM count, shared memory a block may opt in to
  KernelInfo herm, cross;  // K7's and K8's
};

DevInfo dev_info[kMaxDev];

// the current device's DevInfo, its attributes read once per device
cudaError_t current_dev(DevInfo** out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDev) return cudaErrorInvalidDevice;
  DevInfo& d = dev_info[dev];
  if (d.sms == 0) {
    int sms = 0, smem = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    d.smem = smem;
    d.sms = sms;
  }
  *out = &d;
  return cudaSuccess;
}

// The persistent grid of kernel fn for njobs jobs with bytes of dynamic
// shared memory: the kernel opts in to all the shared memory a block may
// take (above 48 KB only after that) once per device, and its occupancy
// at bytes is kept in k until another size comes
cudaError_t persistent_grid(const DevInfo& d, KernelInfo& k,
                            void (*fn)(XArgs), size_t bytes, long long njobs,
                            long long* grid) {
  if (bytes > (size_t)d.smem) return cudaErrorInvalidConfiguration;
  cudaError_t err;
  if (!k.attr) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               d.smem);
    if (err != cudaSuccess) return err;
    k.attr = true;
  }
  if (k.occ_bytes != bytes || k.occ_blocks == 0) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                        kThreads7, bytes);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    k.occ_bytes = bytes;
    k.occ_blocks = per_sm;
  }
  const long long fit = (long long)d.sms * k.occ_blocks;
  *grid = njobs < fit ? njobs : fit;
  return cudaSuccess;
}

// the 16-byte staging's conditions on an operand's planes: (re, im) pairs
// interleaved (element stride 2, im one byte after re), rows (frames,
// channels and groups) on 16 bytes, and n * 2 a multiple of 16
bool vec16_ok(const void* re, const void* im, long long sg, long long st,
              long long sf, long long sn, int n) {
  return sn == 2 && (const char*)im == (const char*)re + 1 &&
         (uintptr_t)re % 16 == 0 && sg % 16 == 0 && st % 16 == 0 &&
         sf % 16 == 0 && (2 * (int64_t)n) % 16 == 0;
}

XPlanes planes(const void* re, const void* im, long long sg, long long st,
               long long sf, long long sn, int n, int vec) {
  XPlanes x;
  x.re = (const int8_t*)re;
  x.im = (const int8_t*)im;
  x.sg = sg;
  x.st = st;
  x.sf = sf;
  x.sn = sn;
  x.n = n;
  x.vec = vec ? 1 : 0;
  return x;
}

// the dynamic shared memory of a launch: the output slots and one resident
// stage or two chunk buffers
size_t launch_bytes(const XArgs& a) {
  return kSlots7 * (size_t)kSlotBytes7 +
         (a.resident ? 1 : 2) * (size_t)a.tch * a.nch * 16;
}

}  // namespace

extern "C" {

// K7.  re, im: (ngroup, ntime, nfreq, n) int8 planes with strides sg, st,
// sf, sn (in elements, shared by both).  out: (ngroup, nfreq, n, n)
// complex64, contiguous.  vec 1 takes the 16-byte staging (vec16_ok's
// conditions), vec 0 the scalar staging.  Returns a cudaError_t value; 0
// on success.
int bf_xcorr_herm(const void* re, const void* im, void* out, int vec,
                  int ngroup, int ntime, int nfreq, int n, long long sg,
                  long long st, long long sf, long long sn, void* stream) {
  if (ngroup <= 0 || nfreq <= 0 || n <= 0) return 0;
  if (ntime <= 0 || ntime > 65535) return (int)cudaErrorInvalidValue;
  if (vec && !vec16_ok(re, im, sg, st, sf, sn, n))
    return (int)cudaErrorInvalidValue;
  DevInfo* d = nullptr;
  cudaError_t err = current_dev(&d);
  if (err != cudaSuccess) return (int)err;
  const int nt = (int)cdiv(n, kTile7);
  const int tall = (int)cdiv(ntime, 32) * 32;
  // a resident channel: tall frames of nt * kTile7 inputs, 2 bytes each
  const size_t res_bytes = (size_t)tall * nt * kTile7 * 2;
  XArgs a;
  a.xi = a.xj = planes(re, im, sg, st, sf, sn, n, vec);
  a.out = (float2*)out;
  a.ntime = ntime;
  a.nfreq = nfreq;
  a.resident = kSlots7 * (size_t)kSlotBytes7 + res_bytes <= (size_t)d->smem;
  a.tch = a.resident ? tall : (tall < kChunk7 ? tall : kChunk7);
  a.nch = a.resident ? nt * kTile7 / 8 : 2 * kTile7 / 8;
  a.nti = a.ntj = nt;
  a.ntiles = nt * (nt + 1) / 2;
  a.njobs = (long long)ngroup * nfreq * (a.resident ? 1 : a.ntiles);
  const size_t bytes = launch_bytes(a);
  long long grid = 0;
  err = persistent_grid(*d, d->herm, xcorr_kernel<true>, bytes, a.njobs,
                        &grid);
  if (err != cudaSuccess) return (int)err;
  xcorr_kernel<true><<<(unsigned)grid, kThreads7, bytes,
                       (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// K8.  re_i, im_i: (ngroup, ntime, nfreq, ni) int8 planes with strides
// sg_i, st_i, sf_i, sn_i (in elements, shared by both); re_j, im_j likewise
// with nj inputs.  out: (ngroup, nfreq, ni, nj) complex64, contiguous.
// vec_i, vec_j: 1 takes the 16-byte staging for that operand (vec16_ok's
// conditions), 0 its scalar staging.  rowblock 1: a job is a row block
// beside all the channel's columns (it must fit in shared memory beside
// the slots: gpu_kernels.xcorr_cross_plan), 0: a job is one tile, staged
// in frame chunks.  Returns a cudaError_t value; 0 on success.
int bf_xcorr_cross(const void* re_i, const void* im_i, const void* re_j,
                   const void* im_j, void* out, int vec_i, int vec_j,
                   int rowblock, int ngroup, int ntime, int nfreq, int ni,
                   int nj, long long sg_i, long long st_i, long long sf_i,
                   long long sn_i, long long sg_j, long long st_j,
                   long long sf_j, long long sn_j, void* stream) {
  if (ngroup <= 0 || nfreq <= 0 || ni <= 0 || nj <= 0) return 0;
  if (ntime <= 0 || ntime > 65535) return (int)cudaErrorInvalidValue;
  if ((vec_i && !vec16_ok(re_i, im_i, sg_i, st_i, sf_i, sn_i, ni)) ||
      (vec_j && !vec16_ok(re_j, im_j, sg_j, st_j, sf_j, sn_j, nj)))
    return (int)cudaErrorInvalidValue;
  DevInfo* d = nullptr;
  cudaError_t err = current_dev(&d);
  if (err != cudaSuccess) return (int)err;
  const int nti = (int)cdiv(ni, kTile7), ntj = (int)cdiv(nj, kTile7);
  const int tall = (int)cdiv(ntime, 32) * 32;
  XArgs a;
  a.xi = planes(re_i, im_i, sg_i, st_i, sf_i, sn_i, ni, vec_i);
  a.xj = planes(re_j, im_j, sg_j, st_j, sf_j, sn_j, nj, vec_j);
  a.out = (float2*)out;
  a.ntime = ntime;
  a.nfreq = nfreq;
  a.resident = rowblock ? 1 : 0;
  a.tch = a.resident ? tall : (tall < kChunk7 ? tall : kChunk7);
  // resident: the row block's 8 pieces, then 8 for each column block
  a.nch = a.resident ? 8 + 8 * ntj : 2 * kTile7 / 8;
  a.nti = nti;
  a.ntj = ntj;
  a.ntiles = nti * ntj;
  a.njobs = (long long)ngroup * nfreq * (a.resident ? nti : a.ntiles);
  const size_t bytes = launch_bytes(a);
  if (a.resident && bytes > (size_t)d->smem)
    return (int)cudaErrorInvalidValue;
  long long grid = 0;
  err = persistent_grid(*d, d->cross, xcorr_kernel<false>, bytes, a.njobs,
                        &grid);
  if (err != cudaSuccess) return (int)err;
  xcorr_kernel<false><<<(unsigned)grid, kThreads7, bytes,
                        (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The shared memory a block may opt in to on device dev (what
// gpu_kernels.xcorr_cross_plan sizes K8's jobs by), or minus a
// cudaError_t value.
int bf_xcorr_smem(int dev) {
  int smem = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err == cudaSuccess ? smem : -(int)err;
}

const char* bf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
