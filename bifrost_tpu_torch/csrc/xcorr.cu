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
// Every int32 sum is exact while T <= 65,535 (|re| <= 2 * 128^2 * T <
// 2^31; the wrapper refuses more), and its __int2float_rn cast is the
// plain version's int -> float32 cast.
//
// ---------------------------------------------------------------------------
// K7: exact int8 tensor-core correlator.
//
// Bound on the H100: the output write.  At the FX path's gulp (2 groups of
// 128 frames, 1024 channels, 512 inputs) K7 reads 268 MB and writes 4.29 GB
// of complex64, 1.362 ms at 3.35 TB/s, against 0.28 ms for its 5.5e11
// operations at the 1,979 TOP/s int8 rate.  The design keeps the write
// stream running and hides the rest behind it.
//
// Design:
// - Arithmetic: time is the contraction axis of mma.sync.m16n8k32 (s8 x s8
//   -> s32, no .satfinite); rows are inputs a, columns inputs b.  Two
//   accumulators an output, two products each per 32-frame step:
//     vr += re_a . re_b + im_a . im_b
//     vi += im_a . re_b + re_a . (~im_b),   and then vi += R_a = sum_t re_a
//   ~im = -im - 1 is an int8 for every int8 (~(-128) = 127), so
//   sum_t re_a (~im_b) + R_a = -sum_t re_a im_b exactly: vi = ir - ri for
//   every int8 value, -128 included.  R_a is summed on the tensor cores
//   too (re_a against a column of ones, one more MMA a step).  The s32 sums
//   wrap; the finals fit.  Padded frames and inputs hold kPad = 0 in both
//   planes: ~0 = -1 meets re_a = 0 there, and R_a gains nothing.
// - Staging as the data lies: a frame's row of the interleaved ci8 view (n
//   (re, im) pairs) is copied 16 bytes (8 inputs) at a time by cp.async into
//   shared memory, piece c of staged frame t at slot c ^ (t & 7), so the 8
//   rows that an ldmatrix reads fall in 8 distinct bank groups.  Every
//   other layout (separate planes, odd strides, any n) is gathered by a
//   scalar path into the same pieces.  Both feed the same tensor-core code.
// - Fragments: ldmatrix.x4.trans of 8 frames x 8 inputs of 16-bit (re, im)
//   pairs gives a lane one input's pairs at frames 2q, 2q + 1; __byte_perm
//   of two such registers (this 8-frame block and the next) makes the re
//   word and the im word of four frames, the four K of a fragment register.
//   A and B take the frames in the same order, so the sums are the sums.
// - Stage each channel once: where a channel fits in shared memory beside
//   the output slots (T n 2 bytes: 128 KB at the FX shape, 64 KB at
//   x-stateful's T = 64), one persistent block an SM walks the (group,
//   channel) jobs and computes all lower-triangle 64 x 64 tiles of a
//   channel from one copy of it, so input leaves HBM once.  The channel's
//   64-input blocks are separate cp.async groups, and the tiles of row
//   block ti start as soon as blocks 0 .. ti are in.  Where it does not
//   fit (T = 256 at 512 inputs, the mesh arms), a job is one tile: its 64
//   rows and 64 columns are staged kChunk7 frames at a time into two
//   alternating buffers, the next chunk's copies in flight while this one
//   multiplies (the input then passes through L2 once per tile).
// - Output streamed by warp specialization: eight compute warps each own
//   16 x 32 outputs of a tile and put the finished tile, converted with
//   __int2float_rn, into one of kSlots7 shared-memory slots (rows padded
//   to 65 float2); four store warps write each slot's rows and, off the
//   diagonal, its conjugate transpose's rows, 256 contiguous bytes a
//   streaming store, while the compute warps run the next tile.  Slots are
//   handed over with named barriers (bar.arrive / bar.sync), so no warp
//   ever waits on its own stores.
//
// ---------------------------------------------------------------------------
// K8: the first version, kept: one block per (group, channel, 64 x 64 output
// tile); 256 threads, each owning 4 x 4 outputs.  Time is looped inside the
// block, 32 frames at a time: each input's 32 samples are staged in shared
// memory as eight words of four int8 (time is the contraction axis, so four
// consecutive frames pack into one word), and the inner loop is __dp4a
// (four int8 MACs into an int32) with three accumulators per output
// (re_a re_b + im_a im_b, im_a re_b, re_a im_b).  The planes come with
// strides (group, time, channel, input), read in place.  Ragged tiles are
// zero-filled in shared memory and masked on store.  The finished tile is
// converted once (__int2float_rn) into shared memory and written row by
// row.  Bound at a 128 x 512 block: 168 MB in, 537 MB out, 0.21 ms,
// against 0.035 ms of operations.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// K8
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kTile = 64;            // inputs per tile side
constexpr int kTC = 32;              // frames staged per chunk
constexpr int kWords = kTC / 4;      // packed words per staged row
constexpr int kWP = kWords + 1;      // padded: odd, so rows hit distinct banks

__device__ __forceinline__ uint32_t pack4(const int8_t* __restrict__ p,
                                          int64_t stride, int n) {
  // up to 4 int8 at p, p + stride, ... packed little-endian; zero past n
  uint32_t w = 0;
  for (int k = 0; k < 4 && k < n; ++k)
    w |= (uint32_t)(uint8_t)__ldg(p + k * stride) << (8 * k);
  return w;
}

struct Planes {
  const int8_t* re;
  const int8_t* im;
  int64_t sg, st, sf, sn;            // strides in bytes (= elements)
  int n;
};

__device__ __forceinline__ void stage(const Planes& x, int g, int f, int t0,
                                      int nt, int first, int row, int w,
                                      int* s_r, int* s_i) {
  // one staged word of input first + row: frames t0 + 4w .. t0 + 4w + 3
  const int a = first + row, left = nt - 4 * w;
  uint32_t pr = 0, pi = 0;
  if (a < x.n && left > 0) {
    const int64_t o = g * x.sg + f * x.sf + (int64_t)(t0 + 4 * w) * x.st +
                      a * x.sn;
    pr = pack4(x.re + o, x.st, left);
    pi = pack4(x.im + o, x.st, left);
  }
  s_r[row * kWP + w] = (int)pr;
  s_i[row * kWP + w] = (int)pi;
}

__global__ void __launch_bounds__(kThreads)
xcorr_cross_kernel(Planes xi, Planes xj, float2* __restrict__ out, int ntime,
                   int nfreq, int ntile_j, int ntiles) {
  __shared__ int s_ra[kTile * kWP], s_ia[kTile * kWP];
  __shared__ int s_rb[kTile * kWP], s_ib[kTile * kWP];
  __shared__ float2 s_out[kTile][kTile + 1];
  int64_t blk = blockIdx.x;
  const int tile = (int)(blk % ntiles);
  blk /= ntiles;
  const int f = (int)(blk % nfreq);
  const int g = (int)(blk / nfreq);
  const int ti = tile / ntile_j, tj = tile % ntile_j;
  const int a0 = ti * kTile, b0 = tj * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  int acc_re[4][4], acc_ir[4][4], acc_ri[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_re[i][j] = acc_ir[i][j] = acc_ri[i][j] = 0;

  for (int t0 = 0; t0 < ntime; t0 += kTC) {
    const int nt = min(kTC, ntime - t0);
    // neighbouring threads take neighbouring inputs: coalesced loads
    for (int k = threadIdx.x; k < kTile * kWords; k += kThreads) {
      const int row = k % kTile, w = k / kTile;
      stage(xi, g, f, t0, nt, a0, row, w, s_ra, s_ia);
      stage(xj, g, f, t0, nt, b0, row, w, s_rb, s_ib);
    }
    __syncthreads();
    const int nw = (nt + 3) / 4;
    for (int w = 0; w < nw; ++w) {
      int ar[4], ai[4], br[4], bi[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ar[i] = s_ra[(ty + 16 * i) * kWP + w];
        ai[i] = s_ia[(ty + 16 * i) * kWP + w];
        br[i] = s_rb[(tx + 16 * i) * kWP + w];
        bi[i] = s_ib[(tx + 16 * i) * kWP + w];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc_re[i][j] = __dp4a(ar[i], br[j],
                                __dp4a(ai[i], bi[j], acc_re[i][j]));
          acc_ir[i][j] = __dp4a(ai[i], br[j], acc_ir[i][j]);
          acc_ri[i][j] = __dp4a(ar[i], bi[j], acc_ri[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      s_out[ty + 16 * i][tx + 16 * j] =
          make_float2(__int2float_rn(acc_re[i][j]),
                      __int2float_rn(acc_ir[i][j] - acc_ri[i][j]));
  __syncthreads();
  const int ni = xi.n, nj = xj.n;
  float2* o = out + ((int64_t)g * nfreq + f) * ni * nj;
  for (int k = threadIdx.x; k < kTile * kTile; k += kThreads) {
    const int r = k / kTile, c = k % kTile;
    const int a = a0 + r, b = b0 + c;
    if (a < ni && b < nj) o[(int64_t)a * nj + b] = s_out[r][c];
  }
}

// ---------------------------------------------------------------------------
// K7
// ---------------------------------------------------------------------------

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

struct K7Args {
  const int8_t* re;     // 16-byte path: byte 0 of each (re, im) pair
  const int8_t* im;
  float2* out;
  long long sg, st, sf, sn;  // strides in bytes (= elements)
  int ntime, nfreq, n;
  int vec;              // the 16-byte staging
  int resident;         // a whole channel lives in shared memory
  int tch;              // frames a chunk, a multiple of 32
  int nch;              // 16-byte pieces a staged frame row
  int nt, ntri;         // tiles a side, tiles of the lower triangle
  long long njobs;      // channels (resident) or channel tiles
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

// Stage pieces c0 .. c0 + 7 of frames t0 .. t0 + tlen - 1 of the channel
// at byte offset off: per frame a row of nch 16-byte pieces, piece c
// holding the (re, im) pairs of inputs in0 .. in0 + 7 (in0 = ia + 8 c for c
// < split, else ib + 8 (c - split)) at slot c ^ (frame & 7); frames past T
// and inputs past n hold kPad.  The 16-byte path issues a cp.async a piece
// (the caller commits and waits); the scalar path gathers it byte by byte.
__device__ void k7_stage(const K7Args& a, char* stage, int64_t off, int c0,
                         int ia, int ib, int split, int t0, int tlen) {
  const int total = tlen * 8;
  for (int k = threadIdx.x; k < total; k += kCompute7) {
    const int tt = k >> 3, c = c0 + (k & 7), t = t0 + tt;
    const int in0 = c < split ? ia + 8 * c : ib + 8 * (c - split);
    char* dst = stage + (int64_t)tt * (16 * a.nch) + 16 * (c ^ (tt & 7));
    if (t >= a.ntime || in0 >= a.n) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(kPad, kPad, kPad, kPad);
    } else if (a.vec) {
      cp_async16(dst, a.re + off + t * a.st + 2 * (int64_t)in0);
    } else {
      const int64_t base = off + t * a.st + (int64_t)in0 * a.sn;
      uint32_t u[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        u[e] = kPad;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (in0 + 2 * e + h < a.n) {
            const int64_t o = base + (2 * e + h) * a.sn;
            const uint32_t pair = (uint8_t)__ldg(a.re + o) |
                                  (uint32_t)(uint8_t)__ldg(a.im + o) << 8;
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
// next, in A and B alike).  racc += re_a . 1 sums R_a on the tensor cores.
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
// columns b0 .. of the channel's (n, n) matrix o: 16 of its rows, and off
// the diagonal 16 rows of its conjugate transpose; a warp writes 256
// contiguous bytes a store.  0 - v keeps a zero imaginary part +0, as the
// plain version's cast gives.
__device__ __forceinline__ void k7_write(float2* o, int n, int a0, int b0,
                                         bool mirror, const float2* slot,
                                         int sw, int lane) {
  for (int k = 0; k < kTile7 / 4; ++k) {
    const int r = sw * (kTile7 / 4) + k, a = a0 + r;
    if (a >= n) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = lane + 32 * h;
      if (b0 + c < n)
        __stcs(o + (int64_t)a * n + b0 + c, slot[r * kOutRow7 + c]);
    }
  }
  if (!mirror) return;
  for (int k = 0; k < kTile7 / 4; ++k) {
    const int c = sw * (kTile7 / 4) + k, b = b0 + c;
    if (b >= n) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lane + 32 * h;
      if (a0 + r < n) {
        const float2 v = slot[r * kOutRow7 + c];
        __stcs(o + (int64_t)b * n + a0 + r,
               make_float2(v.x, __fsub_rn(0.f, v.y)));
      }
    }
  }
}

// tile k of the lower triangle: k = ti (ti + 1) / 2 + tj, tj <= ti
__device__ __forceinline__ void k7_tile_of(int k, int& ti, int& tj) {
  ti = (int)((sqrtf(8.f * k + 1.f) - 1.f) * 0.5f);
  while ((ti + 1) * (ti + 2) / 2 <= k) ++ti;
  while (ti * (ti + 1) / 2 > k) --ti;
  tj = k - ti * (ti + 1) / 2;
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
// Resident: a channel's 64-input blocks are staged as cp.async groups in
// order, and the tiles of row block ti start once blocks 0 .. ti are in,
// while the store warps drain the slots.  Chunked: the steps (tile,
// frame chunk) alternate between two stage buffers, the next step's
// copies in flight while this one multiplies.
__device__ void k7_compute(const K7Args& a, char* stage, float2* slots) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;      // mma groupID, thread in group
  const int wr = 16 * (warp % 4), wc = 32 * (warp / 4);
  long long i = 0;                           // the block's tile sequence
  if (a.resident) {
    for (long long chan = blockIdx.x; chan < a.njobs; chan += gridDim.x) {
      const int f = (int)(chan % a.nfreq);
      const int64_t off = (chan / a.nfreq) * a.sg + (int64_t)f * a.sf;
      bar_sync(kBarCompute, kCompute7);      // the last channel is done
      for (int blk = 0; blk < a.nt; ++blk) {
        k7_stage(a, stage, off, 8 * blk, 0, 0, a.nch, 0, a.tch);
        cp_async_commit();
      }
      for (int ti = 0; ti < a.nt; ++ti) {
        cp_async_wait_upto(a.nt - 1 - ti);
        bar_sync(kBarCompute, kCompute7);    // blocks 0 .. ti are in
        for (int tj = 0; tj <= ti; ++tj, ++i) {
          int vr[4][4] = {}, vi[4][4] = {}, racc[4] = {};
          k7_tile_chunk(stage, a.nch, (ti * kTile7 + wr) / 8,
                        (tj * kTile7 + wc) / 8, a.tch / 32, lane, vr, vi,
                        racc);
          k7_hand_over(slots, i, wr, wc, g, q, vr, vi, racc);
        }
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
    const long long job = blockIdx.x + step / nchunk * gridDim.x;
    const long long chan = job / a.ntri;
    const int t0 = (int)(step % nchunk) * a.tch;
    int ti, tj;
    k7_tile_of((int)(job % a.ntri), ti, tj);
    const int64_t off =
        (chan / a.nfreq) * a.sg + (int64_t)(chan % a.nfreq) * a.sf;
    const int tlen = min(a.tch, (a.ntime - t0 + 31) / 32 * 32);
    char* const dst = stage + (step & 1) * buf;
    k7_stage(a, dst, off, 0, ti * kTile7, tj * kTile7, 8, t0, tlen);
    k7_stage(a, dst, off, 8, ti * kTile7, tj * kTile7, 8, t0, tlen);
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
__device__ void k7_stores(const K7Args& a, const float2* slots) {
  const int sw = threadIdx.x / 32 - kCompute7 / 32, lane = threadIdx.x % 32;
  const long long ntiles =
      (a.njobs - blockIdx.x + gridDim.x - 1) / gridDim.x *
      (a.resident ? a.ntri : 1);
  long long i = 0;
  for (long long job = blockIdx.x; job < a.njobs; job += gridDim.x) {
    const long long chan = a.resident ? job : job / a.ntri;
    float2* const o = a.out + chan * a.n * (int64_t)a.n;
    const int k0 = a.resident ? 0 : (int)(job % a.ntri);
    const int k1 = a.resident ? a.ntri : k0 + 1;
    for (int k = k0; k < k1; ++k, ++i) {
      int ti, tj;
      k7_tile_of(k, ti, tj);
      const int s = (int)(i % kSlots7);
      bar_sync(kBarFull + s, kThreads7);
      k7_write(o, a.n, ti * kTile7, tj * kTile7, ti != tj,
               slots + s * (kSlotBytes7 / 8), sw, lane);
      if (i + kSlots7 < ntiles) bar_arrive(kBarEmpty + s, kThreads7);
    }
  }
}

__global__ void __launch_bounds__(kThreads7, 1)
xcorr_herm_kernel(const K7Args a) {
  extern __shared__ __align__(128) char smem7[];
  float2* const slots = reinterpret_cast<float2*>(smem7);
  char* const stage = smem7 + kSlots7 * kSlotBytes7;
  if (threadIdx.x < kCompute7)
    k7_compute(a, stage, slots);
  else
    k7_stores(a, slots);
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

constexpr int kMaxDev = 64;

struct DevInfo {
  int sms, smem;  // SM count, shared memory a block may opt in to
  bool attr;      // K7's dynamic shared-memory attribute is set
  size_t occ_bytes;  // the last launch's shared memory, and the K7
  int occ_blocks;    // blocks an SM holds with it
};

DevInfo dev_info[kMaxDev];

// the current device's DevInfo, read once per device; K7 opted in to all
// the shared memory a block may take (above 48 KB only after that)
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
  if (!d.attr) {
    err = cudaFuncSetAttribute(xcorr_herm_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               d.smem);
    if (err != cudaSuccess) return err;
    d.attr = true;
  }
  *out = &d;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// K7.  re, im: (ngroup, ntime, nfreq, n) int8 planes with strides sg, st,
// sf, sn (in elements, shared by both).  out: (ngroup, nfreq, n, n)
// complex64, contiguous.  vec 1 takes the 16-byte staging (the conditions
// below), vec 0 the scalar staging.  Returns a cudaError_t value; 0 on
// success.
int bf_xcorr_herm(const void* re, const void* im, void* out, int vec,
                  int ngroup, int ntime, int nfreq, int n, long long sg,
                  long long st, long long sf, long long sn, void* stream) {
  if (ngroup <= 0 || nfreq <= 0 || n <= 0) return 0;
  if (ntime <= 0 || ntime > 65535) return (int)cudaErrorInvalidValue;
  if (vec && !(sn == 2 && (const char*)im == (const char*)re + 1 &&
               (uintptr_t)re % 16 == 0 && sg % 16 == 0 && st % 16 == 0 &&
               sf % 16 == 0 && (2 * (int64_t)n) % 16 == 0))
    return (int)cudaErrorInvalidValue;
  DevInfo* d = nullptr;
  cudaError_t err = current_dev(&d);
  if (err != cudaSuccess) return (int)err;
  const int nt = (int)cdiv(n, kTile7);
  const int ntri = nt * (nt + 1) / 2;
  const int tall = (int)cdiv(ntime, 32) * 32;
  // a resident channel: tall frames of nt * kTile7 inputs, 2 bytes each
  const size_t res_bytes = (size_t)tall * nt * kTile7 * 2;
  K7Args a;
  a.re = (const int8_t*)re;
  a.im = (const int8_t*)im;
  a.out = (float2*)out;
  a.sg = sg;
  a.st = st;
  a.sf = sf;
  a.sn = sn;
  a.ntime = ntime;
  a.nfreq = nfreq;
  a.n = n;
  a.vec = vec ? 1 : 0;
  a.resident = kSlots7 * (size_t)kSlotBytes7 + res_bytes <= (size_t)d->smem;
  a.tch = a.resident ? tall : (tall < kChunk7 ? tall : kChunk7);
  a.nch = a.resident ? nt * kTile7 / 8 : 2 * kTile7 / 8;
  a.nt = nt;
  a.ntri = ntri;
  a.njobs = (long long)ngroup * nfreq * (a.resident ? 1 : ntri);
  const size_t bytes = kSlots7 * (size_t)kSlotBytes7 +
                       (a.resident ? 1 : 2) * (size_t)a.tch * a.nch * 16;
  if (bytes > (size_t)d->smem) return (int)cudaErrorInvalidConfiguration;
  if (d->occ_bytes != bytes || d->occ_blocks == 0) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, xcorr_herm_kernel, kThreads7, bytes);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    d->occ_bytes = bytes;
    d->occ_blocks = per_sm;
  }
  const long long fit = (long long)d->sms * d->occ_blocks;
  const long long grid = a.njobs < fit ? a.njobs : fit;
  xcorr_herm_kernel<<<(unsigned)grid, kThreads7, bytes,
                      (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// K8.  re_i, im_i: (ngroup, ntime, nfreq, ni) int8 planes with strides
// sg_i, st_i, sf_i, sn_i (in elements, shared by both); re_j, im_j likewise
// with nj inputs.  out: (ngroup, nfreq, ni, nj) complex64, contiguous.
// Returns a cudaError_t value; 0 on success.
int bf_xcorr_cross(const void* re_i, const void* im_i, const void* re_j,
                   const void* im_j, void* out, int ngroup, int ntime,
                   int nfreq, int ni, int nj, long long sg_i, long long st_i,
                   long long sf_i, long long sn_i, long long sg_j,
                   long long st_j, long long sf_j, long long sn_j,
                   void* stream) {
  if (ngroup <= 0 || nfreq <= 0 || ni <= 0 || nj <= 0) return 0;
  const Planes xi = {(const int8_t*)re_i, (const int8_t*)im_i, sg_i, st_i,
                     sf_i, sn_i, ni};
  const Planes xj = {(const int8_t*)re_j, (const int8_t*)im_j, sg_j, st_j,
                     sf_j, sn_j, nj};
  const int nti = (ni + kTile - 1) / kTile, ntj = (nj + kTile - 1) / kTile;
  const int ntiles = nti * ntj;
  const long long nblk = (long long)ntiles * nfreq * ngroup;
  if (nblk > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  xcorr_cross_kernel<<<(unsigned)nblk, kThreads, 0, (cudaStream_t)stream>>>(
      xi, xj, (float2*)out, ntime, nfreq, ntj, ntiles);
  return (int)cudaGetLastError();
}

const char* bf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
