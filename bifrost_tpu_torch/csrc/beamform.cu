// Coherent beamform kernels for Hopper (sm_90a): the per-channel complex
// product y[t, b] = sum_s w[b, s] x[t, s] of the quantized beamformer
// (bifrost_tpu_torch/ops/beamform.py), in three forms:
//
//   K4 bf_beamform_int8         int8 x int8 -> exact int32 (yr, yi) planes
//   K5 bf_beamform_bf16         bf16 x bf16 -> f32 (yr, yi) planes
//   K6 bf_beamform_detect_int8  both pols' int8 beamform -> x scale ->
//                               Stokes I, Q, U, V -> sum of R frames
//
// All three tile one frequency channel per block (with tiles of time and
// beams), loop over the stations in chunks staged in shared memory, and
// compute the four real dots of the complex product
//   yr = r . wr - i . wi,   yi = r . wi + i . wr
// with separate accumulators, as the Pallas kernels and the plain PyTorch
// versions do.  Voltages come with strides, so the per-pol views that
// BeamformStage takes of a (T, F, S, P, 2) ci8 gulp are read in place.
// Offsets are 64-bit; ragged edges (T, B, S not multiples of a tile) are
// zero-filled in shared memory and masked on store.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// ---------------------------------------------------------------------------
// K4: int8 beamform, exact int32.
//
// Replaces: bifrost_tpu/ops/pallas_kernels.py:beamform_int8 (pl.pallas_call
// at :265), candidate 'pallas' of the beamformer engine, one launch per pol.
//
// Bound on the H100: memory.  Per pol of the 512 x 512 x 256-station,
// 64-beam gulp it writes 2 x (T, F, B) int32 = 134 MB and reads its pol's
// 134 MB of interleaved ci8 rows (the other pol's bytes share the cache
// lines): about 0.08 ms at 3.35 TB/s, against 0.017 ms for its 34 G int8
// ops at 1,979 TOP/s.
//
// Design: one block per (channel, 32 time rows, 32 beams); 256 threads,
// each owning 4 rows x 1 beam.  Stations are staged 128 at a time, packed
// four to a 32-bit word, so the inner loop is __dp4a (4 int8 MACs into an
// int32) on shared-memory words: the weight row of a thread's beam (rows
// padded to an odd word count, so the 32 lanes hit 32 banks) against the
// voltage words of its rows (one address per warp: a broadcast).  Integer
// accumulation is exact, so the result is bit-identical to the int64
// oracle while |sum| < 2^31 (the wrapper bounds S).  Simple first: the
// byte-wise staging of strided voltages and dp4a instead of the int8
// tensor cores (mma / wgmma) leave it well above its bound.
// ---------------------------------------------------------------------------

constexpr int kTT = 32;            // time rows per tile (K4, K6)
constexpr int kBT = 32;            // beams per tile (K4, K6)
constexpr int kSC4 = 128;          // stations per staged chunk (K4)
constexpr int kW4 = kSC4 / 4 + 1;  // padded words per staged row (K4)

__device__ __forceinline__ uint32_t pack4(const int8_t* __restrict__ p,
                                          int64_t stride, int n) {
  // up to 4 int8 at p, p + stride, ... packed little-endian; zero past n
  uint32_t w = 0;
  for (int k = 0; k < 4 && k < n; ++k)
    w |= (uint32_t)(uint8_t)__ldg(p + k * stride) << (8 * k);
  return w;
}

__global__ void __launch_bounds__(kThreads)
beamform_int8_kernel(const int8_t* __restrict__ wr,
                     const int8_t* __restrict__ wi,
                     const int8_t* __restrict__ re,
                     const int8_t* __restrict__ im,
                     int32_t* __restrict__ yr, int32_t* __restrict__ yi,
                     int ntime, int nfreq, int nstand, int nbeam,
                     int64_t st, int64_t sf, int64_t ss, int ntile_t,
                     int ntile_b) {
  __shared__ int s_r[kTT][kW4], s_i[kTT][kW4];
  __shared__ int s_wr[kBT][kW4], s_wi[kBT][kW4];
  int64_t blk = blockIdx.x;
  const int tb = (int)(blk % ntile_b);
  blk /= ntile_b;
  const int tt = (int)(blk % ntile_t);
  const int f = (int)(blk / ntile_t);
  const int t0 = tt * kTT, b0 = tb * kBT;
  const int bx = threadIdx.x % 32, ty = threadIdx.x / 32;
  int acc_rr[4] = {0, 0, 0, 0}, acc_ii[4] = {0, 0, 0, 0};
  int acc_im[4] = {0, 0, 0, 0};
  for (int s0 = 0; s0 < nstand; s0 += kSC4) {
    const int ns = min(kSC4, nstand - s0);
    for (int i = threadIdx.x; i < kTT * (kSC4 / 4); i += kThreads) {
      const int row = i / (kSC4 / 4), w = i % (kSC4 / 4);
      const int t = t0 + row, n = ns - 4 * w;
      uint32_t pr = 0, pi = 0;
      if (t < ntime && n > 0) {
        const int64_t o = t * st + f * sf + (s0 + 4 * w) * ss;
        pr = pack4(re + o, ss, n);
        pi = pack4(im + o, ss, n);
      }
      s_r[row][w] = (int)pr;
      s_i[row][w] = (int)pi;
    }
    for (int i = threadIdx.x; i < kBT * (kSC4 / 4); i += kThreads) {
      const int row = i / (kSC4 / 4), w = i % (kSC4 / 4);
      const int b = b0 + row, n = ns - 4 * w;
      uint32_t pr = 0, pi = 0;
      if (b < nbeam && n > 0) {
        const int64_t o = (int64_t)b * nstand + s0 + 4 * w;
        pr = pack4(wr + o, 1, n);
        pi = pack4(wi + o, 1, n);
      }
      s_wr[row][w] = (int)pr;
      s_wi[row][w] = (int)pi;
    }
    __syncthreads();
    const int nw = (ns + 3) / 4;
    for (int w = 0; w < nw; ++w) {
      const int a = s_wr[bx][w], c = s_wi[bx][w];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = s_r[ty + 8 * j][w], q = s_i[ty + 8 * j][w];
        acc_rr[j] = __dp4a(r, a, acc_rr[j]);
        acc_ii[j] = __dp4a(q, c, acc_ii[j]);
        acc_im[j] = __dp4a(q, a, __dp4a(r, c, acc_im[j]));
      }
    }
    __syncthreads();
  }
  const int b = b0 + bx;
  if (b >= nbeam) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int t = t0 + ty + 8 * j;
    if (t >= ntime) continue;
    const int64_t o = ((int64_t)t * nfreq + f) * nbeam + b;
    yr[o] = acc_rr[j] - acc_ii[j];
    yi[o] = acc_im[j];
  }
}

// ---------------------------------------------------------------------------
// K5: bf16 beamform with f32 accumulation.
//
// Replaces: bifrost_tpu/ops/pallas_kernels.py:beamform_bf16 (pl.pallas_call
// at :307), candidate 'pallas_bf16', one launch per pol.
//
// Bound on the H100: memory.  Per pol: 2 x (T, F, B) f32 out (134 MB) plus
// the pol's voltages in (134 MB of int8): about 0.08 ms at 3.35 TB/s,
// against 0.035 ms for its 34 G operations at the 989 TFLOP/s bf16 rate.
//
// Design: one block of 4 warps per (channel, 64 time rows, 32 beams); each
// warp owns 16 rows x 32 beams as four m16n8 tiles and issues
// mma.sync.m16n8k16 bf16 with f32 accumulation, four products (r.wr, i.wi,
// r.wi, i.wr) per tile and k-step, kept apart until the end as the plain
// version keeps its four dots apart.  Voltages (int8, exact in bf16, or
// f32) and f32 weights are rounded to bf16 with __float2bfloat16_rn
// (round to nearest even, as torch's .bfloat16() and XLA's convert) while
// they are staged, 64 stations at a time, in shared-memory rows padded to
// 36 words so that a fragment load's 32 lanes hit 32 banks.
// ---------------------------------------------------------------------------

constexpr int kTT5 = 64;           // time rows per tile (K5)
constexpr int kBT5 = 32;           // beams per tile (K5)
constexpr int kSC5 = 64;           // stations per staged chunk (K5)
constexpr int kRow5 = kSC5 + 8;    // padded bf16 per staged row (K5)
constexpr int kThreads5 = 128;

template <typename V>
__device__ __forceinline__ __nv_bfloat16 to_bf16(V v) {
  return __float2bfloat16_rn((float)v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename V>
__global__ void __launch_bounds__(kThreads5)
beamform_bf16_kernel(const float* __restrict__ wr,
                     const float* __restrict__ wi,
                     const V* __restrict__ re, const V* __restrict__ im,
                     float* __restrict__ yr, float* __restrict__ yi,
                     int ntime, int nfreq, int nstand, int nbeam,
                     int64_t st, int64_t sf, int64_t ss, int ntile_t,
                     int ntile_b) {
  __shared__ __align__(16) __nv_bfloat16 s_r[kTT5][kRow5];
  __shared__ __align__(16) __nv_bfloat16 s_i[kTT5][kRow5];
  __shared__ __align__(16) __nv_bfloat16 s_wr[kBT5][kRow5];
  __shared__ __align__(16) __nv_bfloat16 s_wi[kBT5][kRow5];
  int64_t blk = blockIdx.x;
  const int tb = (int)(blk % ntile_b);
  blk /= ntile_b;
  const int tt = (int)(blk % ntile_t);
  const int f = (int)(blk / ntile_t);
  const int t0 = tt * kTT5, b0 = tb * kBT5;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;       // mma groupID, thread in group
  float acc[4][4][4];                         // [n tile][rr, ii, ri, ir][c]
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][k][c] = 0.f;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  for (int s0 = 0; s0 < nstand; s0 += kSC5) {
    const int ns = min(kSC5, nstand - s0);
    for (int i = threadIdx.x; i < kTT5 * kSC5; i += kThreads5) {
      const int row = i / kSC5, s = i % kSC5, t = t0 + row;
      __nv_bfloat16 vr = zero, vi = zero;
      if (t < ntime && s < ns) {
        const int64_t o = t * st + f * sf + (s0 + s) * ss;
        vr = to_bf16(re[o]);
        vi = to_bf16(im[o]);
      }
      s_r[row][s] = vr;
      s_i[row][s] = vi;
    }
    for (int i = threadIdx.x; i < kBT5 * kSC5; i += kThreads5) {
      const int row = i / kSC5, s = i % kSC5, b = b0 + row;
      __nv_bfloat16 a = zero, c = zero;
      if (b < nbeam && s < ns) {
        const int64_t o = (int64_t)b * nstand + s0 + s;
        a = to_bf16(__ldg(wr + o));
        c = to_bf16(__ldg(wi + o));
      }
      s_wr[row][s] = a;
      s_wi[row][s] = c;
    }
    __syncthreads();
    const int nk = (ns + 15) / 16;
    const int r0 = warp * 16 + g;
    for (int kk = 0; kk < nk; ++kk) {
      const int k0 = kk * 16 + 2 * q;
      const uint32_t ar[4] = {ld32(&s_r[r0][k0]), ld32(&s_r[r0 + 8][k0]),
                              ld32(&s_r[r0][k0 + 8]),
                              ld32(&s_r[r0 + 8][k0 + 8])};
      const uint32_t ai[4] = {ld32(&s_i[r0][k0]), ld32(&s_i[r0 + 8][k0]),
                              ld32(&s_i[r0][k0 + 8]),
                              ld32(&s_i[r0 + 8][k0 + 8])};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = j * 8 + g;
        const uint32_t br0 = ld32(&s_wr[n][k0]), br1 = ld32(&s_wr[n][k0 + 8]);
        const uint32_t bi0 = ld32(&s_wi[n][k0]), bi1 = ld32(&s_wi[n][k0 + 8]);
        mma_bf16(acc[j][0], ar, br0, br1);
        mma_bf16(acc[j][1], ai, bi0, bi1);
        mma_bf16(acc[j][2], ar, bi0, bi1);
        mma_bf16(acc[j][3], ai, br0, br1);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int t = t0 + warp * 16 + g + (c >= 2 ? 8 : 0);
      const int b = b0 + j * 8 + 2 * q + (c & 1);
      if (t >= ntime || b >= nbeam) continue;
      const int64_t o = ((int64_t)t * nfreq + f) * nbeam + b;
      yr[o] = __fsub_rn(acc[j][0][c], acc[j][1][c]);
      yi[o] = __fadd_rn(acc[j][2][c], acc[j][3][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// K6: both pols' int8 beamform -> x scale -> Stokes -> sum of R frames.
//
// Replaces: bifrost_tpu/ops/pallas_kernels.py:beamform_detect_int8
// (pl.pallas_call at :384), which stages.match_beamformer substitutes for
// BeamformStage -> DetectStage('stokes', pol) -> ReduceStage('time', R);
// one launch per gulp.
//
// Bound on the H100: memory.  It reads the (T, F, S, 2, 2) ci8 gulp once
// (268 MB at 512 x 512 x 256) and writes (T/R, F, 4, B) f32 (33.5 MB at
// R 8): 0.09 ms at 3.35 TB/s; its 68.7 G int8 ops take 0.035 ms at
// 1,979 TOP/s.  The beam voltages never reach device memory.
//
// Design: one block per (channel, G output groups of R frames, 32 beams),
// G = max(1, 32 / R), so an R-group never straddles two blocks: no atomics
// and a fixed summation order.  The block walks its G * R rows 32 at a
// time.  For each 32-row sub-tile it stages 64 stations at a time: one
// 32-bit word per station holds (re x, im x, re y, im y), and four
// stations' words are regrouped into one word per plane, so the inner loop
// is eight __dp4a per 4 stations (exact int32, as K4).  Each thread owns
// 4 rows x 1 beam; it converts its sums to f32, multiplies by scale and
// forms I, Q, U, V with explicitly rounded multiplies and adds (no FMA
// contraction), as the plain version's separate ops do.  The Stokes
// values go through shared memory to the threads that own the (group,
// beam) sums, which add them in frame order; so the result is
// bit-identical to the plain version's int64 -> f32 -> frame-ordered sum.
// ---------------------------------------------------------------------------

constexpr int kSC6 = 64;           // stations per staged chunk (K6)
constexpr int kW6 = kSC6 / 4 + 1;  // padded words per staged row (K6)

__device__ __forceinline__ uint32_t plane(uint32_t w0, uint32_t w1,
                                          uint32_t w2, uint32_t w3, int k) {
  // byte k of each of four station words, as one word (station order)
  const int sh = 8 * k;
  return ((w0 >> sh) & 0xffu) | (((w1 >> sh) & 0xffu) << 8) |
         (((w2 >> sh) & 0xffu) << 16) | (((w3 >> sh) & 0xffu) << 24);
}

__global__ void __launch_bounds__(kThreads)
beamform_detect_kernel(const int8_t* __restrict__ wxr,
                       const int8_t* __restrict__ wxi,
                       const int8_t* __restrict__ wyr,
                       const int8_t* __restrict__ wyi,
                       const int8_t* __restrict__ x, float* __restrict__ out,
                       float scale, int ntime, int nfreq, int nstand,
                       int nbeam, int rfactor, int ngroup, int64_t st,
                       int64_t sf, int ntile_g, int ntile_b) {
  __shared__ int s_v[4][kTT][kW6];         // planes re x, im x, re y, im y
  __shared__ int s_w[4][kBT][kW6];         // wxr, wxi, wyr, wyi
  __shared__ float s_st[4][kTT][kBT + 1];  // Stokes of one sub-tile
  int64_t blk = blockIdx.x;
  const int tb = (int)(blk % ntile_b);
  blk /= ntile_b;
  const int tg = (int)(blk % ntile_g);
  const int f = (int)(blk / ntile_g);
  const int nout = ntime / rfactor;
  const int g0 = tg * ngroup, b0 = tb * kBT;
  const int ng = min(ngroup, nout - g0);
  const int nrow = ng * rfactor;           // frames of this block
  const int64_t r0 = (int64_t)g0 * rfactor;
  const int bx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int8_t* wsrc[4] = {wxr, wxi, wyr, wyi};
  float sum[4][4];                         // [owned group][I, Q, U, V]
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int k = 0; k < 4; ++k) sum[m][k] = 0.f;

  for (int rs = 0; rs < nrow; rs += kTT) {
    int axp[4] = {0, 0, 0, 0}, axn[4] = {0, 0, 0, 0}, axi[4] = {0, 0, 0, 0};
    int ayp[4] = {0, 0, 0, 0}, ayn[4] = {0, 0, 0, 0}, ayi[4] = {0, 0, 0, 0};
    for (int s0 = 0; s0 < nstand; s0 += kSC6) {
      const int ns = min(kSC6, nstand - s0);
      for (int i = threadIdx.x; i < kTT * (kSC6 / 4); i += kThreads) {
        const int row = i / (kSC6 / 4), w = i % (kSC6 / 4);
        const int n = ns - 4 * w;
        uint32_t sw[4] = {0u, 0u, 0u, 0u};
        if (rs + row < nrow && n > 0) {
          const uint32_t* p = reinterpret_cast<const uint32_t*>(
              x + (r0 + rs + row) * st + f * sf + 4 * (int64_t)(s0 + 4 * w));
          for (int k = 0; k < 4 && k < n; ++k) sw[k] = __ldg(p + k);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k)
          s_v[k][row][w] = (int)plane(sw[0], sw[1], sw[2], sw[3], k);
      }
      for (int i = threadIdx.x; i < kBT * (kSC6 / 4); i += kThreads) {
        const int row = i / (kSC6 / 4), w = i % (kSC6 / 4);
        const int b = b0 + row, n = ns - 4 * w;
        const int64_t o = (int64_t)b * nstand + s0 + 4 * w;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          s_w[k][row][w] =
              (b < nbeam && n > 0) ? (int)pack4(wsrc[k] + o, 1, n) : 0;
      }
      __syncthreads();
      const int nw = (ns + 3) / 4;
      for (int w = 0; w < nw; ++w) {
        const int a = s_w[0][bx][w], c = s_w[1][bx][w];
        const int d = s_w[2][bx][w], e = s_w[3][bx][w];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = ty + 8 * j;
          const int rx = s_v[0][row][w], ix = s_v[1][row][w];
          const int ry = s_v[2][row][w], iy = s_v[3][row][w];
          axp[j] = __dp4a(rx, a, axp[j]);
          axn[j] = __dp4a(ix, c, axn[j]);
          axi[j] = __dp4a(ix, a, __dp4a(rx, c, axi[j]));
          ayp[j] = __dp4a(ry, d, ayp[j]);
          ayn[j] = __dp4a(iy, e, ayn[j]);
          ayi[j] = __dp4a(iy, d, __dp4a(ry, e, ayi[j]));
        }
      }
      __syncthreads();
    }
    // Stokes of this sub-tile's rows, through shared memory
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = ty + 8 * j;
      const float bxr = __fmul_rn((float)(axp[j] - axn[j]), scale);
      const float bxi = __fmul_rn((float)axi[j], scale);
      const float byr = __fmul_rn((float)(ayp[j] - ayn[j]), scale);
      const float byi = __fmul_rn((float)ayi[j], scale);
      const float xx = __fadd_rn(__fmul_rn(bxr, bxr), __fmul_rn(bxi, bxi));
      const float yy = __fadd_rn(__fmul_rn(byr, byr), __fmul_rn(byi, byi));
      const float xyr = __fadd_rn(__fmul_rn(bxr, byr), __fmul_rn(bxi, byi));
      const float xyi = __fsub_rn(__fmul_rn(bxi, byr), __fmul_rn(bxr, byi));
      s_st[0][row][bx] = __fadd_rn(xx, yy);
      s_st[1][row][bx] = __fsub_rn(xx, yy);
      s_st[2][row][bx] = 2.f * xyr;
      s_st[3][row][bx] = -2.f * xyi;
    }
    __syncthreads();
    // frame-ordered sums: thread (ty, bx) owns groups ty + 8 m
    const int rend = min(rs + kTT, nrow);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int gl = ty + 8 * m;
      if (gl >= ng) continue;
      const int lo = max(gl * rfactor, rs), hi = min((gl + 1) * rfactor, rend);
      for (int r = lo; r < hi; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          sum[m][k] = __fadd_rn(sum[m][k], s_st[k][r - rs][bx]);
    }
    __syncthreads();
  }
  const int b = b0 + bx;
  if (b >= nbeam) return;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int gl = ty + 8 * m;
    if (gl >= ng) continue;
    float* o = out + (((int64_t)(g0 + gl) * nfreq + f) * 4) * nbeam + b;
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k * nbeam] = sum[m][k];
  }
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// K4.  wr, wi: (nbeam, nstand) int8, contiguous.  re, im: (ntime, nfreq,
// nstand) int8 with element strides st, sf, ss shared by both.  yr, yi:
// (ntime, nfreq, nbeam) int32, contiguous.  Returns a cudaError_t value.
int bf_beamform_int8(const void* wr, const void* wi, const void* re,
                     const void* im, void* yr, void* yi, int ntime,
                     int nfreq, int nstand, int nbeam, long long st,
                     long long sf, long long ss, void* stream) {
  if (ntime <= 0 || nfreq <= 0 || nbeam <= 0) return 0;
  const int ntt = (int)cdiv(ntime, kTT), ntb = (int)cdiv(nbeam, kBT);
  const int64_t nblk = (int64_t)nfreq * ntt * ntb;
  if (nblk > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  beamform_int8_kernel<<<(unsigned)nblk, kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const int8_t*)wr, (const int8_t*)wi, (const int8_t*)re,
      (const int8_t*)im, (int32_t*)yr, (int32_t*)yi, ntime, nfreq, nstand,
      nbeam, st, sf, ss, ntt, ntb);
  return (int)cudaGetLastError();
}

// K5.  wr, wi: (nbeam, nstand) float32, contiguous.  re, im: (ntime, nfreq,
// nstand), int8 (vtype 0) or float32 (vtype 1), element strides st, sf, ss
// shared by both.  yr, yi: (ntime, nfreq, nbeam) float32, contiguous.
int bf_beamform_bf16(const void* wr, const void* wi, const void* re,
                     const void* im, void* yr, void* yi, int vtype,
                     int ntime, int nfreq, int nstand, int nbeam,
                     long long st, long long sf, long long ss, void* stream) {
  if (ntime <= 0 || nfreq <= 0 || nbeam <= 0) return 0;
  const int ntt = (int)cdiv(ntime, kTT5), ntb = (int)cdiv(nbeam, kBT5);
  const int64_t nblk = (int64_t)nfreq * ntt * ntb;
  if (nblk > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  if (vtype == 0)
    beamform_bf16_kernel<int8_t><<<(unsigned)nblk, kThreads5, 0, s>>>(
        (const float*)wr, (const float*)wi, (const int8_t*)re,
        (const int8_t*)im, (float*)yr, (float*)yi, ntime, nfreq, nstand,
        nbeam, st, sf, ss, ntt, ntb);
  else
    beamform_bf16_kernel<float><<<(unsigned)nblk, kThreads5, 0, s>>>(
        (const float*)wr, (const float*)wi, (const float*)re,
        (const float*)im, (float*)yr, (float*)yi, ntime, nfreq, nstand,
        nbeam, st, sf, ss, ntt, ntb);
  return (int)cudaGetLastError();
}

// K6.  wxr, wxi, wyr, wyi: (nbeam, nstand) int8, contiguous.  x: (ntime,
// nfreq, nstand, 2 pol, 2 re/im) int8 with element strides st, sf for the
// first two axes (multiples of 4) and the last three contiguous; 4-byte
// aligned.  out: (ntime / rfactor, nfreq, 4, nbeam) float32, contiguous,
// ordered I, Q, U, V.  rfactor must divide ntime.
int bf_beamform_detect_int8(const void* wxr, const void* wxi,
                            const void* wyr, const void* wyi, const void* x,
                            void* out, float scale, int ntime, int nfreq,
                            int nstand, int nbeam, int rfactor, long long st,
                            long long sf, void* stream) {
  if (ntime <= 0 || nfreq <= 0 || nbeam <= 0) return 0;
  if (rfactor <= 0 || ntime % rfactor) return (int)cudaErrorInvalidValue;
  const int ngroup = rfactor >= kTT ? 1 : kTT / rfactor;
  const int ntg = (int)cdiv(ntime / rfactor, ngroup);
  const int ntb = (int)cdiv(nbeam, kBT);
  const int64_t nblk = (int64_t)nfreq * ntg * ntb;
  if (nblk > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  beamform_detect_kernel<<<(unsigned)nblk, kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const int8_t*)wxr, (const int8_t*)wxi, (const int8_t*)wyr,
      (const int8_t*)wyi, (const int8_t*)x, (float*)out, scale, ntime,
      nfreq, nstand, nbeam, rfactor, ngroup, st, sf, ntg, ntb);
  return (int)cudaGetLastError();
}

const char* bf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
