// Coherent beamform kernels for Hopper (sm_90a): the per-channel complex
// product y[t, b] = sum_s w[b, s] x[t, s] of the quantized beamformer
// (bifrost_tpu_torch/ops/beamform.py), in three forms:
//
//   K4 bf_beamform_int8         int8 x int8 -> exact int32 (yr, yi) planes
//   K5 bf_beamform_bf16         bf16 x bf16 -> f32 (yr, yi) planes
//   K6 bf_beamform_detect_int8  both pols' int8 beamform -> x scale ->
//                               Stokes I, Q, U, V -> sum of R frames
//
// K4 and K5 compute the complex product
//   yr = r . wr - i . wi,   yi = r . wi + i . wr
// as one GEMM over every channel on the tensor cores (their notes below).
// K6 runs both pols' products of K4's design on one staging of the gulp
// and keeps Stokes and the frame sum in registers (R dividing 16, rows on
// 16 bytes); other gulps take its dp4a kernel, which tiles one frequency
// channel per block and keeps the four real dots in separate accumulators.
// Voltages come with strides, so the per-pol views that BeamformStage takes
// of a (T, F, S, P, 2) ci8 gulp are read in place.  Offsets are 64-bit;
// ragged edges (T, B, S not multiples of a tile) are zero-filled in shared
// memory and masked on store.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// K4: int8 beamform, exact int32.
//
// Replaces: bifrost_tpu/ops/pallas_kernels.py:beamform_int8 (pl.pallas_call
// at :265), candidate 'pallas' of the beamformer engine, one launch per pol.
//
// Bound on the H100: memory.  The per-pol view x[:, :, :, p, 0] of a
// (T, F, S, 2, 2) ci8 gulp touches every 32-byte sector of the gulp, so a
// launch reads all of it: at 512 x 512 x 256 stations and 64 beams,
// 268.4 MB in and 2 x (T, F, B) int32 = 134.2 MB out, 0.120 ms at
// 3.35 TB/s, against 0.017 ms for its 34.4 G int8 ops at 1,979 TOP/s.
//
// Design: one int8 GEMM over every channel on the tensor cores.  Row
// m = (t, f) of the view (M = T * F); K = the stations, with re and im
// staged as separate A operands (de-interleaved K); the weights are the
// panel [wr | wi] (column b is wr[b], column 64 + b is wi[b]), never
// negated.  The four products rr, ii, ri, ir would take four accumulators;
// folding ii into yr's halves that.  mma.sync.m16n8k32 (s8 x s8 -> s32,
// no .satfinite) gives, per 16 rows x 8 beams x 32 stations, four
// products into two accumulators:
//   yr += re . wr  +  (~im) . wi        yi += re . wi  +  im . wr
// with yr's accumulator started at c_b = sum_s wi[b, s].
//
// - Why it is exact for every int8 value, -128 included: ~im = -im - 1 is
//   an int8 for every int8 im (~(-128) = 127), so no operand leaves int8,
//   and sum_s (~im_s) wi_s + c_b = -sum_s im_s wi_s.  The s32
//   accumulators wrap (no .satfinite): every partial sum is the exact one
//   mod 2^32, and the final yr, yi are exact because |yr|, |yi| <=
//   2 S 128^2 < 2^31 for S <= MAX_NSTAND (the wrapper's limit).  The
//   weights go in as they are, so wr, wi = -128 are taken too.
// - Tiles: 128 rows x 64 beams per block; eight warps each own 16 rows x
//   64 beams (yr and yi: 64 accumulator registers a thread), so each
//   staged voltage byte is read from shared memory once.
// - Resident weights, persistent grid: one block per SM walks the M tiles
//   (and the beam tiles when B > 64, rebuilding the panel when its beam
//   tile changes).  The block copies the int8 panel once into dynamic
//   shared memory (128 columns x S bytes, padded: 36 KB at S = 256); above
//   kRes4 stations it stages each chunk's part of the panel beside the
//   voltages instead, from L2.
// - 16-byte staging (SS = 4 or 2, the interleaved ci8 layout): the raw
//   rows (both pols' bytes when SS = 4) go from HBM to shared memory by
//   cp.async, 16 bytes a copy, no registers, into a ring of kStages4
//   stages of 64 stations (32 KB at SS = 4), kStages4 - 1 of them in
//   flight while the block multiplies the oldest, across tile boundaries
//   (3 stages measured as fast as 4 or 5, and 64-row tiles at two blocks
//   an SM slower: the ring's depth is not what holds K4).
//   A consumer loads 16 raw bytes (4 or 8 stations) and picks its pol's
//   re and im bytes out with byte_perm (4 a load), so an A register holds
//   four stations of one plane.  Station k <-> MMA index: a thread's
//   registers a0 (k 4q..4q+3) and a2 (k 16 + 4q ..) hold stations 8q..8q+3
//   and 8q+4..8q+7 of each 32-station group, and the panel keeps stations
//   in order, so a B fragment is one 8-byte load (b0, b1 = stations 8q..8q+7
//   of column g).  Rows of the stage are swizzled by their parity, so the
//   16-byte loads of a quarter-warp hit distinct banks.  Every other layout
//   (separate planes, rows off 16 bytes, odd strides) goes through a scalar
//   staging of the same kernel (SS = 0) into the SS = 2 layout.
// - Epilogue: a C fragment's pair is two adjacent beams of one row, stored
//   as one int2 (streaming stores), rows and beams masked.
// ---------------------------------------------------------------------------

constexpr int kThreads4 = 256;         // 8 warps of mma.sync
constexpr int kBM4 = 128;              // rows (t, f) per tile (K4)
constexpr int kBB4 = 64;               // beams per tile: 128 panel columns
constexpr int kSC4 = 64;               // stations per K chunk (K4)
constexpr int kStages4 = 3;            // cp.async ring depth
constexpr int kRes4 = 256;             // most stations of a resident panel
constexpr int kPW4 = kSC4 + 32;        // bytes per streamed panel column

struct K4Args {
  const int8_t* wr;
  const int8_t* wi;
  const char* re;       // scalar path: the re plane; 16-byte path: row base
  const char* im;
  int* yr;
  int* yi;
  long long st, sf, ss; // element strides of the voltage planes
  int M, F, S, B;
  int nchunk;           // K chunks of kSC4 stations
  int ntile_m, ntiles;
  int pbyte;            // 16-byte path: byte of re in a station word
  int resident;         // the whole panel lives in shared memory
  int pw;               // bytes per panel column when resident
  int wvec;             // weight rows load 16 bytes at a time
};

template <int SS>
struct K4Stage {
  // bytes per staged row of one chunk (the raw layout; SS = 0 stages the
  // SS = 2 layout) and per stage
  static constexpr int kRow = kSC4 * (SS == 4 ? 4 : 2);
  static constexpr int kBytes = kBM4 * kRow;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int nbytes) {
  // 16 bytes to shared memory, the last 16 - nbytes zero-filled
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(nbytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a,
                                       uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// stations s .. s + 15 of a weight row, zero past S
__device__ __forceinline__ uint4 weights16(const int8_t* row, int s, int S,
                                           int vec) {
  if (vec) return s < S ? __ldg(reinterpret_cast<const uint4*>(row + s))
                        : make_uint4(0u, 0u, 0u, 0u);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 16; ++e)
    if (s + e < S)
      w[e / 4] |= (uint32_t)(uint8_t)__ldg(row + s + e) << (8 * (e % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// panel columns of beams b0 .. b0 + 63 (wr, then wi), stations s0 ..
// s0 + 16 * ngrp - 1, ws bytes per column, zero past B and S; W holds
// the weight planes wr, wi and S, B, wvec (K4Args, or a pol's K6Weights)
template <typename W>
__device__ __forceinline__ void k4_panel(char* p, int ws, const W& a,
                                         int b0, int s0, int ngrp) {
  for (int idx = threadIdx.x; idx < 2 * kBB4 * ngrp; idx += kThreads4) {
    const int col = idx / ngrp, grp = idx - col * ngrp;
    const int b = b0 + (col & (kBB4 - 1));
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (b < a.B)
      v = weights16((col < kBB4 ? a.wr : a.wi) + (int64_t)b * a.S,
                    s0 + 16 * grp, a.S, a.wvec);
    *reinterpret_cast<uint4*>(p + col * ws + 16 * grp) = v;
  }
}

// the sum of the four int8 of w
__device__ __forceinline__ int byte_sum(uint32_t w) {
  return (int)(int8_t)w + (int)(int8_t)(w >> 8) + (int)(int8_t)(w >> 16) +
         (int)(int8_t)(w >> 24);
}

// c_b = sum_s wi[b, s] of beams b0 .. b0 + 63 (0 past B): warp w sums
// beams 8w .. 8w + 7, a lane 16 stations at a time
template <typename W>
__device__ __forceinline__ void k4_beam_sums(int* csum, const W& a,
                                             int b0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = 0; i < kBB4 / (kThreads4 / 32); ++i) {
    const int bl = warp * (kBB4 / (kThreads4 / 32)) + i, b = b0 + bl;
    int sum = 0;
    if (b < a.B) {
      const int8_t* row = a.wi + (int64_t)b * a.S;
      for (int s = 16 * lane; s < a.S; s += 16 * 32) {
        const uint4 v = weights16(row, s, a.S, a.wvec);
        sum += byte_sum(v.x) + byte_sum(v.y) + byte_sum(v.z) + byte_sum(v.w);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(~0u, sum, o);
    if (lane == 0) csum[bl] = sum;
  }
}

// Stage chunk k of the block's sequence (its tiles blockIdx.x + i *
// gridDim.x, nchunk chunks each) into ring stage k % kStages4: cp.async
// of the raw rows (SS = 4, 2) or the scalar staging (SS = 0), and the
// chunk's panel part when the panel is not resident.
template <int SS>
__device__ __forceinline__ void k4_stage_chunk(const K4Args& a,
                                               char* stages, char* panel,
                                               int k, int nseq) {
  if (k >= nseq) return;
  const int i = k / a.nchunk, c = k - i * a.nchunk;
  const int tile = blockIdx.x + i * gridDim.x;
  const int nt = tile / a.ntile_m;
  const int m0 = (tile - nt * a.ntile_m) * kBM4;
  char* const A = stages + (k % kStages4) * K4Stage<SS>::kBytes;
  constexpr int kRow = K4Stage<SS>::kRow;
  constexpr int kVR = kRow / 16;                 // 16-byte vectors a row
  constexpr int kNV = kBM4 * kVR / kThreads4;    // vectors a thread
  constexpr int kRS = kThreads4 / kVR;           // row step
  constexpr int kSV = SS == 4 ? 4 : 8;           // stations a vector
  const int v = threadIdx.x % kVR, r0 = threadIdx.x / kVR;
  const int s = c * kSC4 + v * kSV;
  // (t, f) of row m0 + r0, then stepped by kRS rows
  int m = m0 + r0, t = m / a.F, f = m - t * a.F;
#pragma unroll
  for (int n = 0; n < kNV; ++n) {
    const int r = r0 + n * kRS;
    const int sw = SS == 4 ? (r & 1) : (r & 1) << 2;
    char* dst = A + r * kRow + 16 * (v ^ sw);
    const bool ok = m < a.M && s < a.S;
    if (SS) {
      const char* src = a.re;
      if (ok) src += t * a.st + f * a.sf + (int64_t)s * SS;
      cp_async16(dst, src, ok ? 16 : 0);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (ok) {
        const int64_t o = t * a.st + f * a.sf + (int64_t)s * a.ss;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (s + e < a.S) {
            const uint32_t re = (uint8_t)__ldg(a.re + o + e * a.ss);
            const uint32_t im = (uint8_t)__ldg(a.im + o + e * a.ss);
            w[e / 2] |= (re | im << 8) << (16 * (e % 2));
          }
        }
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
    m += kRS;
    f += kRS;
    while (f >= a.F) {
      f -= a.F;
      ++t;
    }
  }
  if (!a.resident)
    k4_panel(panel + (k % kStages4) * (2 * kBB4 * kPW4), kPW4, a, nt * kBB4,
             c * kSC4, kSC4 / 16);
}

// A fragments of rows r and r + 8, 32-station group kg: re and im planes
template <int SS>
__device__ __forceinline__ void k4_load_a(const char* A, int r, int kg,
                                          int q, uint32_t sel, uint32_t* ar,
                                          uint32_t* ai) {
  constexpr int kRow = K4Stage<SS>::kRow;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const char* row = A + (r + 8 * h) * kRow;
    if (SS == 4) {
      // 4 station words a vector; the pol's (re, im) at bytes sel picks
      const int j = kg * 8 + 2 * q, sw = r & 1;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const uint4 w =
            *reinterpret_cast<const uint4*>(row + 16 * ((j + u) ^ sw));
        const uint32_t t0 = __byte_perm(w.x, w.y, sel);
        const uint32_t t1 = __byte_perm(w.z, w.w, sel);
        ar[h + 2 * u] = __byte_perm(t0, t1, 0x6420);
        ai[h + 2 * u] = __byte_perm(t0, t1, 0x7531);
      }
    } else {
      // 8 (re, im) pairs a vector
      const int j = kg * 4 + q, sw = (r & 1) << 2;
      const uint4 w = *reinterpret_cast<const uint4*>(row + 16 * (j ^ sw));
      ar[h] = __byte_perm(w.x, w.y, 0x6420);
      ai[h] = __byte_perm(w.x, w.y, 0x7531);
      ar[h + 2] = __byte_perm(w.z, w.w, 0x6420);
      ai[h + 2] = __byte_perm(w.z, w.w, 0x7531);
    }
  }
}

template <int SS>
__global__ void __launch_bounds__(kThreads4, 1)
beamform_int8_kernel(const K4Args a) {
  extern __shared__ __align__(16) char smem4[];
  char* const stages = smem4;
  char* const panel = smem4 + kStages4 * K4Stage<SS>::kBytes;
  int* const csum = reinterpret_cast<int*>(
      panel + (a.resident ? 2 * kBB4 * a.pw : kStages4 * 2 * kBB4 * kPW4));
  const int nseq = ((a.ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) *
                   a.nchunk;
#pragma unroll
  for (int k = 0; k < kStages4 - 1; ++k) {
    k4_stage_chunk<SS>(a, stages, panel, k, nseq);
    cp_async_commit();
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;      // mma groupID, thread in group
  const int r = warp * 16 + g;               // the thread's rows r, r + 8
  const uint32_t sel = a.pbyte | (a.pbyte + 1) << 4 | (a.pbyte + 4) << 8 |
                       (a.pbyte + 5) << 12;
  int yr[8][4], yi[8][4];
  int tile = blockIdx.x, c = 0, cur_nt = -1;
  for (int k = 0; k < nseq; ++k) {
    cp_async_wait<kStages4 - 2>();
    __syncthreads();                         // chunk k is in; k - 1 done
    k4_stage_chunk<SS>(a, stages, panel, k + kStages4 - 1, nseq);
    cp_async_commit();
    const int nt = tile / a.ntile_m;
    const int m0 = (tile - nt * a.ntile_m) * kBM4, b0 = nt * kBB4;
    if (c == 0) {
      if (nt != cur_nt) {
        if (a.resident) k4_panel(panel, a.pw, a, b0, 0, a.nchunk * kSC4 / 16);
        k4_beam_sums(csum, a, b0);
        __syncthreads();
        cur_nt = nt;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c0 = csum[8 * j + 2 * q], c1 = csum[8 * j + 2 * q + 1];
        yr[j][0] = c0;
        yr[j][1] = c1;
        yr[j][2] = c0;
        yr[j][3] = c1;
#pragma unroll
        for (int e = 0; e < 4; ++e) yi[j][e] = 0;
      }
    }
    const char* A = stages + (k % kStages4) * K4Stage<SS>::kBytes;
    const char* P;
    int ws;
    if (a.resident) {
      ws = a.pw;
      P = panel + c * kSC4;
    } else {
      ws = kPW4;
      P = panel + (k % kStages4) * (2 * kBB4 * kPW4);
    }
    P += g * ws + 8 * q;
#pragma unroll
    for (int kg = 0; kg < kSC4 / 32; ++kg) {
      uint32_t ar[4], ai[4], an[4];
      k4_load_a<SS>(A, r, kg, q, sel, ar, ai);
#pragma unroll
      for (int e = 0; e < 4; ++e) an[e] = ~ai[e];
      uint2 bw[8], bv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        bw[j] = *reinterpret_cast<const uint2*>(P + 8 * j * ws + 32 * kg);
        bv[j] = *reinterpret_cast<const uint2*>(P + (kBB4 + 8 * j) * ws +
                                                32 * kg);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mma_s8(yr[j], ar, bw[j]);
        mma_s8(yi[j], ar, bv[j]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mma_s8(yr[j], an, bv[j]);
        mma_s8(yi[j], ai, bw[j]);
      }
    }
    if (++c < a.nchunk) continue;
    c = 0;
    tile += gridDim.x;
    const bool pairs = (a.B & 1) == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + r + 8 * h;
      if (m >= a.M) continue;
      int* const orow[2] = {a.yr + (int64_t)m * a.B, a.yi + (int64_t)m * a.B};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int b = b0 + 8 * j + 2 * q;
#pragma unroll
        for (int pl = 0; pl < 2; ++pl) {
          const int v0 = pl ? yi[j][2 * h] : yr[j][2 * h];
          const int v1 = pl ? yi[j][2 * h + 1] : yr[j][2 * h + 1];
          if (pairs && b + 1 < a.B) {
            __stcs(reinterpret_cast<int2*>(orow[pl] + b), make_int2(v0, v1));
          } else {
            if (b < a.B) __stcs(orow[pl] + b, v0);
            if (b + 1 < a.B) __stcs(orow[pl] + b + 1, v1);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// K5: bf16 beamform with f32 accumulation.
//
// Replaces: bifrost_tpu/ops/pallas_kernels.py:beamform_bf16 (pl.pallas_call
// at :307), candidate 'pallas_bf16', one launch per pol.
//
// Bound on the H100: memory.  The per-pol view x[:, :, :, p, 0] of a
// (T, F, S, 2, 2) ci8 gulp touches every 32-byte sector of the gulp, so a
// launch reads all of it: at 512 x 512 x 256 stations and 64 beams,
// 268.4 MB in and 2 x (T, F, B) f32 = 134.2 MB out, 0.120 ms at
// 3.35 TB/s, against 0.035 ms for its 34.4 G operations at the 989
// TFLOP/s bf16 rate (0.05-0.07 ms at mma.sync rates).
//
// Design: one real GEMM over every channel.  Row m = (t, f) of the view
// (M = T * F), K = 2S station-interleaved (k = 2s is re_s, k = 2s + 1 is
// im_s), N = 2B (column b is yr[b], column B + b is yi[b]), against the
// widened panel W2[2s][b] = wr, W2[2s+1][b] = -wi, W2[2s][B+b] = wi,
// W2[2s+1][B+b] = wr (bf16 rounding is symmetric: bf16(-w) = -bf16(w)).
// One f32 accumulator per output replaces the four products.  An A
// register of mma.sync.m16n8k16 holds two consecutive k, i.e. one
// (re_s, im_s) pair: two adjacent bytes of the gulp, converted exactly to
// a bf16x2.
//
// - Tiles: 128 rows x 128 columns (64 beams) per block.  Eight consumer
//   warps each own 32 rows x 64 columns of one plane (warps 0-3 yr, 4-7
//   yi) and load their fragments with ldmatrix from shared rows of bf16
//   pairs padded to 68 words (conflict-free).
// - Warp specialization: two producer groups of four warps stage
//   alternate K chunks (64 stations) into two shared stages; named
//   barriers hand a stage to the consumers (full) and back (free), so the
//   loads, the conversion, the products and the output stores of
//   different chunks overlap instead of taking turns at a block barrier.
// - Resident weights, persistent grid: one block per SM; the consumers
//   convert the f32 weight planes once to the n-major W2 panel in dynamic
//   shared memory (2S x 128 bf16 plus padding: 130 KB at S = 256) and the
//   block walks the M tiles (and the N tiles when B > 64, rebuilding the
//   panel when its N tile changes).  Where the panel does not fit
//   (S > 256), the producers stage each chunk's part of it from L2 beside
//   the voltages instead.
// - 16-byte staging (SS = 4 or 2, the interleaved int8 layout with im one
//   byte after re): a producer thread loads 16 bytes of a row (4 stations
//   of both pols, or 8 of one), keeps its pol's pairs, converts them (one
//   byte_perm and one add a value) and stores 16 bytes of bf16 pairs; its
//   next chunk's loads go out as soon as the stage is handed over.  Every
//   other layout (separate planes, f32 voltages, odd strides) goes
//   through the scalar staging of the same kernel (SS = 0) into the same
//   shared layout.
// - Epilogue: a C fragment's pair is two adjacent columns of one row,
//   stored as a float2 (streaming stores), rows and beams masked.
// ---------------------------------------------------------------------------

constexpr int kCons5 = 256;            // consumer threads: 8 warps of mma
constexpr int kProd5 = 128;            // threads of one producer group
constexpr int kThreads5 = kCons5 + 2 * kProd5;
constexpr int kBM5 = 128;              // rows (t, f) per tile (K5)
constexpr int kBN5 = 128;              // columns per tile: 64 beams x 2
constexpr int kSC5 = 64;               // stations per K chunk (K5)
constexpr int kAW5 = kSC5 + 4;         // padded words per staged row (K5)
constexpr int kBufA5 = kBM5 * kAW5;    // words of one staged voltage chunk
constexpr int kBufW5 = kBN5 * kAW5;    // words of one streamed panel chunk
// named barriers: stage s full (1 + s), stage s free (3 + s), consumers (5)
constexpr int kBarFull5 = 1, kBarFree5 = 3, kBarCons5 = 5;

struct K5Args {
  const float* wr;
  const float* wi;
  const char* re;       // scalar path: the re plane; 16-byte path: row base
  const char* im;
  float* yr;
  float* yi;
  long long st, sf, ss; // element strides of the voltage planes
  int M, F, S, B;
  int nchunk;           // K chunks of kSC5 stations
  int ntile_m, ntiles;
  int pbyte;            // 16-byte path: byte of re in a station word
  int resident;         // the whole W2 panel lives in shared memory
  int pw;               // words per panel row when resident
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  // round to nearest even, lo in the low half (the lower k)
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ci8_bf16x2(uint32_t w, int b) {
  // the int8 pair (re, im) at bytes b, b + 1 of w, biased by 0x80 (w is
  // the gulp's word xor 0x80808080) -> bf16x2 (re low), exact: the byte
  // u = x + 128 under 0x4b000000 is the float 2^23 + u, minus 2^23 + 128
  // is x, and an integer of 8 bits is its float's top 16 bits
  const float r = __uint_as_float(__byte_perm(w, 0x4b000000u, 0x7540 + b)) -
                  8388736.f;
  const float i = __uint_as_float(__byte_perm(w, 0x4b000000u, 0x7541 + b)) -
                  8388736.f;
  return __byte_perm(__float_as_uint(r), __float_as_uint(i), 0x7632);
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const uint32_t* p) {
  // four 8 x 8 b16 matrices, lane l giving row l % 8 of matrix l / 8
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
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

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// W2 columns of beams b0 .. b0 + 63 (yr then yi), stations s0 .. s0 + ns - 1,
// as bf16x2 (k pair) words, n-major with ws words per column, zero past B
// and S; thread i0 of nthr
__device__ __forceinline__ void stage_panel(uint32_t* w, int ws,
                                            const K5Args& a, int b0, int s0,
                                            int ns, int i0, int nthr) {
#pragma unroll 4
  for (int idx = i0; idx < 64 * ns; idx += nthr) {
    const int n = idx / ns, sl = idx - n * ns;
    const int b = b0 + n, s = s0 + sl;
    float c = 0.f, d = 0.f;
    if (b < a.B && s < a.S) {
      c = __ldg(a.wr + (int64_t)b * a.S + s);
      d = __ldg(a.wi + (int64_t)b * a.S + s);
    }
    w[n * ws + sl] = pack_bf16x2(c, -d);
    w[(n + 64) * ws + sl] = pack_bf16x2(d, c);
  }
}

// scalar staging of chunk c of the rows m0 .. m0 + 127: one pair a thread
// per (row, station), zero past M and S; thread i0 of nthr
template <typename V>
__device__ __forceinline__ void stage_scalar(uint32_t* sa, const K5Args& a,
                                             int m0, int c, int i0,
                                             int nthr) {
  const V* re = reinterpret_cast<const V*>(a.re);
  const V* im = reinterpret_cast<const V*>(a.im);
  const int sl = i0 % kSC5, s = c * kSC5 + sl;
  for (int r = i0 / kSC5; r < kBM5; r += nthr / kSC5) {
    const int m = m0 + r;
    uint32_t v = 0u;
    if (m < a.M && s < a.S) {
      const int t = m / a.F, f = m - t * a.F;
      const int64_t o = t * a.st + f * a.sf + s * a.ss;
      v = pack_bf16x2((float)re[o], (float)im[o]);
    }
    sa[r * kAW5 + sl] = v;
  }
}

// Producer group G (threads kCons5 + G * kProd5 ...) stages chunks k = G,
// G + 2, ... of the block's sequence into stage G.
template <int SS, typename V>
__device__ __forceinline__ void k5_producer(const K5Args& a, uint32_t* sa,
                                            uint32_t* sw, int G, int nseq) {
  constexpr int kVR = SS ? kSC5 * SS / 16 : 1;   // vectors per row, chunk
  constexpr int kSV = SS ? 16 / SS : 1;          // stations per vector
  constexpr int kNV = SS ? kBM5 * kVR / kProd5 : 1;
  constexpr int kRS = kProd5 / kVR;              // row step
  const int pt = threadIdx.x - kCons5 - G * kProd5;
  const int vv = pt % kVR, vr = pt / kVR;
  uint4 pre[kNV];
  auto load = [&](int k) {
    const int tile = blockIdx.x + (k / a.nchunk) * gridDim.x;
    const int c = k % a.nchunk;
    const int m0 = (tile % a.ntile_m) * kBM5, s = c * kSC5 + vv * kSV;
#pragma unroll
    for (int i = 0; i < kNV; ++i) {
      const int m = m0 + vr + i * kRS;
      pre[i] = make_uint4(0u, 0u, 0u, 0u);
      if (m < a.M && s < a.S) {
        const int t = m / a.F, f = m - t * a.F;
        pre[i] = __ldcs(reinterpret_cast<const uint4*>(
            a.re + t * a.st + f * a.sf + (int64_t)s * SS));
      }
    }
  };
  uint32_t* const A = sa + G * kBufA5;
  if (SS && G < nseq) load(G);
  for (int k = G; k < nseq; k += 2) {
    const int tile = blockIdx.x + (k / a.nchunk) * gridDim.x;
    const int c = k % a.nchunk;
    const int nt = tile / a.ntile_m;
    if (k >= 2) bar_sync(kBarFree5 + G, kCons5 + kProd5);
    if (SS) {
#pragma unroll
      for (int i = 0; i < kNV; ++i) {
        uint32_t* p = A + (vr + i * kRS) * kAW5 + vv * kSV;
        const uint4 w = make_uint4(pre[i].x ^ 0x80808080u,
                                   pre[i].y ^ 0x80808080u,
                                   pre[i].z ^ 0x80808080u,
                                   pre[i].w ^ 0x80808080u);
        if (SS == 4) {
          *reinterpret_cast<uint4*>(p) = make_uint4(
              ci8_bf16x2(w.x, a.pbyte), ci8_bf16x2(w.y, a.pbyte),
              ci8_bf16x2(w.z, a.pbyte), ci8_bf16x2(w.w, a.pbyte));
        } else {
          *reinterpret_cast<uint4*>(p) = make_uint4(
              ci8_bf16x2(w.x, 0), ci8_bf16x2(w.x, 2), ci8_bf16x2(w.y, 0),
              ci8_bf16x2(w.y, 2));
          *reinterpret_cast<uint4*>(p + 4) = make_uint4(
              ci8_bf16x2(w.z, 0), ci8_bf16x2(w.z, 2), ci8_bf16x2(w.w, 0),
              ci8_bf16x2(w.w, 2));
        }
      }
    } else {
      stage_scalar<V>(A, a, (tile - nt * a.ntile_m) * kBM5, c, pt, kProd5);
    }
    if (!a.resident)
      stage_panel(sw + G * kBufW5, kAW5, a, nt * 64, c * kSC5, kSC5, pt,
                  kProd5);
    bar_arrive(kBarFull5 + G, kCons5 + kProd5);
    if (SS && k + 2 < nseq) load(k + 2);
  }
  // the consumers' release of this group's last chunk
  if (G < nseq) bar_sync(kBarFree5 + G, kCons5 + kProd5);
}

template <int SS, typename V>
__global__ void __launch_bounds__(kThreads5, 1)
beamform_bf16_kernel(const K5Args a) {
  extern __shared__ __align__(16) uint32_t smem5[];
  uint32_t* const sa = smem5;                // 2 staged voltage chunks
  uint32_t* const sw = smem5 + 2 * kBufA5;   // panel, or 2 panel chunks
  // the block's chunks in order: its tiles blockIdx.x + i * gridDim.x,
  // nchunk chunks each; chunk k lives in stage k % 2
  const int nseq = ((a.ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) *
                   a.nchunk;
  if (threadIdx.x >= kCons5) {
    k5_producer<SS, V>(a, sa, sw, (threadIdx.x - kCons5) / kProd5, nseq);
    return;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;      // mma groupID, thread in group
  const int wm = warp & 3, wn = warp >> 2;   // warp's rows, plane
  // ldmatrix rows: A's four 8 x 8 blocks (rows +0/+8, k +0/+8) give an
  // m16 fragment, W's (n +0/+8, k +0/+8) the B fragments of two n8 tiles
  const int l8 = lane & 7, lm = lane >> 3;
  const int aoff = (wm * 32 + l8 + 8 * (lm & 1)) * kAW5 + 4 * (lm >> 1);
  const int wrow = wn * 64 + l8 + 8 * (lm >> 1), wcol = 4 * (lm & 1);
  float acc[2][8][4];
  int tile = blockIdx.x, c = 0, cur_nt = -1;
  for (int k = 0; k < nseq; ++k) {
    const int st = k & 1;
    const int nt = tile / a.ntile_m;
    const int m0 = (tile - nt * a.ntile_m) * kBM5, b0 = nt * 64;
    if (c == 0) {
      if (a.resident && nt != cur_nt) {
        bar_sync(kBarCons5, kCons5);         // the old panel is read out
        stage_panel(sw, a.pw, a, b0, 0, a.nchunk * kSC5, threadIdx.x,
                    kCons5);
        bar_sync(kBarCons5, kCons5);
        cur_nt = nt;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
    const uint32_t* ap = sa + st * kBufA5 + aoff;
    const uint32_t* wp;
    int ws;
    if (a.resident) {
      ws = a.pw;
      wp = sw + wrow * ws + wcol + c * kSC5;
    } else {
      ws = kAW5;
      wp = sw + st * kBufW5 + wrow * ws + wcol;
    }
    bar_sync(kBarFull5 + st, kCons5 + kProd5);
#pragma unroll
    for (int ks = 0; ks < kSC5 / 8; ++ks) {
      uint32_t af[2][4];
      ldsm_x4(af[0], ap + ks * 8);
      ldsm_x4(af[1], ap + 16 * kAW5 + ks * 8);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t bf[4];
        ldsm_x4(bf, wp + jj * 16 * ws + ks * 8);
        mma_bf16(acc[0][2 * jj], af[0], bf[0], bf[1]);
        mma_bf16(acc[1][2 * jj], af[1], bf[0], bf[1]);
        mma_bf16(acc[0][2 * jj + 1], af[0], bf[2], bf[3]);
        mma_bf16(acc[1][2 * jj + 1], af[1], bf[2], bf[3]);
      }
    }
    bar_arrive(kBarFree5 + st, kCons5 + kProd5);
    if (++c < a.nchunk) continue;
    c = 0;
    tile += gridDim.x;
    float* const out = wn ? a.yi : a.yr;
    const bool pairs = (a.B & 1) == 0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 32 + i * 16 + g + 8 * h;
        if (m >= a.M) continue;
        float* row = out + (int64_t)m * a.B;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int b = b0 + j * 8 + 2 * q;
          const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
          if (pairs && b + 1 < a.B) {
            __stcs(reinterpret_cast<float2*>(row + b), make_float2(v0, v1));
          } else {
            if (b < a.B) __stcs(row + b, v0);
            if (b + 1 < a.B) __stcs(row + b + 1, v1);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K6: both pols' int8 beamform -> x scale -> Stokes -> sum of R frames,
// dp4a path: the gulps that the tensor-core path below does not take (R
// of 32 or more, or not dividing 16; rows off 16 bytes; S not a multiple
// of 4, or above what its resident panels hold).
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

constexpr int kThreads = 256;
constexpr int kTT = 32;            // time rows per tile (K6)
constexpr int kBT = 32;            // beams per tile (K6)
constexpr int kSC6 = 64;           // stations per staged chunk (K6)
constexpr int kW6 = kSC6 / 4 + 1;  // padded words per staged row (K6)

__device__ __forceinline__ uint32_t pack4(const int8_t* __restrict__ p,
                                          int64_t stride, int n) {
  // up to 4 int8 at p, p + stride, ... packed little-endian; zero past n
  uint32_t w = 0;
  for (int k = 0; k < 4 && k < n; ++k)
    w |= (uint32_t)(uint8_t)__ldg(p + k * stride) << (8 * k);
  return w;
}

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

// ---------------------------------------------------------------------------
// K6, tensor-core path: both pols' int8 beamform on K4's design -> x scale
// -> Stokes -> sum of R frames, all after the products in registers.
//
// Replaces the same Pallas kernel as the dp4a path above, for the gulps
// that bf_beamform_detect_int8_mma takes: R dividing 16, rows on 16 bytes
// (base, st and sf multiples of 16 bytes, S a multiple of 4) and two
// resident weight panels that fit (S <= 640 at 227 KB a block).  Every
// other gulp keeps the dp4a kernel.
//
// Bound on the H100: as the dp4a path, 0.090 ms at 512 x 512 x 256, 64
// beams, R 8 (the gulp read once, 268.4 MB; 33.5 MB written).
//
// Design: K4's exact int8 GEMM, once per pol, on one staging of the raw
// rows.
// - Tile: 16 frames x 4 adjacent channels x 64 beams.  Staged row
//   r = 16 mt + i is channel f0 + mt and frame t0 + 2 (i % 8) + i / 8, so
//   the thread of groupID g holds frames t0 + 2g (its C row g) and
//   t0 + 2g + 1 (C row g + 8) of row-tile mt; with R dividing 16 an
//   R-group lies in one warp's row-tile (no atomics, no shared memory).
//   A row is 64 stations x (re x, im x, re y, im y), 256 bytes, copied by
//   cp.async with K4's parity swizzle into a ring of kStages6 stages of
//   16 KB (kStages6 - 1 in flight; 4 and 6 stages measured no faster, and
//   the read is hidden); a frame's 4 channels are 4 KB of contiguous
//   gulp.  Ragged T, F and S are zero-filled, and T, F and B
//   masked on store.
// - Warp w owns row-tile w % 4 and beams 32 (w / 4) .. + 31: four n8 tiles
//   x (yr, yi) x 2 pols, 64 int32 accumulators a thread.  One uint4 load
//   of 4 station words serves both pols: the byte_perm selectors 0x5410
//   (pol x) and 0x7632 (pol y) pick a pol's (re, im) pairs, then 0x6420
//   and 0x7531 split re from im, as k4_load_a<4> does.
// - Weights: two resident panels [wxr | wxi] and [wyr | wyi] (k4_panel)
//   and c_b per pol (k4_beam_sums); yr += re.wr + (~im).wi from c_b, yi
//   += re.wi + im.wr, exact for every int8 value (K4's note).  Persistent
//   grid, one block an SM; tiles ordered channel quad fastest, then time,
//   then beam tile (the panels are rebuilt when the beam tile changes).
// - Epilogue in registers: a thread converts its sums to f32, times scale
//   (__fmul_rn), forms I, Q, U, V with the _rn intrinsics in the plain
//   version's order and sums its R-group in frame order: R = 2 inside the
//   thread, R = 4 .. 16 along a chain of R / 2 threads 4 lanes apart
//   (__shfl_up_sync), whose last thread stores the group's sums as float2
//   of its two beams.  Bit-identical to the plain version.  The epilogue
//   is over a quarter of the kernel's time at R 8: the block's warps
//   reach it together and the tensor cores wait; the four n8 tiles'
//   chains step together so that their shuffles overlap (a tenth faster
//   than one tile's chain at a time, at 207 registers against 159).
// ---------------------------------------------------------------------------

constexpr int kTF6 = 16;                 // frames per tile (K6 mma)
constexpr int kCF6 = 4;                  // channels per tile
constexpr int kRow6 = kSC4 * 4;          // bytes per staged row
constexpr int kStage6 = kTF6 * kCF6 * kRow6;  // bytes per ring stage
constexpr int kStages6 = 3;              // cp.async ring depth

struct K6Weights {                       // one pol's weight planes
  const int8_t* wr;
  const int8_t* wi;
  int S, B;
  int wvec;                              // rows load 16 bytes at a time
};

struct K6Args {
  K6Weights wx, wy;
  const char* x;         // the gulp (T, F, S, 2, 2) int8
  float* out;            // (T / R, F, 4, B) float32
  long long st, sf;      // frame and channel strides (bytes)
  float scale;
  int T, F, S, B, R;
  int nchunk;            // K chunks of kSC4 stations
  int ntile_f;           // channel quads
  int ntile_tf;          // tiles of one beam tile (time x channel quads)
  int ntiles;
  int pw;                // bytes per panel column
};

// Stage chunk k of the block's sequence (its tiles blockIdx.x + i *
// gridDim.x, nchunk chunks each) into ring stage k % kStages6: thread
// (i, v) copies vector v of MMA row i of each row-tile.
__device__ __forceinline__ void k6_stage_chunk(const K6Args& a, char* stages,
                                               int k, int nseq) {
  if (k >= nseq) return;
  const int n = k / a.nchunk, c = k - n * a.nchunk;
  const int tf = (blockIdx.x + n * gridDim.x) % a.ntile_tf;
  const int tt = tf / a.ntile_f, fq = tf - tt * a.ntile_f;
  char* const A = stages + (k % kStages6) * kStage6;
  const int v = threadIdx.x % 16, i = threadIdx.x / 16;
  const int t = tt * kTF6 + 2 * (i & 7) + (i >> 3);
  const int s = c * kSC4 + 4 * v;
#pragma unroll
  for (int mt = 0; mt < kCF6; ++mt) {
    const int f = fq * kCF6 + mt;
    const bool ok = t < a.T && f < a.F && s < a.S;
    const char* src = a.x;
    if (ok) src += t * a.st + f * a.sf + (int64_t)s * 4;
    cp_async16(A + (16 * mt + i) * kRow6 + 16 * (v ^ (i & 1)), src,
               ok ? 16 : 0);
  }
}

// Stokes I, Q, U, V of one frame and beam from both pols' exact sums,
// each product and sum rounded as the plain version's separate ops
__device__ __forceinline__ void k6_stokes(int xr, int xi, int yr, int yi,
                                          float scale, float* s) {
  const float bxr = __fmul_rn(__int2float_rn(xr), scale);
  const float bxi = __fmul_rn(__int2float_rn(xi), scale);
  const float byr = __fmul_rn(__int2float_rn(yr), scale);
  const float byi = __fmul_rn(__int2float_rn(yi), scale);
  const float xx = __fadd_rn(__fmul_rn(bxr, bxr), __fmul_rn(bxi, bxi));
  const float yy = __fadd_rn(__fmul_rn(byr, byr), __fmul_rn(byi, byi));
  const float xyr = __fadd_rn(__fmul_rn(bxr, byr), __fmul_rn(bxi, byi));
  const float xyi = __fsub_rn(__fmul_rn(bxi, byr), __fmul_rn(bxr, byi));
  s[0] = __fadd_rn(xx, yy);
  s[1] = __fsub_rn(xx, yy);
  s[2] = __fmul_rn(2.f, xyr);
  s[3] = __fmul_rn(-2.f, xyi);
}

// I, Q, U, V of beams b, b + 1 (v[beam][stokes]) into output row `row`,
// channel f; beams masked
__device__ __forceinline__ void k6_store(const K6Args& a, int row, int f,
                                         int b, const float (&v)[2][4]) {
  float* const o = a.out + ((int64_t)row * a.F + f) * 4 * a.B + b;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    if ((a.B & 1) == 0 && b + 1 < a.B) {
      __stcs(reinterpret_cast<float2*>(o + s * a.B),
             make_float2(v[0][s], v[1][s]));
    } else {
      if (b < a.B) __stcs(o + s * a.B, v[0][s]);
      if (b + 1 < a.B) __stcs(o + s * a.B + 1, v[1][s]);
    }
  }
}

// The finished tile's outputs: the thread's frames t0 + 2g, t0 + 2g + 1
// of channel f0 + mt and beams b0 + bw0 + 8j + 2q, + 1 (j < 4).  The four
// n8 tiles' chains step together, 32 independent shuffles a step.  Every
// lane reaches every shuffle; only the stores are masked.
__device__ __forceinline__ void k6_epilogue(const K6Args& a,
                                            const int (&acc)[2][4][2][4],
                                            int tile, int mt, int bw0,
                                            int g, int q) {
  const int nb = tile / a.ntile_tf, tf = tile - nb * a.ntile_tf;
  const int tt = tf / a.ntile_f, fq = tf - tt * a.ntile_f;
  const int f = fq * kCF6 + mt, t = tt * kTF6 + 2 * g;
  const int b = nb * kBB4 + bw0 + 2 * q;   // + 8j
  const int n = a.R >> 1;                  // threads an R-group (R >= 2)
  const int gl = n ? g % n : 0;            // the thread's place in it
  const bool fin = f < a.F;
  float v[4][2][2][4];                     // [n8][frame][beam][I, Q, U, V]
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        k6_stokes(acc[0][j][0][2 * h + e], acc[0][j][1][2 * h + e],
                  acc[1][j][0][2 * h + e], acc[1][j][1][2 * h + e], a.scale,
                  v[j][h][e]);
  if (n == 0) {                            // R = 1: every frame is a row
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (fin && t + h < a.T) k6_store(a, t + h, f, b + 8 * j, v[j][h]);
    return;
  }
  float s[4][2][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        s[j][e][k] = __fadd_rn(v[j][0][e][k], v[j][1][e][k]);
  // the running sum of frames t0 + 2 (g - gl) .. moves one thread on a
  // step: thread gl adds its two frames at step gl
  for (int step = 1; step < n; ++step) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float prev = __shfl_up_sync(~0u, s[j][e][k], 4);
          if (gl == step)
            s[j][e][k] = __fadd_rn(__fadd_rn(prev, v[j][0][e][k]),
                                   v[j][1][e][k]);
        }
  }
  if (gl == n - 1 && fin && t < a.T)
#pragma unroll
    for (int j = 0; j < 4; ++j) k6_store(a, t / a.R, f, b + 8 * j, s[j]);
}

__global__ void __launch_bounds__(kThreads4, 1)
beamform_detect_mma_kernel(const K6Args a) {
  extern __shared__ __align__(16) char smem6[];
  char* const stages = smem6;
  char* const panel = smem6 + kStages6 * kStage6;  // [wxr | wxi], [wyr | wyi]
  int* const csum = reinterpret_cast<int*>(panel + 4 * kBB4 * a.pw);
  const int nseq = ((a.ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) *
                   a.nchunk;
#pragma unroll
  for (int k = 0; k < kStages6 - 1; ++k) {
    k6_stage_chunk(a, stages, k, nseq);
    cp_async_commit();
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;      // mma groupID, thread in group
  const int mt = warp & 3, bw0 = 32 * (warp >> 2);  // row-tile, beams
  const int r = 16 * mt + g;                 // the thread's rows r, r + 8
  int acc[2][4][2][4];                       // [pol][n8][yr, yi][fragment]
  int tile = blockIdx.x, c = 0, cur_nb = -1;
  for (int k = 0; k < nseq; ++k) {
    cp_async_wait<kStages6 - 2>();
    __syncthreads();                         // chunk k is in; k - 1 done
    k6_stage_chunk(a, stages, k + kStages6 - 1, nseq);
    cp_async_commit();
    if (c == 0) {
      const int nb = tile / a.ntile_tf;
      if (nb != cur_nb) {
        const int ngrp = a.nchunk * kSC4 / 16;
        k4_panel(panel, a.pw, a.wx, nb * kBB4, 0, ngrp);
        k4_panel(panel + 2 * kBB4 * a.pw, a.pw, a.wy, nb * kBB4, 0, ngrp);
        k4_beam_sums(csum, a.wx, nb * kBB4);
        k4_beam_sums(csum + kBB4, a.wy, nb * kBB4);
        __syncthreads();
        cur_nb = nb;
      }
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int* cb = csum + p * kBB4 + bw0 + 8 * j + 2 * q;
          acc[p][j][0][0] = acc[p][j][0][2] = cb[0];
          acc[p][j][0][1] = acc[p][j][0][3] = cb[1];
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[p][j][1][e] = 0;
        }
    }
    const char* A = stages + (k % kStages6) * kStage6;
    const char* P = panel + (bw0 + g) * a.pw + c * kSC4 + 8 * q;
#pragma unroll
    for (int kg = 0; kg < kSC4 / 32; ++kg) {
      uint4 w[2][2];                         // [row r, r + 8][vector]
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int u = 0; u < 2; ++u)
          w[h][u] = *reinterpret_cast<const uint4*>(
              A + (r + 8 * h) * kRow6 + 16 * ((kg * 8 + 2 * q + u) ^ (g & 1)));
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const uint32_t sel = p ? 0x7632u : 0x5410u;
        uint32_t ar[4], ai[4], an[4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const uint32_t t0 = __byte_perm(w[h][u].x, w[h][u].y, sel);
            const uint32_t t1 = __byte_perm(w[h][u].z, w[h][u].w, sel);
            ar[h + 2 * u] = __byte_perm(t0, t1, 0x6420);
            ai[h + 2 * u] = __byte_perm(t0, t1, 0x7531);
          }
#pragma unroll
        for (int e = 0; e < 4; ++e) an[e] = ~ai[e];
        const char* Pp = P + p * 2 * kBB4 * a.pw + 32 * kg;
        uint2 fr[4], fi[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          fr[j] = *reinterpret_cast<const uint2*>(Pp + 8 * j * a.pw);
          fi[j] = *reinterpret_cast<const uint2*>(Pp + (kBB4 + 8 * j) * a.pw);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_s8(acc[p][j][0], ar, fr[j]);
          mma_s8(acc[p][j][1], ar, fi[j]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_s8(acc[p][j][0], an, fi[j]);
          mma_s8(acc[p][j][1], ai, fr[j]);
        }
      }
    }
    if (++c < a.nchunk) continue;
    c = 0;
    k6_epilogue(a, acc, tile, mt, bw0, g, q);
    tile += gridDim.x;
  }
  cp_async_wait<0>();
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

constexpr int kMaxDev = 64;

struct DevInfo {
  int sms, smem;  // SM count, shared memory a block may opt in to
  bool attr[8];   // the dynamic shared-memory attribute is set, per kernel
};

DevInfo dev_info[kMaxDev];

// the current device's DevInfo, read once per device
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

// lets kernel `which` of d's device take all the shared memory a block may
// opt in to: above 48 KB only after this; a launch without it is refused
template <typename K>
cudaError_t opt_in_smem(DevInfo& d, int which, K kernel) {
  if (d.attr[which]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, d.smem);
  if (err == cudaSuccess) d.attr[which] = true;
  return err;
}

// the 16-byte staging's conditions (K4, K5): int8 planes with im one byte
// after re, station stride ss == vec (4 or 2), re at byte poff (poff + 2 <=
// vec) of 16-byte aligned rows (st, sf multiples of 16), nstand * vec a
// multiple of 16
bool vec16_ok(const void* re, const void* im, int vec, int poff,
              int nstand, long long st, long long sf, long long ss) {
  const char* base = (const char*)re - poff;
  return (vec == 2 || vec == 4) && ss == vec && poff >= 0 &&
         poff + 2 <= vec && (const char*)im == (const char*)re + 1 &&
         (uintptr_t)base % 16 == 0 && st % 16 == 0 && sf % 16 == 0 &&
         ((int64_t)nstand * vec) % 16 == 0;
}

// zeroes two (M, nbeam) planes of `bytes` bytes each: the empty sums
int zero_planes(void* yr, void* yi, size_t bytes, void* stream) {
  cudaError_t err = cudaMemsetAsync(yr, 0, bytes, (cudaStream_t)stream);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(yi, 0, bytes, (cudaStream_t)stream);
  return (int)err;
}

}  // namespace

extern "C" {

// K4.  wr, wi: (nbeam, nstand) int8, contiguous.  re, im: (ntime, nfreq,
// nstand) int8 with element strides st, sf, ss shared by both.  yr, yi:
// (ntime, nfreq, nbeam) int32, contiguous.  vec 4 or 2 takes the 16-byte
// staging (vec16_ok), vec 0 the scalar staging.  Returns a cudaError_t
// value.
int bf_beamform_int8(const void* wr, const void* wi, const void* re,
                     const void* im, void* yr, void* yi, int vec, int poff,
                     int ntime, int nfreq, int nstand, int nbeam,
                     long long st, long long sf, long long ss, void* stream) {
  if (ntime <= 0 || nfreq <= 0 || nbeam <= 0) return 0;
  const int64_t M = (int64_t)ntime * nfreq;
  const int64_t ntile_m = cdiv(M, kBM4), ntile_n = cdiv(nbeam, kBB4);
  if (M + kBM4 > 0x7fffffff || ntile_m * ntile_n > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (nstand <= 0) return zero_planes(yr, yi, (size_t)M * nbeam * 4, stream);
  if (vec && !vec16_ok(re, im, vec, poff, nstand, st, sf, ss))
    return (int)cudaErrorInvalidValue;
  DevInfo* d = nullptr;
  cudaError_t err = current_dev(&d);
  if (err != cudaSuccess) return (int)err;
  const int nchunk = (int)cdiv(nstand, kSC4);
  const int resident = nstand <= kRes4;
  const int pw = nchunk * kSC4 + 32;
  const size_t bytes =
      kStages4 * (size_t)(vec == 4 ? K4Stage<4>::kBytes : K4Stage<2>::kBytes) +
      (resident ? 2 * kBB4 * (size_t)pw : kStages4 * 2 * kBB4 * kPW4) +
      kBB4 * sizeof(int);
  if (bytes > (size_t)d->smem) return (int)cudaErrorInvalidConfiguration;
  const int wvec = nstand % 16 == 0 && (uintptr_t)wr % 16 == 0 &&
                   (uintptr_t)wi % 16 == 0;
  const int ntiles = (int)(ntile_m * ntile_n);
  K4Args a{(const int8_t*)wr, (const int8_t*)wi,
           (const char*)re - (vec ? poff : 0), (const char*)im, (int*)yr,
           (int*)yi, st, sf, ss, (int)M, nfreq, nstand, nbeam, nchunk,
           (int)ntile_m, ntiles, poff, resident, pw, wvec};
  void (*kernel)(const K4Args) = &beamform_int8_kernel<0>;
  int which = 6;
  if (vec == 4) {
    kernel = &beamform_int8_kernel<4>;
    which = 4;
  } else if (vec == 2) {
    kernel = &beamform_int8_kernel<2>;
    which = 5;
  }
  err = opt_in_smem(*d, which, kernel);
  if (err != cudaSuccess) return (int)err;
  const int grid = ntiles < d->sms ? ntiles : d->sms;
  kernel<<<grid, kThreads4, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// K5.  wr, wi: (nbeam, nstand) float32, contiguous.  re, im: (ntime, nfreq,
// nstand), int8 (vtype 0) or float32 (vtype 1), element strides st, sf, ss
// shared by both.  yr, yi: (ntime, nfreq, nbeam) float32, contiguous.
// vec 4 or 2 takes the 16-byte staging (int8 planes, vec16_ok); vec 0 the
// scalar staging.  Returns a cudaError_t value.
int bf_beamform_bf16(const void* wr, const void* wi, const void* re,
                     const void* im, void* yr, void* yi, int vtype, int vec,
                     int poff, int ntime, int nfreq, int nstand, int nbeam,
                     long long st, long long sf, long long ss, void* stream) {
  if (ntime <= 0 || nfreq <= 0 || nbeam <= 0) return 0;
  const int64_t M = (int64_t)ntime * nfreq;
  const int64_t ntile_m = cdiv(M, kBM5), ntile_n = cdiv(nbeam, 64);
  if (M + kBM5 > 0x7fffffff || ntile_m * ntile_n > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (nstand <= 0)                          // empty sums
    return zero_planes(yr, yi, (size_t)M * nbeam * sizeof(float), stream);
  if (vec && (vtype != 0 || !vec16_ok(re, im, vec, poff, nstand, st, sf, ss)))
    return (int)cudaErrorInvalidValue;
  const char* base = (const char*)re - (vec ? poff : 0);
  DevInfo* d = nullptr;
  cudaError_t err = current_dev(&d);
  if (err != cudaSuccess) return (int)err;
  const int nchunk = (int)cdiv(nstand, kSC5);
  const int pw = nchunk * kSC5 + 4;
  const size_t abytes = 2 * (size_t)kBufA5 * 4;
  const size_t rbytes = abytes + (size_t)kBN5 * pw * 4;
  const size_t sbytes = abytes + 2 * (size_t)kBufW5 * 4;
  const int resident = rbytes <= (size_t)d->smem;
  const size_t bytes = resident ? rbytes : sbytes;
  if (bytes > (size_t)d->smem) return (int)cudaErrorInvalidConfiguration;
  const int ntiles = (int)(ntile_m * ntile_n);
  K5Args a{(const float*)wr, (const float*)wi, base, (const char*)im,
           (float*)yr, (float*)yi, st, sf, ss, (int)M, nfreq, nstand, nbeam,
           nchunk, (int)ntile_m, ntiles, poff, resident, pw};
  void (*kernel)(const K5Args) = &beamform_bf16_kernel<0, float>;
  int which = 3;
  if (vec == 4) {
    kernel = &beamform_bf16_kernel<4, int8_t>;
    which = 0;
  } else if (vec == 2) {
    kernel = &beamform_bf16_kernel<2, int8_t>;
    which = 1;
  } else if (vtype == 0) {
    kernel = &beamform_bf16_kernel<0, int8_t>;
    which = 2;
  }
  err = opt_in_smem(*d, which, kernel);
  if (err != cudaSuccess) return (int)err;
  const int grid = ntiles < d->sms ? ntiles : d->sms;
  kernel<<<grid, kThreads5, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// K6.  wxr, wxi, wyr, wyi: (nbeam, nstand) int8, contiguous.  x: (ntime,
// nfreq, nstand, 2 pol, 2 re/im) int8 with element strides st, sf for the
// first two axes (multiples of 4) and the last three contiguous; 4-byte
// aligned.  out: (ntime / rfactor, nfreq, 4, nbeam) float32, contiguous,
// ordered I, Q, U, V.  rfactor must divide ntime.  Takes every such input
// (the dp4a kernel); the wrapper sends it those that
// bf_beamform_detect_int8_mma does not take.
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

// K6, tensor-core path (beamform_detect_mma_kernel): the arguments of
// bf_beamform_detect_int8, for the inputs it takes and no others: rfactor
// dividing 16 and ntime; x on 16 bytes with st, sf multiples of 16; nstand
// a positive multiple of 4 whose two resident weight panels fit beside the
// ring (nstand <= 640 at 227 KB a block).  Any other input returns
// cudaErrorInvalidValue; the wrapper sends those to
// bf_beamform_detect_int8.
int bf_beamform_detect_int8_mma(const void* wxr, const void* wxi,
                                const void* wyr, const void* wyi,
                                const void* x, void* out, float scale,
                                int ntime, int nfreq, int nstand, int nbeam,
                                int rfactor, long long st, long long sf,
                                void* stream) {
  if (ntime <= 0 || nfreq <= 0 || nbeam <= 0) return 0;
  if (rfactor <= 0 || 16 % rfactor || ntime % rfactor || nstand <= 0 ||
      nstand % 4 || (uintptr_t)x % 16 || st % 16 || sf % 16)
    return (int)cudaErrorInvalidValue;
  const int64_t ntile_f = cdiv(nfreq, kCF6);
  const int64_t ntile_tf = cdiv(ntime, kTF6) * ntile_f;
  const int64_t ntiles = ntile_tf * cdiv(nbeam, kBB4);
  if (ntiles > 0x7fffffff - 4096) return (int)cudaErrorInvalidValue;
  DevInfo* d = nullptr;
  cudaError_t err = current_dev(&d);
  if (err != cudaSuccess) return (int)err;
  const int nchunk = (int)cdiv(nstand, kSC4);
  const int pw = nchunk * kSC4 + 32;
  const size_t bytes = kStages6 * (size_t)kStage6 + 4 * kBB4 * (size_t)pw +
                       2 * kBB4 * sizeof(int);
  if (bytes > (size_t)d->smem) return (int)cudaErrorInvalidValue;
  const auto vec = [nstand](const void* wr, const void* wi) {
    return (int)(nstand % 16 == 0 && (uintptr_t)wr % 16 == 0 &&
                 (uintptr_t)wi % 16 == 0);
  };
  K6Args a{{(const int8_t*)wxr, (const int8_t*)wxi, nstand, nbeam,
            vec(wxr, wxi)},
           {(const int8_t*)wyr, (const int8_t*)wyi, nstand, nbeam,
            vec(wyr, wyi)},
           (const char*)x, (float*)out, st, sf, scale, ntime, nfreq, nstand,
           nbeam, rfactor, nchunk, (int)ntile_f, (int)ntile_tf, (int)ntiles,
           pw};
  err = opt_in_smem(*d, 7, beamform_detect_mma_kernel);
  if (err != cudaSuccess) return (int)err;
  const int grid = ntiles < d->sms ? (int)ntiles : d->sms;
  beamform_detect_mma_kernel<<<grid, kThreads4, bytes,
                               (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

const char* bf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
