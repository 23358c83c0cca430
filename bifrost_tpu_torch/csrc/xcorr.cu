// FX-correlator X-step kernels for Hopper (sm_90a): integer visibilities
//   vis[g, f, a, b] = sum_t x_i[g, t, f, a] * conj(x_j[g, t, f, b])
// of int8 voltage planes, summed over time in int32, written once as
// complex64 (interleaved float pairs that torch.view_as_complex reads):
//
//   re = sum_t (re_a re_b + im_a im_b)
//   im = sum_t (im_a re_b - re_a im_b)
//
//   K7 bf_xcorr with herm = 1: the Hermitian auto-correlation, x_i = x_j.
//      Replaces bifrost_tpu/ops/pallas_kernels.py:xcorr_herm
//      (pl.pallas_call at :155), candidate 'pallas' of the X-engine and of
//      xcorr_int8's auto family.  There im = K - K^T with K = im^T re.
//   K8 bf_xcorr with herm = 0: the cross-correlation of an input block
//      against another.  Replaces pallas_kernels.py:xcorr_cross
//      (pl.pallas_call at :199), candidate 'pallas' of xcorr_int8's cross
//      family (the station-sharded mesh correlator's row block against the
//      gathered columns).
//
// Bound on the H100: the output write.  At the FX path's gulp (2 groups of
// 128 frames, 1024 channels, 512 inputs) K7 reads 268 MB and writes 4.3 GB
// of complex64, 1.36 ms at 3.35 TB/s, against 0.28 ms for its 5.5e11
// operations at the 1,979 TOP/s int8 rate.  K8 at a 128 x 512 block: 168 MB
// in, 537 MB out, 0.21 ms, against 0.035 ms of operations.
//
// Design: one block per (group, channel, 64 x 64 output tile); 256 threads,
// each owning 4 x 4 outputs.  Time is looped inside the block, 32 frames at
// a time: each input's 32 samples are staged in shared memory as eight
// words of four int8 (time is the contraction axis, so four consecutive
// frames pack into one word), and the inner loop is __dp4a (four int8 MACs
// into an int32) with three accumulators per output (re_a re_b + im_a im_b,
// im_a re_b, re_a im_b).  The planes come with strides (group, time,
// channel, input), so the re and im views of a (T, F, S, P, 2) ci8 gulp are
// read in place.  Ragged tiles (n not a multiple of 64, T not of 32) are
// zero-filled in shared memory and masked on store.  The finished tile is
// converted once (__int2float_rn) into shared memory and written row by
// row, so every store is coalesced.  K7 runs only the tiles on and below
// the diagonal and writes each off-diagonal tile a second time as its
// conjugate transpose (the full matrix, matrix_fill_mode 'full'); integer
// sums make that bit-identical to computing the upper tile.  Every int32
// sum is exact while T <= 65,535 (|re| <= 2 * 128^2 * T < 2^31; the
// wrapper refuses more).  Simple first: dp4a instead of the int8 tensor
// cores (mma.sync m16n8k32 or wgmma), byte-wise staging loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <bool kHerm>
__global__ void __launch_bounds__(kThreads)
xcorr_kernel(Planes xi, Planes xj, float2* __restrict__ out, int ntime,
             int nfreq, int ntile_j, int ntiles) {
  __shared__ int s_ra[kTile * kWP], s_ia[kTile * kWP];
  __shared__ int s_rb[kTile * kWP], s_ib[kTile * kWP];
  __shared__ float2 s_out[kTile][kTile + 1];
  int64_t blk = blockIdx.x;
  const int tile = (int)(blk % ntiles);
  blk /= ntiles;
  const int f = (int)(blk % nfreq);
  const int g = (int)(blk / nfreq);
  int ti, tj;
  if (kHerm) {
    // tile k of the lower triangle: k = ti (ti + 1) / 2 + tj, tj <= ti
    ti = (int)((sqrtf(8.f * tile + 1.f) - 1.f) * 0.5f);
    while ((ti + 1) * (ti + 2) / 2 <= tile) ++ti;
    while (ti * (ti + 1) / 2 > tile) --ti;
    tj = tile - ti * (ti + 1) / 2;
  } else {
    ti = tile / ntile_j;
    tj = tile % ntile_j;
  }
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
  if (kHerm && ti != tj) {
    // the conjugate transpose into the upper triangle; 0 - v keeps a zero
    // imaginary part +0, as the plain version's int -> float cast gives
    for (int k = threadIdx.x; k < kTile * kTile; k += kThreads) {
      const int r = k / kTile, c = k % kTile;
      const int b = b0 + r, a = a0 + c;
      if (a < ni && b < nj) {
        const float2 v = s_out[c][r];
        o[(int64_t)b * nj + a] = make_float2(v.x, __fsub_rn(0.f, v.y));
      }
    }
  }
}

}  // namespace

extern "C" {

// re_i, im_i: (ngroup, ntime, nfreq, ni) int8 planes with strides sg_i,
// st_i, sf_i, sn_i (in elements, shared by both); re_j, im_j likewise with
// nj inputs (herm = 1: the same planes, nj = ni).  out: (ngroup, nfreq, ni,
// nj) complex64, contiguous.  Returns a cudaError_t value; 0 on success.
int bf_xcorr(const void* re_i, const void* im_i, const void* re_j,
             const void* im_j, void* out, int herm, int ngroup, int ntime,
             int nfreq, int ni, int nj, long long sg_i, long long st_i,
             long long sf_i, long long sn_i, long long sg_j, long long st_j,
             long long sf_j, long long sn_j, void* stream) {
  if (ngroup <= 0 || nfreq <= 0 || ni <= 0 || nj <= 0) return 0;
  const Planes xi = {(const int8_t*)re_i, (const int8_t*)im_i, sg_i, st_i,
                     sf_i, sn_i, ni};
  const Planes xj = {(const int8_t*)re_j, (const int8_t*)im_j, sg_j, st_j,
                     sf_j, sn_j, nj};
  const int nti = (ni + kTile - 1) / kTile, ntj = (nj + kTile - 1) / kTile;
  const int ntiles = herm ? nti * (nti + 1) / 2 : nti * ntj;
  const long long nblk = (long long)ntiles * nfreq * ngroup;
  if (nblk > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (herm)
    xcorr_kernel<true><<<(unsigned)nblk, kThreads, 0, (cudaStream_t)stream>>>(
        xi, xj, (float2*)out, ntime, nfreq, ntj, ntiles);
  else
    xcorr_kernel<false><<<(unsigned)nblk, kThreads, 0,
                          (cudaStream_t)stream>>>(
        xi, xj, (float2*)out, ntime, nfreq, ntj, ntiles);
  return (int)cudaGetLastError();
}

const char* bf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
