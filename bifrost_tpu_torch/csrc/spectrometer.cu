// Fused spectrometer for Hopper (sm_90a): ci8 dual-pol voltages ->
// nfft-point c2c FFT -> Stokes I, Q, U, V -> sum of rfactor adjacent
// frequency bins, in natural frequency order, in one kernel.
//
// Replaces: bifrost_tpu/ops/spectrometer.py:fused_spectrometer
// (pl.pallas_call at :341, kernel body _kernel at :168).  That kernel
// computes the FFT as a 4-step factorization on the MXU (Karatsuba, bf16
// hi/lo passes, a Bailey transpose), all shaped around Mosaic.  This one
// computes the same function and nothing of that shape carries over.
//
// Bound on the H100: memory.  Per complex sample the kernel reads 2 B of
// ci8 and writes 16 B / rfactor of Stokes (4 B at rfactor 4), 537 MB per
// 16384 x 2 x 4096 gulp: 0.16 ms at 3.35 TB/s.  The work, 5 N log2 N
// flop per FFT, is 8.05 GFLOP per gulp: 0.12 ms at the 67 TFLOP/s FP32
// rate outside the tensor cores.
//
// Design: one thread block per time row.  The block reads both pols'
// nfft samples once (two samples per 32-bit load, coalesced), unpacks
// them to float2 and stores them bit-reversed in dynamic shared memory
// (2 x nfft x 8 B = 64 KB at nfft 4096, above the 48 KB default, hence
// cudaFuncSetAttribute).  The FFT is an in-place iterative radix-2
// Cooley-Tukey (decimation in time) in shared memory, FP32 with FMA and
// a twiddle table built in float64 on the host; in place it needs half
// the shared memory of an out-of-place Stockham pass, so three blocks
// fit on one SM.  Stokes and the rfactor sum are formed in registers and
// each output row (4, nfft / rfactor) is written once.  No intermediate
// touches device memory, so the kernel moves exactly the bytes of its
// bound; its distance from the bound is shared-memory traffic and the
// log2(nfft) block barriers, which later work can cut with radix-4/8
// register butterflies.  Offsets into the gulp are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

__global__ void __launch_bounds__(kThreads)
spectrometer_kernel(const uint32_t* __restrict__ volt,    // (T, 2, n) ci8 pairs
                    const float2* __restrict__ twiddle,   // (n / 2)
                    float* __restrict__ out,              // (T, 4, n / rfactor)
                    int log2n, int rfactor) {
  extern __shared__ float2 sm[];                          // [2][n], pol-major
  const int n = 1 << log2n;
  const int half = n >> 1;
  const int64_t t = blockIdx.x;

  // Load: a row holds 2 n samples in n 32-bit words; each word is two
  // consecutive samples of one pol, each a little-endian int16 whose
  // low byte is re and high byte im.
  const uint32_t* row = volt + t * (int64_t)n;
  for (int w = threadIdx.x; w < n; w += blockDim.x) {
    const uint32_t v = __ldg(row + w);
    const int s = 2 * w;
    const int pol = s >> log2n;
    const int k = s & (n - 1);
    const unsigned r0 = __brev((unsigned)k) >> (32 - log2n);
    const unsigned r1 = __brev((unsigned)(k + 1)) >> (32 - log2n);
    sm[pol * n + r0] = make_float2((float)(int8_t)(v & 0xffu),
                                   (float)(int8_t)((v >> 8) & 0xffu));
    sm[pol * n + r1] = make_float2((float)(int8_t)((v >> 16) & 0xffu),
                                   (float)(int8_t)(v >> 24));
  }
  __syncthreads();

  // Radix-2 DIT stages: span 2m, twiddle W_{2m}^j = twiddle[j n / 2m].
  for (int s = 0; s < log2n; ++s) {
    const int m = 1 << s;
    const int tw_shift = log2n - 1 - s;
    for (int b = threadIdx.x; b < n; b += blockDim.x) {
      const int pol = b >> (log2n - 1);
      const int bb = b & (half - 1);
      const int j = bb & (m - 1);
      const int i0 = pol * n + ((bb - j) << 1) + j;
      const int i1 = i0 + m;
      const float2 a = sm[i0];
      const float2 c = cmul(__ldg(twiddle + (j << tw_shift)), sm[i1]);
      sm[i0] = make_float2(a.x + c.x, a.y + c.y);
      sm[i1] = make_float2(a.x - c.x, a.y - c.y);
    }
    __syncthreads();
  }

  // Stokes of x = pol 0, y = pol 1, summed over rfactor adjacent bins.
  const int nout = n / rfactor;
  float* orow = out + t * 4 * (int64_t)nout;
  for (int g = threadIdx.x; g < nout; g += blockDim.x) {
    float si = 0.f, sq = 0.f, su = 0.f, sv = 0.f;
    for (int q = 0; q < rfactor; ++q) {
      const int k = g * rfactor + q;
      const float2 x = sm[k];
      const float2 y = sm[n + k];
      const float xx = fmaf(x.x, x.x, x.y * x.y);
      const float yy = fmaf(y.x, y.x, y.y * y.y);
      const float xyr = fmaf(x.x, y.x, x.y * y.y);     // Re(x conj(y))
      const float xyi = fmaf(x.y, y.x, -x.x * y.y);    // Im(x conj(y))
      si += xx + yy;
      sq += xx - yy;
      su += 2.f * xyr;
      sv -= 2.f * xyi;
    }
    orow[g] = si;
    orow[nout + g] = sq;
    orow[2 * nout + g] = su;
    orow[3 * nout + g] = sv;
  }
}

}  // namespace

extern "C" {

// volt: (ntime, 2, 2^log2n, 2) int8, contiguous, 4-byte aligned.
// twiddle: (2^log2n / 2) float2, exp(-2 pi i k / 2^log2n).
// out: (ntime, 4, 2^log2n / rfactor) float32, contiguous.
// Returns a cudaError_t value; 0 on success.
int bf_spectrometer(const void* volt, const void* twiddle, void* out,
                    long long ntime, int log2n, int rfactor, void* stream) {
  const size_t smem = 2 * ((size_t)1 << log2n) * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      spectrometer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (ntime <= 0) return 0;
  spectrometer_kernel<<<dim3((unsigned)ntime), kThreads, smem,
                        (cudaStream_t)stream>>>(
      (const uint32_t*)volt, (const float2*)twiddle, (float*)out, log2n,
      rfactor);
  return (int)cudaGetLastError();
}

const char* bf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
